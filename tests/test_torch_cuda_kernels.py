"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside its fixture) where
``torch.cuda.is_available()`` is False. Run them on a machine with a card:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

(``--noconftest`` keeps the JAX-only ``tests/conftest.py`` out of a run on a
machine without JAX.)

Tolerances: both sides round the dequantized weights to bf16 at the same
points with the same IEEE operations, so the matmuls differ only in the
order of their f32 sums (bounded by 1e-4 of the output's scale). Flash
attention's online softmax and the plain one-shot softmax differ in f32
rounding before the final bf16 cast: at most two bf16 ulps of the output's
scale (2 * 2^-8 relative). That holds for every cache kind: the kernels
fold scales and minimums in after the dots, the plain versions before, and
both in f32.
"""

import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
from llama_gguf_inference_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain)
from llama_gguf_inference_tpu_torch.quant.numpy_ref import quantize
from llama_gguf_inference_tpu_torch.quant.repack import repack, to_quant_linear

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weight(gtype, out_f, in_f, seed, device):
    x = np.random.default_rng(seed).normal(size=(out_f, in_f)).astype(np.float32)
    return to_quant_linear(repack(quantize(x, gtype), gtype, out_f, in_f), device)


def _close(got, want, rel):
    scale = want.abs().max().item() + 1e-6
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


@pytest.mark.parametrize("B", [1, 4, 9, 40])
@pytest.mark.parametrize("out_f,in_f", [(256, 512), (132, 1024)])
def test_quant_matmul_4bit_kernel(dev, B, out_f, in_f):
    w = _weight(GGMLType.Q4_K, out_f, in_f, B, dev)
    x = torch.randn(B, in_f, generator=torch.Generator().manual_seed(B)).to(dev)
    x2 = w.permute_activations(x).contiguous()
    args = (x2.bfloat16(), qm._block_sums(x2, w.sub_size), w.codes, w.d, w.sc,
            w.dmin, w.mn, w.code_bias)
    before = _build.LAUNCHES.get(qm.NAME_4BIT, 0)
    got = qm.quant_matmul_4bit(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[qm.NAME_4BIT] == before + 1
    _close(got, qm.quant_matmul_4bit_plain(*args), 1e-4)


def _lowbit_arrays(bits, out_f, in_f, sub, bias, layout, signed, g):
    """Random codes and scale/min arrays of one layout: flat (f32 per
    sub-block), compact (f32 per 256 times 8-bit per sub-block) or mixed
    (flat scale, compact min)."""
    nsub, nd = in_f // sub, in_f // 256
    codes = torch.randint(0, 256, (out_f, in_f * bits // 8), generator=g, dtype=torch.uint8)

    def f32(n):
        return torch.rand(out_f, n, generator=g) * 0.02 + 1e-3

    def u8():
        lo = -32 if signed else 0
        return torch.randint(lo, lo + 64, (out_f, nsub), generator=g,
                             dtype=torch.int32).to(torch.int8 if signed else torch.uint8)

    if layout == "flat":
        return codes, f32(nsub), None, f32(nsub), None
    if layout == "compact":
        return codes, f32(nd), u8(), f32(nd), u8()
    return codes, f32(nsub), None, f32(nd), u8()


LOWBIT = {2: (qm.quant_matmul_2bit, qm.quant_matmul_2bit_plain, qm.NAME_2BIT),
          4: (qm.quant_matmul_4bit, qm.quant_matmul_4bit_plain, qm.NAME_4BIT)}


@pytest.mark.parametrize("B", [1, 5, 17])
@pytest.mark.parametrize("bits,sub,bias,signed", [
    (2, 16, 0, False), (2, 32, 1, False), (2, 8, 1, True),
    (4, 32, 0, False), (4, 16, 4, True), (4, 16, 1, False)])
@pytest.mark.parametrize("layout", ["flat", "compact", "mixed"])
def test_quant_matmul_lowbit_kernel_layouts(dev, B, bits, sub, bias, signed, layout):
    """Every scale/min layout at sub-block sizes 8, 16 and 32, code bias 0,
    1 and 4, u8 and i8 sub-block factors, ragged row counts (the mixed
    layout takes no bias)."""
    if layout == "mixed" and bias:
        bias = 0
    g = torch.Generator().manual_seed(B + sub + bits)
    out_f, in_f = 68, 1024
    codes, d, sc, dmin, mn = _lowbit_arrays(bits, out_f, in_f, sub, bias, layout, signed, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xsum = torch.randn(B, in_f // sub, generator=g)
    args = [t if t is None else t.to(dev) for t in (x, xsum, codes, d, sc, dmin, mn)]
    kernel, plain, name = LOWBIT[bits]
    before = _build.LAUNCHES.get(name, 0)
    got = kernel(*args, bias)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    _close(got, plain(*args, bias), 1e-4)
    # and without the min side
    if layout != "mixed":
        got = kernel(*args[:5], None, None, bias)
        torch.cuda.synchronize()
        _close(got, plain(*args[:5], None, None, bias), 1e-4)


@pytest.mark.parametrize("gtype", [GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("layout", ["auto", "compact", "mixed"])
def test_quant_matmul_repacked_layouts(dev, gtype, layout, monkeypatch):
    """Repacked weights through the dispatcher on the card (the mixed
    layout's block-sum permutation included) against the CPU's plain path
    over the same arrays."""
    monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
    w = _weight(gtype, 200, 1024, 3, dev)
    x = torch.randn(7, 1024, generator=torch.Generator().manual_seed(3))
    got = w.matmul(x.to(dev).bfloat16(), out_dtype=torch.float32)
    torch.cuda.synchronize()
    w_cpu = type(w)(**{f: (getattr(w, f).cpu() if isinstance(getattr(w, f), torch.Tensor)
                           else getattr(w, f)) for f in w.__dataclass_fields__})
    want = w_cpu.matmul(x.bfloat16(), out_dtype=torch.float32)
    _close(got.cpu(), want, 1e-4)


@pytest.mark.parametrize("B", [1, 3, 17])
@pytest.mark.parametrize("gtype", [GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_quant_matmul_8bit_kernel(dev, B, gtype):
    w = _weight(gtype, 260, 512, B, dev)
    x = torch.randn(B, 512, generator=torch.Generator().manual_seed(B)).to(dev)
    x2 = w.permute_activations(x).contiguous().bfloat16()
    args = (x2, w.codes, w.d, w.sc, w.sub_size, w.code_bias)
    got = qm.quant_matmul_8bit(*args)
    torch.cuda.synchronize()
    _close(got, qm.quant_matmul_8bit_plain(*args), 1e-4)


def test_quant_matmul_rejects_bad_input(dev):
    w = _weight(GGMLType.Q4_K, 128, 256, 0, dev)
    x = torch.zeros(2, 256, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        qm.quant_matmul_4bit(x, torch.zeros(2, 8, device=dev), w.codes, w.d, None,
                             w.dmin, None)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("T,group", [(1, 4), (7, 1), (33, 4)])
def test_flash_attention_kernel(dev, D, T, group):
    g = torch.Generator().manual_seed(D + T)
    B, KVH, S = 3, 2, 300
    q = torch.randn(B, T, KVH * group, D, generator=g).bfloat16().to(dev)
    k = torch.randn(B, KVH, S, D, generator=g).bfloat16().to(dev)
    v = torch.randn(B, KVH, S, D, generator=g).bfloat16().to(dev)
    offsets = torch.tensor([0, 150, S - T], dtype=torch.int32, device=dev)
    got = flash_attention(q, k, v, offsets)
    torch.cuda.synchronize()
    _close(got, flash_attention_plain(q, k, v, offsets), 2 * 2 ** -8)


def _codes(kind, shape, g):
    """Random cache codes of one kind: (codes, scales, minimums or None)."""
    B, KVH, S, D = shape
    s = torch.rand(B, KVH, S, generator=g) * 0.05 + 1e-3
    if kind == "q8":
        c = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        return c, s, None
    c = torch.randint(0, 256, (B, KVH, S, D // 2), generator=g, dtype=torch.uint8)
    m = -torch.rand(B, KVH, S, generator=g) * 0.4 if kind == "q41" else None
    return c, s, m


QUANT = {"q8": (fa.flash_attention_q8, fa.flash_attention_q8_plain),
         "q4": (fa.flash_attention_q4, fa.flash_attention_q4_plain),
         "q41": (fa.flash_attention_q41, fa.flash_attention_q41_plain)}


@pytest.mark.parametrize("kind", sorted(QUANT))
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("T,group", [(1, 4), (7, 1), (33, 4)])
def test_flash_attention_quant_kernel(dev, kind, D, T, group):
    g = torch.Generator().manual_seed(D + T)
    B, KVH, S = 3, 2, 300
    q = torch.randn(B, T, KVH * group, D, generator=g).bfloat16()
    kc, ks, km = _codes(kind, (B, KVH, S, D), g)
    vc, vs, vm = _codes(kind, (B, KVH, S, D), g)
    args = [q, kc, ks, vc, vs] if km is None else [q, kc, ks, km, vc, vs, vm]
    args = [a.to(dev) for a in args] + [
        torch.tensor([0, 150, S - T], dtype=torch.int32, device=dev)]
    kernel, plain = QUANT[kind]
    before = _build.LAUNCHES.get("flash_attention_" + kind, 0)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_" + kind] == before + 1
    _close(got, plain(*args), 2 * 2 ** -8)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T,page_s", [(1, 64), (1, 100), (20, 48)])
def test_flash_attention_paged_kernel(dev, quant, D, T, page_s):
    """Shuffled pool pages, a tile straddling page boundaries, and an idle
    slot whose table row is all -1 (it reads page 0, never out of bounds)."""
    g = torch.Generator().manual_seed(D + T + page_s)
    B, KVH, H, NP = 3, 2, 8, 6
    P = B * NP
    q = torch.randn(B, T, H, D, generator=g).bfloat16()
    table = torch.randperm(P, generator=g).reshape(B, NP).int()
    table[1, 4:] = -1                       # slot 1 reserved 4 pages
    table[2] = -1                           # slot 2 idle
    offsets = torch.tensor([NP * page_s - T, 4 * page_s - T - 3, 0], dtype=torch.int32)
    if quant:
        kc, ks, _ = _codes("q8", (P, KVH, page_s, D), g)
        vc, vs, _ = _codes("q8", (P, KVH, page_s, D), g)
        args = [q, kc, ks, vc, vs, offsets, table]
        kernel, plain = fa.flash_attention_paged_q8, fa.flash_attention_paged_q8_plain
    else:
        k = torch.randn(P, KVH, page_s, D, generator=g).bfloat16()
        v = torch.randn(P, KVH, page_s, D, generator=g).bfloat16()
        args = [q, k, v, offsets, table]
        kernel, plain = fa.flash_attention_paged, fa.flash_attention_paged_plain
    args = [a.to(dev) for a in args]
    got = kernel(*args)
    torch.cuda.synchronize()
    _close(got, plain(*args), 2 * 2 ** -8)


def test_flash_attention_rejects_head_dim(dev):
    q = torch.zeros(1, 1, 2, 96, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 2, 128, 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, k, k, torch.zeros(1, dtype=torch.int32, device=dev))
