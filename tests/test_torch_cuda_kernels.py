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
    layout takes no bias), through the decode kernel (from
    LOWBIT_TC_MIN_ROWS rows the dispatching wrapper would take the
    tensor-core one for some of these geometries)."""
    if layout == "mixed" and bias:
        bias = 0
    g = torch.Generator().manual_seed(B + sub + bits)
    out_f, in_f = 68, 1024
    codes, d, sc, dmin, mn = _lowbit_arrays(bits, out_f, in_f, sub, bias, layout, signed, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xsum = torch.randn(B, in_f // sub, generator=g)
    args = [t if t is None else t.to(dev) for t in (x, xsum, codes, d, sc, dmin, mn)]
    _, plain, name = LOWBIT[bits]
    kernel = getattr(qm, f"quant_matmul_{bits}bit_decode")
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


VARIANT_WRAPPERS = {
    "xsum": (qm.quant_matmul_4bit_xsum_decode, qm.quant_matmul_4bit_xsum_plain,
             qm.NAME_4BIT_XSUM),
    "split": (qm.quant_matmul_4bit_split_decode, qm.quant_matmul_4bit_split_plain,
              qm.NAME_4BIT_SPLIT)}


@pytest.mark.parametrize("B", [1, 5, 17])
@pytest.mark.parametrize("sub,bias,signed", [(32, 0, False), (16, 4, True), (32, 8, False)])
@pytest.mark.parametrize("var,layout", [
    (v, lay) for v in ("xsum", "split", "base", "int8") for lay in ("flat", "compact", "mixed")
    if lay != "mixed" or v in ("xsum", "split")])
def test_quant_matmul_4bit_variant_kernels(dev, var, layout, sub, bias, signed, B):
    """The xsum, split, base and int8 kernels in every layout each takes
    (base and int8 take no mixed layout, which the JAX dispatcher sends to
    its dequantize path; mixed takes no code bias), with and without the
    min side. Every body through its decode wrapper: from 8 or 16 rows the
    dispatching ones take the tensor-core kernels for some of these
    geometries."""
    if layout == "mixed":
        bias = 0
    g = torch.Generator().manual_seed(B + sub + bias)
    out_f, in_f = 68, 1024
    codes, d, sc, dmin, mn = _lowbit_arrays(4, out_f, in_f, sub, bias, layout, signed, g)
    x = torch.randn(B, in_f, generator=g)
    xsum = qm._block_sums(x, sub)
    xq, xs = qm.quantize_acts(x, sub)
    mins = [(dmin, mn)] if layout == "mixed" else [(dmin, mn), (None, None)]
    for dm, m in mins:
        w = [t if t is None else t.to(dev) for t in (codes, d, sc, dm, m)]
        if var == "base":
            kernel, plain, name = qm.quant_matmul_4bit_base_decode, \
                qm.quant_matmul_4bit_base_plain, qm.NAME_4BIT_BASE
            args = pargs = (x.bfloat16().to(dev), *w, bias)
        elif var == "int8":
            kernel, plain, name = qm.quant_matmul_4bit_int8_decode, \
                qm.quant_matmul_4bit_int8_plain, qm.NAME_4BIT_INT8
            args = pargs = (xq.to(dev), xs.to(dev), xsum.to(dev), *w, bias)
        else:
            kernel, plain, name = VARIANT_WRAPPERS[var]
            args = pargs = (x.bfloat16().to(dev), xsum.to(dev), *w, bias)
        before = _build.LAUNCHES.get(name, 0)
        got = kernel(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[name] == before + 1
        _close(got, plain(*pargs), 1e-4)


@pytest.mark.parametrize("fmt", ["iq2_xs", "iq3_s"])
@pytest.mark.parametrize("layout", ["flat", "compact"])
@pytest.mark.parametrize("B", [1, 7])
def test_quant_matmul_mapped_code_kernels(dev, fmt, layout, B):
    """IQ2/IQ3 4-bit codes through the fsplit kernel's value map and the
    base body's f32 branch."""
    g = torch.Generator().manual_seed(B)
    codes, d, sc, _, _ = _lowbit_arrays(4, 40, 512, 32, 0, layout, False, g)
    x = torch.randn(B, 512, generator=g).bfloat16()
    w = [t if t is None else t.to(dev) for t in (codes, d, sc)]
    xsum = qm._block_sums(x.float(), 32).to(dev)
    x = x.to(dev)
    got = qm.quant_matmul_4bit(x, xsum, *w, None, None, 0, fmt)
    _close(got, qm.quant_matmul_4bit_plain(x, xsum, *w, None, None, 0, fmt), 1e-4)
    got = qm.quant_matmul_lowbit_base(x, *w, None, None, 0, 4, fmt)
    torch.cuda.synchronize()
    _close(got, qm.quant_matmul_lowbit_base_plain(x, *w, None, None, 0, 4, fmt), 1e-4)


@pytest.mark.parametrize("B", [1, 5, 17])
@pytest.mark.parametrize("sub,bias,signed", [(16, 0, False), (32, 1, False), (8, 1, True)])
@pytest.mark.parametrize("layout", ["flat", "compact"])
def test_quant_matmul_2bit_base_kernel(dev, layout, sub, bias, signed, B):
    """The base body's 2-bit decode kernel (from 16 rows the dispatching
    wrapper takes the tensor-core kernel for some of these geometries)."""
    g = torch.Generator().manual_seed(B + sub)
    codes, d, sc, dmin, mn = _lowbit_arrays(2, 68, 1024, sub, bias, layout, signed, g)
    x = torch.randn(B, 1024, generator=g).bfloat16().to(dev)
    for dm, m in ((dmin, mn), (None, None)):
        w = [t if t is None else t.to(dev) for t in (codes, d, sc, dm, m)]
        before = _build.LAUNCHES.get(qm.NAME_LOWBIT_BASE, 0)
        got = qm.quant_matmul_lowbit_base_decode(x, *w, bias, 2)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[qm.NAME_LOWBIT_BASE] == before + 1
        _close(got, qm.quant_matmul_lowbit_base_plain(x, *w, bias, 2), 1e-4)


@pytest.mark.parametrize("B", [1, 3, 17])
@pytest.mark.parametrize("gtype,layout", [
    (GGMLType.Q5_K, "auto"), (GGMLType.Q5_K, "flat"), (GGMLType.Q5_1, "auto"),
    (GGMLType.IQ4_XS, "auto"), (GGMLType.Q5_0, "auto")], ids=str)
def test_quant_matmul_8bit_min_kernel(dev, gtype, layout, B, monkeypatch):
    """The 8-bit kernel over the new formats: Q5_K with u8 sc and mn
    (compact) or flat f32 sides, Q5_1's flat min, IQ4_XS's i8 sc."""
    monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
    w = _weight(gtype, 260, 512, B, dev)
    x = torch.randn(B, 512, generator=torch.Generator().manual_seed(B)).to(dev)
    x2 = w.permute_activations(x).contiguous().bfloat16()
    args = (x2, w.codes, w.d, w.sc, w.sub_size, w.code_bias, w.dmin, w.mn)
    name = qm.NAME_8BIT if w.dmin is None else qm.NAME_8BIT_MIN
    before = _build.LAUNCHES.get(name, 0)
    got = qm.quant_matmul_8bit(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    _close(got, qm.quant_matmul_8bit_plain(*args), 1e-4)


def _8bit_arrays(out_f, in_f, sub, layout, has_min, signed, g):
    """8-bit codes with flat sides (f32 per sub-block) or compact ones (f32
    per 256 times an 8-bit factor per sub-block; the min side's factor u8)."""
    nsub, nd = in_f // sub, in_f // 256
    codes = torch.randint(-128, 128, (out_f, in_f), generator=g, dtype=torch.int32).to(torch.int8)

    def f32(n):
        return torch.rand(out_f, n, generator=g) * 0.02 + 1e-3

    def u8(signed_):
        lo = -32 if signed_ else 0
        return torch.randint(lo, lo + 64, (out_f, nsub), generator=g,
                             dtype=torch.int32).to(torch.int8 if signed_ else torch.uint8)
    if layout == "flat":
        return codes, f32(nsub), None, (f32(nsub) if has_min else None), None
    return codes, f32(nd), u8(signed), (f32(nd) if has_min else None), \
        (u8(False) if has_min else None)


# the 8B's projections (out, in) and the decode kernel's formats there:
# (layout, has min, signed sc, sub) of Q5_K compact and flat, Q6_K compact,
# Q8_0 flat
SHAPES_8B = {"qkv": (6144, 4096), "o": (4096, 4096), "gate_up": (28672, 4096),
             "down": (4096, 14336), "head": (128256, 4096)}
FORMATS_8BIT = {"q5_k": ("compact", True, False, 32), "q5_k_flat": ("flat", True, False, 32),
                "q6_k": ("compact", False, True, 16), "q8_0": ("flat", False, False, 32)}
_FULL = {}


def _full_weight(fmt, shape, dev):
    """One 8B-shaped weight at a time, kept while the tests that share it
    run (B varies fastest)."""
    key = (fmt, shape)
    if key not in _FULL:
        _FULL.clear()
        torch.cuda.empty_cache()
        layout, has_min, signed, sub = FORMATS_8BIT[fmt]
        out_f, in_f = SHAPES_8B[shape]
        g = torch.Generator(device=dev).manual_seed(out_f + in_f + sub)
        nsub, nd = in_f // sub, in_f // 256
        codes = torch.randint(-128, 128, (out_f, in_f), generator=g, device=dev,
                              dtype=torch.int8)

        def f32(n):
            return torch.rand(out_f, n, generator=g, device=dev) * 0.02 + 1e-3

        def u8(signed_):
            lo = -32 if signed_ else 0
            return torch.randint(lo, lo + 64, (out_f, nsub), generator=g, device=dev,
                                 dtype=torch.int32).to(torch.int8 if signed_ else torch.uint8)
        if layout == "flat":
            arrs = (codes, f32(nsub), None, f32(nsub) if has_min else None, None)
        else:
            arrs = (codes, f32(nd), u8(signed), f32(nd) if has_min else None,
                    u8(False) if has_min else None)
        _FULL[key] = (arrs, sub)
    return _FULL[key]


def _decode_check(dev, fmt, shape, B, fn):
    (codes, d, sc, dmin, mn), sub = _full_weight(fmt, shape, dev)
    in_f = codes.shape[1]
    x = torch.randn(B, in_f, generator=torch.Generator().manual_seed(B)).bfloat16().to(dev)
    args = (x, codes, d, sc, sub, 0, dmin, mn)
    name = qm.NAME_8BIT if dmin is None else qm.NAME_8BIT_MIN
    before = _build.LAUNCHES.get(name, 0)
    got = fn(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    _close(got, qm.quant_matmul_8bit_plain(*args), 1e-4)


@pytest.mark.parametrize("B", range(1, qm.TC_MIN_ROWS))
@pytest.mark.parametrize("shape", SHAPES_8B)
@pytest.mark.parametrize("fmt", FORMATS_8BIT)
def test_quant_matmul_8bit_decode_8b_shapes(dev, fmt, shape, B):
    """The 8-bit decode kernel at every 8B projection and the head, for the
    decode rows the dispatcher sends it (B < TC_MIN_ROWS), through the
    dispatching wrapper."""
    _decode_check(dev, fmt, shape, B, qm.quant_matmul_8bit)


@pytest.mark.parametrize("B", [8, 16, 300])
@pytest.mark.parametrize("shape", SHAPES_8B)
@pytest.mark.parametrize("fmt", FORMATS_8BIT)
def test_quant_matmul_8bit_decode_any_rows(dev, fmt, shape, B):
    """The decode kernel called directly at row counts the dispatcher gives
    the tensor-core kernel: it takes any B, in tiles of 8 rows."""
    _decode_check(dev, fmt, shape, B, qm.quant_matmul_8bit_decode)


# every (scale side, min side) instance: (layout, has min, signed sc, sub, bias)
TC_SIDES = [("flat", False, False, 32, 0), ("flat", True, False, 32, 16),
            ("compact", False, False, 32, 4), ("compact", True, False, 32, 0),
            ("compact", False, True, 16, 0), ("compact", True, True, 16, 0)]


@pytest.mark.parametrize("B", sorted({qm.TC_MIN_ROWS, qm.TC_MIN_ROWS + 1, 64, 65, 129, 300, 512}))
@pytest.mark.parametrize("layout,has_min,signed,sub,bias", TC_SIDES, ids=str)
def test_quant_matmul_8bit_tc_kernel(dev, layout, has_min, signed, sub, bias, B):
    """The tensor-core 8-bit kernel against the plain version: every side
    instance, ragged rows (64 and 65 either side of the 64-row activation
    tile), an out (200) that is no multiple of the 128-row tile; through the
    dispatching wrapper, which launches it from TC_MIN_ROWS rows up."""
    g = torch.Generator().manual_seed(B + sub + bias + has_min)
    out_f, in_f = 200, 2048
    arrs = [t if t is None else t.to(dev)
            for t in _8bit_arrays(out_f, in_f, sub, layout, has_min, signed, g)]
    x = torch.randn(B, in_f, generator=g).bfloat16().to(dev)
    codes, d, sc, dmin, mn = arrs
    args = (x, codes, d, sc, sub, bias, dmin, mn)
    name = qm.NAME_8BIT_MIN_TC if has_min else qm.NAME_8BIT_TC
    before = _build.LAUNCHES.get(name, 0)
    got = qm.quant_matmul_8bit(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    _close(got, qm.quant_matmul_8bit_plain(*args), 1e-4)


@pytest.mark.parametrize("B", [qm.TC_MIN_ROWS, 300])
@pytest.mark.parametrize("layout", ["compact", "flat"])
def test_quant_matmul_8bit_tc_kernel_down(dev, layout, B):
    """in = 14336 (ffn_down of the 8B): 448 sub-blocks of 32, 56 super-blocks,
    so a thread's 32 sub-blocks wrap the super-block index."""
    g = torch.Generator().manual_seed(B)
    out_f, in_f = 136, 14336
    codes, d, sc, dmin, mn = [t if t is None else t.to(dev)
                              for t in _8bit_arrays(out_f, in_f, 32, layout, True, False, g)]
    x = torch.randn(B, in_f, generator=g).bfloat16().to(dev)
    args = (x, codes, d, sc, 32, 0, dmin, mn)
    before = _build.LAUNCHES.get(qm.NAME_8BIT_MIN_TC, 0)
    got = qm.quant_matmul_8bit_tc(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[qm.NAME_8BIT_MIN_TC] == before + 1
    _close(got, qm.quant_matmul_8bit_plain(*args), 1e-4)


def test_quant_matmul_8bit_dispatch_by_rows(dev):
    """Below TC_MIN_ROWS the decode kernel runs, from it up the tensor-core
    one; a geometry the tensor-core kernel does not take (in/sub not a
    multiple of 64) keeps the decode kernel at any row count."""
    g = torch.Generator().manual_seed(7)
    for in_f, B, want in ((2048, qm.TC_MIN_ROWS - 1, qm.NAME_8BIT_MIN),
                          (2048, qm.TC_MIN_ROWS, qm.NAME_8BIT_MIN_TC),
                          (2048, qm.TC_MIN_ROWS + 1, qm.NAME_8BIT_MIN_TC),
                          (1536, 300, qm.NAME_8BIT_MIN)):
        codes, d, sc, dmin, mn = [t if t is None else t.to(dev)
                                  for t in _8bit_arrays(72, in_f, 32, "compact", True, False, g)]
        x = torch.randn(B, in_f, generator=g).bfloat16().to(dev)
        args = (x, codes, d, sc, 32, 0, dmin, mn)
        _build.reset_launches()
        got = qm.quant_matmul_8bit(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {want: 1}
        _close(got, qm.quant_matmul_8bit_plain(*args), 1e-4)


def test_quant_matmul_8bit_tc_rejects_geometry(dev):
    """The tensor-core wrapper raises on in % 64 != 0, and on in/sub not a
    multiple of 64, before any launch."""
    g = torch.Generator().manual_seed(3)
    for in_f in (1040, 1536):
        codes, d, sc, dmin, mn = [t if t is None else t.to(dev)
                                  for t in _8bit_arrays(64, in_f, 16 if in_f == 1040 else 32,
                                                        "flat", False, False, g)]
        x = torch.zeros(64, in_f, device=dev).bfloat16()
        with pytest.raises(ValueError, match="tensor-core"):
            qm.quant_matmul_8bit_tc(x, codes, d, sc, 16 if in_f == 1040 else 32, 0)


# (bits, sub, bias, layout, signed sc, code map) of the 2/4-bit tensor-core
# kernel: Q4_K flat/compact/mixed, Q3_K's sub-blocks of 16 and bias 4
# (compact with i8 sc, flat), the IQ2/IQ3 maps, Q2_K flat/compact/mixed and a
# bias beside an i8 compact scale
LOWBIT_TC = [(4, 32, 0, "flat", False, ""), (4, 32, 0, "compact", False, ""),
             (4, 32, 0, "mixed", False, ""), (4, 16, 4, "compact", True, ""),
             (4, 16, 4, "flat", False, ""), (4, 32, 0, "flat", False, "iq2_xs"),
             (4, 32, 0, "compact", False, "iq3_s"), (2, 16, 0, "flat", False, ""),
             (2, 16, 0, "compact", False, ""), (2, 16, 0, "mixed", False, ""),
             (2, 16, 1, "compact", True, "")]


def _lowbit_tc_call(dev, bits, B, out_f, in_f, sub, bias, layout, signed, fmt, g):
    """Arguments of one 2/4-bit call on the card (no min side for the code
    maps; xsum in the mixed layout's min order)."""
    codes, d, sc, dmin, mn = _lowbit_arrays(bits, out_f, in_f, sub, bias, layout, signed, g)
    if fmt:
        dmin = mn = None
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xsum = qm._block_sums(x, sub)
    if layout == "mixed":
        xsum = xsum.reshape(B, in_f // 256, 256 // sub).transpose(1, 2).reshape(B, -1)
    return [t if t is None else t.contiguous().to(dev)
            for t in (x, xsum, codes, d, sc, dmin, mn)] + [bias, fmt]


@pytest.mark.parametrize("B", [qm.LOWBIT_TC_MIN_ROWS, 65, 129, 300, 512])
@pytest.mark.parametrize("bits,sub,bias,layout,signed,fmt", LOWBIT_TC, ids=str)
def test_quant_matmul_lowbit_tc_kernel(dev, bits, sub, bias, layout, signed, fmt, B):
    """The tensor-core 2/4-bit kernel against the plain version: every layout,
    bias and map of the served formats, ragged rows, an out (200) that is no
    multiple of the 128-row tile, nsub 64 and 128; through the dispatching
    wrapper, which launches it from LOWBIT_TC_MIN_ROWS rows up; a compact
    case once more without its min side."""
    g = torch.Generator().manual_seed(B + sub + bias + bits)
    args = _lowbit_tc_call(dev, bits, B, 200, 2048, sub, bias, layout, signed, fmt, g)
    kernel, plain, _ = LOWBIT[bits]
    name = qm.NAME_4BIT_TC if bits == 4 else qm.NAME_2BIT_TC
    runs = [args] + ([args[:5] + [None, None] + args[7:]]
                     if layout == "compact" and not fmt else [])
    for a in runs:
        before = _build.LAUNCHES.get(name, 0)
        got = kernel(*a)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[name] == before + 1
        _close(got, plain(*a), 1e-4)


@pytest.mark.parametrize("B", [qm.LOWBIT_TC_MIN_ROWS, 300])
@pytest.mark.parametrize("bits,layout", [(4, "compact"), (4, "mixed"), (2, "mixed")])
def test_quant_matmul_lowbit_tc_kernel_down(dev, bits, layout, B):
    """in = 14336 (ffn_down of the 8B): 448 (or 896) sub-blocks, 56
    super-blocks, so a thread's run of scales wraps the super-block index."""
    g = torch.Generator().manual_seed(B + bits)
    sub = 32 if bits == 4 else 16
    args = _lowbit_tc_call(dev, bits, B, 136, 14336, sub, 0, layout, False, "", g)
    name = qm.NAME_4BIT_TC if bits == 4 else qm.NAME_2BIT_TC
    before = _build.LAUNCHES.get(name, 0)
    got = getattr(qm, f"quant_matmul_{bits}bit_tc")(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    _close(got, LOWBIT[bits][1](*args), 1e-4)


@pytest.mark.parametrize("bits", [2, 4])
def test_quant_matmul_lowbit_dispatch_by_rows(dev, bits):
    """Below LOWBIT_TC_MIN_ROWS the decode kernel runs, from it up the
    tensor-core one and no decode kernel; a geometry the tensor-core kernel
    does not take (nsub 48) keeps the decode kernel at any row count."""
    g = torch.Generator().manual_seed(bits)
    sub = 32 if bits == 4 else 16
    tc, dec = (qm.NAME_4BIT_TC, qm.NAME_4BIT) if bits == 4 else (qm.NAME_2BIT_TC, qm.NAME_2BIT)
    for in_f, B, want in ((64 * sub, qm.LOWBIT_TC_MIN_ROWS - 1, dec),
                          (64 * sub, qm.LOWBIT_TC_MIN_ROWS, tc), (64 * sub, 512, tc),
                          (48 * sub, 300, dec)):
        args = _lowbit_tc_call(dev, bits, B, 72, in_f, sub, 0, "flat", False, "", g)
        _build.reset_launches()
        got = LOWBIT[bits][0](*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {want: 1}
        _close(got, LOWBIT[bits][1](*args), 1e-4)


def test_quant_matmul_lowbit_tc_rejects_geometry(dev):
    """The tensor-core 2/4-bit wrappers raise on a geometry they do not take
    (nsub 48), before any launch."""
    g = torch.Generator().manual_seed(5)
    for bits, sub in ((4, 32), (2, 16)):
        args = _lowbit_tc_call(dev, bits, 64, 64, 48 * sub, sub, 0, "flat", False, "", g)
        with pytest.raises(ValueError, match="tensor-core"):
            getattr(qm, f"quant_matmul_{bits}bit_tc")(*args)


# (rule, bits, sub, bias, layout, signed sc, code map) of the base rules on
# the tensor-core kernel: base at Q4_K (flat, compact), Q4_0's bias 8, Q4_1
# (flat min), Q3_K (sub 16, bias 4, compact i8 sc and flat); base_f32 at Q2_K
# (flat, compact) and the IQ2/IQ3 maps
BASE_TC = [("base", 4, 32, 0, "flat", False, ""), ("base", 4, 32, 0, "compact", False, ""),
           ("base", 4, 32, 8, "flat", False, ""), ("base", 4, 16, 4, "compact", True, ""),
           ("base", 4, 16, 4, "flat", False, ""), ("base_f32", 2, 16, 0, "flat", False, ""),
           ("base_f32", 2, 16, 0, "compact", False, ""),
           ("base_f32", 4, 32, 0, "flat", False, "iq2_xs"),
           ("base_f32", 4, 32, 0, "compact", False, "iq3_s")]


def _base_call(dev, rule, bits, B, out_f, in_f, sub, bias, layout, signed, fmt, g, has_min):
    """(tc wrapper, dispatching wrapper, plain version, launch names, args)
    of one base-rule call on the card."""
    codes, d, sc, dmin, mn = _lowbit_arrays(bits, out_f, in_f, sub, bias, layout, signed, g)
    if fmt or not has_min:
        dmin = mn = None
    x = torch.randn(B, in_f, generator=g).bfloat16()
    args = [t if t is None else t.contiguous().to(dev) for t in (x, codes, d, sc, dmin, mn)]
    if rule == "base":
        return (qm.quant_matmul_4bit_base_tc, qm.quant_matmul_4bit_base,
                qm.quant_matmul_4bit_base_plain, (qm.NAME_4BIT_BASE_TC, qm.NAME_4BIT_BASE),
                args + [bias])
    return (qm.quant_matmul_lowbit_base_tc, qm.quant_matmul_lowbit_base,
            qm.quant_matmul_lowbit_base_plain, (qm.NAME_LOWBIT_BASE_TC, qm.NAME_LOWBIT_BASE),
            args + [bias, bits, fmt])


@pytest.mark.parametrize("B", [16, 64, 512])
@pytest.mark.parametrize("rule,bits,sub,bias,layout,signed,fmt", BASE_TC, ids=str)
def test_quant_matmul_base_tc_kernel(dev, rule, bits, sub, bias, layout, signed, fmt, B):
    """The base and base_f32 rules of the tensor-core 2/4-bit kernel against
    their plain versions, in = 4096 (the 8B's width), out 200 (no multiple
    of the 64-row tile), with and without the min side."""
    g = torch.Generator().manual_seed(B + sub + bias + bits + len(fmt))
    for has_min in ((True, False) if not fmt and bias in (0, 1) else (False,)):
        tc, _, plain, (name, _), args = _base_call(dev, rule, bits, B, 200, 4096, sub, bias,
                                                   layout, signed, fmt, g, has_min)
        before = _build.LAUNCHES.get(name, 0)
        got = tc(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[name] == before + 1
        _close(got, plain(*args), 1e-4)


@pytest.mark.parametrize("B", [16, 512])
@pytest.mark.parametrize("rule,bits,sub", [("base", 4, 32), ("base_f32", 2, 16)])
def test_quant_matmul_base_tc_kernel_down(dev, rule, bits, sub, B):
    """in = 14336 (ffn_down of the 8B), compact: the scale runs wrap the 56
    super-blocks."""
    g = torch.Generator().manual_seed(B + bits)
    tc, _, plain, (name, _), args = _base_call(dev, rule, bits, B, 136, 14336, sub, 0,
                                               "compact", False, "", g, True)
    got = tc(*args)
    torch.cuda.synchronize()
    _close(got, plain(*args), 1e-4)


@pytest.mark.parametrize("rule", ["base", "base_f32"])
def test_quant_matmul_base_dispatch_by_rows(dev, rule):
    """Below LOWBIT_TC_MIN_ROWS the decode kernel, from it the tensor-core one;
    nsub 48 keeps the decode kernel at any row count; the tensor-core wrapper
    raises on it."""
    g = torch.Generator().manual_seed(len(rule))
    bits, sub = (4, 32) if rule == "base" else (2, 16)
    for in_f, B, tc_runs in ((64 * sub, qm.LOWBIT_TC_MIN_ROWS - 1, False),
                             (64 * sub, qm.LOWBIT_TC_MIN_ROWS, True), (64 * sub, 512, True),
                             (48 * sub, 300, False)):
        tc, wrapper, plain, names, args = _base_call(dev, rule, bits, B, 72, in_f, sub, 0,
                                                     "flat", False, "", g, True)
        _build.reset_launches()
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {names[0] if tc_runs else names[1]: 1}
        _close(got, plain(*args), 1e-4)
    with pytest.raises(ValueError, match="tensor-core"):
        tc(*args)


# (sub, bias, layout, signed sc, has min) of the int8 tensor-core kernel:
# Q4_K flat and compact (u8 and i8 sc), Q4_0's bias 8, Q4_1's flat min, Q3_K
# (sub 16, bias 4; compact i8 sc and flat)
INT8_TC = [(32, 0, "flat", False, True), (32, 0, "compact", False, True),
           (32, 0, "compact", True, True), (32, 8, "flat", False, False),
           (32, 0, "flat", False, False), (16, 4, "compact", True, False),
           (16, 4, "flat", False, False)]


def _int8_call(dev, B, out_f, in_f, sub, bias, layout, signed, has_min, g):
    codes, d, sc, dmin, mn = _lowbit_arrays(4, out_f, in_f, sub, bias, layout, signed, g)
    if not has_min:
        dmin = mn = None
    x = torch.randn(B, in_f, generator=g)
    xq, xs = qm.quantize_acts(x, sub)
    return [t if t is None else t.contiguous().to(dev)
            for t in (xq, xs, qm._block_sums(x, sub), codes, d, sc, dmin, mn)] + [bias]


# 16 and 24 rows, INT8_TC_MIN_ROWS and its neighbours (64-row activation
# tiles), 64 and 512 (128-row tiles)
INT8_TC_ROWS = sorted({16, 24, qm.INT8_TC_MIN_ROWS - 1, qm.INT8_TC_MIN_ROWS,
                       qm.INT8_TC_MIN_ROWS + 1, 64, 512})


@pytest.mark.parametrize("B", INT8_TC_ROWS)
@pytest.mark.parametrize("sub,bias,layout,signed,has_min", INT8_TC, ids=str)
def test_quant_matmul_int8_tc_kernel(dev, sub, bias, layout, signed, has_min, B):
    """The tensor-core int8 kernel against the plain version of
    _make_kernel_int8, in = 4096, out 200 (no multiple of the 128-row
    tile)."""
    g = torch.Generator().manual_seed(B + sub + bias + has_min)
    args = _int8_call(dev, B, 200, 4096, sub, bias, layout, signed, has_min, g)
    before = _build.LAUNCHES.get(qm.NAME_4BIT_INT8_TC, 0)
    got = qm.quant_matmul_4bit_int8_tc(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[qm.NAME_4BIT_INT8_TC] == before + 1
    _close(got, qm.quant_matmul_4bit_int8_plain(*args), 1e-4)


@pytest.mark.parametrize("B", [16, 512])
@pytest.mark.parametrize("layout", ["flat", "compact"])
def test_quant_matmul_int8_tc_kernel_down(dev, layout, B):
    """in = 14336 (ffn_down of the 8B): 448 sub-blocks, 28 groups, 56
    super-blocks, so the scale runs wrap the super-block index."""
    g = torch.Generator().manual_seed(B)
    args = _int8_call(dev, B, 136, 14336, 32, 0, layout, False, True, g)
    got = qm.quant_matmul_4bit_int8_tc(*args)
    torch.cuda.synchronize()
    _close(got, qm.quant_matmul_4bit_int8_plain(*args), 1e-4)


def test_quant_matmul_int8_dispatch_by_rows(dev):
    """Below INT8_TC_MIN_ROWS the decode kernel, from it the tensor-core
    one; nsub 40 (no whole group of 16) keeps the decode kernel at any row
    count, and the tensor-core wrapper raises on it."""
    g = torch.Generator().manual_seed(8)
    for nsub, B, want in ((64, qm.INT8_TC_MIN_ROWS - 1, qm.NAME_4BIT_INT8),
                          (64, qm.INT8_TC_MIN_ROWS, qm.NAME_4BIT_INT8_TC),
                          (64, 512, qm.NAME_4BIT_INT8_TC), (40, 300, qm.NAME_4BIT_INT8)):
        args = _int8_call(dev, B, 72, 32 * nsub, 32, 0, "flat", False, True, g)
        _build.reset_launches()
        got = qm.quant_matmul_4bit_int8(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {want: 1}
        _close(got, qm.quant_matmul_4bit_int8_plain(*args), 1e-4)
    with pytest.raises(ValueError, match="tensor-core"):
        qm.quant_matmul_4bit_int8_tc(*args)


# the int8 decode kernel's weights at the 8B shapes: (sub, bias, layout,
# signed sc, has min) of Q4_K flat and compact at the four projections and
# of Q4_0, Q4_1 and Q3_K at o
FORMATS_INT8 = {"q4_k": (32, 0, "flat", False, True), "q4_k_compact": (32, 0, "compact", False, True),
                "q4_0": (32, 8, "flat", False, False), "q4_1": (32, 0, "flat", False, True),
                "q3_k": (16, 4, "flat", False, False)}
INT8_8B = [(fmt, shape) for fmt in ("q4_k", "q4_k_compact") for shape in ("qkv", "o", "gate_up",
                                                                          "down")]
INT8_8B += [(fmt, "o") for fmt in ("q4_0", "q4_1", "q3_k")]
_FULL_INT8 = {}


@pytest.mark.parametrize("B", [*range(1, 8), 8, 16, 300])
@pytest.mark.parametrize("fmt,shape", INT8_8B, ids=str)
def test_quant_matmul_int8_decode_8b_shapes(dev, fmt, shape, B):
    """The int8 decode kernel at the 8B projections, through its own
    wrapper, for the decode rows and beyond (it takes any B, in tiles of 8
    rows); one weight kept while its row counts run."""
    sub, bias, layout, signed, has_min = FORMATS_INT8[fmt]
    out_f, in_f = SHAPES_8B[shape]
    if (fmt, shape) not in _FULL_INT8:
        _FULL_INT8.clear()
        torch.cuda.empty_cache()
        g = torch.Generator().manual_seed(out_f + in_f + sub)
        arrs = _lowbit_arrays(4, out_f, in_f, sub, bias, layout, signed, g)
        if not has_min:
            arrs = (*arrs[:3], None, None)
        _FULL_INT8[(fmt, shape)] = [t if t is None else t.to(dev) for t in arrs]
    g = torch.Generator().manual_seed(B)
    x = torch.randn(B, in_f, generator=g)
    xq, xs = qm.quantize_acts(x, sub)
    args = [t.to(dev) for t in (xq, xs, qm._block_sums(x, sub))] + _FULL_INT8[(fmt, shape)] + [bias]
    before = _build.LAUNCHES.get(qm.NAME_4BIT_INT8, 0)
    got = qm.quant_matmul_4bit_int8_decode(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[qm.NAME_4BIT_INT8] == before + 1
    _close(got, qm.quant_matmul_4bit_int8_plain(*args), 1e-4)


@pytest.mark.parametrize("B", [4, 512])
def test_dequant_matmul_on_the_card(dev, B):
    """The dequantize path (``matmul_xla``'s counterpart): a bf16 product
    accumulated in f32 on the card, against the CPU's f32 product of the
    same bf16 values."""
    w = _weight(GGMLType.Q4_K, 256, 1024, B, dev)
    x = torch.randn(B, 1024, generator=torch.Generator().manual_seed(B)).bfloat16()
    got = qm.dequant_matmul(w, x.to(dev), torch.float32)
    torch.cuda.synchronize()
    w_cpu = type(w)(**{f: (getattr(w, f).cpu() if isinstance(getattr(w, f), torch.Tensor)
                           else getattr(w, f)) for f in w.__dataclass_fields__})
    _close(got.cpu(), qm.dequant_matmul(w_cpu, x, torch.float32), 1e-4)


@pytest.mark.parametrize("variant", ["base", "xsum", "split", "int8", "fsplit"])
@pytest.mark.parametrize("gtype", [GGMLType.Q4_K, GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q2_K,
                                   GGMLType.Q5_K], ids=lambda t: t.name)
def test_quant_matmul_variants_on_the_card(dev, gtype, variant, monkeypatch):
    """Each LGT_MM_VARIANT through the dispatcher on the card against the
    CPU's plain path over the same arrays."""
    monkeypatch.setenv("LGT_MM_VARIANT", variant)
    w = _weight(gtype, 200, 1024, 5, dev)
    x = torch.randn(7, 1024, generator=torch.Generator().manual_seed(5))
    got = w.matmul(x.to(dev).bfloat16(), out_dtype=torch.float32)
    torch.cuda.synchronize()
    w_cpu = type(w)(**{f: (getattr(w, f).cpu() if isinstance(getattr(w, f), torch.Tensor)
                           else getattr(w, f)) for f in w.__dataclass_fields__})
    _close(got.cpu(), w_cpu.matmul(x.bfloat16(), out_dtype=torch.float32), 1e-4)


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
    # each kind takes the tensor-core kernel from FLASH_TC_MIN_ROWS positions
    tc = T >= fa.FLASH_TC_MIN_ROWS and D in fa.TC_HEAD_DIMS
    name = "flash_attention_" + kind + ("_tc" if tc else "")
    before = _build.LAUNCHES.get(name, 0)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
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


def _tc_args(kind, B, T, H, KVH, D, offsets, g, page_s=64, S=None):
    """Card inputs of a flash wrapper: contiguous caches of ``S`` slots
    (default offsets + T rounded up to 64, plus 64), or pools of shuffled
    pages of ``page_s`` with a last, idle slot whose table row is all -1."""
    q = torch.randn(B, T, H, D, generator=g).bfloat16()
    off = torch.tensor(offsets, dtype=torch.int32)
    if kind.startswith("paged"):
        NP = -(-(max(offsets) + T) // page_s)
        P = B * NP
        rows = (P, KVH, page_s)
        table = torch.randperm(P, generator=g).reshape(B, NP).int()
        for b, o in enumerate(offsets):
            table[b, -(-(o + T) // page_s):] = -1
        table[-1] = -1
    else:
        rows = (B, KVH, S or (max(offsets) + T + 127) // 64 * 64)
    if kind.endswith("q8"):
        kc, ks, _ = _codes("q8", (*rows, D), g)
        vc, vs, _ = _codes("q8", (*rows, D), g)
        kv = [kc, ks, vc, vs]
    elif kind in ("q4", "q41"):
        kc, ks, km = _codes(kind, (*rows, D), g)
        vc, vs, vm = _codes(kind, (*rows, D), g)
        kv = [kc, ks, vc, vs] if kind == "q4" else [kc, ks, km, vc, vs, vm]
    else:
        kv = [torch.randn(*rows, D, generator=g).bfloat16() for _ in range(2)]
    return [q, *kv, off] + ([table] if kind.startswith("paged") else [])


TC_KINDS = {"bf16": (fa.flash_attention_tc, fa.flash_attention_plain, fa.NAME_TC),
            "q8": (fa.flash_attention_q8_tc, fa.flash_attention_q8_plain, fa.NAME_Q8_TC),
            "q4": (fa.flash_attention_q4_tc, fa.flash_attention_q4_plain, fa.NAME_Q4_TC),
            "q41": (fa.flash_attention_q41_tc, fa.flash_attention_q41_plain, fa.NAME_Q41_TC),
            "paged": (fa.flash_attention_paged_tc, fa.flash_attention_paged_plain,
                      fa.NAME_PAGED_TC),
            "paged_q8": (fa.flash_attention_paged_q8_tc, fa.flash_attention_paged_q8_plain,
                         fa.NAME_PAGED_Q8_TC)}


@pytest.mark.parametrize("kind", sorted(TC_KINDS))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T,group,offsets", [(16, 4, (0, 1000)), (33, 1, (70, 0)),
                                             (64, 4, (1024, 5)), (512, 4, (0, 1024))], ids=str)
def test_flash_attention_tc_kernel(dev, kind, D, T, group, offsets):
    """Each tensor-core flash kernel against its plain version: T 16 to 512,
    offsets 0 to 1024, GQA groups of 4 and 1, the paged ones over shuffled
    pages of 64 beside an idle slot."""
    g = torch.Generator().manual_seed(D + T + group)
    offsets = (*offsets, 0) if kind.startswith("paged") else offsets
    B, KVH = len(offsets), 2
    args = [a.to(dev) for a in _tc_args(kind, B, T, KVH * group, KVH, D, offsets, g)]
    kernel, plain, name = TC_KINDS[kind]
    before = _build.LAUNCHES.get(name, 0)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    _close(got, plain(*args), 2 * 2 ** -8)


@pytest.mark.parametrize("kind", sorted(TC_KINDS))
def test_flash_attention_dispatch_by_rows(dev, kind):
    """The dispatching wrappers on the card: the tensor-core kernel from
    FLASH_TC_MIN_ROWS query positions, the CUDA-core kernel below it and at
    head_dim 256."""
    g = torch.Generator().manual_seed(len(kind))
    wrapper = getattr(fa, "flash_attention" + ("" if kind == "bf16" else "_" + kind))
    tc = TC_KINDS[kind][2]
    dec = tc[:-3]
    n = fa.FLASH_TC_MIN_ROWS
    for T, D, want in ((n - 1, 128, dec), (n, 128, tc), (n, 64, tc)) + (
            ((n, 256, dec),) if not kind.startswith("paged") else ()):
        offsets = (0, 300)
        offsets = (*offsets, 0) if kind.startswith("paged") else offsets
        args = [a.to(dev) for a in _tc_args(kind, len(offsets), T, 8, 2, D, offsets, g)]
        _build.reset_launches()
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {want: 1}, (T, D, _build.LAUNCHES)
        _close(got, TC_KINDS[kind][1](*args), 2 * 2 ** -8)


def test_flash_attention_tc_rejects_head_dim(dev):
    q = torch.zeros(1, 16, 2, 256, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 2, 128, 256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_tc(q, k, k, torch.zeros(1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("kind", sorted(k for k in TC_KINDS if k != "bf16"))
def test_flash_attention_quant_tc_rejects_head_dim(dev, kind):
    """Every other tensor-core wrapper refuses head_dim 256 (its register
    tiles take 64 and 128), where the dispatchers take the decode kernel."""
    g = torch.Generator().manual_seed(3)
    offsets = (0, 0) if kind.startswith("paged") else (0,)
    args = [a.to(dev) for a in _tc_args(kind, len(offsets), 16, 2, 2, 256, offsets, g)]
    with pytest.raises(ValueError, match="head_dim"):
        TC_KINDS[kind][0](*args)


DECODE = {"bf16": (fa.flash_attention_decode, fa.flash_attention_plain, fa.NAME),
          **{k: (getattr(fa, f"flash_attention_{k}_decode"),
                 getattr(fa, f"flash_attention_{k}_plain"), f"flash_attention_{k}")
             for k in ("q8", "q4", "q41", "paged", "paged_q8")}}


@pytest.mark.parametrize("kind", sorted(DECODE))
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("B", [1, 4])
def test_flash_attention_split_decode_long(dev, kind, B, T):
    """The split decode kernel over 8192 slots a sequence (32 splits): the
    last sequence's rows reach slot 8191, the others end inside one split,
    at a split boundary (255, 256) and across many; the paged ones over
    shuffled pages of 256 beside an idle slot; H 32 over KVH 8, D 128."""
    g = torch.Generator().manual_seed(B * 10 + T)
    offsets = (100, 256 - T, 257 - T, 8192 - T)[-B:]
    offsets = (*offsets, 0) if kind.startswith("paged") else offsets
    args = [a.to(dev) for a in _tc_args(kind, len(offsets), T, 32, 8, 128, offsets, g,
                                        page_s=256, S=8192)]
    kernel, plain, name = DECODE[kind]
    _build.reset_launches()
    got = kernel(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {name: 1}
    _close(got, plain(*args), 2 * 2 ** -8)
    assert not fa._ARRIVALS[got.device].any()


@pytest.mark.parametrize("kind", sorted(DECODE))
def test_flash_attention_split_decode_repeats_and_grows(dev, kind):
    """The same call three times gives the same output (each launch leaves
    its arrival counters at 0); then a cache of another S and more rows
    (the counter buffer grows), then the first again."""
    g = torch.Generator().manual_seed(len(kind))
    kernel, plain, _ = DECODE[kind]
    small = (700, 37, 0) if kind.startswith("paged") else (700, 37)
    args = [a.to(dev) for a in _tc_args(kind, len(small), 1, 8, 2, 128, small, g, page_s=256,
                                        S=1024)]
    outs = [kernel(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    _close(outs[0], plain(*args), 2 * 2 ** -8)
    big = (3000, 4095, 5, 0) if kind.startswith("paged") else (3000, 4095, 5)
    wide = [a.to(dev) for a in _tc_args(kind, len(big), 7, 32, 8, 128, big, g, page_s=256,
                                        S=4096 + 256)]
    got = kernel(*wide)
    torch.cuda.synchronize()
    _close(got, plain(*wide), 2 * 2 ** -8)
    assert torch.equal(kernel(*args), outs[0])
    assert not fa._ARRIVALS[got.device].any()


XSUM_TC = [(32, 0, "flat", False), (32, 0, "compact", False), (32, 0, "mixed", False),
           (16, 4, "compact", True), (32, 8, "flat", False)]


@pytest.mark.parametrize("B", [16, 64, 512])
@pytest.mark.parametrize("rule", ["xsum", "split"])
@pytest.mark.parametrize("sub,bias,layout,signed", XSUM_TC, ids=str)
def test_quant_matmul_xsum_split_tc_kernel(dev, rule, sub, bias, layout, signed, B):
    """The xsum rule of the 2/4-bit tensor-core kernel (split through the
    same instances) against the plain versions of _make_kernel_xsum and
    _make_kernel_split, with and without the min side."""
    g = torch.Generator().manual_seed(B + sub + bias + len(rule))
    out_f, in_f = 200, 4096
    codes, d, sc, dmin, mn = _lowbit_arrays(4, out_f, in_f, sub, bias, layout, signed, g)
    x = torch.randn(B, in_f, generator=g)
    xsum = qm._block_sums(x, sub)
    kernel = getattr(qm, f"quant_matmul_4bit_{rule}_tc")
    plain = getattr(qm, f"quant_matmul_4bit_{rule}_plain")
    name = qm.NAME_4BIT_XSUM_TC if rule == "xsum" else qm.NAME_4BIT_SPLIT_TC
    mins = [(dmin, mn)] if layout == "mixed" else [(dmin, mn), (None, None)]
    for dm, m in mins:
        w = [t if t is None else t.to(dev) for t in (codes, d, sc, dm, m)]
        args = (x.bfloat16().to(dev), xsum.to(dev), *w, bias)
        before = _build.LAUNCHES.get(name, 0)
        got = kernel(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[name] == before + 1
        _close(got, plain(*args), 1e-4)


@pytest.mark.parametrize("rule", ["xsum", "split"])
def test_quant_matmul_xsum_split_dispatch_by_rows(dev, rule):
    """The xsum and split wrappers on the card: the decode kernel below
    LOWBIT_TC_MIN_ROWS rows, the tensor-core kernel from it."""
    g = torch.Generator().manual_seed(len(rule))
    codes, d, sc, dmin, mn = _lowbit_arrays(4, 128, 2048, 32, 0, "flat", False, g)
    wrapper = getattr(qm, f"quant_matmul_4bit_{rule}")
    plain = getattr(qm, f"quant_matmul_4bit_{rule}_plain")
    names = {"xsum": (qm.NAME_4BIT_XSUM, qm.NAME_4BIT_XSUM_TC),
             "split": (qm.NAME_4BIT_SPLIT, qm.NAME_4BIT_SPLIT_TC)}[rule]
    for B, want in ((qm.LOWBIT_TC_MIN_ROWS - 1, names[0]), (qm.LOWBIT_TC_MIN_ROWS, names[1])):
        x = torch.randn(B, 2048, generator=g)
        args = (x.bfloat16().to(dev), qm._block_sums(x, 32).to(dev),
                *[t if t is None else t.to(dev) for t in (codes, d, sc, dmin, mn)])
        _build.reset_launches()
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {want: 1}
        _close(got, plain(*args), 1e-4)


# the 2/4-bit decode kernel's weights at the 8B shapes: (bits, sub, bias,
# layout, signed sc, has min) of Q4_K flat, compact and mixed, Q3_K flat
# (sub 16, bias 4), Q2_K flat, compact and mixed; each with the rules that
# take it (base and base_f32 no mixed layout)
FORMATS_LOWBIT = {"q4_k": (4, 32, 0, "flat", False, True),
                  "q4_k_compact": (4, 32, 0, "compact", False, True),
                  "q4_k_mixed": (4, 32, 0, "mixed", False, True),
                  "q3_k": (4, 16, 4, "flat", False, False),
                  "q2_k": (2, 16, 0, "flat", False, True),
                  "q2_k_compact": (2, 16, 0, "compact", False, True),
                  "q2_k_mixed": (2, 16, 0, "mixed", False, True)}
LOWBIT_RULES_8B = {"fsplit": tuple(FORMATS_LOWBIT), "xsum": ("q4_k", "q4_k_compact"),
                   "split": ("q4_k", "q4_k_compact"), "base": ("q4_k", "q4_k_compact"),
                   "base_f32": ("q2_k", "q2_k_compact")}
LOWBIT_8B = [(fmt, shape, rule) for fmt in FORMATS_LOWBIT for shape in ("qkv", "o", "gate_up", "down")
             for rule in LOWBIT_RULES_8B if fmt in LOWBIT_RULES_8B[rule]]
_FULL_LOWBIT = {}


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("fmt,shape,rule", LOWBIT_8B, ids=str)
def test_quant_matmul_lowbit_decode_8b_shapes(dev, fmt, shape, rule, B):
    """The 2/4-bit decode kernel at the 8B projections, each rule through
    its decode wrapper, at the decode rows; one weight kept while its rules
    and row counts run."""
    bits, sub, bias, layout, signed, has_min = FORMATS_LOWBIT[fmt]
    out_f, in_f = SHAPES_8B[shape]
    if (fmt, shape) not in _FULL_LOWBIT:
        _FULL_LOWBIT.clear()
        torch.cuda.empty_cache()
        g = torch.Generator().manual_seed(out_f + in_f + sub + bits)
        arrs = _lowbit_arrays(bits, out_f, in_f, sub, bias, layout, signed, g)
        if not has_min:
            arrs = (*arrs[:3], None, None)
        _FULL_LOWBIT[(fmt, shape)] = [t if t is None else t.to(dev) for t in arrs]
    arrs = _FULL_LOWBIT[(fmt, shape)]
    x = torch.randn(B, in_f, generator=torch.Generator().manual_seed(B)).bfloat16()
    xsum = qm._block_sums(x, sub)
    if layout == "mixed":
        xsum = xsum.reshape(B, in_f // 256, 256 // sub).transpose(1, 2).reshape(B, -1)
    x, xsum = x.to(dev), xsum.contiguous().to(dev)
    if rule == "base":
        kern, plain, name = (qm.quant_matmul_4bit_base_decode, qm.quant_matmul_4bit_base_plain,
                             qm.NAME_4BIT_BASE)
        args = (x, *arrs, bias)
    elif rule == "base_f32":
        kern, plain, name = (qm.quant_matmul_lowbit_base_decode,
                             qm.quant_matmul_lowbit_base_plain, qm.NAME_LOWBIT_BASE)
        args = (x, *arrs, bias, bits)
    else:
        suffix = "" if rule == "fsplit" else f"_{rule}"
        kern = getattr(qm, f"quant_matmul_{bits}bit{suffix}_decode")
        plain = getattr(qm, f"quant_matmul_{bits}bit{suffix}_plain")
        name = {"fsplit": LOWBIT[bits][2], "xsum": qm.NAME_4BIT_XSUM,
                "split": qm.NAME_4BIT_SPLIT}[rule]
        args = (x, xsum, *arrs, bias)
    before = _build.LAUNCHES.get(name, 0)
    got = kern(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    _close(got, plain(*args), 1e-4)


# the 2/4-bit tensor-core kernel's weights at the 8B shapes, each with the
# rules that take it: fsplit every format, xsum and split and the base rule
# the 4-bit identity codes (Q4_K flat and compact, Q3_K), base_f32 Q2_K flat
# and compact (the base rules take no mixed layout)
LOWBIT_TC_RULES_8B = {"fsplit": ("q4_k", "q4_k_compact", "q3_k", "q2_k", "q2_k_compact",
                                 "q2_k_mixed"),
                      "xsum": ("q4_k", "q4_k_compact", "q3_k"),
                      "split": ("q4_k", "q4_k_compact", "q3_k"),
                      "base": ("q4_k", "q4_k_compact", "q3_k"),
                      "base_f32": ("q2_k", "q2_k_compact")}
LOWBIT_TC_8B = [(fmt, shape, rule) for fmt in FORMATS_LOWBIT
                for shape in ("qkv", "o", "gate_up", "down")
                for rule in LOWBIT_TC_RULES_8B if fmt in LOWBIT_TC_RULES_8B[rule]]
_FULL_LOWBIT_TC = {}


@pytest.mark.parametrize("B", [16, 24, 32, 48, 64, 300, 512])
@pytest.mark.parametrize("fmt,shape,rule", LOWBIT_TC_8B, ids=str)
def test_quant_matmul_lowbit_tc_8b_shapes(dev, fmt, shape, rule, B):
    """The 2/4-bit tensor-core (wgmma) kernel at the 8B projections, each
    rule through its tensor-core wrapper, at prefill row counts: the 64-row
    activation tile (16, 24, 32, 48, 64; from LOWBIT_TC_MIN_ROWS) and the
    128-row one (300 ragged, 512); one
    weight kept while its rules and row counts run."""
    bits, sub, bias, layout, signed, has_min = FORMATS_LOWBIT[fmt]
    out_f, in_f = SHAPES_8B[shape]
    if (fmt, shape) not in _FULL_LOWBIT_TC:
        _FULL_LOWBIT_TC.clear()
        torch.cuda.empty_cache()
        g = torch.Generator().manual_seed(out_f + in_f + sub + bits)
        arrs = _lowbit_arrays(bits, out_f, in_f, sub, bias, layout, signed, g)
        if not has_min:
            arrs = (*arrs[:3], None, None)
        _FULL_LOWBIT_TC[(fmt, shape)] = [t if t is None else t.to(dev) for t in arrs]
    arrs = _FULL_LOWBIT_TC[(fmt, shape)]
    x = torch.randn(B, in_f, generator=torch.Generator().manual_seed(B)).bfloat16()
    xsum = qm._block_sums(x, sub)
    if layout == "mixed":
        xsum = xsum.reshape(B, in_f // 256, 256 // sub).transpose(1, 2).reshape(B, -1)
    x, xsum = x.to(dev), xsum.contiguous().to(dev)
    if rule == "base":
        kern, plain, name = (qm.quant_matmul_4bit_base_tc, qm.quant_matmul_4bit_base_plain,
                             qm.NAME_4BIT_BASE_TC)
        args = (x, *arrs, bias)
    elif rule == "base_f32":
        kern, plain, name = (qm.quant_matmul_lowbit_base_tc, qm.quant_matmul_lowbit_base_plain,
                             qm.NAME_LOWBIT_BASE_TC)
        args = (x, *arrs, bias, bits)
    else:
        suffix = "" if rule == "fsplit" else f"_{rule}"
        kern = getattr(qm, f"quant_matmul_{bits}bit{suffix}_tc")
        plain = getattr(qm, f"quant_matmul_{bits}bit{suffix}_plain")
        name = {"fsplit": qm.NAME_4BIT_TC if bits == 4 else qm.NAME_2BIT_TC,
                "xsum": qm.NAME_4BIT_XSUM_TC, "split": qm.NAME_4BIT_SPLIT_TC}[rule]
        args = (x, xsum, *arrs, bias)
    before = _build.LAUNCHES.get(name, 0)
    got = kern(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    _close(got, plain(*args), 1e-4)
