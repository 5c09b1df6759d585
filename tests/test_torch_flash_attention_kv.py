"""The port's attention over quantized and paged caches (plain versions, on
the CPU) against the JAX package's Pallas kernels ``_flash_q8_jit`` (q8_0,
q4_0, q4_1), ``_flash_paged_jit`` and ``_flash_paged_q8_jit``, which run in
interpret mode on the CPU.

Tolerance: both compute f32 softmax attention over the same codes and
round once to bf16. The kernels fold scales and minimums in after the dots
and run an online softmax; the plain versions dequantize first and take
one softmax. Those differ only in f32 rounding, so the outputs agree to two
bf16 ulps of their scale (2 * 2^-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.ops import flash_attention as jfa
from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

# kind: (JAX wrapper, the Pallas function it must reach, port wrapper)
KINDS = {
    "q8": (jfa.flash_attention_q8, "_flash_q8_jit", tfa.flash_attention_q8),
    "q4": (jfa.flash_attention_q4, "_flash_q8_jit", tfa.flash_attention_q4),
    "q41": (jfa.flash_attention_q41, "_flash_q8_jit", tfa.flash_attention_q41),
    "paged": (jfa.flash_attention_paged, "_flash_paged_jit", tfa.flash_attention_paged),
    "paged_q8": (jfa.flash_attention_paged_q8, "_flash_paged_q8_jit",
                 tfa.flash_attention_paged_q8),
}


def _inputs(kind, rng, B, T, H, KVH, D):
    """numpy inputs in the wrapper's argument order. Contiguous caches hold
    S = 256 slots; paged pools 3 pages of 128 per slot, shuffled, with one
    slot holding 2 pages (its last entry -1) and one idle (all -1)."""
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    paged = kind.startswith("paged")
    if paged:
        page_s, NP = 128, 3
        P = B * NP
        rows = (P, KVH, page_s)
        table = rng.permutation(P).astype(np.int32).reshape(B, NP)
        table[1, 2:] = -1
        table[2] = -1
        offsets = np.array([NP * page_s - T, rng.integers(0, 2 * page_s - T + 1), 0],
                           np.int32)
    else:
        rows = (B, KVH, 256)
        offsets = rng.integers(0, 256 - T + 1, size=B).astype(np.int32)

    def side():
        if kind == "paged":
            return [rng.normal(size=rows + (D,)).astype(np.float32)]
        s = (rng.random(rows) * 0.05 + 1e-3).astype(np.float32)
        if kind in ("q8", "paged_q8"):
            return [rng.integers(-127, 128, rows + (D,)).astype(np.int8), s]
        c = rng.integers(0, 256, rows + (D // 2,)).astype(np.uint8)
        if kind == "q4":
            return [c, s]
        return [c, s, -(rng.random(rows) * 0.4).astype(np.float32)]

    return [q] + side() + side() + [offsets] + ([table] if paged else [])


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("T", [1, 5, 16])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_matches_pallas(kind, T, group, D, monkeypatch):
    jfn, pallas, tfn = KINDS[kind]
    calls = []
    real = getattr(jfa, pallas)
    monkeypatch.setattr(jfa, pallas, lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(T * 100 + group * 10 + D)
    B, KVH = 3, 2
    args = _inputs(kind, rng, B, T, KVH * group, KVH, D)
    jargs = [jnp.asarray(args[0], jnp.bfloat16)] + [jnp.asarray(a) for a in args[1:]]
    want = np.asarray(jfn(*jargs).astype(jnp.float32))
    assert calls, f"JAX did not take the Pallas kernel {pallas}"
    targs = [torch.from_numpy(np.asarray(jargs[0]).view(np.int16).copy()).view(
        torch.bfloat16)] + [torch.from_numpy(a) for a in args[1:]]
    name = tfn.__name__
    before = _build.LAUNCHES.get(name + ".plain", 0)
    got = tfn(*targs).float().numpy()
    assert _build.LAUNCHES[name + ".plain"] == before + 1
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2 * 2 ** -8 * scale


def test_paged_plain_reads_page_zero_for_unmapped_entries():
    """An idle slot (table row all -1) at offset 0 attends to page 0's first
    key, without indexing past the pool."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 1, 2, 64)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.normal(size=(2, 1, 16, 64)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.normal(size=(2, 1, 16, 64)).astype(np.float32)).bfloat16()
    out = tfa.flash_attention_paged(q, k, v, torch.zeros(1, dtype=torch.int32),
                                    torch.full((1, 2), -1, dtype=torch.int32))
    assert torch.equal(out[0, 0], v[0, 0, :1].expand(2, 64))


def test_quant_wrappers_reject_mismatched_scales():
    q = torch.zeros(1, 1, 2, 64, dtype=torch.bfloat16)
    kq = torch.zeros(1, 2, 128, 32, dtype=torch.uint8)
    with pytest.raises(ValueError, match="ks"):
        tfa.flash_attention_q4(q, kq, torch.zeros(1, 2, 64), kq, torch.zeros(1, 2, 128),
                               torch.zeros(1, dtype=torch.int32))
