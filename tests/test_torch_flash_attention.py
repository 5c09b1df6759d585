"""The port's flash attention (plain version, on the CPU) against the JAX
package's Pallas ``_flash_jit``, which runs in interpret mode on the CPU.

Tolerance: both compute f32 softmax attention and round once to bf16; the
online (JAX) and one-shot (port) softmax differ only in f32 rounding, so the
outputs agree to two bf16 ulps of their scale (2 * 2^-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.ops import flash_attention as jfa
from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("T", [1, 5, 16])
def test_flash_matches_pallas(T, group, D, monkeypatch):
    calls = []
    real = jfa._flash_jit
    monkeypatch.setattr(jfa, "_flash_jit",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(T * 100 + group * 10 + D)
    B, KVH, S = 2, 2, 256
    q = rng.normal(size=(B, T, KVH * group, D)).astype(np.float32)
    k = rng.normal(size=(B, KVH, S, D)).astype(np.float32)
    v = rng.normal(size=(B, KVH, S, D)).astype(np.float32)
    offsets = rng.integers(0, S - T + 1, size=B).astype(np.int32)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(offsets)).astype(jnp.float32))
    assert calls, "JAX did not take the Pallas kernel"
    before = _build.LAUNCHES.get(tfa.NAME + ".plain", 0)
    got = tfa.flash_attention(_bf16(q), _bf16(k), _bf16(v),
                              torch.from_numpy(offsets)).float().numpy()
    assert _build.LAUNCHES[tfa.NAME + ".plain"] == before + 1
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2 * 2 ** -8 * scale


@pytest.mark.parametrize("D", [64, 128])
def test_flash_prefill_chunk_matches_pallas(D, monkeypatch):
    """A prefill chunk of at least FLASH_TC_MIN_ROWS positions past a
    nonzero offset (the shape that takes the tensor-core kernel on the
    card): the plain version against ``_flash_jit``."""
    calls = []
    real = jfa._flash_jit
    monkeypatch.setattr(jfa, "_flash_jit",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(D)
    B, KVH, group, S = 2, 2, 4, 256
    T = max(64, tfa.FLASH_TC_MIN_ROWS)
    q = rng.normal(size=(B, T, KVH * group, D)).astype(np.float32)
    k = rng.normal(size=(B, KVH, S, D)).astype(np.float32)
    v = rng.normal(size=(B, KVH, S, D)).astype(np.float32)
    offsets = np.array([S - T, 70], np.int32)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(offsets)).astype(jnp.float32))
    assert calls, "JAX did not take the Pallas kernel"
    got = tfa.flash_attention(_bf16(q), _bf16(k), _bf16(v),
                              torch.from_numpy(offsets)).float().numpy()
    assert np.abs(got - want).max() <= 2 * 2 ** -8 * np.abs(want).max()


# wrapper: (its tensor-core wrapper, its CUDA-core wrapper)
DISPATCH = {"flash_attention": ("flash_attention_tc", "flash_attention_decode"),
            "flash_attention_q8": ("flash_attention_q8_tc", "flash_attention_q8_decode"),
            "flash_attention_paged": ("flash_attention_paged_tc",
                                      "flash_attention_paged_decode"),
            "flash_attention_paged_q8": ("flash_attention_paged_q8_tc",
                                         "flash_attention_paged_q8_decode"),
            "flash_attention_q4": ("flash_attention_q4_tc", "flash_attention_q4_decode"),
            "flash_attention_q41": ("flash_attention_q41_tc", "flash_attention_q41_decode")}


def _dispatch_args(wrapper, T, D):
    """CPU inputs of ``wrapper``: H 8 over KVH 2, 64 slots (paged: 2 pages
    of 32)."""
    g = torch.Generator().manual_seed(T + D)
    q = torch.randn(1, T, 8, D, generator=g).bfloat16()
    off = torch.zeros(1, dtype=torch.int32)
    table = torch.tensor([[1, 0]], dtype=torch.int32)
    rows = (2, 2, 32) if "paged" in wrapper else (1, 2, 64)
    s = torch.rand(rows, generator=g) + 0.01
    if wrapper in ("flash_attention", "flash_attention_paged"):
        kv = [torch.randn(*rows, D, generator=g).bfloat16() for _ in range(2)]
    elif wrapper.endswith("q8"):
        c = torch.randint(-127, 128, (*rows, D), generator=g, dtype=torch.int8)
        kv = [c, s, c, s]
    else:
        c = torch.randint(0, 256, (*rows, D // 2), generator=g, dtype=torch.uint8)
        kv = [c, s, c, s] if wrapper.endswith("q4") else [c, s, -s, c, s, -s]
    return [q, *kv, off] + ([table] if "paged" in wrapper else [])


@pytest.mark.parametrize("wrapper", sorted(DISPATCH))
def test_flash_dispatch_by_rows(wrapper, monkeypatch):
    """With the device check answering True: every wrapper takes its
    tensor-core wrapper from FLASH_TC_MIN_ROWS query positions at head_dim
    64 and 128, and the CUDA-core one below it and at head_dim 256. Each spy
    calls the wrapper it stands for, which takes the plain version on these
    CPU tensors."""
    monkeypatch.setattr(tfa, "_card", lambda q: True)
    calls = []
    for name in [n for pair in DISPATCH.values() for n in pair]:
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    tc, dec = DISPATCH[wrapper]
    n = tfa.FLASH_TC_MIN_ROWS
    for T, D, want in ((n - 1, 64, dec), (n, 64, tc), (n, 128, tc), (2 * n, 256, dec), (1, 128, dec)):
        calls.clear()
        args = _dispatch_args(wrapper, T, D)
        out = getattr(tfa, wrapper)(*args)
        assert out.shape == args[0].shape
        assert calls == [want], (T, D, calls)


def test_flash_offset_zero_sees_one_key():
    """At offset 0 the first query sees only slot 0: output == v[0]."""
    rng = np.random.default_rng(0)
    q = _bf16(rng.normal(size=(1, 1, 4, 64)).astype(np.float32))
    k = _bf16(rng.normal(size=(1, 2, 128, 64)).astype(np.float32))
    v = _bf16(rng.normal(size=(1, 2, 128, 64)).astype(np.float32))
    out = tfa.flash_attention(q, k, v, torch.zeros(1, dtype=torch.int32))
    assert torch.equal(out[0, 0, :2], v[0, 0, :1].expand(2, 64))
    assert torch.equal(out[0, 0, 2:], v[0, 1, :1].expand(2, 64))


def test_flash_rejects_bad_offsets():
    q = torch.zeros(1, 1, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        tfa.flash_attention(q, k, k, torch.zeros(1, dtype=torch.int64))
