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
