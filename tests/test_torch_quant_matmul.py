"""The port's quantized matmuls (plain versions, on the CPU) against the JAX
package's Pallas kernels, which run in interpret mode on the CPU.

Tolerance: both sides round the same dequantized weights to bf16 at the same
points and accumulate in f32; only the order of the f32 sums differs, so
outputs agree to 2e-5 of their scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.ops import pallas_matmul as jpm
from llama_gguf_inference_tpu.quant import numpy_ref as jref
from llama_gguf_inference_tpu.quant import repack as jrepack
from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
from llama_gguf_inference_tpu_torch.quant import repack as trepack

torch.set_num_threads(1)


def _pair(gtype, out_f, in_f, seed):
    x = np.random.default_rng(seed).normal(size=(out_f, in_f)).astype(np.float32)
    raw = jref.quantize(x, gtype)
    return (jrepack.to_quant_linear(jrepack.repack(raw, gtype, out_f, in_f)),
            trepack.to_quant_linear(trepack.repack(raw, gtype, out_f, in_f), "cpu"))


def _spy(monkeypatch, name):
    calls = []
    real = getattr(jpm, name)

    def spy(*a, **k):
        calls.append(k.get("kern", "base"))
        return real(*a, **k)

    monkeypatch.setattr(jpm, name, spy)
    return calls


def _compare(jq, tq, B, seed, kernel):
    x = np.random.default_rng(seed).normal(size=(B, tq.in_features)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jpm.pallas_quant_matmul(jq, xj, out_dtype=jnp.float32))
    before = _build.LAUNCHES.get(kernel + ".plain", 0)
    got = tq.matmul(torch.from_numpy(x).bfloat16(), out_dtype=torch.float32).numpy()
    assert _build.LAUNCHES[kernel + ".plain"] == before + 1
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-5 * scale


@pytest.mark.parametrize("B", [1, 3, 8, 40])
@pytest.mark.parametrize("out_f,in_f", [(128, 512), (256, 256)])
def test_4bit_matches_pallas_fsplit(B, out_f, in_f, monkeypatch):
    calls = _spy(monkeypatch, "_quant_matmul_2d_xsum")
    jq, tq = _pair(GGMLType.Q4_K, out_f, in_f, B)
    _compare(jq, tq, B, B + 1, qm.NAME_4BIT)
    assert calls == ["fsplit"]


@pytest.mark.parametrize("B", [1, 3, 8, 40])
@pytest.mark.parametrize("gtype", [GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_8bit_matches_pallas_base(B, gtype, monkeypatch):
    calls = _spy(monkeypatch, "_quant_matmul_2d")
    jq, tq = _pair(gtype, 128, 512, B)
    _compare(jq, tq, B, B + 2, qm.NAME_8BIT)
    assert calls == ["base"]


def test_block_sums_and_3d_input():
    jq, tq = _pair(GGMLType.Q4_K, 128, 256, 0)
    x = np.random.default_rng(5).normal(size=(2, 5, 256)).astype(np.float32)
    xb = tq.permute_activations(torch.from_numpy(x)).reshape(10, 256)
    want = np.asarray(jpm._block_sums(jnp.asarray(xb.numpy()), 32))
    assert np.allclose(qm._block_sums(xb, 32).numpy(), want, rtol=1e-6, atol=1e-6)
    y = tq.matmul(torch.from_numpy(x).bfloat16())
    assert y.shape == (2, 5, 128) and y.dtype == torch.bfloat16
