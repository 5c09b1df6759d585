"""Port weight containers and repack against the JAX package, on the CPU.

Every check here is bit-exact: repacking and dequantization are integer
shuffles plus the same IEEE f32 products in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.ops import linear as jlinear
from llama_gguf_inference_tpu.quant import numpy_ref as jref
from llama_gguf_inference_tpu.quant import repack as jrepack
from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
from llama_gguf_inference_tpu_torch.ops import linear as tlinear
from llama_gguf_inference_tpu_torch.quant import numpy_ref as tref
from llama_gguf_inference_tpu_torch.quant import repack as trepack

torch.set_num_threads(1)

FORMATS = [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0]
LAYOUT = {GGMLType.Q4_K: "flat", GGMLType.Q6_K: "compact", GGMLType.Q8_0: "flat"}


def _raw(gtype, out_f, in_f, seed=0):
    x = np.random.default_rng(seed).normal(size=(out_f, in_f)).astype(np.float32)
    return jref.quantize(x, gtype)


def _np(t):
    return None if t is None else np.asarray(t)


@pytest.mark.parametrize("gtype", FORMATS, ids=lambda t: t.name)
def test_repack_arrays_match(gtype):
    raw = _raw(gtype, 64, 512)
    assert tref.quantize(jref.dequantize(raw, gtype, 64 * 512), gtype) == \
        jref.quantize(jref.dequantize(raw, gtype, 64 * 512), gtype)
    jr = jrepack.repack(raw, gtype, 64, 512)
    tr = trepack.repack(raw, gtype, 64, 512)
    for f in ("codes", "d", "sc", "dmin", "mn"):
        a, b = getattr(jr, f), getattr(tr, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("fmt", "bits", "sub_size", "d_size", "code_bias",
              "out_features", "in_features", "min_size"):
        assert getattr(jr, f) == getattr(tr, f), f


@pytest.mark.parametrize("gtype", FORMATS, ids=lambda t: t.name)
def test_device_layout_and_dequant_bit_exact(gtype):
    out_f, in_f = 48, 768
    raw = _raw(gtype, out_f, in_f, seed=1)
    jq = jrepack.to_quant_linear(jrepack.repack(raw, gtype, out_f, in_f))
    tq = trepack.to_quant_linear(trepack.repack(raw, gtype, out_f, in_f), "cpu")
    layout = "flat" if tq.d_size == tq.sub_size else "compact"
    assert layout == LAYOUT[gtype]
    for f in ("codes", "d", "sc", "dmin", "mn"):
        a, b = _np(getattr(jq, f)), getattr(tq, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a, b.numpy()), f
    golden = jref.dequantize(raw, gtype, out_f * in_f).reshape(out_f, in_f)
    got = tq.dequantize(torch.float32).numpy()
    assert np.array_equal(got, golden)
    assert np.array_equal(got, np.asarray(jq.dequantize(jnp.float32)))
    # bf16 block-minor decode, the form the matmul plain versions start from
    jbm = np.asarray(jq.dequantize_bm(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(tq.dequantize_bm().float().numpy(), jbm)


def test_permute_activations_matches():
    raw = _raw(GGMLType.Q6_K, 16, 512)
    jq = jrepack.to_quant_linear(jrepack.repack(raw, GGMLType.Q6_K, 16, 512))
    tq = trepack.to_quant_linear(trepack.repack(raw, GGMLType.Q6_K, 16, 512), "cpu")
    x = np.random.default_rng(2).normal(size=(2, 3, 512)).astype(np.float32)
    got = tq.permute_activations(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jq.permute_activations(jnp.asarray(x))))
    # the layout's definition: stored position j holds logical element perm[j]
    perm = trepack.block_minor_perm(512, 16, 256)
    assert np.array_equal(perm, jrepack.block_minor_perm(512, 16, 256))
    assert np.array_equal(got, x[..., perm])


def test_quant_embedding_take_matches():
    raw = _raw(GGMLType.Q4_K, 40, 256, seed=3)
    jq = jrepack.to_quant_linear(jrepack.repack(raw, GGMLType.Q4_K, 40, 256))
    tq = trepack.to_quant_linear(trepack.repack(raw, GGMLType.Q4_K, 40, 256), "cpu")
    ids = np.array([[3, 0, 39], [7, 7, 1]], np.int32)
    want = np.asarray(jlinear.QuantEmbedding(table=jq).take(jnp.asarray(ids))
                      .astype(jnp.float32))
    got = tlinear.embed_lookup(tlinear.QuantEmbedding(table=tq),
                               torch.from_numpy(ids)).float().numpy()
    assert got.shape == (2, 3, 256)
    assert np.array_equal(got, want)


def test_fuse_linears_exact():
    parts = [trepack.to_quant_linear(
        trepack.repack(_raw(GGMLType.Q4_K, o, 512, seed=o), GGMLType.Q4_K, o, 512),
        "cpu") for o in (64, 32, 32)]
    fused = tlinear.fuse_linears(parts)
    assert fused.out_features == 128
    want = torch.cat([p.dequantize(torch.float32) for p in parts])
    assert torch.equal(fused.dequantize(torch.float32), want)
    jparts = [jrepack.to_quant_linear(
        jrepack.repack(_raw(GGMLType.Q4_K, o, 512, seed=o), GGMLType.Q4_K, o, 512))
        for o in (64, 32, 32)]
    jf = jlinear.fuse_linears(jparts)
    for f in ("codes", "d", "dmin"):
        assert np.array_equal(getattr(fused, f).numpy(), np.asarray(getattr(jf, f)))


def test_fuse_linears_rejects_mismatch():
    a = trepack.to_quant_linear(
        trepack.repack(_raw(GGMLType.Q4_K, 32, 512), GGMLType.Q4_K, 32, 512), "cpu")
    b = trepack.to_quant_linear(
        trepack.repack(_raw(GGMLType.Q6_K, 32, 512), GGMLType.Q6_K, 32, 512), "cpu")
    assert tlinear.fuse_linears([a, b]) is None
    # min_size is part of the compatibility key (mixed layouts must not fuse
    # with flat ones)
    assert tlinear.fuse_linears([a, dataclasses.replace(a, min_size=256)]) is None


def test_unported_formats_raise():
    raw = _raw(GGMLType.Q8_0, 4, 256)
    with pytest.raises(NotImplementedError, match="Q5_K"):
        trepack.repack(raw, GGMLType.Q5_K, 4, 256)
    with pytest.raises(NotImplementedError, match="Q5_K"):
        tref.dequantize(raw, GGMLType.Q5_K, 256)
    with pytest.raises(NotImplementedError, match="IQ1_S"):
        trepack.repack(raw, GGMLType.IQ1_S, 4, 256)
    with pytest.raises(NotImplementedError, match="IQ4_NL"):
        tref.quantize(np.zeros(256, np.float32), GGMLType.IQ4_NL)
