"""The port's codecs and repacks of the legacy, Q5_K, Q8_K and IQ4 formats,
its activation quantization and its IQ2/IQ3 code alphabets, against the JAX
package on the CPU.

Every check is bit-exact: wire bytes, decoded values and repacked arrays are
integer shuffles plus the same IEEE f32 operations in both packages, and the
activation quantization divides, rounds half to even and clips exactly as
``_quantize_acts`` does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.ops import linear as jlinear
from llama_gguf_inference_tpu.ops import pallas_matmul as jpm
from llama_gguf_inference_tpu.quant import numpy_ref as jref
from llama_gguf_inference_tpu.quant import repack as jrepack
from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
from llama_gguf_inference_tpu_torch.ops import linear as tlinear
from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
from llama_gguf_inference_tpu_torch.quant import numpy_ref as tref
from llama_gguf_inference_tpu_torch.quant import repack as trepack

torch.set_num_threads(1)

ENCODED = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_K,
           GGMLType.Q5_K, GGMLType.IQ4_NL, GGMLType.IQ4_XS]
NEW = ENCODED + [GGMLType.Q8_1]
LAYOUTS = ["auto", "flat", "compact", "mixed"]
FIELDS = ("codes", "d", "sc", "dmin", "mn")
STATIC = ("fmt", "bits", "sub_size", "d_size", "code_bias", "out_features",
          "in_features", "min_size")
# the device layout each mode gives a format: only the hierarchical 8-bit
# formats (Q5_K, IQ4_XS) have a choice, and mixed keeps them compact
HIER = {GGMLType.Q5_K, GGMLType.IQ4_XS}


def _x(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x.reshape(-1)[:256] = 0.0                          # an all-zero block
    x.reshape(-1)[256:512] = np.abs(x.reshape(-1)[256:512])   # no negative values
    return x


def _q8_1_raw(out_f, in_f, seed):
    """Q8_1 wire bytes (the JAX package has no Q8_1 encoder): f16 d, f16 s,
    32 int8 codes per block."""
    rng = np.random.default_rng(seed)
    nb = out_f * in_f // 32
    blocks = np.empty((nb, 36), np.uint8)
    blocks[:, 0:2] = (rng.random((nb, 1)) * 0.01).astype("<f2").view(np.uint8)
    blocks[:, 2:4] = rng.normal(size=(nb, 1)).astype("<f2").view(np.uint8)
    blocks[:, 4:36] = rng.integers(-127, 128, (nb, 32)).astype(np.int8).view(np.uint8)
    return blocks.tobytes()


def _raw(gtype, out_f, in_f, seed):
    if gtype == GGMLType.Q8_1:
        return _q8_1_raw(out_f, in_f, seed)
    return jref.quantize(_x((out_f, in_f), seed), gtype)


@pytest.mark.parametrize("gtype", ENCODED, ids=lambda t: t.name)
def test_codec_bit_exact(gtype):
    x = _x((16, 1024), 7)
    raw = jref.quantize(x, gtype)
    assert tref.quantize(x, gtype) == raw
    assert np.array_equal(tref.dequantize(raw, gtype, x.size),
                          jref.dequantize(raw, gtype, x.size))


def test_q8_1_decodes_bit_exact():
    raw = _q8_1_raw(8, 512, 3)
    assert np.array_equal(tref.dequantize(raw, GGMLType.Q8_1, 8 * 512),
                          jref.dequantize(raw, GGMLType.Q8_1, 8 * 512))
    with pytest.raises(NotImplementedError, match="Q8_1"):
        tref.quantize(np.zeros(256, np.float32), GGMLType.Q8_1)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("gtype", NEW, ids=lambda t: t.name)
def test_repack_layouts_bit_exact(gtype, layout, monkeypatch):
    """The host arrays, the device arrays after the layout policy, and the
    dequantized values, in every layout mode."""
    monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
    out_f, in_f = 24, 768
    raw = _raw(gtype, out_f, in_f, 1)
    jr = jrepack.repack(raw, gtype, out_f, in_f)
    tr = trepack.repack(raw, gtype, out_f, in_f)
    jq = jrepack.to_quant_linear(jrepack.repack(raw, gtype, out_f, in_f))
    tq = trepack.to_quant_linear(tr, "cpu")
    for src, dst in ((jr, tr), (jq, tq)):
        for f in FIELDS:
            a, b = getattr(src, f), getattr(dst, f)
            assert (a is None) == (b is None), f
            if a is not None:
                b = b.numpy() if isinstance(b, torch.Tensor) else b
                assert np.asarray(a).dtype == b.dtype and np.array_equal(a, b), f
        for f in STATIC:
            assert getattr(src, f) == getattr(dst, f), f
    compact = gtype in HIER and layout in ("auto", "compact", "mixed")
    assert (tq.d_size != tq.sub_size) == compact
    golden = jref.dequantize(raw, gtype, out_f * in_f).reshape(out_f, in_f)
    assert np.array_equal(tq.dequantize(torch.float32).numpy(), golden)
    jbm = np.asarray(jq.dequantize_bm(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(tq.dequantize_bm().float().numpy(), jbm)


def test_q5k_auto_layout_and_footprint(monkeypatch):
    """Q5_K under ``auto``: int8 codes, f32 d and dmin per 256, u8 sc and mn
    per 32 (8.75 bits a weight); under ``flat``, f32 d and dmin per 32 (10)."""
    out_f, in_f = 16, 512
    raw = _raw(GGMLType.Q5_K, out_f, in_f, 2)
    for layout, bits in (("auto", 8.75), ("flat", 10.0)):
        monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
        q = trepack.to_quant_linear(trepack.repack(raw, GGMLType.Q5_K, out_f, in_f), "cpu")
        assert q.codes.dtype == torch.int8 and q.dmin is not None
        if layout == "auto":
            assert q.sc.dtype == q.mn.dtype == torch.uint8 and q.d.shape == (out_f, 2)
        stored = sum(t.numel() * t.element_size() for t in (q.codes, q.d, q.sc, q.dmin, q.mn)
                     if t is not None)
        assert 8 * stored / (out_f * in_f) == bits


@pytest.mark.parametrize("gtype", [GGMLType.Q5_K, GGMLType.IQ4_XS, GGMLType.Q5_1],
                         ids=lambda t: t.name)
def test_quant_embedding_take(gtype):
    raw = _raw(gtype, 40, 512, 3)
    jq = jrepack.to_quant_linear(jrepack.repack(raw, gtype, 40, 512))
    tq = trepack.to_quant_linear(trepack.repack(raw, gtype, 40, 512), "cpu")
    ids = np.array([[3, 0, 39], [7, 7, 1]], np.int32)
    want = np.asarray(jlinear.QuantEmbedding(table=jq).take(jnp.asarray(ids))
                      .astype(jnp.float32))
    got = tlinear.embed_lookup(tlinear.QuantEmbedding(table=tq),
                               torch.from_numpy(ids)).float().numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fmt", ["iq2_xxs", "iq2_xs", "iq2_s", "iq3_xxs", "iq3_s", "q4_k"])
def test_code_values_match(fmt):
    q = np.arange(16, dtype=np.int32)
    want = np.asarray(jlinear.code_values(fmt, jnp.asarray(q)))
    assert np.array_equal(tlinear.code_values(fmt, torch.from_numpy(q)).numpy(), want)


@pytest.mark.parametrize("sub", [32, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_acts_bit_exact(seed, dtype, sub):
    """Activations at three magnitudes, with an all-zero sub-block (its
    scale is 0 and its codes 0)."""
    x = np.random.default_rng(seed).normal(size=(9, 1024)).astype(np.float32) * 10.0 ** (seed - 1)
    x[2, ::1024 // sub] = 0.0                          # sub-block 0 of row 2 in block-minor order
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x)
    if dtype == "bf16":
        tx = tx.bfloat16()
    jq, js = jpm._quantize_acts(jx, sub)
    tq, ts = qm.quantize_acts(tx, sub)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert (ts[2, 0] == 0).item() and not tq[2, ::1024 // sub].any()
