"""The port's Q2_K and Q3_K codecs, repacks, scale layouts and 2-/4-bit
matmuls against the JAX package, on the CPU.

Codecs, repacked arrays and dequantized values are bit-exact: integer
shuffles plus the same IEEE f32 products in both packages. The matmuls'
plain versions round the same dequantized weights to bf16 at the same
points as the Pallas kernels (run in interpret mode) and accumulate in f32;
only the order of the f32 sums differs, so outputs agree to 2e-5 of their
scale.
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
from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.ops import linear as tlinear
from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
from llama_gguf_inference_tpu_torch.quant import numpy_ref as tref
from llama_gguf_inference_tpu_torch.quant import repack as trepack

torch.set_num_threads(1)

LAYOUTS = ["auto", "flat", "compact", "mixed"]
FIELDS = ("codes", "d", "sc", "dmin", "mn")
STATIC = ("fmt", "bits", "sub_size", "d_size", "code_bias", "out_features",
          "in_features", "min_size")
# the device layout each mode gives a format (mixed needs a min and no bias)
EXPECT = {
    GGMLType.Q2_K: {"auto": "flat", "flat": "flat", "compact": "compact", "mixed": "mixed"},
    GGMLType.Q3_K: {"auto": "flat", "flat": "flat", "compact": "compact", "mixed": "flat"},
    GGMLType.Q4_K: {"auto": "flat", "flat": "flat", "compact": "compact", "mixed": "mixed"},
    GGMLType.Q6_K: {"auto": "compact", "flat": "flat", "compact": "compact",
                    "mixed": "compact"},
}


def _raw(gtype, out_f, in_f, seed=0):
    x = np.random.default_rng(seed).normal(size=(out_f, in_f)).astype(np.float32)
    return jref.quantize(x, gtype)


def _layout_of(q) -> str:
    if q.min_size:
        return "mixed"
    return "flat" if q.d_size == q.sub_size else "compact"


def _pair(gtype, out_f, in_f, seed, layout, monkeypatch):
    monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
    raw = _raw(gtype, out_f, in_f, seed)
    return (raw, jrepack.to_quant_linear(jrepack.repack(raw, gtype, out_f, in_f)),
            trepack.to_quant_linear(trepack.repack(raw, gtype, out_f, in_f), "cpu"))


@pytest.mark.parametrize("gtype", [GGMLType.Q2_K, GGMLType.Q3_K], ids=lambda t: t.name)
def test_codec_bit_exact(gtype):
    x = np.random.default_rng(7).normal(size=(16, 1024)).astype(np.float32)
    x[3, :256] = 0.0                                  # an all-zero block
    x[5, 256:512] = np.abs(x[5, 256:512])             # no negative values
    raw = jref.quantize(x, gtype)
    assert tref.quantize(x, gtype) == raw
    assert np.array_equal(tref.dequantize(raw, gtype, x.size),
                          jref.dequantize(raw, gtype, x.size))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("gtype", sorted(EXPECT, key=int), ids=lambda t: t.name)
def test_repack_layouts_bit_exact(gtype, layout, monkeypatch):
    """The host arrays, the device arrays after the layout policy, and the
    dequantized values, in every layout mode."""
    out_f, in_f = 48, 768
    raw, jq, tq = _pair(gtype, out_f, in_f, 1, layout, monkeypatch)
    jr = jrepack.repack(raw, gtype, out_f, in_f)
    tr = trepack.repack(raw, gtype, out_f, in_f)
    for src, dst in ((jr, tr), (jq, tq)):
        for f in FIELDS:
            a, b = getattr(src, f), getattr(dst, f)
            assert (a is None) == (b is None), f
            if a is not None:
                b = b.numpy() if isinstance(b, torch.Tensor) else b
                assert np.asarray(a).dtype == b.dtype and np.array_equal(a, b), f
        for f in STATIC:
            assert getattr(src, f) == getattr(dst, f), f
    assert _layout_of(tq) == EXPECT[gtype][layout]
    golden = jref.dequantize(raw, gtype, out_f * in_f).reshape(out_f, in_f)
    assert np.array_equal(tq.dequantize(torch.float32).numpy(), golden)
    jbm = np.asarray(jq.dequantize_bm(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(tq.dequantize_bm().float().numpy(), jbm)


def test_scale_layout_reads_the_environment(monkeypatch):
    monkeypatch.delenv("LGT_SCALE_LAYOUT", raising=False)
    monkeypatch.delenv("LGT_FLAT_SCALES", raising=False)
    assert trepack.scale_layout() == jrepack.scale_layout() == "auto"
    monkeypatch.setenv("LGT_FLAT_SCALES", "1")
    assert trepack.scale_layout() == jrepack.scale_layout() == "flat"
    monkeypatch.setenv("LGT_SCALE_LAYOUT", "Mixed")
    assert trepack.scale_layout() == jrepack.scale_layout() == "mixed"
    for bits, has_min, bias in ((2, True, 0), (4, False, 4), (8, False, 0), (4, True, 0)):
        assert trepack.device_scale_layout(bits, "", has_min, bias) == \
            jrepack.device_scale_layout(bits, "", has_min, bias)


@pytest.mark.parametrize("layout", ["flat", "compact", "mixed"])
def test_quant_embedding_take_q2k(layout, monkeypatch):
    _, jq, tq = _pair(GGMLType.Q2_K, 40, 512, 3, layout, monkeypatch)
    ids = np.array([[3, 0, 39], [7, 7, 1]], np.int32)
    want = np.asarray(jlinear.QuantEmbedding(table=jq).take(jnp.asarray(ids))
                      .astype(jnp.float32))
    got = tlinear.embed_lookup(tlinear.QuantEmbedding(table=tq),
                               torch.from_numpy(ids)).float().numpy()
    assert got.shape == (2, 3, 512)
    assert np.array_equal(got, want)


def _spy(monkeypatch):
    calls = []
    real = jpm._quant_matmul_2d_xsum

    def spy(*a, **k):
        calls.append(k.get("kern"))
        return real(*a, **k)

    monkeypatch.setattr(jpm, "_quant_matmul_2d_xsum", spy)
    return calls


def _compare(jq, tq, B, seed, kernel):
    x = np.random.default_rng(seed).normal(size=(B, tq.in_features)).astype(np.float32)
    want = np.asarray(jpm.pallas_quant_matmul(jq, jnp.asarray(x, jnp.bfloat16),
                                              out_dtype=jnp.float32))
    before = _build.LAUNCHES.get(kernel + ".plain", 0)
    got = tq.matmul(torch.from_numpy(x).bfloat16(), out_dtype=torch.float32).numpy()
    assert _build.LAUNCHES[kernel + ".plain"] == before + 1
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-5 * scale


@pytest.mark.parametrize("layout", ["flat", "compact", "mixed"])
@pytest.mark.parametrize("out_f,in_f", [(256, 512), (128, 1024)])
@pytest.mark.parametrize("B", [1, 3, 8, 40])
def test_2bit_matches_pallas_qsplit(B, out_f, in_f, layout, monkeypatch):
    _, jq, tq = _pair(GGMLType.Q2_K, out_f, in_f, B, layout, monkeypatch)
    assert _layout_of(tq) == layout
    calls = _spy(monkeypatch)
    _compare(jq, tq, B, B + 1, qm.NAME_2BIT)
    assert calls == ["qsplit"]


@pytest.mark.parametrize("gtype,layout", [
    (GGMLType.Q3_K, "flat"), (GGMLType.Q3_K, "compact"), (GGMLType.Q3_K, "mixed"),
    (GGMLType.Q4_K, "compact"), (GGMLType.Q4_K, "mixed")],
    ids=lambda v: v.name if isinstance(v, GGMLType) else v)
@pytest.mark.parametrize("B", [1, 3, 40])
def test_4bit_layouts_match_pallas_fsplit(B, gtype, layout, monkeypatch):
    _, jq, tq = _pair(gtype, 256, 512, B, layout, monkeypatch)
    calls = _spy(monkeypatch)
    _compare(jq, tq, B, B + 2, qm.NAME_4BIT)
    assert calls == ["fsplit"]


@pytest.mark.parametrize("sub", [32, 8])
@pytest.mark.parametrize("B", [1, 8])
def test_2bit_iq1_geometry(B, sub, monkeypatch):
    """IQ1 trit codes (bias 1) at sub-block sizes 32 and 8 in the flat
    layout, built from arrays, through the JAX qsplit kernel and the port."""
    out_f, in_f = 128, 512
    nsub = in_f // sub
    rng = np.random.default_rng(B + sub)
    arrs = {"codes": rng.integers(0, 256, (out_f, in_f // 4), dtype=np.uint8),
            "d": (rng.random((out_f, nsub)) * 0.02 + 1e-3).astype(np.float32),
            "dmin": ((rng.random((out_f, nsub)) - 0.5) * 0.01).astype(np.float32)}
    meta = dict(fmt="iq1_s", bits=2, sub_size=sub, d_size=sub, code_bias=1,
                out_features=out_f, in_features=in_f)
    jq = jlinear.QuantLinear(codes=jnp.asarray(arrs["codes"]), d=jnp.asarray(arrs["d"]),
                             sc=None, dmin=jnp.asarray(arrs["dmin"]), mn=None, **meta)
    tq = tlinear.QuantLinear(codes=torch.from_numpy(arrs["codes"]),
                             d=torch.from_numpy(arrs["d"]), sc=None,
                             dmin=torch.from_numpy(arrs["dmin"]), mn=None, **meta)
    assert np.array_equal(tq.dequantize(torch.float32).numpy(),
                          np.asarray(jq.dequantize(jnp.float32)))
    calls = _spy(monkeypatch)
    _compare(jq, tq, B, B + 3, qm.NAME_2BIT)
    assert calls == ["qsplit"]


def test_2bit_geometry_the_kernel_does_not_take(monkeypatch):
    """in_features 256 is no multiple of 512, so the qsplit kernel does not
    take it: both packages send it to the base body's 2-bit branch."""
    _, jq, tq = _pair(GGMLType.Q2_K, 64, 256, 0, "flat", monkeypatch)
    assert qm.select_kernel(tq) == "base"
    calls = []
    real = jpm._quant_matmul_2d
    monkeypatch.setattr(jpm, "_quant_matmul_2d",
                        lambda *a, **k: calls.append("base") or real(*a, **k))
    _compare(jq, tq, 3, 4, qm.NAME_LOWBIT_BASE)
    assert calls == ["base"]


def test_lowbit_wrapper_checks(monkeypatch):
    _, _, tq = _pair(GGMLType.Q2_K, 64, 512, 0, "mixed", monkeypatch)
    x = torch.zeros(2, 512, dtype=torch.bfloat16)
    xsum = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="mixed layout takes no code bias"):
        qm.quant_matmul_2bit(x, xsum, tq.codes, tq.d, tq.sc, tq.dmin, tq.mn, 1)
    with pytest.raises(ValueError, match="shape"):
        qm.quant_matmul_2bit(x, torch.zeros(2, 16), tq.codes, tq.d, tq.sc, tq.dmin, tq.mn)
    with pytest.raises(ValueError, match="codes has shape"):
        qm.quant_matmul_4bit(x, xsum, tq.codes, tq.d, tq.sc, tq.dmin, tq.mn)
