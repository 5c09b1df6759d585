"""The port's dispatcher and the plain versions of every remaining Pallas
matmul body against the JAX package, on the CPU, under each
``LGT_MM_VARIANT``: the JAX bodies run in interpret mode through
``pallas_quant_matmul``, and a spy records which one ran.

Tolerance: both sides round the same dequantized weights to bf16 at the same
points and accumulate in f32 (the int8 body's integer dots are exact on both
sides); only the order of the f32 sums differs, so outputs agree to 2e-5 of
their scale. The base body's 4-bit branch rounds its weight twice, bf16(q·s)
and then bf16(that − m′): XLA on the CPU keeps no excess precision between
the multiply and the subtract there (a single rounding differs from the
interpret-mode kernel by 3.5e-3 of the output's scale on a Q4_K weight,
measured), so the port rounds twice as well and is held to the same 2e-5.
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
from llama_gguf_inference_tpu_torch.quant import repack as trepack

torch.set_num_threads(1)

# the port's launch name for each body the JAX dispatcher can pick
PORT_NAME = {"fsplit": qm.NAME_4BIT, "xsum": qm.NAME_4BIT_XSUM, "split": qm.NAME_4BIT_SPLIT,
             "int8": qm.NAME_4BIT_INT8, "qsplit": qm.NAME_2BIT}


def _pair(gtype, out_f, in_f, seed, layout, monkeypatch):
    monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
    x = np.random.default_rng(seed).normal(size=(out_f, in_f)).astype(np.float32)
    raw = jref.quantize(x, gtype)
    return (jrepack.to_quant_linear(jrepack.repack(raw, gtype, out_f, in_f)),
            trepack.to_quant_linear(trepack.repack(raw, gtype, out_f, in_f), "cpu"))


@pytest.fixture
def spy(monkeypatch):
    """The JAX bodies that run: ``base``, ``int8``, a kern of the xsum
    family, or ``xla`` (``matmul_xla``)."""
    calls = []
    for name, tag in (("_quant_matmul_2d", "base"), ("_quant_matmul_2d_int8", "int8"),
                      ("_quant_matmul_2d_xsum", None)):
        real = getattr(jpm, name)

        def fn(*a, _real=real, _tag=tag, **k):
            calls.append(_tag or k.get("kern", "xsum"))
            return _real(*a, **k)
        monkeypatch.setattr(jpm, name, fn)
    real_xla = jlinear.QuantLinear.matmul_xla

    def xla(self, *a, **k):
        calls.append("xla")
        return real_xla(self, *a, **k)
    monkeypatch.setattr(jlinear.QuantLinear, "matmul_xla", xla)
    return calls


def _compare(jq, tq, B, seed, name, tol=2e-5):
    x = np.random.default_rng(seed).normal(size=(B, tq.in_features)).astype(np.float32)
    want = np.asarray(jpm.pallas_quant_matmul(jq, jnp.asarray(x, jnp.bfloat16),
                                              out_dtype=jnp.float32))
    key = name if name == qm.NAME_DEQUANT else name + ".plain"    # CPU tensors
    before = _build.LAUNCHES.get(key, 0)
    got = tq.matmul(torch.from_numpy(x).bfloat16(), out_dtype=torch.float32).numpy()
    assert _build.LAUNCHES.get(key, 0) == before + 1, key
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale


def _port_name(tq, kern):
    if kern == "base":
        if tq.bits == 8:
            return qm.NAME_8BIT if tq.dmin is None else qm.NAME_8BIT_MIN
        if tq.bits == 4 and tq.fmt not in tlinear.MAPPED_FMTS:
            return qm.NAME_4BIT_BASE
        return qm.NAME_LOWBIT_BASE
    if kern == "dequant":
        return qm.NAME_DEQUANT
    return PORT_NAME[kern]


@pytest.mark.parametrize("B", [1, 3, 8, 40])
@pytest.mark.parametrize("gtype,layout", [
    (GGMLType.Q4_K, "flat"), (GGMLType.Q4_K, "compact"), (GGMLType.Q4_0, "auto"),
    (GGMLType.Q4_1, "auto"), (GGMLType.Q3_K, "flat"), (GGMLType.Q3_K, "compact")],
    ids=lambda v: v.name if isinstance(v, GGMLType) else v)
@pytest.mark.parametrize("variant", ["base", "xsum", "split", "int8"])
def test_4bit_variants_match_pallas(variant, gtype, layout, B, spy, monkeypatch):
    monkeypatch.setenv("LGT_MM_VARIANT", variant)
    jq, tq = _pair(gtype, 256, 512, B, layout, monkeypatch)
    kern = qm.select_kernel(tq)
    assert kern == variant
    _compare(jq, tq, B, B + 1, _port_name(tq, kern))
    assert spy == [variant]


@pytest.mark.parametrize("variant", ["base", "int8", "xsum", "split", "fsplit"])
@pytest.mark.parametrize("gtype", [GGMLType.Q4_K, GGMLType.Q2_K], ids=lambda t: t.name)
def test_mixed_layout_follows_the_dispatcher(gtype, variant, spy, monkeypatch):
    """A mixed-layout weight under base or int8 leaves the kernels for the
    dequantize path (``matmul_xla`` in JAX), counted; otherwise it stays on
    its kernel (Q2_K keeps qsplit under every variant but base)."""
    monkeypatch.setenv("LGT_MM_VARIANT", variant)
    jq, tq = _pair(gtype, 128, 1024, 5, "mixed", monkeypatch)
    assert tq.min_size == 256
    kern = qm.select_kernel(tq)
    if variant == "base" or (variant == "int8" and gtype == GGMLType.Q4_K):
        assert kern == "dequant"
    else:
        assert kern == ("qsplit" if gtype == GGMLType.Q2_K else variant)
    _compare(jq, tq, 3, 6, _port_name(tq, kern))
    assert spy == ["xla" if kern == "dequant" else kern]


@pytest.mark.parametrize("B", [1, 3, 8, 40])
@pytest.mark.parametrize("gtype,layout", [
    (GGMLType.Q5_K, "auto"), (GGMLType.Q5_K, "flat"), (GGMLType.Q5_1, "auto"),
    (GGMLType.Q5_0, "auto"), (GGMLType.Q8_1, "auto"), (GGMLType.Q8_K, "auto"),
    (GGMLType.IQ4_NL, "auto"), (GGMLType.IQ4_XS, "auto")],
    ids=lambda v: v.name if isinstance(v, GGMLType) else v)
def test_8bit_formats_match_pallas_base(gtype, layout, B, spy, monkeypatch):
    """The 8-bit branch with its min term (Q5_K compact or flat, Q5_1) and
    the new symmetric formats, under the default variant."""
    monkeypatch.delenv("LGT_MM_VARIANT", raising=False)
    if gtype == GGMLType.Q8_1:
        from test_torch_quant_formats import _q8_1_raw
        monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
        raw = _q8_1_raw(128, 512, B)
        jq = jrepack.to_quant_linear(jrepack.repack(raw, gtype, 128, 512))
        tq = trepack.to_quant_linear(trepack.repack(raw, gtype, 128, 512), "cpu")
    else:
        jq, tq = _pair(gtype, 128, 512, B, layout, monkeypatch)
    assert qm.select_kernel(tq) == "base"
    _compare(jq, tq, B, B + 2, _port_name(tq, "base"))
    assert spy == ["base"]


@pytest.mark.parametrize("B", [1, 3, 8, 40])
@pytest.mark.parametrize("layout", ["flat", "compact"])
@pytest.mark.parametrize("in_f", [512, 1024])
def test_2bit_base_matches_pallas(in_f, layout, B, spy, monkeypatch):
    monkeypatch.setenv("LGT_MM_VARIANT", "base")
    jq, tq = _pair(GGMLType.Q2_K, 128, in_f, B, layout, monkeypatch)
    assert qm.select_kernel(tq) == "base"
    _compare(jq, tq, B, B + 3, qm.NAME_LOWBIT_BASE)
    assert spy == ["base"]


@pytest.mark.parametrize("gtype", [GGMLType.Q4_0, GGMLType.Q4_1], ids=lambda t: t.name)
@pytest.mark.parametrize("variant", ["fsplit", "int8"])
def test_geometry_outside_the_variants_takes_base(gtype, variant, spy, monkeypatch):
    """in/sub = 12 sub-blocks, no multiple of 8: every variant falls to the
    base body, as in the JAX dispatcher."""
    monkeypatch.setenv("LGT_MM_VARIANT", variant)
    jq, tq = _pair(gtype, 128, 384, 4, "auto", monkeypatch)
    assert qm.select_kernel(tq) == "base"
    _compare(jq, tq, 5, 7, qm.NAME_4BIT_BASE)
    assert spy == ["base"]


def _mapped(fmt, layout, seed):
    """IQ2/IQ3 4-bit sign|magnitude codes built as arrays (the port has no
    IQ repack yet): flat d per 32, or compact d per 256 times u8 sc per 32,
    no min."""
    out_f, in_f, sub = 128, 512, 32
    nsub = in_f // sub
    rng = np.random.default_rng(seed)
    arrs = {"codes": rng.integers(0, 256, (out_f, in_f // 2), dtype=np.uint8)}
    if layout == "flat":
        arrs["d"] = (rng.random((out_f, nsub)) * 2e-3 + 1e-4).astype(np.float32)
        arrs["sc"] = None
    else:
        arrs["d"] = (rng.random((out_f, in_f // 256)) * 2e-4 + 1e-5).astype(np.float32)
        arrs["sc"] = rng.integers(1, 32, (out_f, nsub), dtype=np.uint8)
    meta = dict(fmt=fmt, bits=4, sub_size=sub, d_size=sub if layout == "flat" else 256,
                code_bias=0, out_features=out_f, in_features=in_f)

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)
    jq = jlinear.QuantLinear(codes=j(arrs["codes"]), d=j(arrs["d"]), sc=j(arrs["sc"]),
                             dmin=None, mn=None, **meta)
    tq = tlinear.QuantLinear(codes=t(arrs["codes"]), d=t(arrs["d"]), sc=t(arrs["sc"]),
                             dmin=None, mn=None, **meta)
    return jq, tq


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("layout", ["flat", "compact"])
@pytest.mark.parametrize("fmt", ["iq2_xs", "iq3_s"])
@pytest.mark.parametrize("variant", ["fsplit", "xsum", "int8", "base"])
def test_mapped_codes_match_pallas(variant, fmt, layout, B, spy, monkeypatch):
    """Value-mapped codes force fsplit under every variant but base, which
    takes the base body's f32 branch; both decode through code_values."""
    monkeypatch.setenv("LGT_MM_VARIANT", variant)
    jq, tq = _mapped(fmt, layout, B)
    assert np.array_equal(tq.dequantize(torch.float32).numpy(),
                          np.asarray(jq.dequantize(jnp.float32)))
    kern = qm.select_kernel(tq)
    assert kern == ("base" if variant == "base" else "fsplit")
    _compare(jq, tq, B, B + 4, _port_name(tq, kern))
    assert spy == [kern]


def test_variant_is_read_per_call(monkeypatch):
    _, tq = _pair(GGMLType.Q4_K, 128, 512, 0, "flat", monkeypatch)
    for v in ("base", "xsum", "split", "fsplit", "int8"):
        monkeypatch.setenv("LGT_MM_VARIANT", v)
        assert qm.select_kernel(tq) == v
    monkeypatch.delenv("LGT_MM_VARIANT")
    assert qm.variant() == "fsplit" and qm.select_kernel(tq) == "fsplit"


def test_variant_wrapper_checks(monkeypatch):
    _, tq = _pair(GGMLType.Q4_K, 64, 512, 0, "mixed", monkeypatch)
    x = torch.zeros(2, 512, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no mixed layout"):
        qm.quant_matmul_4bit_base(x, tq.codes, tq.d, tq.sc, tq.dmin, tq.mn)
    xq, xs = qm.quantize_acts(x, 32)
    with pytest.raises(ValueError, match="no mixed layout"):
        qm.quant_matmul_4bit_int8(xq, xs, xs, tq.codes, tq.d, tq.sc, tq.dmin, tq.mn)
    with pytest.raises(ValueError, match="code map"):
        qm.quant_matmul_4bit_xsum(x, xs, tq.codes, tq.d, None, None, None, 0, "iq2_xs")


def test_profile_names_each_kernel():
    """``tools.profile`` books each CUDA kernel instance under its wrapper's
    launch name, from the template arguments (bits, element rule; the 8-bit
    kernel's min side)."""
    from llama_gguf_inference_tpu_torch.tools import profile
    lowbit = "void (anonymous namespace)::quant_matmul_lowbit_kernel<{}, {}, 0, 1, 1>(Args)"
    for (bits, var), name in ((2, 0), qm.NAME_2BIT), ((4, 0), qm.NAME_4BIT), \
            ((4, 1), qm.NAME_4BIT_XSUM), ((4, 2), qm.NAME_4BIT_SPLIT), \
            ((4, 3), qm.NAME_4BIT_BASE), ((2, 4), qm.NAME_LOWBIT_BASE):
        assert profile._kernel_group(lowbit.format(bits, var)) == name
    assert profile._kernel_group("quant_matmul_8bit_kernel<2, 2>(Args8)") == qm.NAME_8BIT_MIN
    assert profile._kernel_group("quant_matmul_8bit_kernel<3, 0>(Args8)") == qm.NAME_8BIT
    assert profile._kernel_group("quant_matmul_int8_kernel<1, 1>(Int8Args)") == qm.NAME_4BIT_INT8
    assert profile._kernel_group("void elementwise_kernel<128, 4>") == "other"
    assert set(profile.KERNELS) >= set(PORT_NAME.values())
