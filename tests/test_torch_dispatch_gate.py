"""The port's dispatcher gate against the JAX package's, on the CPU.

``pallas_quant_matmul`` sends three cases to ``matmul_xla`` before it picks
a Pallas body: no out-tile fits (``_pick_tile``), ``in % 128 != 0``, and more
than ``LGT_MM_MAX_B`` activation rows whose ``B·in·2`` bytes pass
``LGT_MM_X_VMEM``. ``select_kernel(w, B)`` must make the same choice, read
from the same knobs per call. A spy records which JAX body ran; the bodies
and ``matmul_xla`` are replaced by zeros of the right shape, since only the
choice is compared here (the numbers of each body are held elsewhere).

``dequant_matmul``, the port's ``matmul_xla``, is held to the real
``matmul_xla`` on the CPU: both dequantize to the same bf16 weights
(bit-exact, ``test_torch_quant_formats.py``) and sum exact f32 products of
bf16 values; only the order of the f32 sums differs, so the outputs agree to
2e-5 of their scale.
"""

import types

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
from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
from llama_gguf_inference_tpu_torch.quant import repack as trepack

torch.set_num_threads(1)

KQUANTS = [GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K]
KNOBS = ("LGT_MM_MAX_B", "LGT_MM_X_VMEM", "LGT_MM_TO", "LGT_MM_VMEM_BUDGET", "LGT_MM_VARIANT")


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _pair(gtype, out_f, in_f, seed=0):
    x = np.random.default_rng(seed).normal(size=(out_f, in_f)).astype(np.float32)
    raw = jref.quantize(x, gtype)
    return (jrepack.to_quant_linear(jrepack.repack(raw, gtype, out_f, in_f)),
            trepack.to_quant_linear(trepack.repack(raw, gtype, out_f, in_f), "cpu"))


@pytest.fixture
def jax_choice(monkeypatch):
    """``choice(jq, B)``: the body the JAX dispatcher picks for B rows, in
    the port's names (``matmul_xla`` is ``dequant``)."""
    calls = []
    for name, tag in (("_quant_matmul_2d", "base"), ("_quant_matmul_2d_int8", "int8"),
                      ("_quant_matmul_2d_xsum", None)):
        def fn(*a, _tag=tag, **k):
            calls.append(_tag or k.get("kern", "xsum"))
            shapes = k["shapes"]
            return jnp.zeros((shapes[0], shapes[2]), jnp.float32)
        monkeypatch.setattr(jpm, name, fn)

    def xla(self, x, out_dtype=None):
        calls.append("dequant")
        return jnp.zeros((*x.shape[:-1], self.out_features), out_dtype or x.dtype)
    monkeypatch.setattr(jlinear.QuantLinear, "matmul_xla", xla)

    def choice(jq, B):
        before = len(calls)
        jpm.pallas_quant_matmul(jq, jnp.zeros((B, jq.in_features), jnp.bfloat16))
        assert len(calls) == before + 1
        return calls[-1]
    return choice


@pytest.mark.parametrize("B", [64, 65])
@pytest.mark.parametrize("gtype", KQUANTS, ids=lambda t: t.name)
def test_rows_past_max_b_gate(gtype, B, jax_choice, monkeypatch):
    """Around LGT_MM_MAX_B: with LGT_MM_X_VMEM at 64 rows' bytes, 64 rows
    stay on the kernel and 65 leave it; with the default budget both stay;
    with LGT_MM_MAX_B and the budget lowered to 63 rows, 64 rows leave too."""
    jq, tq = _pair(gtype, 128, 512)
    want = jax_choice(jq, B)
    assert want != "dequant"
    assert qm.select_kernel(tq, B) == want
    monkeypatch.setenv("LGT_MM_X_VMEM", str(64 * 512 * 2))
    want = jax_choice(jq, B)
    assert want == ("dequant" if B == 65 else qm.select_kernel(tq, 1))
    assert qm.select_kernel(tq, B) == want
    monkeypatch.setenv("LGT_MM_MAX_B", "63")
    monkeypatch.setenv("LGT_MM_X_VMEM", str(63 * 512 * 2))
    assert jax_choice(jq, B) == qm.select_kernel(tq, B) == "dequant"


@pytest.mark.parametrize("x_vmem,gated", [(None, False), (128 * 256 * 2, False),
                                          (128 * 256 * 2 - 1, True)])
@pytest.mark.parametrize("gtype", KQUANTS, ids=lambda t: t.name)
def test_activation_bytes_gate(gtype, x_vmem, gated, jax_choice, monkeypatch):
    """LGT_MM_X_VMEM shrunk until a small prefill (128 rows x 256) crosses
    it: the gate compares B·in·2 against it strictly."""
    if x_vmem is not None:
        monkeypatch.setenv("LGT_MM_X_VMEM", str(x_vmem))
    jq, tq = _pair(gtype, 128, 256)
    want = jax_choice(jq, 128)
    assert (want == "dequant") == gated
    assert qm.select_kernel(tq, 128) == want


@pytest.mark.parametrize("gtype,in_f", [(GGMLType.Q8_0, 96), (GGMLType.Q4_0, 160),
                                        (GGMLType.Q5_1, 224), (GGMLType.Q8_0, 256)],
                         ids=str)
def test_in_not_multiple_of_128(gtype, in_f, jax_choice):
    """in % 128 != 0 leaves the kernels at any row count (block-32 formats;
    every K-quant row is a multiple of 256)."""
    jq, tq = _pair(gtype, 64, in_f)
    for B in (1, 5):
        want = jax_choice(jq, B)
        assert (want == "dequant") == (in_f % 128 != 0)
        assert qm.select_kernel(tq, B) == want


@pytest.mark.parametrize("out_f,env", [(600, {}), (100, {}), (1024, {}),
                                       (1024, {"LGT_MM_VMEM_BUDGET": "1000"}),
                                       (600, {"LGT_MM_TO": "200"}),
                                       (768, {"LGT_MM_TO": "384"})], ids=str)
@pytest.mark.parametrize("gtype", KQUANTS, ids=lambda t: t.name)
def test_out_tile_gate(gtype, out_f, env, jax_choice, monkeypatch):
    """An out with no fitting tile (over 512 and no multiple of 128, or no
    tile within the budget) leaves the kernels; under 128 the whole axis is
    a tile; LGT_MM_TO forces a tile that divides out."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jq, tq = _pair(gtype, out_f, 256)
    tile = jpm._pick_tile(out_f, 256, 256 * tq.bits // 8)
    assert qm.pick_tile(out_f, 256, 256 * tq.bits // 8) == tile
    want = jax_choice(jq, 3)
    assert (want == "dequant") == (tile == 0)
    assert qm.select_kernel(tq, 3) == want


@pytest.mark.parametrize("gtype", KQUANTS, ids=lambda t: t.name)
def test_prefill_down_projection_leaves_the_kernels(gtype, jax_choice):
    """512 rows x in 14336 (the 8B's ffn_down in a full prefill chunk): the
    JAX package takes matmul_xla, and so does the port; 219 rows stay."""
    jq, tq = _pair(gtype, 128, 14336)
    assert jax_choice(jq, 512) == qm.select_kernel(tq, 512) == "dequant"
    want = jax_choice(jq, 219)
    assert want != "dequant" and qm.select_kernel(tq, 219) == want


# the 8B's projections and head: (out, in)
SERVED = {"qkv": (6144, 4096), "o": (4096, 4096), "gate_up": (28672, 4096),
          "down": (4096, 14336), "head": (128256, 4096)}


@pytest.mark.parametrize("fmt,bits,sub", [("q4_k", 4, 32), ("q5_k", 8, 32), ("q6_k", 8, 16),
                                          ("q2_k", 2, 16)], ids=str)
@pytest.mark.parametrize("name", SERVED)
def test_served_shapes(name, fmt, bits, sub):
    """Existing callers (B left at 1) keep their body at every 8B shape, as
    do decode and prefill buckets below 220 rows; ffn_down alone leaves the
    kernels, from 220 rows up (220·14336·2 > 6 MiB)."""
    out_f, in_f = SERVED[name]
    w = types.SimpleNamespace(fmt=fmt, bits=bits, sub_size=sub, d_size=256, min_size=0,
                              in_features=in_f, out_features=out_f)
    body = qm.select_kernel(w)
    assert body != "dequant"
    for B in (1, 4, 16, 64, 219, 220, 256, 512):
        want = "dequant" if in_f == 14336 and B >= 220 else body
        assert qm.select_kernel(w, B) == want


@pytest.mark.parametrize("B", [1, 70])
@pytest.mark.parametrize("gtype", KQUANTS + [GGMLType.Q8_0], ids=lambda t: t.name)
def test_dequant_matmul_matches_matmul_xla(gtype, B):
    """The port's dequantize path against ``matmul_xla``, and the dispatcher
    through it where the gate sends a call (counted under its name)."""
    jq, tq = _pair(gtype, 96, 512, seed=B)
    x = np.random.default_rng(B + 1).normal(size=(B, 512)).astype(np.float32)
    want = np.asarray(jq.matmul_xla(jnp.asarray(x, jnp.bfloat16), jnp.float32))
    got = qm.dequant_matmul(tq, torch.from_numpy(x).bfloat16(), torch.float32).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-5 * scale
    before = _build.LAUNCHES.get(qm.NAME_DEQUANT, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGT_MM_MAX_B", "0")
        mp.setenv("LGT_MM_X_VMEM", "0")
        y = tq.matmul(torch.from_numpy(x).bfloat16(), out_dtype=torch.float32).numpy()
    assert _build.LAUNCHES[qm.NAME_DEQUANT] == before + 1
    np.testing.assert_array_equal(y, got)


def test_tc_wrapper_rejects_geometry():
    """The tensor-core 8-bit wrapper raises on in % 64 != 0 or in/sub not a
    multiple of 64, before it looks at the device; the dispatching wrapper
    keeps such a geometry on the decode kernel."""
    g = torch.Generator().manual_seed(0)
    for in_f, sub in ((1040, 16), (1536, 32)):
        codes = torch.randint(-128, 128, (8, in_f), generator=g, dtype=torch.int32).to(torch.int8)
        d = torch.rand(8, in_f // sub, generator=g)
        x = torch.randn(64, in_f, generator=g).bfloat16()
        assert not qm.tc_takes(in_f, sub)
        with pytest.raises(ValueError, match="tensor-core"):
            qm.quant_matmul_8bit_tc(x, codes, d, None, sub, 0)
        torch.testing.assert_close(qm.quant_matmul_8bit(x, codes, d, None, sub, 0),
                                   qm.quant_matmul_8bit_plain(x, codes, d, None, sub, 0))
    assert qm.tc_takes(4096, 32) and qm.tc_takes(14336, 32) and qm.tc_takes(4096, 16)


def test_profile_names_the_tensor_core_kernel():
    """tools/profile.py books the tensor-core instances under their launch
    names, by the min side (the second template argument)."""
    from llama_gguf_inference_tpu_torch.tools import profile
    assert profile._kernel_group(
        "void quant_matmul_8bit_tc_kernel<2, 2, 128>(ArgsTC)") == qm.NAME_8BIT_MIN_TC
    assert profile._kernel_group(
        "void quant_matmul_8bit_tc_kernel<1, 0, 64>(ArgsTC)") == qm.NAME_8BIT_TC
    assert profile._kernel_group("quant_matmul_8bit_kernel<2, 2>(Args8)") == qm.NAME_8BIT_MIN


# the 2/4-bit tensor-core kernel's geometries: (bits, in, nsub, nd, ndm)
LOWBIT_TC_GEOMETRIES = {
    "q4_k flat 4096": (4, 4096, 128, 128, 128), "q4_k compact 4096": (4, 4096, 128, 16, 16),
    "q4_k mixed 14336": (4, 14336, 448, 448, 56), "q3_k flat 4096": (4, 4096, 256, 256, 256),
    "q3_k compact 14336": (4, 14336, 896, 56, 56), "q2_k mixed 4096": (2, 4096, 256, 256, 16),
    "q2_k compact 14336": (2, 14336, 896, 56, 56), "q2_k flat 4096": (2, 4096, 256, 256, 256)}
LOWBIT_TC_REFUSED = {
    "nsub 48": (4, 1536, 48, 48, 48), "in % 64": (4, 2080, 65, 65, 65),
    "2-bit sub 2": (2, 128, 64, 64, 64), "nd % 4": (4, 2048, 64, 2, 2),
    "nd not dividing nsub": (4, 4096, 128, 12, 12), "ndm not dividing nsub": (2, 4096, 256, 256, 24)}


@pytest.mark.parametrize("name", LOWBIT_TC_GEOMETRIES)
def test_lowbit_tc_takes_the_served_geometries(name):
    """Every 2/4-bit layout the served 8B models and the smoke's kernels
    phase use, at in 4096 and 14336, fits the tensor-core kernel."""
    assert qm.lowbit_tc_takes(*LOWBIT_TC_GEOMETRIES[name])


@pytest.mark.parametrize("name", LOWBIT_TC_REFUSED)
def test_lowbit_tc_refuses_geometry(name):
    """A geometry the tensor-core kernel does not take stays on the decode
    kernel at any row count, and its wrapper raises before any launch."""
    bits, in_f, nsub, nd, ndm = LOWBIT_TC_REFUSED[name]
    assert not qm.lowbit_tc_takes(bits, in_f, nsub, nd, ndm)
    if in_f % nsub or nsub % nd or nsub % ndm or in_f % (16 * 8 // bits) \
            or (in_f * bits // 8) % nsub:
        return                                   # the arrays cannot be formed
    g = torch.Generator().manual_seed(in_f)
    codes = torch.randint(0, 256, (8, in_f * bits // 8), generator=g, dtype=torch.uint8)
    sc = torch.randint(0, 64, (8, nsub), generator=g, dtype=torch.int32).to(torch.uint8) \
        if nd != nsub else None
    d, dmin = torch.rand(8, nd, generator=g), torch.rand(8, ndm, generator=g)
    mn = torch.randint(0, 64, (8, nsub), generator=g, dtype=torch.int32).to(torch.uint8) \
        if ndm != nsub else None
    x = torch.randn(64, in_f, generator=g).bfloat16()
    args = (x, qm._block_sums(x, in_f // nsub), codes, d, sc, dmin, mn)
    with pytest.raises(ValueError, match="tensor-core"):
        getattr(qm, f"quant_matmul_{bits}bit_tc")(*args)


@pytest.fixture
def on_card_spies(monkeypatch):
    """The 2/4-bit dispatch as on the card: ``_on_card`` answers True, the
    tensor-core and decode wrappers record their calls and return the plain
    versions."""
    calls = []
    monkeypatch.setattr(qm, "_on_card", lambda t: True)
    for bits in (2, 4):
        plain = getattr(qm, f"quant_matmul_{bits}bit_plain")
        for kind in ("tc", "decode"):
            def fn(*a, _tag=f"{bits}bit_{kind}", _plain=plain):
                calls.append(_tag)
                return _plain(*a)
            monkeypatch.setattr(qm, f"quant_matmul_{bits}bit_{kind}", fn)
    return calls


@pytest.mark.parametrize("bits", [2, 4])
def test_lowbit_rows_threshold(bits, on_card_spies):
    """Below LOWBIT_TC_MIN_ROWS rows the decode kernel, from it up (512
    included) the tensor-core kernel; on the CPU the wrapper takes neither."""
    sub = 16 if bits == 2 else 32
    g = torch.Generator().manual_seed(bits)
    codes = torch.randint(0, 256, (8, 128 * sub * bits // 8), generator=g, dtype=torch.uint8)
    d = torch.rand(8, 128, generator=g)
    for B, want in ((1, "decode"), (qm.LOWBIT_TC_MIN_ROWS - 1, "decode"),
                    (qm.LOWBIT_TC_MIN_ROWS, "tc"), (512, "tc")):
        x = torch.randn(B, 128 * sub, generator=g).bfloat16()
        on_card_spies.clear()
        getattr(qm, f"quant_matmul_{bits}bit")(x, qm._block_sums(x, sub), codes, d, None, d,
                                                None)
        assert on_card_spies == [f"{bits}bit_{want}"]


@pytest.mark.parametrize("has_min", [False, True])
def test_8bit_rows_threshold(has_min, monkeypatch):
    """The 8-bit dispatch as on the card (``_on_card`` answers True): below
    TC_MIN_ROWS rows the decode kernel, from it up (512 included) the
    tensor-core kernel; a geometry the tensor-core kernel does not take
    (nsub 48) keeps the decode kernel at any row count."""
    calls = []
    monkeypatch.setattr(qm, "_on_card", lambda t: True)
    for kind in ("tc", "decode"):
        def fn(*a, _tag=kind):
            calls.append(_tag)
            return qm.quant_matmul_8bit_plain(*a)
        monkeypatch.setattr(qm, f"quant_matmul_8bit_{kind}", fn)
    g = torch.Generator().manual_seed(int(has_min))
    for in_f, B, want in ((2048, 1, "decode"), (2048, qm.TC_MIN_ROWS - 1, "decode"),
                          (2048, qm.TC_MIN_ROWS, "tc"), (2048, qm.TC_MIN_ROWS + 1, "tc"),
                          (2048, 512, "tc"), (1536, 512, "decode")):
        nsub = in_f // 32
        codes = torch.randint(-128, 128, (8, in_f), generator=g, dtype=torch.int32).to(torch.int8)
        d = torch.rand(8, nsub, generator=g)
        dmin = torch.rand(8, nsub, generator=g) if has_min else None
        x = torch.randn(B, in_f, generator=g).bfloat16()
        calls.clear()
        qm.quant_matmul_8bit(x, codes, d, None, 32, 0, dmin)
        assert calls == [want], (in_f, B)


@pytest.mark.parametrize("variant", ["fsplit", "xsum", "split", "base", "int8"])
@pytest.mark.parametrize("gtype", [GGMLType.Q4_K, GGMLType.Q2_K], ids=lambda t: t.name)
def test_variants_never_reach_the_lowbit_tc_kernel(gtype, variant, on_card_spies, monkeypatch):
    """512 prefill rows through the dispatcher under each LGT_MM_VARIANT: only
    the fsplit/qsplit body reaches the fsplit rule's tensor-core kernel;
    xsum, split, base and int8 take their own tensor-core kernels
    (``test_torch_prefill_tc.py``) (Q2_K takes qsplit under every variant
    but base, as in the JAX package)."""
    monkeypatch.setenv("LGT_MM_VARIANT", variant)
    _, tq = _pair(gtype, 64, 2048)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(512, 2048)).astype(np.float32))
    body = qm.select_kernel(tq, 512)
    tq.matmul(x.bfloat16(), out_dtype=torch.float32)
    bits = tq.bits
    want = [f"{bits}bit_tc"] if body in ("fsplit", "qsplit") else []
    assert on_card_spies == want
    assert (body in ("fsplit", "qsplit")) == (variant != "base" if bits == 2 else variant == "fsplit")


def test_profile_names_the_lowbit_tensor_core_kernels():
    """tools/profile.py books the 2/4-bit tensor-core instances by their bit
    width (the first template argument)."""
    from llama_gguf_inference_tpu_torch.tools import profile
    assert profile._kernel_group(
        "void quant_matmul_lowbit_tc_kernel<4, 0, 1, 1>(ArgsLowTC)") == qm.NAME_4BIT_TC
    assert profile._kernel_group(
        "void quant_matmul_lowbit_tc_kernel<2, 0, 1, 2>(ArgsLowTC)") == qm.NAME_2BIT_TC


def test_profile_names_both_lowbit_decode_instances():
    """tools/profile.py books the 2/4-bit decode kernel's stepped and generic
    instances alike, by (bits, element rule)."""
    from llama_gguf_inference_tpu_torch.tools import profile
    assert profile._kernel_group(
        "void quant_matmul_lowbit_kernel<4, 0, 0, 1, 1>(LowbitArgs, PlanLb)") == qm.NAME_4BIT
    assert profile._kernel_group(
        "void quant_matmul_lowbit_generic<4, 1, 0, 1, 1>(LowbitArgs)") == qm.NAME_4BIT_XSUM
    assert profile._kernel_group(
        "void quant_matmul_lowbit_generic<2, 4, 0, 2, 2>(LowbitArgs)") == qm.NAME_LOWBIT_BASE


def test_profile_names_the_xsum_split_and_flash_tensor_core_kernels(monkeypatch):
    """tools/profile.py books the xsum rule's tensor-core instances under the
    body that ran them (split runs xsum's instances), and the tensor-core
    flash kernel apart from the CUDA-core one."""
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.tools import profile
    name = "void quant_matmul_lowbit_tc_kernel<4, 1, 0, 1, 1>(ArgsLowTC)"
    monkeypatch.setenv("LGT_MM_VARIANT", "xsum")
    assert profile._kernel_group(name) == qm.NAME_4BIT_XSUM_TC
    monkeypatch.setenv("LGT_MM_VARIANT", "split")
    assert profile._kernel_group(name) == qm.NAME_4BIT_SPLIT_TC
    assert profile._kernel_group(
        "void flash_attention_tc_kernel<128, 0, false>(FArgs)") == fa.NAME_TC
    assert profile._kernel_group(
        "void flash_attention_kernel<128, 1, true>(Args)") == fa.NAME


def test_profile_names_the_flash_kernels_of_every_cache():
    """tools/profile.py books the split decode kernel's instances (every
    cache kind, D 256 too, the merge in the same launch) as the CUDA-core
    flash kernel and the tensor-core instances of q4_0 and q4_1 as the
    tensor-core one, so decode and prefill flash time stay in their
    columns."""
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.tools import profile
    for kind in range(4):
        assert profile._kernel_group(
            f"void (anonymous namespace)::flash_attention_kernel<256, {kind}, false>(Args)"
        ) == fa.NAME
        assert profile._kernel_group(
            f"void flash_attention_tc_kernel<128, {kind}, false>(FArgs)") == fa.NAME_TC
    assert profile._kernel_group("void flash_attention_kernel<64, 1, true>(Args)") == fa.NAME


def test_profile_names_the_prefill_kernels_of_the_variants():
    """tools/profile.py books the base rules' tensor-core instances by (bits,
    element rule) and the int8 body's tensor-core kernel apart from its
    decode kernel."""
    from llama_gguf_inference_tpu_torch.tools import profile
    assert profile._kernel_group(
        "void quant_matmul_lowbit_tc_kernel<4, 3, 0, 1, 1>(ArgsLowTC)") == qm.NAME_4BIT_BASE_TC
    assert profile._kernel_group(
        "void quant_matmul_lowbit_tc_kernel<2, 4, 0, 1, 1>(ArgsLowTC)") == qm.NAME_LOWBIT_BASE_TC
    assert profile._kernel_group(
        "void quant_matmul_lowbit_tc_kernel<4, 4, 1, 2, 0>(ArgsLowTC)") == qm.NAME_LOWBIT_BASE_TC
    assert profile._kernel_group(
        "void quant_matmul_int8_tc_kernel<32, 1, 1>(ArgsInt8TC)") == qm.NAME_4BIT_INT8_TC
    assert profile._kernel_group(
        "void quant_matmul_int8_kernel<1, 1>(Int8Args)") == qm.NAME_4BIT_INT8
