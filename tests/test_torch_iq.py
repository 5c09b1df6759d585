"""The port's grid-codebook formats (IQ1_S, IQ1_M, IQ2_XXS, IQ2_XS, IQ2_S,
IQ3_XXS, IQ3_S) against the JAX package on the CPU.

Codecs and repacks are bit-exact: integer shuffles and the same IEEE f32
products in both packages (every split of a wire scale is a power-of-two
factorization), in every ``LGT_SCALE_LAYOUT`` mode and both
``LGT_IQ_CODES`` layouts (int8 values, packed4 mapped codes). The matmul
holds the port's plain version against the JAX package's Pallas kernel in
interpret mode to 2e-5 of the output's scale: the same bf16 weights and
activations summed in another f32 order. The grids are the synthesized
stand-ins in both packages (``LGT_IQ_GRID_FILE`` unset), the same tables.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.gguf.constants import GGMLType as JGGMLType
from llama_gguf_inference_tpu.ops import pallas_matmul as jpm
from llama_gguf_inference_tpu.quant import iq_ref as jiq
from llama_gguf_inference_tpu.quant import numpy_ref as jref
from llama_gguf_inference_tpu.quant import repack as jrepack
from llama_gguf_inference_tpu.utils.testing import write_tiny_llama
from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.quant import iq_grids as tgrids
from llama_gguf_inference_tpu_torch.quant import iq_ref as tiq
from llama_gguf_inference_tpu_torch.quant import numpy_ref as tref
from llama_gguf_inference_tpu_torch.quant import repack as trepack
from llama_gguf_inference_tpu_torch.runtime import loader

torch.set_num_threads(1)

IQ = [GGMLType.IQ1_S, GGMLType.IQ1_M, GGMLType.IQ2_XXS, GGMLType.IQ2_XS,
      GGMLType.IQ2_S, GGMLType.IQ3_XXS, GGMLType.IQ3_S]
IQ23 = [t for t in IQ if t not in (GGMLType.IQ1_S, GGMLType.IQ1_M)]
LAYOUTS = ["auto", "flat", "compact", "mixed"]
CODES = ["int8", "packed4"]
FIELDS = ("codes", "d", "sc", "dmin", "mn")
STATIC = ("fmt", "bits", "sub_size", "d_size", "code_bias", "out_features",
          "in_features", "min_size")


@pytest.fixture(autouse=True)
def _stand_in_grids(monkeypatch):
    monkeypatch.delenv("LGT_IQ_GRID_FILE", raising=False)


def _x(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x.reshape(-1)[:256] = 0.0                                # an all-zero block
    x.reshape(-1)[256:512] = np.abs(x.reshape(-1)[256:512])  # no negative values
    return x


_RAW: dict = {}


def _raw(gtype, out_f, in_f, seed):
    key = (gtype, out_f, in_f, seed)
    if key not in _RAW:
        _RAW[key] = jref.quantize(_x((out_f, in_f), seed), JGGMLType(int(gtype)))
    return _RAW[key]


def test_grids_and_signs_match():
    """The stand-in grids, the sign codebook and the deltas are the JAX
    package's."""
    from llama_gguf_inference_tpu.quant import iq_grids as jgrids
    for name in tgrids.GRID_SPECS:
        assert np.array_equal(tgrids.get_grid(name), jgrids.get_grid(name)), name
    assert np.array_equal(tgrids.KSIGNS, jgrids.KSIGNS)
    assert (tgrids.IQ1S_DELTA, tgrids.IQ1M_DELTA) == (jgrids.IQ1S_DELTA, jgrids.IQ1M_DELTA)
    assert tgrids.grids_are_synthetic()


@pytest.mark.parametrize("gtype", IQ, ids=lambda t: t.name)
def test_codec_bit_exact(gtype):
    """quantize and dequantize through the port's numpy_ref dispatch against
    the JAX package's iq_ref, and its own iq_ref tables against the JAX
    ones."""
    x = _x((8, 1024), 7)
    raw = jref.quantize(x, JGGMLType(int(gtype)))
    assert tref.quantize(x, gtype) == raw
    assert tiq.IQ_QUANT[gtype](x.reshape(-1)).tobytes() == raw
    blocks = np.frombuffer(raw, np.uint8).reshape(x.size // 256, -1)
    want = jiq.IQ_DEQUANT[JGGMLType(int(gtype))](blocks).reshape(-1)
    got = tref.dequantize(raw, gtype, x.size)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tiq.IQ_DEQUANT[gtype](blocks).reshape(-1), want)


@pytest.mark.parametrize("codes", CODES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("gtype", IQ, ids=lambda t: t.name)
def test_repack_bit_exact(gtype, layout, codes, monkeypatch):
    """The host arrays, the device arrays after the layout policy, and the
    dequantized values (logical and block-minor order) in every scale layout
    and both IQ code layouts."""
    monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
    monkeypatch.setenv("LGT_IQ_CODES", codes)
    out_f, in_f = 16, 768
    raw = _raw(gtype, out_f, in_f, 1)
    jt = JGGMLType(int(gtype))
    jr = jrepack.repack(raw, jt, out_f, in_f)
    tr = trepack.repack(raw, gtype, out_f, in_f)
    jq = jrepack.to_quant_linear(jr)
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
    iq1 = gtype in (GGMLType.IQ1_S, GGMLType.IQ1_M)
    assert tq.bits == (2 if iq1 else 4 if codes == "packed4" else 8)
    assert tq.code_bias == (1 if iq1 else 0)
    golden = jref.dequantize(raw, jt, out_f * in_f).reshape(out_f, in_f)
    assert np.array_equal(tq.dequantize(torch.float32).numpy(), golden)
    jbm = np.asarray(jq.dequantize_bm(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(tq.dequantize_bm().float().numpy(), jbm)


@pytest.mark.parametrize("codes", CODES)
@pytest.mark.parametrize("gtype", IQ, ids=lambda t: t.name)
def test_matmul_matches_jax(gtype, codes, monkeypatch):
    """``QuantLinear.matmul`` on CPU tensors (the plain version of the
    kernel the format's bits select) against the JAX package's
    ``pallas_quant_matmul`` at 1 and 5 rows."""
    monkeypatch.setenv("LGT_IQ_CODES", codes)
    out_f, in_f = 64, 512
    raw = _raw(gtype, out_f, in_f, 2)
    jq = jrepack.to_quant_linear(jrepack.repack(raw, JGGMLType(int(gtype)), out_f, in_f))
    tq = trepack.to_quant_linear(trepack.repack(raw, gtype, out_f, in_f), "cpu")
    for B in (1, 5):
        x = np.random.default_rng(B).normal(size=(B, in_f)).astype(np.float32)
        want = np.asarray(jpm.pallas_quant_matmul(jq, jnp.asarray(x, jnp.bfloat16),
                                                  out_dtype=jnp.float32))
        before = sum(n for k, n in _build.LAUNCHES.items() if k.endswith(".plain"))
        got = tq.matmul(torch.from_numpy(x).bfloat16(), out_dtype=torch.float32).numpy()
        assert sum(n for k, n in _build.LAUNCHES.items() if k.endswith(".plain")) > before
        assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def test_unknown_iq_codes_mode_is_int8(monkeypatch):
    """Any ``LGT_IQ_CODES`` other than packed4 stores the int8 values, as
    in the JAX package."""
    raw = _raw(GGMLType.IQ3_S, 8, 256, 3)
    monkeypatch.setenv("LGT_IQ_CODES", "int8")
    a = trepack.repack(raw, GGMLType.IQ3_S, 8, 256)
    monkeypatch.setenv("LGT_IQ_CODES", "bogus")
    b = trepack.repack(raw, GGMLType.IQ3_S, 8, 256)
    assert a.bits == b.bits == 8 and np.array_equal(a.codes, b.codes)


@pytest.mark.parametrize("codes", CODES)
@pytest.mark.parametrize("gtype", [GGMLType.IQ2_XS, GGMLType.IQ1_M], ids=lambda t: t.name)
def test_layout_cache_round_trip(gtype, codes, tmp_path, monkeypatch):
    """A tiny model with IQ projections loads cold into a fresh layout cache
    and warm from it: every projection served from the cache, every tensor
    equal to the cold load's; the cache's key tells the two code layouts
    apart; the model's logits match the JAX package's dense load."""
    from llama_gguf_inference_tpu.models.llama import KVCache as JKV
    from llama_gguf_inference_tpu.models.llama import forward as jforward
    from llama_gguf_inference_tpu.runtime.loader import load_model as jload
    from llama_gguf_inference_tpu_torch.models.llama import KVCache, forward
    monkeypatch.delenv("LGT_LAYOUT_CACHE", raising=False)
    monkeypatch.setenv("LGT_LAYOUT_CACHE_DIR", str(tmp_path / "lc"))
    monkeypatch.setenv("LGT_IQ_CODES", codes)
    path = write_tiny_llama(tmp_path / "m.gguf", dim=256, n_layers=1, n_heads=4,
                            n_kv_heads=2, ffn_dim=256, quant=JGGMLType(int(gtype)), seed=4)
    cold, warm = {}, {}
    _, p0, r = loader.load_model(path, device="cpu", stats=cold)
    r.close()
    cfg, p1, r = loader.load_model(path, device="cpu", stats=warm)
    r.close()
    # seven projections and the head; the embedding is F32
    assert cold["repacked_numpy"] == 8 and cold["cache_hits"] == 0
    assert warm["cache_hits"] == 8 and warm["repacked_numpy"] == 0
    assert _leaves(p0) and all(torch.equal(a, b) for a, b in zip(_leaves(p0), _leaves(p1)))
    other = "int8" if codes == "packed4" else "packed4"
    monkeypatch.setenv("LGT_IQ_CODES", other)
    again = {}
    loader.load_model(path, device="cpu", stats=again)[2].close()
    assert again["cache_hits"] == 0
    monkeypatch.setenv("LGT_IQ_CODES", codes)

    ids = np.array([[1, 5, 9, 200, 17, 3]], np.int32)
    jcfg, jp, jr = jload(path, mode="dense")
    jr.close()
    want, _ = jforward(jp, jcfg, jnp.asarray(ids), jnp.zeros(1, jnp.int32),
                       JKV.zeros(jcfg, 1, 16), jnp.full(1, ids.shape[1], jnp.int32))
    got = forward(p1, cfg, torch.from_numpy(ids), torch.zeros(1, dtype=torch.int32),
                  KVCache.zeros(cfg, 1, 16, "cpu"))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 0.02 * np.abs(want).max()


def _leaves(node, out=None):
    out = [] if out is None else out
    if isinstance(node, torch.Tensor):
        out.append(node)
    elif isinstance(node, dict):
        for k in sorted(node):
            _leaves(node[k], out)
    elif isinstance(node, list):
        for v in node:
            _leaves(v, out)
    elif hasattr(node, "__dataclass_fields__"):
        for f in node.__dataclass_fields__:
            _leaves(getattr(node, f), out)
    return out
