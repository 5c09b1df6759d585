"""The port's native (C++) repack of Q8_0, Q4_K and Q6_K against its numpy
path and the JAX package's native and numpy repacks, byte for byte, at the
shapes of ``tests/test_native_repack.py``; the library is built with g++
into a temporary ``LGT_NATIVE_BUILD_DIR``. A build that fails prints one
line naming the failure, counts no native repack, and the numpy path gives
the same bytes; ``LGT_NO_NATIVE`` does the same. ``repack`` takes the native
path for those three formats only.
"""

import numpy as np
import pytest

import llama_gguf_inference_tpu.native as jnative
from llama_gguf_inference_tpu.quant import repack as jrepack
from llama_gguf_inference_tpu_torch import native
from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
from llama_gguf_inference_tpu_torch.quant import repack as trepack
from llama_gguf_inference_tpu_torch.quant.numpy_ref import quantize

FORMATS = [GGMLType.Q8_0, GGMLType.Q4_K, GGMLType.Q6_K]
SHAPES = [(4, 512), (3, 1024), (128, 256)]
FIELDS = ("codes", "d", "sc", "dmin", "mn")
STATIC = ("fmt", "bits", "sub_size", "d_size", "code_bias", "out_features",
          "in_features", "min_size")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's library built afresh into a temporary directory."""
    mp = pytest.MonkeyPatch()
    build_dir = tmp_path_factory.mktemp("native_build")
    mp.setenv("LGT_NATIVE_BUILD_DIR", str(build_dir))
    mp.delenv("LGT_NO_NATIVE", raising=False)
    mp.setattr(native, "_LIB", None)
    mp.setattr(native, "_LIB_FAILED", False)
    lib = native.load_library()
    assert lib is not None
    yield build_dir
    mp.undo()


def _numpy_port(raw, gtype, o, i, mp):
    with mp.context() as m:
        m.setattr(native, "_LIB", None)
        m.setattr(native, "_LIB_FAILED", True)
        return trepack.repack(raw, gtype, o, i)


def _numpy_jax(raw, gtype, o, i, mp):
    with mp.context() as m:
        m.setattr(jnative, "_LIB", None)
        m.setattr(jnative, "_LIB_FAILED", True)
        return jrepack.repack(raw, gtype, o, i)


def _equal(a, b, what):
    for f in STATIC:
        assert getattr(a, f) == getattr(b, f), (what, f)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
            assert x.tobytes() == y.tobytes(), (what, f)


@pytest.mark.parametrize("gtype", FORMATS, ids=lambda t: t.name)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_native_equals_numpy_and_jax(built, gtype, shape, rng, monkeypatch):
    o, i = shape
    raw = np.frombuffer(quantize(rng.normal(size=(o, i)).astype(np.float32), gtype), np.uint8)
    native.reset_repacks()
    got = native.native_repack(raw, gtype.name.lower(), o, i)
    assert got is not None and native.REPACKS == {gtype.name.lower(): 1}
    via_repack = trepack.repack(raw, gtype, o, i)
    assert native.REPACKS == {gtype.name.lower(): 2}
    jax_native = jnative.native_repack(raw, gtype.name.lower(), o, i)
    assert jax_native is not None
    _equal(got, via_repack, "port repack")
    _equal(got, _numpy_port(raw, gtype, o, i, monkeypatch), "port numpy")
    _equal(got, jax_native, "jax native")
    _equal(got, _numpy_jax(raw, gtype, o, i, monkeypatch), "jax numpy")


@pytest.mark.parametrize("gtype", [GGMLType.Q4_0, GGMLType.Q2_K, GGMLType.Q5_K],
                         ids=lambda t: t.name)
def test_other_formats_stay_on_numpy(built, gtype, rng):
    raw = np.frombuffer(quantize(rng.normal(size=(8, 512)).astype(np.float32), gtype),
                        np.uint8)
    native.reset_repacks()
    assert native.native_repack(raw, gtype.name.lower(), 8, 512) is None
    trepack.repack(raw, gtype, 8, 512)
    assert native.REPACKS == {}


def test_short_input_is_left_to_numpy(built, rng):
    raw = np.frombuffer(quantize(rng.normal(size=(4, 256)).astype(np.float32),
                                 GGMLType.Q4_K), np.uint8)
    assert native.native_repack(raw[:-1], "q4_k", 4, 256) is None
    with pytest.raises(ValueError):
        trepack.repack(raw[:-1], GGMLType.Q4_K, 4, 256)


def test_failed_build_prints_and_counts_nothing(tmp_path, rng, monkeypatch, capsys):
    bad = tmp_path / "repack.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("LGT_NATIVE_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delenv("LGT_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_FAILED", False)
    native.reset_repacks()
    raw = np.frombuffer(quantize(rng.normal(size=(4, 512)).astype(np.float32),
                                 GGMLType.Q4_K), np.uint8)
    got = trepack.repack(raw, GGMLType.Q4_K, 4, 512)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[native]")]
    assert len(lines) == 1 and "repack library unavailable" in lines[0] \
        and "numpy" in lines[0], out
    assert native.REPACKS == {}
    # the failure is latched: no second build, no second line
    trepack.repack(raw, GGMLType.Q4_K, 4, 512)
    assert "[native]" not in capsys.readouterr().out
    _equal(got, _numpy_jax(raw, GGMLType.Q4_K, 4, 512, monkeypatch), "numpy fallback")


def test_no_native_env_prints_and_counts_nothing(rng, monkeypatch, capsys):
    monkeypatch.setenv("LGT_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_FAILED", False)
    native.reset_repacks()
    raw = np.frombuffer(quantize(rng.normal(size=(4, 256)).astype(np.float32),
                                 GGMLType.Q6_K), np.uint8)
    got = trepack.repack(raw, GGMLType.Q6_K, 4, 256)
    assert "LGT_NO_NATIVE" in capsys.readouterr().out
    assert native.REPACKS == {}
    _equal(got, _numpy_jax(raw, GGMLType.Q6_K, 4, 256, monkeypatch), "LGT_NO_NATIVE")
