"""The port's post-repack layout cache, on the CPU: the counterparts of
``tests/test_layout_cache.py``'s five tests, and the on-disk format shared
with the JAX package: a cache written by the JAX package's load is read by
the port (every tensor served from it, every array equal to the port's own
repack), and one written by the port is read by the JAX package (every
array equal to the JAX repack; its load writes nothing), for a Q4_K_M-style
(Q4_K with a Q6_K head) and a Q2_K model of the 160m widths at one layer.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.gguf.constants import GGMLType as JGGMLType
from llama_gguf_inference_tpu.quant import repack as jrepack
from llama_gguf_inference_tpu.runtime import layout_cache as jcache
from llama_gguf_inference_tpu.runtime.loader import load_model as jload
from llama_gguf_inference_tpu.utils.testing import write_tiny_llama
from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
from llama_gguf_inference_tpu_torch.gguf.reader import GGUFReader
from llama_gguf_inference_tpu_torch.quant import repack as trepack
from llama_gguf_inference_tpu_torch.quant.numpy_ref import quantize
from llama_gguf_inference_tpu_torch.runtime import loader
from llama_gguf_inference_tpu_torch.runtime.layout_cache import LayoutCache
from llama_gguf_inference_tpu_torch.tools.synth import synth_model

torch.set_num_threads(1)

FIELDS = ("codes", "d", "sc", "dmin", "mn")


def _leaves(node, out):
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


def _params_equal(a, b) -> bool:
    la, lb = _leaves(a, []), _leaves(b, [])
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _load(path, stats=None):
    cfg, p, r = loader.load_model(path, device="cpu", stats=stats)
    r.close()
    return p


def _tiny(path, seed=0, n_layers=1):
    write_tiny_llama(path, dim=64, n_layers=n_layers, n_heads=4, n_kv_heads=2,
                     ffn_dim=96, quant=JGGMLType.Q4_0, seed=seed)
    return path


def test_second_load_hits_cache_and_is_identical(tmp_path, monkeypatch):
    monkeypatch.delenv("LGT_LAYOUT_CACHE", raising=False)
    monkeypatch.setenv("LGT_LAYOUT_CACHE_DIR", str(tmp_path / "lc"))
    path = _tiny(tmp_path / "m.gguf", n_layers=2)
    cold: dict = {}
    p1 = _load(path, cold)
    assert cold["cache_hits"] == 0
    # the directory's name hashes the model's absolute path
    dirs = list((tmp_path / "lc").glob("m.gguf.*.lcache"))
    assert len(dirs) == 1
    m = json.loads((dirs[0] / "manifest.json").read_text())
    assert m["tensors"] and m["version"] == 6
    assert cold["layout_cache"] == str(dirs[0])
    stats: dict = {}
    p2 = _load(path, stats)
    assert stats["cache_hits"] == len(m["tensors"])
    assert stats["repacked_native"] + stats["repacked_numpy"] == 0
    assert _params_equal(p1, p2)
    monkeypatch.setenv("LGT_LAYOUT_CACHE", "0")
    assert _params_equal(p1, _load(path))


def test_stale_fingerprint_invalidates(tmp_path, monkeypatch):
    monkeypatch.delenv("LGT_LAYOUT_CACHE", raising=False)
    monkeypatch.setenv("LGT_LAYOUT_CACHE_DIR", str(tmp_path / "lc"))
    path = _tiny(tmp_path / "m.gguf")
    p1 = _load(path)
    _tiny(path, seed=99)            # other weights: another fingerprint
    cache = LayoutCache.open(path)
    assert cache is not None and cache.tensors == {}, "a stale cache must not be trusted"
    stats: dict = {}
    p2 = _load(path, stats)
    assert stats["cache_hits"] == 0
    assert not _params_equal(p1, p2)


def test_disable_via_env(tmp_path, monkeypatch):
    monkeypatch.setenv("LGT_LAYOUT_CACHE", "0")
    monkeypatch.delenv("LGT_LAYOUT_CACHE_DIR", raising=False)
    path = _tiny(tmp_path / "m.gguf")
    assert LayoutCache.open(path) is None
    stats: dict = {}
    _load(path, stats)
    assert stats["layout_cache"] is None
    assert not (tmp_path / "m.gguf.lcache" / "manifest.json").exists()


def test_partial_cache_rebuilds(tmp_path, monkeypatch):
    """A crash mid-population leaves no manifest: the next boot rebuilds."""
    monkeypatch.delenv("LGT_LAYOUT_CACHE", raising=False)
    monkeypatch.setenv("LGT_LAYOUT_CACHE_DIR", str(tmp_path / "lc"))
    path = _tiny(tmp_path / "m.gguf")
    cache = LayoutCache.open(path)
    raw = quantize(np.random.default_rng(0).standard_normal((32, 256)).astype(np.float32),
                   GGMLType.Q4_K)
    cache.put("t", trepack.repack(raw, GGMLType.Q4_K, 32, 256))
    assert cache.get("t") is not None        # readable from its tmp blob
    # no finalize(): a fresh open sees nothing
    assert LayoutCache.open(path).get("t") is None


def test_same_basename_different_dirs_get_separate_caches(tmp_path, monkeypatch):
    monkeypatch.delenv("LGT_LAYOUT_CACHE", raising=False)
    monkeypatch.setenv("LGT_LAYOUT_CACHE_DIR", str(tmp_path / "lc"))
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
        _tiny(tmp_path / sub / "m.gguf")
        _load(tmp_path / sub / "m.gguf")
    assert len(list((tmp_path / "lc").glob("m.gguf.*.lcache"))) == 2
    for sub in ("a", "b"):
        stats: dict = {}
        _load(tmp_path / sub / "m.gguf", stats)
        assert stats["cache_hits"] > 0
    assert len(list((tmp_path / "lc").glob("m.gguf.*.lcache"))) == 2


def test_default_dir_is_beside_the_model(tmp_path, monkeypatch):
    monkeypatch.delenv("LGT_LAYOUT_CACHE", raising=False)
    monkeypatch.delenv("LGT_LAYOUT_CACHE_DIR", raising=False)
    path = _tiny(tmp_path / "m.gguf")
    _load(path)
    assert (tmp_path / "m.gguf.lcache" / "manifest.json").exists()
    assert (tmp_path / "m.gguf.lcache" / "data.bin").exists()
    assert not list((tmp_path / "m.gguf.lcache").glob("*.tmp"))


# -- the on-disk format, shared with the JAX package ------------------------

QUANTS = ["q4_k", "q2_k"]


@pytest.fixture(scope="module", params=QUANTS)
def model(request, tmp_path_factory):
    return synth_model(str(tmp_path_factory.mktemp(request.param) / "m.gguf"), "160m",
                       quant=request.param, n_layers=1)


def _quant_names(path):
    r = GGUFReader(path)
    names = {n: (info.ggml_type, info.shape) for n, info in r.tensors.items()
             if info.ggml_type not in (GGMLType.F32, GGMLType.F16, GGMLType.BF16)}
    return r, names


def _check_arrays(cache_get, repack_fn, path):
    r, names = _quant_names(path)
    try:
        assert names
        for name, (gt, (o, i)) in names.items():
            got, want = cache_get(name), repack_fn(r.tensor_bytes(name), gt, o, i)
            assert got is not None, name
            for f in ("fmt", "bits", "sub_size", "d_size", "code_bias",
                      "out_features", "in_features"):
                assert getattr(got, f) == getattr(want, f), (name, f)
            for f in FIELDS:
                x, y = getattr(got, f), getattr(want, f)
                assert (x is None) == (y is None), (name, f)
                if x is not None:
                    assert x.dtype == y.dtype and np.array_equal(x, y), (name, f)
    finally:
        r.close()
    return len(names)


def test_jax_written_cache_loads_in_the_port(model, tmp_path, monkeypatch):
    monkeypatch.delenv("LGT_LAYOUT_CACHE", raising=False)
    monkeypatch.setenv("LGT_LAYOUT_CACHE_DIR", str(tmp_path / "lc"))
    _, _, jr = jload(model, mode="quant")
    jr.close()
    cache = LayoutCache.open(model)
    assert cache.tensors, "the port reads the JAX package's manifest"
    n = _check_arrays(cache.get, trepack.repack, model)
    blob = cache.dir / "data.bin"
    before = (blob.stat().st_size, blob.stat().st_mtime_ns)
    stats: dict = {}
    warm = _load(model, stats)
    assert stats["cache_hits"] == n
    assert stats["repacked_native"] + stats["repacked_numpy"] == 0
    assert (blob.stat().st_size, blob.stat().st_mtime_ns) == before
    monkeypatch.setenv("LGT_LAYOUT_CACHE", "0")
    assert _params_equal(warm, _load(model))


def test_port_written_cache_loads_in_jax(model, tmp_path, monkeypatch):
    monkeypatch.delenv("LGT_LAYOUT_CACHE", raising=False)
    monkeypatch.setenv("LGT_LAYOUT_CACHE_DIR", str(tmp_path / "lc"))
    _load(model)
    cache = jcache.LayoutCache.open(model)
    assert cache.tensors, "the JAX package reads the port's manifest"
    _check_arrays(cache.get, jrepack.repack, model)
    manifest = cache.dir / "manifest.json"
    blob = cache.dir / "data.bin"
    before = [(p.stat().st_size, p.stat().st_mtime_ns) for p in (manifest, blob)]
    _, warm, jr = jload(model, mode="quant")
    jr.close()
    # the JAX load found every tensor there: it appended and rewrote nothing
    assert [(p.stat().st_size, p.stat().st_mtime_ns) for p in (manifest, blob)] == before
    monkeypatch.setenv("LGT_LAYOUT_CACHE", "0")
    _, cold, jr = jload(model, mode="quant")
    jr.close()
    la, lb = jax.tree_util.tree_leaves(warm), jax.tree_util.tree_leaves(cold)
    assert len(la) == len(lb)
    assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))
    assert not os.environ.get("LGT_UPLOAD")
