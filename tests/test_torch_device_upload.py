"""The port's bulk upload (``runtime.device_upload``), on the CPU: every
carved array equals the per-tensor path's (``to_quant_linear(cache.get(
name), "cpu")``) and the JAX package's ``bulk_upload``, bit for bit, for every
format of ``tests/test_device_upload.py`` under ``LGT_SCALE_LAYOUT`` flat,
compact and mixed, with a chunk limit that spreads the tensors over several
chunks; carved arrays own their storage; a blob not yet finalized is read;
a missing tensor raises ``KeyError``. Then ``load_model`` over the cache:
cold and warm loads equal the per-tensor path's and a load without the
cache, and a warm load with a LoRA adapter equals a cold one and the JAX
package's forward within the LoRA tests' tolerance.
"""

import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.models import llama as jllama
from llama_gguf_inference_tpu.runtime import device_upload as jupload
from llama_gguf_inference_tpu.runtime import layout_cache as jcache
from llama_gguf_inference_tpu.runtime import loader as jloader
from llama_gguf_inference_tpu.utils.testing import write_tiny_llama
from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
from llama_gguf_inference_tpu_torch.gguf.reader import GGUFReader
from llama_gguf_inference_tpu_torch.gguf.writer import GGUFWriter
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.ops.linear import LoraLinear, QuantEmbedding, QuantLinear
from llama_gguf_inference_tpu_torch.quant.numpy_ref import quantize
from llama_gguf_inference_tpu_torch.quant.repack import repack, to_quant_linear
from llama_gguf_inference_tpu_torch.runtime import device_upload as tupload
from llama_gguf_inference_tpu_torch.runtime import loader
from llama_gguf_inference_tpu_torch.runtime.layout_cache import LayoutCache
from test_lora import _write_adapter
from test_torch_model import write_tiny_q4km

torch.set_num_threads(1)

FORMATS = [GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q2_K, GGMLType.Q3_K,
           GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.IQ4_XS]
LAYOUTS = ["flat", "compact", "mixed"]
FIELDS = ("codes", "d", "sc", "dmin", "mn")
STATIC = ("fmt", "bits", "sub_size", "d_size", "code_bias", "out_features",
          "in_features", "min_size")
CHUNK = 6000               # bytes: a few tensors of 8 x 512 a chunk
LOGITS_TOL = 0.03          # tests/test_torch_lora.py's, of max |logit|


def _model(tmp_path):
    path = tmp_path / "m.gguf"
    write_tiny_llama(path, dim=64, n_layers=1, n_heads=4, n_kv_heads=2, ffn_dim=96)
    return path


def _make_caches(tmp_path, monkeypatch, tensors):
    """The same tensors put in a port cache and read back through a fresh
    open of each package (the JAX one reads the port's files)."""
    monkeypatch.setenv("LGT_LAYOUT_CACHE_DIR", str(tmp_path / "lc"))
    model = _model(tmp_path)
    cache = LayoutCache.open(model)
    for name, rp in tensors:
        cache.put(name, rp)
    cache.finalize()
    return LayoutCache.open(model), jcache.LayoutCache.open(model)


def _assert_ql_equal(got, want, name):
    for f in STATIC:
        assert getattr(got, f) == getattr(want, f), (name, f)
    for f in FIELDS:
        x, y = getattr(got, f), getattr(want, f)
        assert (x is None) == (y is None), (name, f)
        if x is not None:
            y = y if isinstance(y, torch.Tensor) else torch.from_numpy(np.array(y))
            assert x.dtype == y.dtype and x.shape == y.shape, (name, f)
            assert torch.equal(x, y), (name, f)


def _assert_owned(ql, name):
    """No carved array is a view: each owns a storage of its own size."""
    for f in FIELDS:
        a = getattr(ql, f)
        if a is not None:
            assert a.is_contiguous() and a.storage_offset() == 0, (name, f)
            assert a.untyped_storage().nbytes() == a.numel() * a.element_size(), (name, f)


def _tensors(rng, specs):
    out = []
    for name, gt, o, i in specs:
        x = rng.normal(size=(o, i)).astype(np.float32)
        out.append((name, repack(quantize(x, gt), gt, o, i)))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("gtype", FORMATS, ids=lambda t: t.name)
def test_bulk_matches_per_tensor_and_jax(gtype, layout, rng, tmp_path, monkeypatch):
    monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
    monkeypatch.setattr(tupload, "_chunk_bytes", lambda: CHUNK)
    monkeypatch.setattr(jupload, "_chunk_bytes", lambda: CHUNK)
    tensors = _tensors(rng, [(f"t{i}", gtype, 8, 512) for i in range(5)])
    cache, jc = _make_caches(tmp_path, monkeypatch, tensors)
    names = [n for n, _ in tensors]
    groups, _ = tupload._chunks(cache.entries_in_offset_order(names), CHUNK)
    assert len(groups) > 1
    stats: dict = {}
    got = tupload.bulk_upload(cache, names, "cpu", stats)
    assert stats["bulk_bytes"] > 0 and stats["bulk_s"] >= 0
    want_jax = jupload.bulk_upload(jc, names)
    for name in names:
        _assert_ql_equal(got[name], to_quant_linear(cache.get(name), "cpu"), name)
        _assert_ql_equal(got[name], want_jax[name], name)
        _assert_owned(got[name], name)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mixed_formats_over_chunks(layout, rng, tmp_path, monkeypatch):
    """Several chunks (a 1 MB limit), formats and shapes in one blob, one
    tensor larger than the limit (a chunk of its own)."""
    monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
    monkeypatch.setenv("LGT_UPLOAD_CHUNK_MB", "1")
    specs = [("a", GGMLType.Q4_K, 64, 1024), ("b", GGMLType.Q6_K, 32, 512),
             ("c", GGMLType.Q8_0, 128, 2048), ("d", GGMLType.Q4_K, 256, 512),
             ("e", GGMLType.Q2_K, 16, 256), ("f", GGMLType.Q6_K, 512, 2304),
             ("g", GGMLType.Q5_K, 16, 512)]
    tensors = _tensors(rng, specs)
    cache, jc = _make_caches(tmp_path, monkeypatch, tensors)
    names = [n for n, _ in tensors]
    groups, spans = tupload._chunks(cache.entries_in_offset_order(names), 1 << 20)
    assert len(groups) > 2 and max(hi - lo for lo, hi in spans) > 1 << 20
    got = tupload.bulk_upload(cache, names, "cpu")
    want_jax = jupload.bulk_upload(jc, names)
    for name in names:
        _assert_ql_equal(got[name], to_quant_linear(cache.get(name), "cpu"), name)
        _assert_ql_equal(got[name], want_jax[name], name)
        _assert_owned(got[name], name)


def test_missing_tensor_raises(rng, tmp_path, monkeypatch):
    cache, _ = _make_caches(tmp_path, monkeypatch,
                            _tensors(rng, [("t0", GGMLType.Q4_K, 8, 512)]))
    with pytest.raises(KeyError):
        tupload.bulk_upload(cache, ["t0", "nope"], "cpu")


def test_unfinalized_blob_is_readable(rng, tmp_path, monkeypatch):
    """A cold boot resolves its placeholders before finalize renames the
    tmp blob."""
    monkeypatch.setenv("LGT_LAYOUT_CACHE_DIR", str(tmp_path / "lc"))
    cache = LayoutCache.open(_model(tmp_path))
    (name, rp), = _tensors(rng, [("t0", GGMLType.Q4_K, 8, 512)])
    cache.put(name, rp)
    assert cache.blob_path.name.endswith(".tmp")
    got = tupload.bulk_upload(cache, [name], "cpu")
    _assert_ql_equal(got[name], to_quant_linear(rp, "cpu"), name)
    cache.finalize()
    assert cache.blob_path.name == "data.bin"
    _assert_ql_equal(tupload.bulk_upload(cache, [name], "cpu")[name],
                     to_quant_linear(cache.get(name), "cpu"), name)


def test_upload_knob(monkeypatch):
    monkeypatch.delenv("LGT_UPLOAD", raising=False)
    assert tupload.upload_enabled()
    monkeypatch.setenv("LGT_UPLOAD", "tensor")
    assert not tupload.upload_enabled()


# -- load_model over the cache ------------------------------------------------

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


def _load(path, **kw):
    cfg, p, r = loader.load_model(path, device="cpu", **kw)
    r.close()
    return cfg, p


def _tied(src, dst):
    """``src`` rewritten without its head: the embedding is tied to it."""
    r = GGUFReader(src)
    w = GGUFWriter(dst)
    for k, v in r.metadata.items():
        if not k.startswith("GGUF."):
            w.add(k, v)
    for name, info in r.tensors.items():
        if name != "output.weight":
            w.add_raw_tensor(name, info.ggml_shape, info.ggml_type,
                             r.tensor_bytes(name).tobytes())
    w.write()
    r.close()
    return dst


@pytest.fixture(params=["head", "tied"])
def q4km(request, tmp_path):
    """Q4_K embedding and projections with a Q6_K head, or tied to the
    embedding."""
    path = write_tiny_q4km(str(tmp_path / "q.gguf"))
    return path if request.param == "head" else _tied(path, str(tmp_path / "tied.gguf"))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_load_model_cold_warm_and_per_tensor(q4km, tmp_path, monkeypatch, layout):
    monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
    monkeypatch.delenv("LGT_LAYOUT_CACHE", raising=False)
    monkeypatch.delenv("LGT_UPLOAD", raising=False)
    monkeypatch.setenv("LGT_LAYOUT_CACHE_DIR", str(tmp_path / "lc"))
    cold_stats: dict = {}
    warm_stats: dict = {}
    tensor_stats: dict = {}
    _, cold = _load(q4km, stats=cold_stats)
    _, warm = _load(q4km, stats=warm_stats)
    monkeypatch.setenv("LGT_UPLOAD", "tensor")
    _, per_tensor = _load(q4km, stats=tensor_stats)
    monkeypatch.setenv("LGT_LAYOUT_CACHE", "0")
    _, uncached = _load(q4km)
    for other in (warm, per_tensor, uncached):
        assert _params_equal(cold, other)
    n = cold_stats["repacked_native"] + cold_stats["repacked_numpy"]
    assert n > 0 and cold_stats["cache_hits"] == 0 and cold_stats["bulk_bytes"] > 0
    assert warm_stats["cache_hits"] == n and warm_stats["bulk_bytes"] == cold_stats["bulk_bytes"]
    assert tensor_stats["cache_hits"] == n and "bulk_bytes" not in tensor_stats
    # a tied head shares the embedding's arrays; the weights are real
    assert isinstance(warm["tok_embd"], QuantEmbedding)
    if str(q4km).endswith("tied.gguf"):
        assert warm["output"] is warm["tok_embd"].table
    else:
        assert warm["output"].fmt == "q6_k"
    assert isinstance(warm["layers"][0]["attn_qkv"], QuantLinear)


def _jax_logits(cfg, params, ids):
    import jax.numpy as jnp
    logits, _ = jllama.forward(params, cfg, jnp.asarray(ids), jnp.zeros(1, jnp.int32),
                               jllama.KVCache.zeros(cfg, 1, 16),
                               jnp.full(1, ids.shape[1], jnp.int32))
    return np.asarray(logits, np.float32)


def _port_logits(cfg, params, ids):
    with torch.inference_mode():
        return tllama.forward(params, cfg, torch.from_numpy(ids),
                              torch.zeros(1, dtype=torch.int32),
                              tllama.KVCache.zeros(cfg, 1, 16, "cpu")).float().numpy()


def test_warm_load_with_lora_matches_cold_and_jax(q4km, tmp_path, monkeypatch):
    """The bulk upload resolves before the adapter and the fusion: adapted
    projections wrap real QuantLinears and stay unfused."""
    monkeypatch.delenv("LGT_LAYOUT_CACHE", raising=False)
    monkeypatch.delenv("LGT_UPLOAD", raising=False)
    monkeypatch.setenv("LGT_LAYOUT_CACHE_DIR", str(tmp_path / "lc"))
    adapter = tmp_path / "adapter.gguf"
    _write_adapter(adapter, {"blk.0.attn_q.weight": (256, 256),
                             "blk.1.ffn_down.weight": (256, 512)},
                   np.random.default_rng(3), mag=0.1)
    cold_stats: dict = {}
    warm_stats: dict = {}
    cfg, cold = _load(q4km, lora_path=str(adapter), lora_scale=0.5, stats=cold_stats)
    _, warm = _load(q4km, lora_path=str(adapter), lora_scale=0.5, stats=warm_stats)
    assert cold_stats["cache_hits"] == 0 and warm_stats["cache_hits"] > 0
    assert _params_equal(cold, warm)
    l0 = warm["layers"][0]
    assert isinstance(l0["attn_q"], LoraLinear) and isinstance(l0["attn_q"].base, QuantLinear)
    assert "attn_qkv" not in l0 and "ffn_gateup" in l0
    ids = np.random.default_rng(11).integers(3, 250, size=(1, 8)).astype(np.int32)
    got = _port_logits(cfg, warm, ids)
    assert np.array_equal(got, _port_logits(cfg, cold, ids))
    jcfg, jparams, jr = jloader.load_model(q4km, mode="quant", fuse=True,
                                           lora_path=str(adapter), lora_scale=0.5)
    jr.close()
    want = _jax_logits(jcfg, jparams, ids)
    assert np.abs(got - want).max() <= LOGITS_TOL * np.abs(want).max()
    _, plain = _load(q4km)
    assert np.abs(got - _port_logits(cfg, plain, ids)).max() > 0.1   # the adapter moves logits
