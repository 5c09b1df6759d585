"""The port's quantized and paged KV caches against the JAX package's, on
the CPU: codecs, writes at offsets, writes through a page table, and the
host-side page allocator, all bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.models.config import ModelConfig as JConfig
from llama_gguf_inference_tpu.runtime import kv_cache as jkv
from llama_gguf_inference_tpu.runtime import paged_kv as jpaged
from llama_gguf_inference_tpu_torch.models.config import ModelConfig as TConfig
from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
from llama_gguf_inference_tpu_torch.runtime import kv_cache as tkv
from llama_gguf_inference_tpu_torch.runtime import paged_kv as tpaged
from llama_gguf_inference_tpu_torch.runtime.convert import cache_from_numpy

torch.set_num_threads(1)

CODECS = {"q8_0": (jkv.QuantKV, tkv.QuantKV), "q4_0": (jkv.QuantKV4, tkv.QuantKV4),
          "q4_1": (jkv.QuantKV41, tkv.QuantKV41)}
SHAPE = dict(n_layers=2, n_kv_heads=2, head_dim=64)


def _bf16_pair(a):
    """The same bf16 values for both packages."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(torch.bfloat16)
    return j, t


def _chunk(rng, B, T, KVH=2, D=64):
    x = rng.normal(size=(B, T, KVH, D)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                    # all-zero vector: scale 0
    x[0, 0, 1] = 1.5                    # constant vector: q4_1 range 0
    return x


def _assert_equal(jarr, tarr, what):
    j = np.asarray(jnp.asarray(jarr, jnp.float32) if jarr.dtype == jnp.bfloat16 else jarr)
    t = tarr.float().numpy() if tarr.dtype == torch.bfloat16 else tarr.numpy()
    assert j.dtype == t.dtype or tarr.dtype == torch.bfloat16, what
    assert np.array_equal(j, t), what


@pytest.mark.parametrize("kind", sorted(CODECS))
def test_codec_bit_exact(kind):
    jcls, tcls = CODECS[kind]
    jx, tx = _bf16_pair(_chunk(np.random.default_rng(1), 3, 5))
    jparts, tparts = jcls.quantize(jx), tcls.quantize(tx)
    assert len(jparts) == len(tparts)
    for i, (j, t) in enumerate(zip(jparts, tparts)):
        _assert_equal(j, t, f"{kind} part {i}")
    _assert_equal(jcls.dequantize(*jparts), tcls.dequantize(*tparts), kind + " dequant")


@pytest.mark.parametrize("kind", sorted(CODECS))
def test_write_at_offsets_matches_jax(kind):
    jcls, tcls = CODECS[kind]
    B, S, T = 3, 32, 6
    rng = np.random.default_rng(2)
    offsets = np.array([0, 9, S - T], np.int32)
    jc = jcls.zeros(JConfig(**SHAPE), B, S)
    tc = tcls.zeros(TConfig(**SHAPE), B, S, "cpu")
    for layer in range(2):
        jk, tk = _bf16_pair(_chunk(rng, B, T))
        jv, tv = _bf16_pair(_chunk(rng, B, T))
        jc = jc.write(layer, jk, jv, jnp.asarray(offsets))
        off = torch.from_numpy(offsets)
        tc.write(layer, tk, tv, tc.write_index(off, T))
    for name in jc._fields:
        for layer in range(2):
            _assert_equal(getattr(jc, name)[layer], getattr(tc, name)[layer],
                          f"{kind}.{name}[{layer}]")
        _assert_equal(jc.k_full(1),
                      tcls.dequantize(*(getattr(tc, n)[1] for n in tcls.K_FIELDS)),
                      kind + " k_full")
    # a slot view writes into the cache it came from
    tc.slot(1).write(0, tk[1:2], tv[1:2], tc.slot(1).write_index(off[:1], T))
    jc = jc.write(0, jk, jv, jnp.asarray([S - T, 0, S - T], np.int32))
    for name in jc._fields:
        _assert_equal(getattr(jc, name)[0][1], getattr(tc, name)[0][1], name)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8_0"])
def test_paged_write_matches_jax_and_drops_unmapped_rows(quant):
    """Scattered pages, a slot whose chunk runs past its last mapped page,
    and an idle slot whose table row is all -1 writing at offset 0: the
    unmapped rows are dropped, so the pool's last page stays untouched."""
    B, P, page_s, T = 3, 6, 16, 12
    rng = np.random.default_rng(3)
    table = np.full((B, P), -1, np.int32)
    table[0, :3] = [4, 1, 2]
    table[1, :2] = [0, 3]
    offsets = np.array([10, 24, 0], np.int32)   # slot 1 runs past page 2
    jcls, tcls = ((jpaged.PagedQuantKV, tpaged.PagedQuantKV) if quant
                  else (jpaged.PagedKV, tpaged.PagedKV))
    jc = jcls.zeros(JConfig(**SHAPE), B, P, page_s)._replace(page_table=jnp.asarray(table))
    tc = tcls.zeros(TConfig(**SHAPE), B, P, page_s, "cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    jk, tk = _bf16_pair(_chunk(rng, B, T))
    jv, tv = _bf16_pair(_chunk(rng, B, T))
    jc = jc.write(1, jk, jv, jnp.asarray(offsets))
    tc.write(1, tk, tv, tc.write_index(torch.from_numpy(offsets), T))
    for name in jc._fields:
        if name == "page_table":
            continue
        _assert_equal(getattr(jc, name)[1], getattr(tc, name)[1], name)
        assert not getattr(tc, name)[1][P - 1].any(), f"{name}: last page written"
    pt = tc.page_table
    if quant:
        got = [tkv.QuantKV.dequantize(fa.gather_pages(c[1], pt), fa.gather_pages(s[1], pt))
               for c, s in ((tc.k_q, tc.k_s), (tc.v_q, tc.v_s))]
    else:
        got = [fa.gather_pages(pool[1], pt) for pool in (tc.k, tc.v)]
    for j, t in zip(jc.gather(1), got):
        _assert_equal(j, t, "gather")


def test_page_allocator_matches_jax():
    ja, ta = jpaged.PageAllocator(8, 3), tpaged.PageAllocator(8, 3)
    for op, b, n in [("r", 0, 3), ("r", 1, 2), ("r", 2, 4), ("x", 0, 0), ("r", 2, 2),
                     ("r", 0, 4), ("x", 1, 0), ("r", 1, 5), ("r", 1, 3)]:
        if op == "r":
            assert ja.reserve(b, n) == ta.reserve(b, n)
        else:
            ja.release(b)
            ta.release(b)
        assert np.array_equal(ja.table, ta.table) and ja.owned == ta.owned
        assert ja.free_pages == ta.free_pages


@pytest.mark.parametrize("kind", ["bf16", "q8_0", "q4_0", "q4_1", "paged", "paged_q8_0"])
def test_cache_from_numpy_keeps_every_field(kind):
    cfg = JConfig(**SHAPE)
    if kind.startswith("paged"):
        jcls = jpaged.PagedQuantKV if kind == "paged_q8_0" else jpaged.PagedKV
        jc = jcls.zeros(cfg, 2, 4, 16)
    elif kind == "bf16":
        from llama_gguf_inference_tpu.models.llama import KVCache
        jc = KVCache.zeros(cfg, 2, 16)
    else:
        jc = CODECS[kind][0].zeros(cfg, 2, 16)
    fields = {k: (np.asarray(v) if k == "page_table" else [np.asarray(a) for a in v])
              for k, v in jc._asdict().items()}
    tc = cache_from_numpy(fields, "cpu")
    assert type(tc).__name__ == type(jc).__name__
    for name in jc._fields:
        vals = getattr(jc, name)
        if name == "page_table":
            _assert_equal(vals, getattr(tc, name), name)
        else:
            for j, t in zip(vals, getattr(tc, name)):
                _assert_equal(j, t, name)
