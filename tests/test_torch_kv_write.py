"""The KV write index with static shapes and sink rows, against the index it
replaced, on the CPU.

The earlier index kept only the chunk rows that land in the cache (with
``torch.nonzero``, a host read of the offsets or the page table); every
other row was dropped. The new one sends those rows to the sink rows past
each cache tensor's last row. For each cache kind, chunks that cross the
end of the cache, offsets past it and page tables with -1 rows, the cache
proper must come out byte for byte as the earlier index left it, and the
sink rows must be the only storage written outside it.
"""

import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.models.config import ModelConfig
from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig, make_kv_cache
from llama_gguf_inference_tpu_torch.runtime.kv_cache import QuantKV

CFG = ModelConfig(vocab_size=64, dim=64, n_layers=1, n_heads=4, n_kv_heads=2,
                  head_dim=16, ffn_dim=32, rope_dim=16)
S, PAGE = 16, 4


def _old_write_index(offsets, T, S):
    pos = offsets.long()[:, None] + torch.arange(T)[None, :]
    bi, ti = torch.nonzero(pos < S, as_tuple=True)
    return bi, ti, bi, pos[bi, ti]


def _old_paged_index(page_table, page_s, offsets, T):
    NP = page_table.shape[1]
    pos = offsets.long()[:, None] + torch.arange(T)[None, :]
    lp = pos // page_s
    phys = torch.gather(page_table.long(), 1, lp.clamp(max=NP - 1))
    bi, ti = torch.nonzero((lp < NP) & (phys >= 0), as_tuple=True)
    return bi, ti, phys[bi, ti], pos[bi, ti] % page_s


def _old_write(cache, layer, k, v, idx):
    """The earlier ``write`` of each cache kind, field by field."""
    bi, ti, row, si = idx

    def put(t, new):
        t[row, :, si] = new[bi, ti].to(t.dtype)

    if hasattr(cache, "k"):
        put(cache.k[layer], k)
        put(cache.v[layer], v)
        return
    names = [f for f in ("k_q", "k_s", "k_m") if hasattr(cache, f)]
    quant = getattr(cache, "quantize", QuantKV.quantize)   # paged q8_0: QuantKV's codec
    for prefix, x in (("k", k), ("v", v)):
        for name, part in zip([n.replace("k_", prefix + "_") for n in names], quant(x)):
            put(getattr(cache, name)[layer], part)


def _fields(cache):
    return [a for name in ("k", "v", "k_q", "k_s", "k_m", "v_q", "v_s", "v_m")
            if hasattr(cache, name) for a in getattr(cache, name)]


def _storage(t):
    """Every element of ``t``'s storage, as raw bytes."""
    return torch.frombuffer(bytearray(t.untyped_storage()), dtype=torch.uint8).clone()


KINDS = [("bf16", "contig"), ("q8_0", "contig"), ("q4_0", "contig"), ("q4_1", "contig"),
         ("bf16", "paged"), ("q8_0", "paged")]
# (offsets, T): a chunk inside, one ending at S, ones crossing S, one past it
CHUNKS = [([0, 3, 9, 12], 4), ([12, 0, 5, 8], 4), ([10, 14, 15, 2], 4),
          ([15, 13, 16, 20], 1), ([7, 11, 1, 0], 8)]


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: "-".join(k))
@pytest.mark.parametrize("chunk", range(len(CHUNKS)))
def test_write_matches_the_earlier_index(kind, chunk):
    kv_dtype, layout = kind
    ecfg = EngineConfig(max_slots=4, ctx=S, kv_dtype=kv_dtype, kv_layout=layout,
                        kv_page_size=PAGE)
    new, _ = make_kv_cache(CFG, ecfg, "cpu")
    old, _ = make_kv_cache(CFG, ecfg, "cpu")
    if layout == "paged":
        # slots own shuffled pages; slot 2 owns two pages only, slot 3 none
        table = torch.tensor([[5, 0, 9, 2], [1, 14, 7, 11], [3, 12, -1, -1],
                              [-1, -1, -1, -1]], dtype=torch.int32)
        table = torch.cat([table, torch.full((4, new.page_table.shape[1] - 4), -1,
                                             dtype=torch.int32)], 1)
        for c in (new, old):
            c.page_table.copy_(table)
    offsets, T = CHUNKS[chunk]
    offsets = torch.tensor(offsets, dtype=torch.int32)
    g = torch.Generator().manual_seed(chunk)
    k = torch.randn(4, T, CFG.n_kv_heads, CFG.head_dim, generator=g).to(torch.bfloat16)
    v = torch.randn(4, T, CFG.n_kv_heads, CFG.head_dim, generator=g).to(torch.bfloat16)
    before = [_storage(a) for a in _fields(new)]
    new.write(0, k, v, new.write_index(offsets, T))
    if layout == "paged":
        idx = _old_paged_index(old.page_table, PAGE, offsets, T)
    else:
        idx = _old_write_index(offsets, T, S)
    _old_write(old, 0, k, v, idx)
    written_outside = 0
    for a, b, raw in zip(_fields(new), _fields(old), before):
        assert torch.equal(a, b)                   # the cache proper: as before
        n = a.numel() * a.element_size()
        after = _storage(a)
        written_outside += int((after[n:] != raw[n:]).any())
        # sink rows: KVH rows of the trailing shape past the last row
        assert after.numel() - n == CFG.n_kv_heads * (a[0, 0, 0].numel()
                                                       * a.element_size())
    dropped = bool(((offsets[:, None] + torch.arange(T)) >= S).any()) or layout == "paged"
    assert written_outside == 0 or dropped


def test_slot_view_writes_land_in_its_row_and_sink():
    """A one-sequence view (prefill's) writes its own row, and its dropped
    rows go to the storage's sink rows, not into the next slot."""
    cache, _ = make_kv_cache(CFG, EngineConfig(max_slots=3, ctx=S), "cpu")
    view = cache.slot(1)
    k = torch.ones(1, 8, CFG.n_kv_heads, CFG.head_dim, dtype=torch.bfloat16)
    view.write(0, k, k, view.write_index(torch.tensor([12], dtype=torch.int32), 8))
    assert cache.k[0][1, :, 12:].eq(1).all() and cache.k[0][1, :, :12].eq(0).all()
    assert cache.k[0][0].eq(0).all() and cache.k[0][2].eq(0).all()


def test_cache_without_sink_rows_is_refused():
    t = torch.zeros(2, 2, S, 4)
    with pytest.raises(ValueError, match="sink"):
        tllama._write_index(torch.zeros(2, dtype=torch.int32), 1, t)


def test_write_index_has_static_shape():
    """The index is (B, T, KVH) whatever the offsets: no shape follows
    from the data, so nothing reads the offsets on the host."""
    t = tllama.sink_zeros((4, 2, S, 8))
    shapes = {tuple(tllama._write_index(torch.tensor(o, dtype=torch.int32), 4, t).shape)
              for o, _ in CHUNKS[:3]}
    assert shapes == {(4, 4, 2)}
    rows = tllama._rows(t)
    assert rows.shape == (4 * 2 * S + 2, 8) and rows.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(
        tllama._write_index(torch.tensor([S - 1, 0, 0, 0], dtype=torch.int32), 2, t)[0].numpy(),
        [[S - 1, S + S - 1], [4 * 2 * S, 4 * 2 * S + 1]])
