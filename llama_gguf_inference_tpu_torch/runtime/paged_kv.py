"""Paged KV caches: a shared page pool plus per-slot page tables.

A contiguous cache splits the context statically across slots: a slot can
never hold more than ctx tokens even when every other slot is idle.
llama-server instead keeps one unified KV buffer whose cells go to
sequences on demand; this is the same idea, as in the JAX package's
``runtime/paged_kv.py``:

- per layer, K and V live in a (P, KVH, page_s, D) physical page pool
  (bf16, or int8 codes plus (P, KVH, page_s) f32 scales for q8_0);
- ``page_table`` (B, NP) int32 maps slot b's logical page j to a physical
  page (-1 = unassigned);
- the engine reserves a request's pages at admission (:class:`PageAllocator`,
  a host-side free list), so decode never allocates mid-flight;
- the attention kernels read the pools through the table.

Writes go through the table too. A position whose table entry is -1 (an
idle slot, or a padded chunk row past the slot's reservation) is dropped,
as the JAX scatter drops it (``mode="drop"``): indexing a tensor with -1
would write the pool's LAST page instead, another slot's keys. Positions
past the table's last page are dropped as well, where the JAX package
clamps them onto its last page.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import _write_kv
from ..ops import flash_attention as fa
from .kv_cache import QuantKV


def _paged_index(page_table: torch.Tensor, page_s: int, offsets: torch.Tensor, T: int):
    """(b, t, page, slot-in-page) index vectors of the chunk rows whose
    logical page is mapped."""
    NP = page_table.shape[1]
    pos = offsets.long()[:, None] + torch.arange(T, device=offsets.device)[None, :]
    lp = pos // page_s
    phys = torch.gather(page_table.long(), 1, lp.clamp(max=NP - 1))
    bi, ti = torch.nonzero((lp < NP) & (phys >= 0), as_tuple=True)
    return bi, ti, phys[bi, ti], pos[bi, ti] % page_s


class _Paged:
    """Shared geometry; the first field is an L-list of code pools."""

    page_table: torch.Tensor

    @property
    def _pool(self) -> torch.Tensor:
        return getattr(self, dataclasses.fields(self)[0].name)[0]

    @property
    def page_s(self) -> int:
        return self._pool.shape[2]

    @property
    def pool_pages(self) -> int:
        return self._pool.shape[0]

    @property
    def max_seq(self) -> int:
        """Logical capacity per slot: any slot may use the whole pool."""
        return self.page_table.shape[1] * self.page_s

    def slot(self, b: int):
        """The shared pools with slot b's table row (a view: table updates
        and pool writes land in this cache)."""
        return dataclasses.replace(self, page_table=self.page_table[b:b + 1])

    def write_index(self, offsets: torch.Tensor, T: int):
        return _paged_index(self.page_table, self.page_s, offsets, T)


@dataclasses.dataclass
class PagedKV(_Paged):
    """k/v: L-lists of (P, KVH, page_s, D) bf16; page_table (B, NP) int32."""

    k: list
    v: list
    page_table: torch.Tensor

    @staticmethod
    def zeros(cfg: ModelConfig, batch: int, pool_pages: int, page_s: int,
              device: str | torch.device) -> "PagedKV":
        shape = (pool_pages, cfg.n_kv_heads, page_s, cfg.head_dim)
        bf16 = lambda: [torch.zeros(shape, dtype=torch.bfloat16, device=device)
                        for _ in range(cfg.n_layers)]
        return PagedKV(k=bf16(), v=bf16(),
                       page_table=torch.full((batch, pool_pages), -1, dtype=torch.int32,
                                             device=device))

    def write(self, layer: int, k: torch.Tensor, v: torch.Tensor, idx) -> None:
        _write_kv(self.k[layer], k, idx)
        _write_kv(self.v[layer], v, idx)

    def attend(self, layer: int, q: torch.Tensor, offsets: torch.Tensor):
        return fa.flash_attention_paged(q, self.k[layer], self.v[layer], offsets,
                                        self.page_table)


@dataclasses.dataclass
class PagedQuantKV(_Paged):
    """q8_0 pools: k_q/v_q L-lists of (P, KVH, page_s, D) int8, k_s/v_s of
    (P, KVH, page_s) f32 per-(token, head) scales, and the shared table.
    The codec is :class:`runtime.kv_cache.QuantKV`'s."""

    k_q: list
    k_s: list
    v_q: list
    v_s: list
    page_table: torch.Tensor

    @staticmethod
    def zeros(cfg: ModelConfig, batch: int, pool_pages: int, page_s: int,
              device: str | torch.device) -> "PagedQuantKV":
        qshape = (pool_pages, cfg.n_kv_heads, page_s, cfg.head_dim)
        sshape = qshape[:3]
        L = cfg.n_layers
        codes = lambda: [torch.zeros(qshape, dtype=torch.int8, device=device)
                         for _ in range(L)]
        scales = lambda: [torch.zeros(sshape, device=device) for _ in range(L)]
        return PagedQuantKV(k_q=codes(), k_s=scales(), v_q=codes(), v_s=scales(),
                            page_table=torch.full((batch, pool_pages), -1,
                                                  dtype=torch.int32, device=device))

    def write(self, layer: int, k: torch.Tensor, v: torch.Tensor, idx) -> None:
        for (codes, scales), x in (((self.k_q, self.k_s), k), ((self.v_q, self.v_s), v)):
            c, s = QuantKV.quantize(x)
            _write_kv(codes[layer], c, idx)
            _write_kv(scales[layer], s, idx)

    def attend(self, layer: int, q: torch.Tensor, offsets: torch.Tensor):
        return fa.flash_attention_paged_q8(q, self.k_q[layer], self.k_s[layer],
                                           self.v_q[layer], self.v_s[layer],
                                           offsets, self.page_table)


class PageAllocator:
    """Host-side free-list allocator for the physical pool.

    The engine reserves a slot's pages up front (prompt + max_tokens) and
    frees them when the request leaves its slot; the device table is
    rebuilt from the host mirror only on admission/release (never in the
    decode loop)."""

    def __init__(self, pool_pages: int, batch: int):
        self.page_s_free = list(range(pool_pages - 1, -1, -1))
        self.table = np.full((batch, pool_pages), -1, dtype="int32")
        self.owned: dict[int, list[int]] = {b: [] for b in range(batch)}

    @property
    def free_pages(self) -> int:
        return len(self.page_s_free)

    def reserve(self, b: int, n_pages: int) -> bool:
        """Extend slot b's mapping by ``n_pages``; False if pool exhausted
        (nothing allocated on failure)."""
        if n_pages > len(self.page_s_free):
            return False
        start = len(self.owned[b])
        for j in range(n_pages):
            pg = self.page_s_free.pop()
            self.owned[b].append(pg)
            self.table[b, start + j] = pg
        return True

    def release(self, b: int) -> None:
        for pg in self.owned[b]:
            self.page_s_free.append(pg)
        self.owned[b] = []
        self.table[b, :] = -1
