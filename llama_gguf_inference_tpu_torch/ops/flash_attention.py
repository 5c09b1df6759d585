"""Causal flash attention over the offset-indexed KV caches.

Six wrappers keep the JAX package's names, argument orders and layouts:
q (B, T, H, D); caches in their storage layout; offsets (B,) int32. Query
t of sequence b attends to logical slots ``s <= offsets[b] + t``; the
functions ignore how many of the T rows are real, so padded rows of a
prefill chunk get outputs nobody reads.

- :func:`flash_attention`: bf16 caches (B, KVH, S, D)
- :func:`flash_attention_q8`: int8 codes (B, KVH, S, D) and f32 scales
  (B, KVH, S), one per (token, head)
- :func:`flash_attention_q4`: uint8 codes (B, KVH, S, D/2) in planar nibble
  order (byte j holds element j in its low nibble and element j + D/2 in
  its high one), biased by 8, and f32 scales
- :func:`flash_attention_q41`: unsigned planar nibbles plus f32 scales and
  minimums: an element is ``c * s + m``
- :func:`flash_attention_paged`: bf16 pools (P, KVH, page_s, D) read
  through ``page_table`` (B, NP) int32; entries of -1 read page 0
- :func:`flash_attention_paged_q8`: int8 pools and (P, KVH, page_s) f32
  scale pools through the same table

On tensors on the card each wrapper launches its CUDA kernel of
``csrc/flash_attention.cu`` (the counterparts of the TPU kernels
``_flash_jit``, ``_flash_q8_jit``, ``_flash_paged_jit`` and
``_flash_paged_q8_jit``) or raises; on CPU tensors it takes its ``*_plain``
version: the cache dequantized in f32 (codes × scales, + minimums; no bf16
rounding) and gathered through the table, then one masked f32 softmax.
"""

from __future__ import annotations

import torch

from . import _build

NAME = "flash_attention"
NAME_Q8 = "flash_attention_q8"
NAME_Q4 = "flash_attention_q4"
NAME_Q41 = "flash_attention_q41"
NAME_PAGED = "flash_attention_paged"
NAME_PAGED_Q8 = "flash_attention_paged_q8"
HEAD_DIMS = (64, 128, 256)


def _on_card(name: str, q: torch.Tensor, offsets: torch.Tensor,
             codes: dict[str, torch.Tensor], code_shape: tuple,
             code_dtype: torch.dtype, scales: dict[str, torch.Tensor] | None = None,
             page_table: torch.Tensor | None = None) -> bool:
    """Validate a call; True when it runs on the card. Every code tensor
    must have ``code_shape``, every scale tensor its first three dims."""
    scales = scales or {}
    B, _, H, D = q.shape
    KVH = code_shape[1]
    for n, t in codes.items():
        if tuple(t.shape) != tuple(code_shape):
            raise ValueError(f"{name}: {n} is {tuple(t.shape)}, expected "
                             f"{tuple(code_shape)} for q {tuple(q.shape)}")
    for n, t in scales.items():
        if tuple(t.shape) != tuple(code_shape[:3]):
            raise ValueError(f"{name}: {n} is {tuple(t.shape)}, expected "
                             f"{tuple(code_shape[:3])}")
    if H % KVH:
        raise ValueError(f"{name}: {H} query heads over {KVH} kv heads")
    if tuple(offsets.shape) != (B,) or offsets.dtype != torch.int32:
        raise ValueError(f"{name}: offsets must be (B,) int32")
    rest = {}
    if page_table is not None:
        if (page_table.dim() != 2 or page_table.shape[0] != B
                or page_table.dtype != torch.int32):
            raise ValueError(f"{name}: page_table must be (B, NP) int32")
        rest["page_table"] = page_table
    dev = q.device
    for n, t in {"q": q, "offsets": offsets, **codes, **scales, **rest}.items():
        if t.device != dev:
            raise ValueError(f"{name}: {n} is on {t.device}, expected {dev}")
    if dev.type != "cuda":
        return False
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous bf16")
    for n, t in codes.items():
        if t.dtype != code_dtype or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be contiguous {code_dtype}, "
                             "16-byte aligned")
    for n, t in scales.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous float32")
    return True


def _launch(name: str, tensors: list, ints: list) -> torch.Tensor:
    """Call C entry point ``lgt_<name>`` with the pointers of ``tensors``
    (q first, offsets and table in their places), out, ``ints``, the
    softmax scale and the stream; count the launch."""
    tensors = [t.contiguous() for t in tensors]   # copies only offsets or a table
    q = tensors[0]
    out = torch.empty_like(q)
    fn = getattr(_build.library("flash_attention"), "lgt_" + name)
    _build.check(fn(*[t.data_ptr() for t in tensors], out.data_ptr(), *ints,
                    1.0 / q.shape[-1] ** 0.5,
                    torch.cuda.current_stream(q.device).cuda_stream), name)
    _build.count(name)
    return out


# -- kernels ------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, D) bf16; k/v (B, KVH, S, D) bf16; offsets (B,) int32
    -> (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    shape = (B, k_cache.shape[1], k_cache.shape[2], D)
    if not _on_card(NAME, q, offsets, {"k_cache": k_cache, "v_cache": v_cache},
                    shape, torch.bfloat16):
        return flash_attention_plain(q, k_cache, v_cache, offsets)
    return _launch(NAME, [q, k_cache, v_cache, offsets],
                   [B, T, H, shape[1], shape[2], D])


def flash_attention_q8(q, kq, ks, vq, vs, offsets) -> torch.Tensor:
    """kq/vq (B, KVH, S, D) int8; ks/vs (B, KVH, S) f32."""
    B, T, H, D = q.shape
    shape = (B, kq.shape[1], kq.shape[2], D)
    if not _on_card(NAME_Q8, q, offsets, {"kq": kq, "vq": vq}, shape, torch.int8,
                    {"ks": ks, "vs": vs}):
        return flash_attention_q8_plain(q, kq, ks, vq, vs, offsets)
    return _launch(NAME_Q8, [q, kq, ks, vq, vs, offsets],
                   [B, T, H, shape[1], shape[2], D])


def flash_attention_q4(q, kq, ks, vq, vs, offsets) -> torch.Tensor:
    """kq/vq (B, KVH, S, D/2) uint8 planar nibbles biased by 8; ks/vs
    (B, KVH, S) f32."""
    B, T, H, D = q.shape
    shape = (B, kq.shape[1], kq.shape[2], D // 2)
    if not _on_card(NAME_Q4, q, offsets, {"kq": kq, "vq": vq}, shape, torch.uint8,
                    {"ks": ks, "vs": vs}):
        return flash_attention_q4_plain(q, kq, ks, vq, vs, offsets)
    return _launch(NAME_Q4, [q, kq, ks, vq, vs, offsets],
                   [B, T, H, shape[1], shape[2], D])


def flash_attention_q41(q, kq, ks, km, vq, vs, vm, offsets) -> torch.Tensor:
    """kq/vq (B, KVH, S, D/2) uint8 unsigned planar nibbles; ks/vs scales
    and km/vm minimums (B, KVH, S) f32."""
    B, T, H, D = q.shape
    shape = (B, kq.shape[1], kq.shape[2], D // 2)
    if not _on_card(NAME_Q41, q, offsets, {"kq": kq, "vq": vq}, shape, torch.uint8,
                    {"ks": ks, "km": km, "vs": vs, "vm": vm}):
        return flash_attention_q41_plain(q, kq, ks, km, vq, vs, vm, offsets)
    return _launch(NAME_Q41, [q, kq, ks, km, vq, vs, vm, offsets],
                   [B, T, H, shape[1], shape[2], D])


def flash_attention_paged(q, k_pool, v_pool, offsets, page_table) -> torch.Tensor:
    """Pools (P, KVH, page_s, D) bf16; page_table (B, NP) int32 maps slot
    b's logical page j to a pool page (-1: none, read as page 0)."""
    B, T, H, D = q.shape
    P, KVH, page_s = k_pool.shape[:3]
    if not _on_card(NAME_PAGED, q, offsets, {"k_pool": k_pool, "v_pool": v_pool},
                    (P, KVH, page_s, D), torch.bfloat16, page_table=page_table):
        return flash_attention_paged_plain(q, k_pool, v_pool, offsets, page_table)
    return _launch(NAME_PAGED, [q, k_pool, v_pool, offsets, page_table],
                   [B, T, H, KVH, page_table.shape[1], page_s, D])


def flash_attention_paged_q8(q, kq, ks, vq, vs, offsets, page_table) -> torch.Tensor:
    """Pools kq/vq (P, KVH, page_s, D) int8 and ks/vs (P, KVH, page_s)
    f32, through page_table as :func:`flash_attention_paged`."""
    B, T, H, D = q.shape
    P, KVH, page_s = kq.shape[:3]
    if not _on_card(NAME_PAGED_Q8, q, offsets, {"kq": kq, "vq": vq},
                    (P, KVH, page_s, D), torch.int8, {"ks": ks, "vs": vs},
                    page_table=page_table):
        return flash_attention_paged_q8_plain(q, kq, ks, vq, vs, offsets, page_table)
    return _launch(NAME_PAGED_Q8, [q, kq, ks, vq, vs, offsets, page_table],
                   [B, T, H, KVH, page_table.shape[1], page_s, D])


# -- plain versions -----------------------------------------------------------

def unpack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """(..., D/2) uint8 planar nibbles -> (..., D) int32 codes in [0, 15]."""
    c = codes.to(torch.int32)
    return torch.cat([c & 0x0F, c >> 4], dim=-1)


def _dequant(codes: torch.Tensor, s: torch.Tensor,
             m: torch.Tensor | None = None) -> torch.Tensor:
    """codes × per-row scale (+ per-row minimum), in f32."""
    x = codes.float() * s[..., None]
    return x if m is None else x + m[..., None]


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P, KVH, page_s, ...) pool -> (B, KVH, NP * page_s, ...) logical
    view through the table; -1 entries read page 0."""
    g = pool[page_table.long().clamp(0, pool.shape[0] - 1)]  # (B, NP, KVH, page_s, ...)
    g = g.transpose(1, 2)
    return g.reshape(g.shape[0], g.shape[1], -1, *pool.shape[3:])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            offsets: torch.Tensor) -> torch.Tensor:
    """f32 scores of pre-scaled q against (B, KVH, S, D) k, the causal
    offset mask at -1e30, softmax, f32 P·V, one cast to q's dtype."""
    B, T, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    qh = (q.float() * (1.0 / D ** 0.5)).reshape(B, T, KVH, H // KVH, D)
    scores = torch.einsum("btkgd,bksd->bkgts", qh, k.float())
    pos = offsets.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    mask = torch.arange(S, device=q.device)[None, None, :] <= pos[:, :, None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgts,bksd->btkgd", probs, v.float())
    return ctx.reshape(B, T, H, D).to(q.dtype)


def flash_attention_plain(q, k_cache, v_cache, offsets) -> torch.Tensor:
    _build.count(NAME + ".plain")
    return _attend(q, k_cache, v_cache, offsets)


def flash_attention_q8_plain(q, kq, ks, vq, vs, offsets) -> torch.Tensor:
    _build.count(NAME_Q8 + ".plain")
    return _attend(q, _dequant(kq, ks), _dequant(vq, vs), offsets)


def flash_attention_q4_plain(q, kq, ks, vq, vs, offsets) -> torch.Tensor:
    _build.count(NAME_Q4 + ".plain")
    return _attend(q, _dequant(unpack_nibbles(kq) - 8, ks),
                   _dequant(unpack_nibbles(vq) - 8, vs), offsets)


def flash_attention_q41_plain(q, kq, ks, km, vq, vs, vm, offsets) -> torch.Tensor:
    _build.count(NAME_Q41 + ".plain")
    return _attend(q, _dequant(unpack_nibbles(kq), ks, km),
                   _dequant(unpack_nibbles(vq), vs, vm), offsets)


def flash_attention_paged_plain(q, k_pool, v_pool, offsets, page_table) -> torch.Tensor:
    _build.count(NAME_PAGED + ".plain")
    return _attend(q, gather_pages(k_pool, page_table),
                   gather_pages(v_pool, page_table), offsets)


def flash_attention_paged_q8_plain(q, kq, ks, vq, vs, offsets,
                                   page_table) -> torch.Tensor:
    _build.count(NAME_PAGED_Q8 + ".plain")
    return _attend(q, _dequant(gather_pages(kq, page_table), gather_pages(ks, page_table)),
                   _dequant(gather_pages(vq, page_table), gather_pages(vs, page_table)),
                   offsets)
