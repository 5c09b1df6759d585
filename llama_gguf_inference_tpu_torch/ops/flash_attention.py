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

On tensors on the card each wrapper launches a CUDA kernel (the
counterparts of the TPU kernels ``_flash_jit``, ``_flash_q8_jit``,
``_flash_paged_jit`` and ``_flash_paged_q8_jit``) or raises. Every wrapper
dispatches by query positions: from :data:`FLASH_TC_MIN_ROWS` (prefill
chunks) at a head_dim of :data:`TC_HEAD_DIMS`, the tensor-core kernel of
``csrc/flash_attention_tc.cu`` (``*_tc`` wrappers, launches counted as
:data:`NAME_TC`, :data:`NAME_Q8_TC`, :data:`NAME_Q4_TC`,
:data:`NAME_Q41_TC`, :data:`NAME_PAGED_TC`, :data:`NAME_PAGED_Q8_TC`); else
the decode kernel of ``csrc/flash_attention.cu`` (``*_decode`` wrappers,
launches counted under the wrapper's own name), which splits each
sequence's keys across blocks of :data:`FLASH_SPLIT_KEYS` and merges the
splits in the same launch, through a scratch of partials allocated per call
(at most :data:`FLASH_SPLIT_SCRATCH` bytes: a longer call launches over
pieces of its query positions) and arrival counters kept per device
(:func:`_arrivals`); the host never reads ``offsets``, so a launch's grid
follows from shapes alone. On CPU
tensors every wrapper takes its ``*_plain`` version, the plain version of
both kernels: the cache dequantized in f32 (codes × scales, + minimums; no
bf16 rounding) and gathered through the table, then one masked f32 softmax.
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
NAME_TC = "flash_attention_tc"
NAME_Q8_TC = "flash_attention_q8_tc"
NAME_Q4_TC = "flash_attention_q4_tc"
NAME_Q41_TC = "flash_attention_q41_tc"
NAME_PAGED_TC = "flash_attention_paged_tc"
NAME_PAGED_Q8_TC = "flash_attention_paged_q8_tc"
HEAD_DIMS = (64, 128, 256)
TC_HEAD_DIMS = (64, 128)   # the tensor-core kernel's register tiles
# query positions T from which every wrapper takes the tensor-core kernel. On
# an H100 at offset 1000, B = 1 (chip_smoke.py's crossover rows, PERF.md
# §6) the tensor-core kernel wins from T = 16 for every kind: bf16 0.0202
# against the split CUDA-core kernel's 0.0370 ms, q8_0 0.0346 against
# 0.0398 (the narrowest), q4_0 0.0295 against 0.0505, paged q8_0 0.0366
# against 0.0472; one threshold for all, the engine's smallest prefill
# bucket, so every prefill chunk takes it and decode steps the split kernel
FLASH_TC_MIN_ROWS = 16
# keys a split of the decode kernel (kChunk of csrc/flash_attention.cu, which
# refuses a launch sized for another)
FLASH_SPLIT_KEYS = 256
_ROW_GROUP = 4                 # query rows a decode block (kWarps)
# bytes a decode launch's partials may take: at head_dim 256 a 512-position
# prefill chunk over 8192 keys at 8 kv heads and group 2 would ask for about
# 270 MB at once, so such calls launch over pieces of the query positions
FLASH_SPLIT_SCRATCH = 64 << 20
_ARRIVALS: dict[torch.device, torch.Tensor] = {}


def _on_card(name: str, q: torch.Tensor, offsets: torch.Tensor,
             codes: dict[str, torch.Tensor], code_shape: tuple,
             code_dtype: torch.dtype, scales: dict[str, torch.Tensor] | None = None,
             page_table: torch.Tensor | None = None, tc: bool = False) -> bool:
    """Validate a call; True when it runs on the card. Every code tensor
    must have ``code_shape``, every scale tensor its first three dims; the
    tensor-core kernel (``tc``) takes the head dims of :data:`TC_HEAD_DIMS`."""
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
    dims = TC_HEAD_DIMS if tc else HEAD_DIMS
    if D not in dims:
        raise ValueError(f"{name}: head_dim {D} not in {dims}")
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


def _arrivals(dev: torch.device, n: int) -> torch.Tensor:
    """The decode kernel's arrival counters on ``dev``: zeroed once, grown
    (anew, zeroed) to the largest ``n`` seen; each launch leaves every
    counter it used at 0."""
    buf = _ARRIVALS.get(dev)
    if buf is None or buf.numel() < n:
        buf = _ARRIVALS[dev] = torch.zeros(n, dtype=torch.int32, device=dev)
    return buf


def split_scratch_bytes(B: int, T: int, group: int, KVH: int, S: int, D: int) -> int:
    """Bytes of the decode kernel's partials for a launch of T query
    positions: per (b, kv head, row group of :data:`_ROW_GROUP` of the
    group * T rows, split of :data:`FLASH_SPLIT_KEYS` keys) and row, acc
    over D, then m and l, f32."""
    groups = B * KVH * -(-(group * T) // _ROW_GROUP)
    return groups * -(-S // FLASH_SPLIT_KEYS) * _ROW_GROUP * (D + 2) * 4


def split_rows(B: int, T: int, group: int, KVH: int, S: int, D: int) -> int:
    """Query positions a decode launch takes: all T where their partials fit
    :data:`FLASH_SPLIT_SCRATCH`, else the fewest even pieces that do (at
    least one row group's worth, whatever its bytes), from shapes alone."""
    one = split_scratch_bytes(B, _ROW_GROUP, 1, KVH, S, D)   # a row group each
    rows = max(1, FLASH_SPLIT_SCRATCH // one * _ROW_GROUP // group)
    if rows >= T:
        return T
    pieces = -(-T // rows)
    return -(-T // pieces)


def _split_work(q: torch.Tensor, rows: int, KVH: int, S: int) -> list[torch.Tensor]:
    """The decode kernel's partials' scratch and arrival counters (per (b,
    kv head, row group)) for launches of ``rows`` query positions, sized
    from shapes alone, before any launch."""
    B, _, H, D = q.shape
    group = H // KVH
    part = torch.empty(split_scratch_bytes(B, rows, group, KVH, S, D) // 4,
                       dtype=torch.float32, device=q.device)
    return [part, _arrivals(q.device, B * KVH * -(-(group * rows) // _ROW_GROUP))]


def _launch(name: str, tensors: list, ints: list, tc: bool = False) -> torch.Tensor:
    """Call C entry point ``lgt_<name>`` of ``csrc/flash_attention.cu`` (of
    ``csrc/flash_attention_tc.cu`` with ``tc``) with the pointers of
    ``tensors`` (q first, offsets and table in their places), out (the
    decode kernel then its scratch and counters), ``ints`` (B, T, H, KVH, S
    or NP and page_s, D; the decode kernel then :data:`FLASH_SPLIT_KEYS`),
    the softmax scale and the stream; count each launch.

    The decode kernel runs over pieces of :func:`split_rows` query
    positions when its partials for all T would pass
    :data:`FLASH_SPLIT_SCRATCH` (head_dim 256 prefill over long caches):
    piece t0 is the same call on q's rows t0.. with offsets + t0, through
    one scratch, each piece a launch."""
    tensors = [t.contiguous() for t in tensors]   # copies only offsets or a table
    q = tensors[0]
    lib = _build.library("flash_attention_tc" if tc else "flash_attention")
    fn = getattr(lib, "lgt_" + name)
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def call(parts: list, o: torch.Tensor, work: list, args: list) -> None:
        _build.check(fn(*[t.data_ptr() for t in [*parts, o, *work]], *args,
                        1.0 / q.shape[-1] ** 0.5, stream), name)
        _build.count(name)

    out = torch.empty_like(q)
    if tc:
        call(tensors, out, [], ints)
        return out
    paged = len(ints) == 7
    B, T, H, KVH = ints[:4]
    S = ints[4] * ints[5] if paged else ints[4]
    rows = split_rows(B, T, H // KVH, KVH, S, ints[-1])
    work = _split_work(q, rows, KVH, S)
    if rows == T:
        call(tensors, out, work, [*ints, FLASH_SPLIT_KEYS])
        return out
    oi = len(tensors) - 1 - paged                 # offsets, before a page table
    for t0 in range(0, T, rows):
        n = min(rows, T - t0)
        parts = list(tensors)
        parts[0] = q[:, t0:t0 + n].contiguous()
        parts[oi] = tensors[oi] + t0
        o = torch.empty_like(parts[0])
        call(parts, o, work, [B, n, *ints[2:], FLASH_SPLIT_KEYS])
        out[:, t0:t0 + n] = o
    return out


# -- kernels ------------------------------------------------------------------

def _card(q: torch.Tensor) -> bool:
    return q.device.type == "cuda"


def _takes_tc(q: torch.Tensor) -> bool:
    """Whether a call goes to the tensor-core kernel: on the card, from
    :data:`FLASH_TC_MIN_ROWS` query positions, at a head_dim of
    :data:`TC_HEAD_DIMS`."""
    return _card(q) and q.shape[1] >= FLASH_TC_MIN_ROWS and q.shape[-1] in TC_HEAD_DIMS


def flash_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, D) bf16; k/v (B, KVH, S, D) bf16; offsets (B,) int32
    -> (B, T, H, D) in q's dtype: :func:`flash_attention_tc` where
    :func:`_takes_tc`, else :func:`flash_attention_decode`."""
    fn = flash_attention_tc if _takes_tc(q) else flash_attention_decode
    return fn(q, k_cache, v_cache, offsets)


def _contig(name, q, k_cache, v_cache, offsets, tc=False):
    B, T, H, D = q.shape
    shape = (B, k_cache.shape[1], k_cache.shape[2], D)
    if not _on_card(name, q, offsets, {"k_cache": k_cache, "v_cache": v_cache},
                    shape, torch.bfloat16, tc=tc):
        return flash_attention_plain(q, k_cache, v_cache, offsets)
    return _launch(name, [q, k_cache, v_cache, offsets],
                   [B, T, H, shape[1], shape[2], D], tc)


def flash_attention_decode(q, k_cache, v_cache, offsets) -> torch.Tensor:
    """As :func:`flash_attention`, through the CUDA-core split kernel at any
    T; launches count under :data:`NAME`."""
    return _contig(NAME, q, k_cache, v_cache, offsets)


def flash_attention_tc(q, k_cache, v_cache, offsets) -> torch.Tensor:
    """As :func:`flash_attention`, through the tensor-core kernel at any T
    (head_dim 64 or 128; raises on another); launches count under
    :data:`NAME_TC`; the plain version is :func:`flash_attention_plain`."""
    return _contig(NAME_TC, q, k_cache, v_cache, offsets, tc=True)


def flash_attention_q8(q, kq, ks, vq, vs, offsets) -> torch.Tensor:
    """kq/vq (B, KVH, S, D) int8; ks/vs (B, KVH, S) f32:
    :func:`flash_attention_q8_tc` where :func:`_takes_tc`, else
    :func:`flash_attention_q8_decode`."""
    fn = flash_attention_q8_tc if _takes_tc(q) else flash_attention_q8_decode
    return fn(q, kq, ks, vq, vs, offsets)


def _q8(name, q, kq, ks, vq, vs, offsets, tc=False):
    B, T, H, D = q.shape
    shape = (B, kq.shape[1], kq.shape[2], D)
    if not _on_card(name, q, offsets, {"kq": kq, "vq": vq}, shape, torch.int8,
                    {"ks": ks, "vs": vs}, tc=tc):
        return flash_attention_q8_plain(q, kq, ks, vq, vs, offsets)
    return _launch(name, [q, kq, ks, vq, vs, offsets],
                   [B, T, H, shape[1], shape[2], D], tc)


def flash_attention_q8_decode(q, kq, ks, vq, vs, offsets) -> torch.Tensor:
    """As :func:`flash_attention_q8`, through the CUDA-core split kernel at
    any T; launches count under :data:`NAME_Q8`."""
    return _q8(NAME_Q8, q, kq, ks, vq, vs, offsets)


def flash_attention_q8_tc(q, kq, ks, vq, vs, offsets) -> torch.Tensor:
    """As :func:`flash_attention_q8`, through the tensor-core kernel at any
    T (the codes converted to bf16 in shared memory, the scales applied
    after the dots); launches count under :data:`NAME_Q8_TC`."""
    return _q8(NAME_Q8_TC, q, kq, ks, vq, vs, offsets, tc=True)


def flash_attention_q4(q, kq, ks, vq, vs, offsets) -> torch.Tensor:
    """kq/vq (B, KVH, S, D/2) uint8 planar nibbles biased by 8; ks/vs
    (B, KVH, S) f32: :func:`flash_attention_q4_tc` where :func:`_takes_tc`,
    else :func:`flash_attention_q4_decode`."""
    fn = flash_attention_q4_tc if _takes_tc(q) else flash_attention_q4_decode
    return fn(q, kq, ks, vq, vs, offsets)


def _q4(name, q, kq, ks, vq, vs, offsets, tc=False):
    B, T, H, D = q.shape
    shape = (B, kq.shape[1], kq.shape[2], D // 2)
    if not _on_card(name, q, offsets, {"kq": kq, "vq": vq}, shape, torch.uint8,
                    {"ks": ks, "vs": vs}, tc=tc):
        return flash_attention_q4_plain(q, kq, ks, vq, vs, offsets)
    return _launch(name, [q, kq, ks, vq, vs, offsets], [B, T, H, shape[1], shape[2], D], tc)


def flash_attention_q4_decode(q, kq, ks, vq, vs, offsets) -> torch.Tensor:
    """As :func:`flash_attention_q4`, through the CUDA-core split kernel at
    any T; launches count under :data:`NAME_Q4`."""
    return _q4(NAME_Q4, q, kq, ks, vq, vs, offsets)


def flash_attention_q4_tc(q, kq, ks, vq, vs, offsets) -> torch.Tensor:
    """As :func:`flash_attention_q4`, through the tensor-core kernel at any
    T (the nibbles converted to bf16 in shared memory, the scales applied
    after the dots); launches count under :data:`NAME_Q4_TC`."""
    return _q4(NAME_Q4_TC, q, kq, ks, vq, vs, offsets, tc=True)


def flash_attention_q41(q, kq, ks, km, vq, vs, vm, offsets) -> torch.Tensor:
    """kq/vq (B, KVH, S, D/2) uint8 unsigned planar nibbles; ks/vs scales
    and km/vm minimums (B, KVH, S) f32: :func:`flash_attention_q41_tc` where
    :func:`_takes_tc`, else :func:`flash_attention_q41_decode`."""
    fn = flash_attention_q41_tc if _takes_tc(q) else flash_attention_q41_decode
    return fn(q, kq, ks, km, vq, vs, vm, offsets)


def _q41(name, q, kq, ks, km, vq, vs, vm, offsets, tc=False):
    B, T, H, D = q.shape
    shape = (B, kq.shape[1], kq.shape[2], D // 2)
    if not _on_card(name, q, offsets, {"kq": kq, "vq": vq}, shape, torch.uint8,
                    {"ks": ks, "km": km, "vs": vs, "vm": vm}, tc=tc):
        return flash_attention_q41_plain(q, kq, ks, km, vq, vs, vm, offsets)
    return _launch(name, [q, kq, ks, km, vq, vs, vm, offsets],
                   [B, T, H, shape[1], shape[2], D], tc)


def flash_attention_q41_decode(q, kq, ks, km, vq, vs, vm, offsets) -> torch.Tensor:
    """As :func:`flash_attention_q41`, through the CUDA-core split kernel at
    any T; launches count under :data:`NAME_Q41`."""
    return _q41(NAME_Q41, q, kq, ks, km, vq, vs, vm, offsets)


def flash_attention_q41_tc(q, kq, ks, km, vq, vs, vm, offsets) -> torch.Tensor:
    """As :func:`flash_attention_q41`, through the tensor-core kernel at any
    T (the minimums folded in after the dots, as the scales); launches count
    under :data:`NAME_Q41_TC`."""
    return _q41(NAME_Q41_TC, q, kq, ks, km, vq, vs, vm, offsets, tc=True)


def flash_attention_paged(q, k_pool, v_pool, offsets, page_table) -> torch.Tensor:
    """Pools (P, KVH, page_s, D) bf16; page_table (B, NP) int32 maps slot
    b's logical page j to a pool page (-1: none, read as page 0):
    :func:`flash_attention_paged_tc` where :func:`_takes_tc`, else
    :func:`flash_attention_paged_decode`."""
    fn = flash_attention_paged_tc if _takes_tc(q) else flash_attention_paged_decode
    return fn(q, k_pool, v_pool, offsets, page_table)


def _paged(name, q, k_pool, v_pool, offsets, page_table, tc=False):
    B, T, H, D = q.shape
    P, KVH, page_s = k_pool.shape[:3]
    if not _on_card(name, q, offsets, {"k_pool": k_pool, "v_pool": v_pool},
                    (P, KVH, page_s, D), torch.bfloat16, page_table=page_table, tc=tc):
        return flash_attention_paged_plain(q, k_pool, v_pool, offsets, page_table)
    return _launch(name, [q, k_pool, v_pool, offsets, page_table],
                   [B, T, H, KVH, page_table.shape[1], page_s, D], tc)


def flash_attention_paged_decode(q, k_pool, v_pool, offsets, page_table) -> torch.Tensor:
    """As :func:`flash_attention_paged`, through the CUDA-core split kernel
    at any T; launches count under :data:`NAME_PAGED`."""
    return _paged(NAME_PAGED, q, k_pool, v_pool, offsets, page_table)


def flash_attention_paged_tc(q, k_pool, v_pool, offsets, page_table) -> torch.Tensor:
    """As :func:`flash_attention_paged`, through the tensor-core kernel at
    any T; launches count under :data:`NAME_PAGED_TC`."""
    return _paged(NAME_PAGED_TC, q, k_pool, v_pool, offsets, page_table, tc=True)


def flash_attention_paged_q8(q, kq, ks, vq, vs, offsets, page_table) -> torch.Tensor:
    """Pools kq/vq (P, KVH, page_s, D) int8 and ks/vs (P, KVH, page_s)
    f32, through page_table as :func:`flash_attention_paged`:
    :func:`flash_attention_paged_q8_tc` where :func:`_takes_tc`, else
    :func:`flash_attention_paged_q8_decode`."""
    fn = flash_attention_paged_q8_tc if _takes_tc(q) else flash_attention_paged_q8_decode
    return fn(q, kq, ks, vq, vs, offsets, page_table)


def _paged_q8(name, q, kq, ks, vq, vs, offsets, page_table, tc=False):
    B, T, H, D = q.shape
    P, KVH, page_s = kq.shape[:3]
    if not _on_card(name, q, offsets, {"kq": kq, "vq": vq},
                    (P, KVH, page_s, D), torch.int8, {"ks": ks, "vs": vs},
                    page_table=page_table, tc=tc):
        return flash_attention_paged_q8_plain(q, kq, ks, vq, vs, offsets, page_table)
    return _launch(name, [q, kq, ks, vq, vs, offsets, page_table],
                   [B, T, H, KVH, page_table.shape[1], page_s, D], tc)


def flash_attention_paged_q8_decode(q, kq, ks, vq, vs, offsets, page_table) -> torch.Tensor:
    """As :func:`flash_attention_paged_q8`, through the CUDA-core split
    kernel at any T; launches count under :data:`NAME_PAGED_Q8`."""
    return _paged_q8(NAME_PAGED_Q8, q, kq, ks, vq, vs, offsets, page_table)


def flash_attention_paged_q8_tc(q, kq, ks, vq, vs, offsets, page_table) -> torch.Tensor:
    """As :func:`flash_attention_paged_q8`, through the tensor-core kernel at
    any T; launches count under :data:`NAME_PAGED_Q8_TC`."""
    return _paged_q8(NAME_PAGED_Q8_TC, q, kq, ks, vq, vs, offsets, page_table, tc=True)


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
