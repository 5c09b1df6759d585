"""Llama forward graph in PyTorch.

One function handles prefill (T = chunk) and decode (T = 1). Weights are
``LinearWeight`` containers (dense or quantized-resident), norms are f32
tensors, the KV cache is preallocated per layer and written in place at
per-sequence offsets: (B, KVH, S, D) bf16 here, quantized in
``runtime/kv_cache.py``, paged in ``runtime/paged_kv.py``. RoPE follows the GGUF "norm"
convention (interleaved pairs), which llama files are converted for.

Layouts, rounding points and masking follow the JAX package's
``models/llama.py``; where the port departs from it, the docstring says so.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..ops import flash_attention as fa
from ..ops.linear import embed_lookup, matmul
from .config import ModelConfig

Params = dict[str, Any]  # layer i under params["layers"][i]


@dataclasses.dataclass
class KVCache:
    """Per-layer buffers: k, v are L-lists of (B, KVH, S_max, head_dim),
    the flash kernel's layout. Written in place.

    Every cache kind (this one, ``runtime.kv_cache``'s quantized ones and
    ``runtime.paged_kv``'s paged ones) offers the same four methods:
    ``write_index`` (where a chunk's rows land), ``write`` (store a layer's
    new K/V there), ``attend`` (its attention kernel) and ``slot`` (the view
    of one sequence that prefill writes through)."""

    k: list
    v: list

    @staticmethod
    def zeros(cfg: ModelConfig, batch: int, max_seq: int,
              device: str | torch.device, dtype=torch.bfloat16) -> "KVCache":
        shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        return KVCache(
            k=[sink_zeros(shape, dtype, device) for _ in range(cfg.n_layers)],
            v=[sink_zeros(shape, dtype, device) for _ in range(cfg.n_layers)])

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[2]

    def slot(self, b: int) -> "KVCache":
        """Views of sequence b's rows (writes land in this cache)."""
        return KVCache(k=[a[b:b + 1] for a in self.k],
                       v=[a[b:b + 1] for a in self.v])

    def write_index(self, offsets: torch.Tensor, T: int):
        return _write_index(offsets, T, self.k[0])

    def write(self, layer: int, k: torch.Tensor, v: torch.Tensor, idx) -> None:
        _write_kv(self.k[layer], k, idx)
        _write_kv(self.v[layer], v, idx)

    def attend(self, layer: int, q: torch.Tensor, offsets: torch.Tensor):
        return fa.flash_attention(q, self.k[layer], self.v[layer], offsets)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Whole product in f32, ONE cast back to x.dtype at the end: an f32
    norm weight must not promote the activations downstream."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope_angles(positions: torch.Tensor, rope_dim: int, base: float,
                cfg: ModelConfig | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (B, T) -> (B, T, rope_dim // 2) f32, with
    the GGUF rope scaling "linear" (position / factor) or "llama3"
    (frequency-dependent wavelength interpolation)."""
    half = rope_dim // 2
    dev = positions.device
    # torch.full, not torch.tensor: a copy from the host would wait for
    # the card's queue on every forward
    freqs = torch.pow(torch.full((), base, dtype=torch.float32, device=dev),
                      -torch.arange(half, dtype=torch.float32, device=dev) / half)
    pos = positions.float()
    if cfg is not None and cfg.rope_scaling_type == "linear" \
            and cfg.rope_scaling_factor > 1.0:
        pos = pos / cfg.rope_scaling_factor
    elif cfg is not None and cfg.rope_scaling_type == "llama3" \
            and cfg.rope_orig_ctx > 0:
        factor = cfg.rope_scaling_factor
        low, high = cfg.rope_low_freq_factor, cfg.rope_high_freq_factor
        old_len = float(cfg.rope_orig_ctx)
        wavelen = 2.0 * math.pi / freqs
        smooth = ((old_len / wavelen - low) / max(high - low, 1e-6)).clamp(0.0, 1.0)
        scaled = freqs / factor
        freqs = torch.where(wavelen > old_len / low, scaled,
                            torch.where(wavelen < old_len / high, freqs,
                                        (1.0 - smooth) * scaled + smooth * freqs))
    ang = pos[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, head_dim). Rotates interleaved pairs (2i, 2i+1) of the
    first rope_dim dims of each head, in f32."""
    half = cos.shape[-1]
    xf = x.float()
    x0, x1 = xf[..., 0:2 * half:2], xf[..., 1:2 * half:2]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    rot = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).flatten(-2)
    if 2 * half != x.shape[-1]:
        rot = torch.cat([rot, xf[..., 2 * half:]], dim=-1)
    return rot.to(x.dtype)


def sink_zeros(shape: tuple, dtype=torch.float32, device="cpu",
               fill: int | float = 0) -> torch.Tensor:
    """A cache tensor (N, KVH, S, ...) filled with ``fill`` whose storage
    runs on for KVH more rows of its trailing shape: the sink rows that
    the KV writes send every dropped chunk row to (one per kv head). No
    kernel reads them, so they are not part of the cache."""
    n, kvh, s, *rest = shape
    buf = torch.full((n * kvh * s + kvh, *rest), fill, dtype=dtype, device=device)
    return buf[:n * kvh * s].view(shape)


def with_sink(t: torch.Tensor) -> torch.Tensor:
    """A copy of the cache tensor ``t`` with sink rows (:func:`sink_zeros`)."""
    out = sink_zeros(tuple(t.shape), t.dtype, t.device)
    out.copy_(t)
    return out


def _rows(t: torch.Tensor) -> torch.Tensor:
    """The cache tensor ``t`` (N, KVH, S, ...) as a view of rows of its
    trailing shape, from its first row to the end of its storage: its
    N * KVH * S rows, the rows of any later slots when ``t`` is one slot's
    view, then the KVH sink rows."""
    rest = t.shape[3:]
    row = 1
    for d in rest:
        row *= d
    n = t.untyped_storage().nbytes() // t.element_size() - t.storage_offset()
    if not t.is_contiguous() or t.storage_offset() % row \
            or n // row < t.shape[0] * t.shape[1] * t.shape[2] + t.shape[1]:
        raise ValueError(f"cache tensor {tuple(t.shape)} has no sink rows "
                         "(allocate it with sink_zeros)")
    return torch.as_strided(t, (n // row, *rest), (row, *t.stride()[3:]),
                            t.storage_offset())


def _sink_index(rows: torch.Tensor, dest: torch.Tensor, t: torch.Tensor
                ) -> torch.Tensor:
    """(B, T, KVH) row indices of :func:`_rows` (``t``): kv head h of chunk
    row (b, t) at ``rows[b, t] * KVH + h`` (a ``(N, KVH, S)`` flat index
    without the head) where ``dest`` holds, else at sink row h."""
    S, KVH = t.shape[2], t.shape[1]
    sink = _rows(t).shape[0] - KVH
    h = torch.arange(KVH, device=rows.device)
    flat = ((rows // S * KVH)[..., None] + h) * S + (rows % S)[..., None]
    return torch.where(dest[..., None], flat, sink + h)


def _write_index(offsets: torch.Tensor, T: int, t: torch.Tensor) -> torch.Tensor:
    """Where a (B, T) chunk's rows land in a contiguous cache shaped like
    ``t`` (B, KVH, S, ...): chunk row (b, t) at slot ``offsets[b] + t`` of
    cache row b, as (B, T, KVH) indices of :func:`_rows` (``t``).

    Rows at s >= S go to the sink rows. They can only be padding: callers
    keep each sequence's real tokens within S. Static shapes and no read
    of ``offsets`` on the host, so a forward never waits for the card. The
    JAX package's dynamic-update-slice instead clamps the whole chunk's
    start to S - T, shifting real rows; the two agree whenever
    offset + T <= S.
    """
    B, S = offsets.shape[0], t.shape[2]
    pos = offsets.long()[:, None] + torch.arange(T, device=offsets.device)[None, :]
    b = torch.arange(B, device=offsets.device)[:, None]
    return _sink_index(b * S + pos.clamp(max=S - 1), pos < S, t)


def _write_kv(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> None:
    """cache (rows, H, S, ...) <- new (B, T, H, ...) in place, each (chunk
    row, head) vector at its row of ``idx`` (:func:`_write_index`). Two
    indices meet only in the sink rows, which nothing reads."""
    _rows(cache)[idx] = new.to(cache.dtype)


def attention(layer: Params, cfg: ModelConfig, x: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor, cache,
              layer_idx: int, offsets: torch.Tensor, write_idx) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D); writes this chunk's K/V into the cache
    (quantizing it for a quantized cache) and runs the cache's attention
    kernel, as the JAX package dispatches on the cache type."""
    B, T, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if "attn_qkv" in layer:
        q, k, v = torch.split(matmul(layer["attn_qkv"], x),
                              [H * hd, KVH * hd, KVH * hd], dim=-1)
    else:
        q = matmul(layer["attn_q"], x)
        k = matmul(layer["attn_k"], x)
        v = matmul(layer["attn_v"], x)
    q = apply_rope(q.reshape(B, T, H, hd), cos, sin)
    k = apply_rope(k.reshape(B, T, KVH, hd), cos, sin)
    v = v.reshape(B, T, KVH, hd)
    cache.write(layer_idx, k, v, write_idx)
    ctx = cache.attend(layer_idx, q.contiguous(), offsets)
    return matmul(layer["attn_output"], ctx.reshape(B, T, H * hd).to(x.dtype))


def shift_cache_slot(cache, cfg: ModelConfig, b: int, keep: int, discard: int) -> None:
    """Context shift (llama-server ``--ctx-shift``): roll slot ``b``'s KV
    left by ``discard`` positions beyond ``keep`` and re-rope the moved K by
    ``-angle(discard)``, in place, as the JAX package's function does.

    The delta rotation is exact for the scalings the port has (none, linear,
    llama3), whose angle is linear in the position, up to the re-rounding
    of already rounded values (llama.cpp's K-shift has the same property).
    A bf16 cache rolls and rotates K and rolls V. A quantized cache
    (``runtime.kv_cache``) dequantizes slot b's K to f32, rolls, rotates
    and requantizes it, and rolls V's codes, scales and minimums directly,
    which is exact. Positions below ``keep`` are never written, so they
    stay bit-identical.

    Every cache tensor is a view into storage that runs on into sink rows
    (:func:`sink_zeros`), so the shift writes into slot b's rows of the
    same tensors (``copy_``) and never rebinds them; rolls run over the
    ``S`` axis of the slot's (KVH, S, ...) view, never over the storage or
    the packed 4-bit ``D`` axis. Contiguous caches only.
    """
    first = cache.k[0] if isinstance(cache, KVCache) else cache.k_q[0]
    delta = torch.full((1, 1), float(discard), dtype=torch.float32, device=first.device)
    cos_d, sin_d = rope_angles(delta, cfg.rope_dim, cfg.rope_base, cfg)

    def rope_rolled(kf: torch.Tensor) -> torch.Tensor:
        """(KVH, S, D) f32 -> rolled along S and rotated by -delta."""
        x = torch.roll(kf, -discard, dims=1).transpose(0, 1)[None]   # (1, S, KVH, D)
        return apply_rope(x, cos_d, -sin_d)[0].transpose(0, 1)

    def put(buf: torch.Tensor, new: torch.Tensor) -> None:
        buf[b, :, keep:].copy_(new[:, keep:])

    if isinstance(cache, KVCache):
        for k, v in zip(cache.k, cache.v):
            put(k, rope_rolled(k[b].float()).to(k.dtype))
            put(v, torch.roll(v[b], -discard, dims=1))
        return
    cls = type(cache)
    for li in range(cfg.n_layers):
        kf = cls.dequantize(*(getattr(cache, f)[li][b] for f in cls.K_FIELDS),
                            dtype=torch.float32)
        for f, new in zip(cls.K_FIELDS, cls.quantize(rope_rolled(kf))):
            buf = getattr(cache, f)[li]
            put(buf, new.to(buf.dtype))
        for f in cls.V_FIELDS:
            buf = getattr(cache, f)[li]
            put(buf, torch.roll(buf[b], -discard, dims=1))


def ffn_swiglu(layer: Params, x: torch.Tensor) -> torch.Tensor:
    if "ffn_gateup" in layer:
        gate, up = matmul(layer["ffn_gateup"], x).chunk(2, dim=-1)
    else:
        gate = matmul(layer["ffn_gate"], x)
        up = matmul(layer["ffn_up"], x)
    g = F.silu(gate.float())
    return matmul(layer["ffn_down"], g.to(x.dtype) * up)


def forward(params: Params, cfg: ModelConfig, token_ids: torch.Tensor,
            offsets: torch.Tensor, cache,
            logits_at: torch.Tensor | None = None,
            return_hidden: bool = False):
    """One model step over a (B, T) token chunk.

    Args:
      token_ids: (B, T) int — right-padded chunk
      offsets: (B,) int32 — tokens already in each sequence's cache
      cache: any cache kind (:class:`KVCache`, ``runtime.kv_cache``,
        ``runtime.paged_kv``), written in place
      logits_at: optional (B,) chunk row per sequence; the head then runs on
        that row only and logits are (B, 1, vocab) (the engine reads one row
        per prefill chunk, so the others are never computed)

    Returns:
      logits (B, T, vocab) f32 (bf16-rounded, as the head's output is cast to
      the activation dtype), and with ``return_hidden`` the final-normed
      hidden states. Padded rows get outputs nobody should read.
    """
    B, T = token_ids.shape
    x = embed_lookup(params["tok_embd"], token_ids)
    positions = offsets.long()[:, None] + torch.arange(
        T, device=token_ids.device)[None, :]
    cos, sin = rope_angles(positions, cfg.rope_dim, cfg.rope_base, cfg)
    write_idx = cache.write_index(offsets, T)

    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        x = x + attention(layer, cfg, h, cos, sin, cache, i, offsets, write_idx)
        h = rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
        x = x + ffn_swiglu(layer, h)

    x = rms_norm(x, params["output_norm"], cfg.rms_eps)
    hx = x
    if logits_at is not None:
        hx = x[torch.arange(B, device=x.device), logits_at.long()][:, None]
    logits = matmul(params["output"], hx).float()
    if return_hidden:
        return logits, x
    return logits
