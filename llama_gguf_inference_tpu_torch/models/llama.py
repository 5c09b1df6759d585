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
            k=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(cfg.n_layers)],
            v=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(cfg.n_layers)])

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[2]

    def slot(self, b: int) -> "KVCache":
        """Views of sequence b's rows (writes land in this cache)."""
        return KVCache(k=[a[b:b + 1] for a in self.k],
                       v=[a[b:b + 1] for a in self.v])

    def write_index(self, offsets: torch.Tensor, T: int):
        return _write_index(offsets, T, self.max_seq)

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
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32, device=dev),
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


def _write_index(offsets: torch.Tensor, T: int, S: int):
    """(b, t, row, s) index vectors of the chunk rows that land inside the
    cache: chunk row (b, t) goes to cache row b, slot s.

    Rows at s >= S are dropped. They can only be padding: callers keep each
    sequence's real tokens within S. The JAX package's dynamic-update-slice
    instead clamps the whole chunk's start to S - T, shifting real rows;
    the two agree whenever offset + T <= S.
    """
    pos = offsets.long()[:, None] + torch.arange(T, device=offsets.device)[None, :]
    bi, ti = torch.nonzero(pos < S, as_tuple=True)
    return bi, ti, bi, pos[bi, ti]


def _write_kv(cache: torch.Tensor, new: torch.Tensor, idx) -> None:
    """cache (rows, H, S, ...) <- new (B, T, H, ...) in place: chunk row
    (b, t) of idx lands at (row, :, s)."""
    bi, ti, row, si = idx
    cache[row, :, si] = new[bi, ti].to(cache.dtype)


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
