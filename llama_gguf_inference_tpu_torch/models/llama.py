"""Llama-family forward graph in PyTorch: llama (and Mixtral's routed
experts), qwen2, qwen3, qwen2moe, qwen3moe, gemma, gemma2, gemma3, phi3,
starcoder2, deepseek2, granite, command-r and olmo2.

One function handles prefill (T = chunk) and decode (T = 1). Weights are
``LinearWeight`` containers (dense or quantized-resident), norms are f32
tensors, the KV cache is preallocated per layer and written in place at
per-sequence offsets: (B, KVH, S, D) bf16 here, quantized in
``runtime/kv_cache.py``, paged in ``runtime/paged_kv.py``. RoPE follows the
file's GGUF style: "norm" (interleaved pairs) for llama, granite and
command-r, "neox" (halves) for the others. The per-architecture deltas come
from ``ModelConfig`` (scales, softcaps, activation, window) and from the
optional tensors of a layer (biases, q/k norms, post-norms), so one graph
covers the family.

Attention runs the cache's flash kernel, except on layers that slide or
softcap (gemma2, gemma3's local layers, phi3's window): those take
:func:`masked_attention`, a masked softmax over the cache's bf16 view, as
the JAX package sends them to its XLA path on every cache kind. deepseek2's
latent attention (:func:`attention_mla`) caches the latent itself, one
shared head whose k and v widths differ, and runs a masked softmax in f32.

A layer with routed experts (:func:`ffn_moe`) picks each token's top-k
experts on the card (:func:`moe_route`). A decode step (at most 16 rows)
runs them through one expert-indexed launch of the decode kernel a role
(:func:`_moe_cond`, ``ops.quant_matmul.expert_matmul``), so no expert is
chosen on the host; a prefill chunk gathers each expert's top-C tokens
(:func:`_moe_capacity`). ``LGT_MOE_DENSE=1`` runs every expert on every
token (:func:`_moe_dense`, the parity oracle) and ``LGT_MOE_CAPACITY``
(2.0) sets the capacity factor, as in the JAX package.

Layouts, rounding points and masking follow the JAX package's
``models/llama.py``; where the port departs from it, the docstring says so.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import torch
import torch.nn.functional as F

from ..ops import flash_attention as fa
from ..ops.linear import embed_lookup, matmul
from ..ops.quant_matmul import expert_matmul, expert_view
from .config import ModelConfig

Params = dict[str, Any]  # layer i under params["layers"][i]


@dataclasses.dataclass
class KVCache:
    """Per-layer buffers: k, v are L-lists of (B, KVH, S_max, head_dim),
    the flash kernel's layout (MLA: one head, k and v of
    ``cfg.kv_cache_dims``). Written in place.

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
        dk, dv = cfg.kv_cache_dims
        kvh = cfg.cache_kv_heads
        return KVCache(
            k=[sink_zeros((batch, kvh, max_seq, dk), dtype, device) for _ in range(cfg.n_layers)],
            v=[sink_zeros((batch, kvh, max_seq, dv), dtype, device) for _ in range(cfg.n_layers)])

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

    def view(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Layer ``layer``'s (B, KVH, S, D) bf16 K and V, for
        :func:`masked_attention` (the buffers themselves)."""
        return self.k[layer], self.v[layer]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Whole product in f32, ONE cast back to x.dtype at the end: an f32
    norm weight must not promote the activations downstream."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
               eps: float) -> torch.Tensor:
    """Mean-centred LayerNorm with an optional bias (starcoder2, command-r),
    in f32 with one cast back to x.dtype."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps) * w
    if b is not None:
        out = out + b
    return out.to(x.dtype)


def _norm(x: torch.Tensor, container: Params, key: str, cfg: ModelConfig) -> torch.Tensor:
    """A block norm of ``cfg.norm_type`` (the q/k head norms stay RMS)."""
    if cfg.norm_type == "layernorm":
        return layer_norm(x, container[key], container.get(key + "_bias"), cfg.rms_eps)
    return rms_norm(x, container[key], cfg.rms_eps)


def rope_angles(positions: torch.Tensor, rope_dim: int, base: float,
                cfg: ModelConfig | None = None,
                freq_factors: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (B, T) -> (B, T, rope_dim // 2) f32, with
    the GGUF rope scaling "linear" (position / factor), "yarn" (a ramp
    between the original and the divided frequencies), "llama3"
    (frequency-dependent wavelength interpolation) or "longrope" (phi3: the
    per-dim ``freq_factors`` divide the frequencies and
    ``cfg.rope_attn_factor`` scales the magnitudes)."""
    half = rope_dim // 2
    dev = positions.device
    # torch.full, not torch.tensor: a copy from the host would wait for
    # the card's queue on every forward
    freqs = torch.pow(torch.full((), base, dtype=torch.float32, device=dev),
                      -torch.arange(half, dtype=torch.float32, device=dev) / half)
    pos = positions.float()
    if freq_factors is not None:
        freqs = freqs / freq_factors
    if cfg is not None and cfg.rope_scaling_type == "linear" \
            and cfg.rope_scaling_factor > 1.0:
        pos = pos / cfg.rope_scaling_factor
    elif cfg is not None and cfg.rope_scaling_type == "yarn" \
            and cfg.rope_orig_ctx > 0 and cfg.rope_scaling_factor > 1.0:
        # high-frequency dims keep their frequency, low-frequency ones divide
        # by the factor, a linear ramp between the dims whose wavelength
        # makes 32 and 1 rotations over the original context
        def corr_dim(n_rot: float) -> float:
            return rope_dim * math.log(cfg.rope_orig_ctx / (n_rot * 2 * math.pi)) \
                / (2 * math.log(base))

        low = max(math.floor(corr_dim(32.0)), 0)
        high = min(math.ceil(corr_dim(1.0)), rope_dim - 1)
        ramp = ((torch.arange(half, dtype=torch.float32, device=dev) - low)
                / max(high - low, 1e-3)).clamp(0.0, 1.0)
        freqs = (freqs / cfg.rope_scaling_factor) * ramp + freqs * (1.0 - ramp)
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
    cos, sin = torch.cos(ang), torch.sin(ang)
    if cfg is not None and cfg.rope_attn_factor != 1.0:
        cos, sin = cos * cfg.rope_attn_factor, sin * cfg.rope_attn_factor
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleaved: bool = True) -> torch.Tensor:
    """x: (B, T, H, head_dim). Rotates the first rope_dim dims of each head
    in f32: interleaved pairs (2i, 2i+1) (GGUF "norm"), else the halves
    (i, i + rope_dim/2) (GGUF "neox")."""
    half = cos.shape[-1]
    xf = x.float()
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    if interleaved:
        x0, x1 = xf[..., 0:2 * half:2], xf[..., 1:2 * half:2]
        rot = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).flatten(-2)
    else:
        x0, x1 = xf[..., :half], xf[..., half:2 * half]
        rot = torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
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


def _biased(y: torch.Tensor, layer: Params, key: str) -> torch.Tensor:
    """``y`` plus the f32 bias ``layer[key]`` where the layer has one, in f32
    with one cast back."""
    if key not in layer:
        return y
    return (y.float() + layer[key]).to(y.dtype)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     offsets: torch.Tensor, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Attention as the JAX package's XLA path computes it, for the layers
    the flash kernels do not take: q (B, T, H, D) against the (B, KVH, S, D)
    views k and v, f32 scores over ``sqrt(D)``, ``softcap · tanh(scores /
    softcap)`` when ``softcap``, the causal mask (key s seen by query t iff
    ``s <= offsets[b] + t``) and, with a ``window``, only the keys with
    ``offsets[b] + t - s < window``, at -1e30; f32 softmax and P·V, one cast
    to q's dtype."""
    B, T, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    qh = q.float().reshape(B, T, KVH, H // KVH, D)
    scores = torch.einsum("btkgd,bksd->bkgts", qh, k.float()) / math.sqrt(float(D))
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    pos = offsets.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    s_idx = torch.arange(S, device=q.device)[None, None, :]
    mask = s_idx <= pos[:, :, None]
    if window > 0:
        mask = mask & (pos[:, :, None] - s_idx < window)
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgts,bksd->btkgd", probs, v.float())
    return ctx.reshape(B, T, H, D).to(q.dtype)


def attention(layer: Params, cfg: ModelConfig, x: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor, cache,
              layer_idx: int, offsets: torch.Tensor, write_idx,
              sliding: bool = False) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D); writes this chunk's K/V into the cache
    (quantizing it for a quantized cache) and runs the cache's attention
    kernel, as the JAX package dispatches on the cache type; a ``sliding``
    or softcapped layer runs :func:`masked_attention` over the cache's view
    instead (the JAX package's ``flash_ok``)."""
    B, T, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if "attn_qkv" in layer:
        qkv = _biased(matmul(layer["attn_qkv"], x), layer, "attn_qkv_bias")
        q, k, v = torch.split(qkv, [H * hd, KVH * hd, KVH * hd], dim=-1)
    else:
        q = _biased(matmul(layer["attn_q"], x), layer, "attn_q_bias")
        k = _biased(matmul(layer["attn_k"], x), layer, "attn_k_bias")
        v = _biased(matmul(layer["attn_v"], x), layer, "attn_v_bias")
        if "attn_q_norm" in layer and layer["attn_q_norm"].shape[-1] == q.shape[-1] != hd:
            # olmo2: RMSNorm over the flat projection, before the heads (the
            # weight's size tells it from the per-head norm below)
            q = rms_norm(q, layer["attn_q_norm"], cfg.rms_eps)
            k = rms_norm(k, layer["attn_k_norm"], cfg.rms_eps)
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, KVH, hd)
    v = v.reshape(B, T, KVH, hd)
    if "attn_q_norm" in layer and layer["attn_q_norm"].shape[-1] == hd:
        # qwen3, gemma3: a per-head RMSNorm before the rope
        q = rms_norm(q, layer["attn_q_norm"], cfg.rms_eps)
        k = rms_norm(k, layer["attn_k_norm"], cfg.rms_eps)
    q = apply_rope(q, cos, sin, cfg.rope_interleaved)
    k = apply_rope(k, cos, sin, cfg.rope_interleaved)
    if cfg.attn_scale > 0.0:
        # a query scale other than 1/sqrt(head_dim) (gemma2, gemma3-27B,
        # granite), folded into q so that every attention path stays right
        q = (q.float() * (cfg.attn_scale * math.sqrt(float(hd)))).to(q.dtype)
    cache.write(layer_idx, k, v, write_idx)
    if sliding or cfg.attn_softcap > 0.0:
        k_all, v_all = cache.view(layer_idx)
        ctx = masked_attention(q, k_all, v_all, offsets,
                               cfg.sliding_window if sliding else 0, cfg.attn_softcap)
    else:
        ctx = cache.attend(layer_idx, q.contiguous(), offsets)
    out = matmul(layer["attn_output"], ctx.reshape(B, T, H * hd).to(x.dtype))
    return _biased(out, layer, "attn_output_bias")


def attention_mla(layer: Params, cfg: ModelConfig, x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, cache, layer_idx: int, offsets: torch.Tensor,
                  write_idx) -> torch.Tensor:
    """deepseek2's multi-head latent attention over a latent-resident cache,
    as the JAX package's ``attention_mla``: ``kv_a`` emits [c_kv; k_pe], the
    cache holds the roped k_pe (k, ``qk_rope_head_dim`` wide) and the normed
    c_kv (v, ``kv_lora_rank`` wide) of one shared head, and the queries
    absorb ``kv_b``'s k half (``attn_kv_b_k``, (H, dn, C)):

        score_h(s) = (W_uk[h]ᵀ q_nope_h) · c_s + q_pe_h · k_pe_s
        out_h      = W_uv[h] · Σ_s p_h(s) c_s

    q_lat, the scores, the softmax and the latent context in f32, the causal
    mask at -1e30, W_uv (``attn_kv_b_v``, (H, dv, C)) expanding the context
    back; a direct q projection (V2-Lite) or the query LoRA
    (``attn_q_a``, its norm, ``attn_q_b``). The rope is the interleaved
    pairs' (HF's de-interleave before a half rotation). The port's forward
    takes no chunk lengths, so a padded query row sees its causal keys where
    the JAX package masks it whole; nothing reads its output, but it is
    routed (and competes for capacity) with other hidden states there."""
    B, T, _ = x.shape
    H, dn, dr, C = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    if "attn_q_a" in layer:
        q = matmul(layer["attn_q_b"], rms_norm(matmul(layer["attn_q_a"], x),
                                               layer["attn_q_a_norm"], cfg.rms_eps))
    else:
        q = matmul(layer["attn_q"], x)
    q = q.reshape(B, T, H, dn + dr)
    q_nope = q[..., :dn]
    q_pe = apply_rope(q[..., dn:], cos, sin, cfg.rope_interleaved)
    kv = matmul(layer["attn_kv_a_mqa"], x)
    c_kv = rms_norm(kv[..., :C], layer["attn_kv_a_norm"], cfg.rms_eps)
    k_pe = apply_rope(kv[..., C:].reshape(B, T, 1, dr), cos, sin, cfg.rope_interleaved)
    q_lat = torch.einsum("bthd,hdc->bthc", q_nope.float(), layer["attn_kv_b_k"].float())
    cache.write(layer_idx, k_pe, c_kv.reshape(B, T, 1, C), write_idx)
    k_all, v_all = cache.view(layer_idx)
    lat, kpe = v_all[:, 0].float(), k_all[:, 0].float()
    scale = cfg.attn_scale if cfg.attn_scale > 0.0 else 1.0 / math.sqrt(float(dn + dr))
    scores = (torch.einsum("bthc,bsc->bhts", q_lat, lat)
              + torch.einsum("bthd,bsd->bhts", q_pe.float(), kpe)) * scale
    S = lat.shape[1]
    pos = offsets.long()[:, None] + torch.arange(T, device=x.device)[None, :]
    mask = torch.arange(S, device=x.device)[None, None, :] <= pos[:, :, None]
    scores = torch.where(mask[:, None], scores, torch.full_like(scores, -1e30))
    ctx_lat = torch.einsum("bhts,bsc->bthc", torch.softmax(scores, dim=-1), lat)
    ctx = torch.einsum("bthc,hvc->bthv", ctx_lat, layer["attn_kv_b_v"].float())
    return matmul(layer["attn_output"], ctx.reshape(B, T, H * cfg.v_head_dim).to(x.dtype))


def shift_cache_slot(cache, cfg: ModelConfig, b: int, keep: int, discard: int) -> None:
    """Context shift (llama-server ``--ctx-shift``): roll slot ``b``'s KV
    left by ``discard`` positions beyond ``keep`` and re-rope the moved K by
    ``-angle(discard)``, in place, as the JAX package's function does.

    The delta rotation, in the file's rope style (interleaved or neox), is
    exact for the scalings whose angle is linear in the position (none,
    linear, llama3, yarn), up to the re-rounding
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
        return apply_rope(x, cos_d, -sin_d, cfg.rope_interleaved)[0].transpose(0, 1)

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


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    return F.gelu(x, approximate="tanh") if act == "gelu_tanh" else F.silu(x)


def ffn_mlp(layer: Params, x: torch.Tensor, act: str = "gelu_tanh") -> torch.Tensor:
    """Un-gated MLP: up -> act -> down, with optional biases (starcoder2)."""
    up = matmul(layer["ffn_up"], x).float()
    if "ffn_up_bias" in layer:
        up = up + layer["ffn_up_bias"]
    return _biased(matmul(layer["ffn_down"], _act(up, act).to(x.dtype)), layer, "ffn_down_bias")


def ffn_swiglu(layer: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: SwiGLU, or GeGLU (gemma) with ``act="gelu_tanh"``."""
    if "ffn_gateup" in layer:
        gate, up = matmul(layer["ffn_gateup"], x).chunk(2, dim=-1)
    else:
        gate = matmul(layer["ffn_gate"], x)
        up = matmul(layer["ffn_up"], x)
    g = _act(gate.float(), act)
    return matmul(layer["ffn_down"], g.to(x.dtype) * up)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index, as
    ``lax.top_k`` breaks them (``torch.topk`` does not promise an order, and
    the router's bf16 logits tie often): a stable descending sort."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def moe_route(layer: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each token's routed experts: (B, T, k) weights and expert ids, as the
    JAX package's ``moe_router`` picks them. The router's softmax in f32;
    with expert groups only the best ``topk_groups`` groups (by their best
    expert) stay; the top-k renormalised where ``moe_renorm``, times
    ``routed_scale``."""
    n_exp, k = cfg.n_experts, cfg.n_experts_used
    probs = torch.softmax(matmul(layer["ffn_gate_inp"], x).float(), dim=-1)
    if cfg.n_expert_groups > 1:
        g = cfg.n_expert_groups
        gsize = n_exp // g
        topg = _top_k(probs.reshape(*probs.shape[:-1], g, gsize).amax(-1), cfg.topk_groups)[1]
        # the kept groups as a 0/1 mask (a scatter: one_hot checks its
        # indices on the host)
        gmask = torch.zeros(*probs.shape[:-1], g, device=x.device).scatter(-1, topg, 1.0)
        probs = probs * gmask.repeat_interleave(gsize, dim=-1)
    topv, topi = _top_k(probs, k)
    if cfg.moe_renorm:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    if cfg.routed_scale != 1.0:
        topv = topv * cfg.routed_scale
    return topv, topi


def route_weights(cfg: ModelConfig, topv: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """The routed weights scattered to per-expert columns (B, T, E), zero
    for the experts a token was not routed to."""
    return torch.zeros(*topv.shape[:-1], cfg.n_experts, dtype=topv.dtype,
                       device=topv.device).scatter(-1, topi, topv)


def moe_router(layer: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``moe_router``: (B, T, E) routed weights."""
    return route_weights(cfg, *moe_route(layer, cfg, x))


def _expert_views(st: Params, n_experts: int) -> list[Params]:
    """Per-expert weight dicts of the stacked (E, ...)-leading arrays
    (views of the same storage)."""
    return [{role: expert_view(w, e) for role, w in st.items()} for e in range(n_experts)]


def _moe_dense(experts: list[Params], cfg: ModelConfig, x: torch.Tensor,
               w_exp: torch.Tensor) -> torch.Tensor:
    """The parity oracle: every expert on every token, each output in f32
    times its weight and summed in ascending expert order."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        out = out + ffn_swiglu(experts[e], x).float() * w_exp[..., e:e + 1]
    return out.to(x.dtype)


def _moe_cond(st: Params, cfg: ModelConfig, x: torch.Tensor, topv: torch.Tensor,
              topi: torch.Tensor) -> torch.Tensor:
    """The decode path: the routed (token, slot) pairs sorted by expert
    (stably), their activation rows gathered, and one expert-indexed launch a
    role (``ops.quant_matmul.expert_matmul``) over the stacked experts
    ``st``; then each token's outputs in f32 times their weights, summed in
    ascending expert order. The JAX package's ``_moe_cond`` runs each routed
    expert under ``lax.cond`` and adds its rows in the same order (an
    unrouted expert adds zeros), so the two agree bit for bit wherever the
    matmuls do. Nothing is read back to the host."""
    B, T, D = x.shape
    N, k = B * T, cfg.n_experts_used
    eid = topi.reshape(N * k).to(torch.int32)
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order].contiguous()
    xp = x.reshape(N, D).index_select(0, order // k)
    gate = expert_matmul(st["ffn_gate"], xp, eid_s)
    up = expert_matmul(st["ffn_up"], xp, eid_s)
    y = expert_matmul(st["ffn_down"], F.silu(gate.float()).to(x.dtype) * up, eid_s)
    yk = torch.empty_like(y).index_copy_(0, order, y).reshape(N, k, D)
    topv, topi = topv.reshape(N, k), topi.reshape(N, k)
    rows = torch.arange(N, device=x.device)
    out = torch.zeros(N, D, dtype=torch.float32, device=x.device)
    for slot in torch.argsort(topi, dim=-1).unbind(-1):
        out = out + yk[rows, slot].float() * topv[rows, slot][:, None]
    return out.reshape(B, T, D).to(x.dtype)


def _moe_capacity(experts: list[Params], cfg: ModelConfig, x: torch.Tensor,
                  w_exp: torch.Tensor, cf: float) -> torch.Tensor:
    """The prefill path, the JAX package's ``_moe_capacity``: each expert
    takes its top C = min(N, max(8, ceil(N·k·cf / E))) tokens by weight
    (a stable sort, so ties and the dropped overflow are the JAX package's),
    runs them through its FFN (the dispatcher's kernels, one launch a role)
    and adds their weighted f32 outputs back (``index_add_``)."""
    B, T, D = x.shape
    N, E, k = B * T, cfg.n_experts, cfg.n_experts_used
    C = min(N, max(8, math.ceil(N * k * cf / E)))
    xf, wf = x.reshape(N, D), w_exp.reshape(N, E)
    out = torch.zeros(N, D, dtype=torch.float32, device=x.device)
    for e in range(E):
        we = wf[:, e]
        order = torch.argsort(-we, stable=True)[:C]
        ye = ffn_swiglu(experts[e], xf.index_select(0, order)).float()
        out.index_add_(0, order, ye * we.index_select(0, order)[:, None])
    return out.reshape(B, T, D).to(x.dtype)


def ffn_moe(layer: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Routed experts, then the shared ones: deepseek2 adds them as they
    are, qwen2moe times a per-token sigmoid gate. At most 16 rows take the
    expert-indexed decode path over the stacked experts, more the capacity
    path; ``LGT_MOE_DENSE`` takes the dense oracle, and so do at most 16 rows
    over an unstacked per-expert list (an unfused load), where its sum is
    ``_moe_cond``'s exactly."""
    topv, topi = moe_route(layer, cfg, x)
    st = layer.get("experts_st")
    B, T, _ = x.shape
    dense = bool(os.environ.get("LGT_MOE_DENSE"))
    if B * T <= 16 and st is not None and not dense:
        out = _moe_cond(st, cfg, x, topv, topi)
    else:
        experts = layer["experts"] if st is None else _expert_views(st, cfg.n_experts)
        w_exp = route_weights(cfg, topv, topi)
        if dense or B * T <= 16:
            out = _moe_dense(experts, cfg, x, w_exp)
        else:
            out = _moe_capacity(experts, cfg, x, w_exp,
                                float(os.environ.get("LGT_MOE_CAPACITY", "2.0")))
    if "shared_experts" in layer:
        sh = ffn_swiglu(layer["shared_experts"], x, cfg.act)
        if "shared_gate" in layer:
            sh = sh * torch.sigmoid(matmul(layer["shared_gate"], x).float()).to(sh.dtype)
        out = out + sh
    return out


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
      the activation dtype, then softcapped and scaled in f32 where the
      architecture does), and with ``return_hidden`` the final-normed hidden
      states. Padded rows get outputs nobody should read.
    """
    B, T = token_ids.shape
    x = embed_lookup(params["tok_embd"], token_ids)
    if cfg.embedding_scale != 1.0:
        # gemma: sqrt(dim), rounded to the activations' dtype first
        x = x * torch.tensor(cfg.embedding_scale, dtype=x.dtype).item()
    positions = offsets.long()[:, None] + torch.arange(
        T, device=token_ids.device)[None, :]
    ff = None
    if cfg.rope_scaling_type == "longrope":
        # llama.cpp picks the factor set by the cache's length against the
        # original context
        long = cfg.rope_orig_ctx > 0 and cache.max_seq > cfg.rope_orig_ctx
        ff = params.get("rope_factors_long" if long else "rope_factors_short")
    cos, sin = rope_angles(positions, cfg.rope_dim, cfg.rope_base, cfg, ff)
    local = None
    if cfg.rope_local_base > 0.0:
        # gemma3: the sliding layers rope with their own base, unscaled
        local = rope_angles(positions, cfg.rope_dim, cfg.rope_local_base)
    write_idx = cache.write_index(offsets, T)

    for i, layer in enumerate(params["layers"]):
        sliding = cfg.is_sliding(i)
        c, s = local if sliding and local is not None else (cos, sin)
        # olmo2 has post-norms only: its branches read the raw residual
        h = _norm(x, layer, "attn_norm", cfg) if "attn_norm" in layer else x
        if cfg.is_mla:
            attn = attention_mla(layer, cfg, h, c, s, cache, i, offsets, write_idx)
        else:
            attn = attention(layer, cfg, h, c, s, cache, i, offsets, write_idx, sliding)
        if "attn_post_norm" in layer:
            attn = rms_norm(attn, layer["attn_post_norm"], cfg.rms_eps)
        if cfg.parallel_residual:
            # command-r: the FFN reads the same normed input; both branches
            # join the residual together
            ffn_in = h
        else:
            if cfg.residual_scale != 1.0:
                attn = attn * torch.tensor(cfg.residual_scale, dtype=x.dtype).item()
            x = x + attn
            ffn_in = _norm(x, layer, "ffn_norm", cfg) if "ffn_norm" in layer else x
        if "experts_st" in layer or "experts" in layer:
            ffn = ffn_moe(layer, cfg, ffn_in)
        elif cfg.ffn_gated:
            ffn = ffn_swiglu(layer, ffn_in, cfg.act)
        else:
            ffn = ffn_mlp(layer, ffn_in, cfg.act)
        if "ffn_post_norm" in layer:
            ffn = rms_norm(ffn, layer["ffn_post_norm"], cfg.rms_eps)
        if cfg.parallel_residual:
            x = x + attn + ffn
        else:
            if cfg.residual_scale != 1.0:
                ffn = ffn * torch.tensor(cfg.residual_scale, dtype=x.dtype).item()
            x = x + ffn

    x = _norm(x, params, "output_norm", cfg)
    hx = x
    if logits_at is not None:
        hx = x[torch.arange(B, device=x.device), logits_at.long()][:, None]
    logits = matmul(params["output"], hx).float()
    if cfg.final_softcap > 0.0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.logit_multiplier != 1.0:
        logits = logits * cfg.logit_multiplier
    if return_hidden:
        return logits, x
    return logits
