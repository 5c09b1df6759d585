"""Causal flash attention over the offset-indexed bf16 KV cache.

``flash_attention(q, k_cache, v_cache, offsets)`` keeps the JAX package's
layouts: q (B, T, H, D), caches (B, KVH, S, D) in their storage layout,
offsets (B,). Query t of sequence b attends to cache slots
``s <= offsets[b] + t``; the function ignores how many of the T rows are
real, so padded rows of a prefill chunk get outputs nobody reads.

On tensors on the card the wrapper launches the CUDA kernel of
``csrc/flash_attention.cu`` (the counterpart of the TPU kernel
``_flash_jit``) or raises; on CPU tensors it takes
:func:`flash_attention_plain`, the same function as one masked softmax.
"""

from __future__ import annotations

import torch

from . import _build

NAME = "flash_attention"
HEAD_DIMS = (64, 128, 256)


def flash_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, D) bf16; k/v (B, KVH, S, D) bf16; offsets (B,) int32
    -> (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    _, KVH, S, _ = k_cache.shape
    dev = q.device
    if tuple(k_cache.shape) != (B, KVH, S, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if H % KVH:
        raise ValueError(f"{H} query heads over {KVH} kv heads")
    if tuple(offsets.shape) != (B,) or offsets.dtype != torch.int32:
        raise ValueError("offsets must be (B,) int32")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("offsets", offsets)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dev.type != "cuda":
        return flash_attention_plain(q, k_cache, v_cache, offsets)
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bf16")
    offsets = offsets.contiguous()
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    _build.check(lib.lgt_flash_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        offsets.data_ptr(), out.data_ptr(), B, T, H, KVH, S, D,
        1.0 / D ** 0.5, torch.cuda.current_stream(dev).cuda_stream), NAME)
    _build.count(NAME)
    return out


def flash_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 scores of pre-scaled q, the causal
    offset mask at -1e30, softmax, f32 P·V, one cast to q's dtype."""
    _build.count(NAME + ".plain")
    B, T, H, D = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    qh = (q.float() * (1.0 / D ** 0.5)).reshape(B, T, KVH, H // KVH, D)
    scores = torch.einsum("btkgd,bksd->bkgts", qh, k_cache.float())
    pos = offsets.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    mask = torch.arange(S, device=q.device)[None, None, :] <= pos[:, :, None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgts,bksd->btkgd", probs, v_cache.float())
    return ctx.reshape(B, T, H, D).to(q.dtype)
