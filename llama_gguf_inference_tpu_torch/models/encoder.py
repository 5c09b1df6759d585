"""BERT-family encoder graph in PyTorch: the embedding and reranking model
side of llama-server.

The reference serves embedding GGUFs (bert, e.g. bge and nomic-embed) through
llama-server's ``--embedding`` mode and exposes them on ``/v1/embeddings``;
llama.cpp's ``llm_build_bert`` defines the graph and
``convert_hf_to_gguf.py::BertModel`` the tensor and key names followed here.

One call runs the whole encoder over a padded bucket: bidirectional attention
is a plain (B, H, T, T) masked softmax in f32 (no KV cache), the padding mask
rides ``lengths``, and the pooling (mean or cls) and the L2 normalization run
in the same call. The projections go through ``ops.linear.matmul``, so a
quantized weight takes the port's CUDA kernels; the attention stays in plain
PyTorch, as the JAX package's is plain XLA.

Layouts and rounding points follow the JAX package's ``models/encoder.py``:
the tables, the hidden states and the activations between layers are bf16,
each LayerNorm computes in f32, a projection's bias is added after its
product in the product's dtype, GELU is exact (erf) in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from ..ops.linear import matmul

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    arch: str = "bert"
    vocab_size: int = 30522
    dim: int = 384
    n_layers: int = 6
    n_heads: int = 12
    head_dim: int = 32
    ffn_dim: int = 1536
    ln_eps: float = 1e-12
    max_positions: int = 512
    n_token_types: int = 2
    pooling: str = "mean"            # "mean" | "cls" (llama.cpp pooling_type)

    @staticmethod
    def from_gguf_metadata(md: Mapping[str, Any]) -> "EncoderConfig":
        arch = str(md.get("general.architecture", "bert"))

        def k(suffix, default=None):
            return md.get(f"{arch}.{suffix}", default)

        dim = int(k("embedding_length"))
        n_heads = int(k("attention.head_count"))
        # llama.cpp pooling_type: 0 none, 1 mean, 2 cls. Type 0 returns
        # per-token embeddings in llama-server, a different response shape
        # than the pooled vector this engine serves: refuse it rather than
        # alias it to mean
        ptype = int(k("pooling_type", 1))
        if ptype == 0:
            raise ValueError(
                "pooling_type 0 (none) requests per-token embeddings, "
                "which this engine does not serve; re-export the GGUF "
                "with mean (1) or cls (2) pooling")
        pooling = {1: "mean", 2: "cls"}[ptype]
        vocab = int(k("vocab_size", 0))
        if not vocab:
            vocab = len(md.get("tokenizer.ggml.tokens", ())) or 30522
        return EncoderConfig(
            arch=arch,
            vocab_size=vocab,
            dim=dim,
            n_layers=int(k("block_count")),
            n_heads=n_heads,
            head_dim=dim // n_heads,
            ffn_dim=int(k("feed_forward_length")),
            ln_eps=float(k("attention.layer_norm_epsilon", 1e-12)),
            max_positions=int(k("context_length", 512)),
            pooling=pooling,
        )


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def _linear(layer: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    y = matmul(layer[name], x)
    bias = layer.get(name + "_bias")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def encoder_forward(params: Params, cfg: EncoderConfig, tokens: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) int padded; lengths (B,) valid counts.

    Returns L2-normalized pooled embeddings (B, dim) f32, llama-server's
    default ``--embd-normalize 2``.
    """
    B, T = tokens.shape
    H, hd = cfg.n_heads, cfg.head_dim
    dev = tokens.device

    x = params["tok_embd"].index_select(0, tokens.reshape(-1).long()).reshape(B, T, -1)
    x = x + params["pos_embd"][None, :T]
    x = x + params["type_embd"][None, None, 0]                # all type 0
    x = _ln(x, params["embd_norm"], params["embd_norm_bias"], cfg.ln_eps)

    valid = torch.arange(T, device=dev)[None, :] < lengths.to(dev)[:, None]   # (B, T)
    # bidirectional attention restricted to the valid (non-pad) key positions
    attn_bias = torch.where(valid[:, None, None, :], 0.0, -1e30)              # (B,1,1,T)
    scale = math.sqrt(float(hd))

    for layer in params["layers"]:
        q = _linear(layer, "attn_q", x).reshape(B, T, H, hd)
        k = _linear(layer, "attn_k", x).reshape(B, T, H, hd)
        v = _linear(layer, "attn_v", x).reshape(B, T, H, hd)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / scale
        probs = torch.softmax(scores + attn_bias, dim=-1)
        ctx = torch.einsum("bhts,bshd->bthd", probs, v.float()).reshape(B, T, H * hd)
        attn_out = _linear(layer, "attn_output", ctx.to(x.dtype))
        x = _ln(x + attn_out, layer["attn_output_norm"],
                layer["attn_output_norm_bias"], cfg.ln_eps)
        up = _linear(layer, "ffn_up", x)
        act = F.gelu(up.float())                                  # exact (erf)
        ffn_out = _linear(layer, "ffn_down", act.to(x.dtype))
        x = _ln(x + ffn_out, layer["layer_output_norm"],
                layer["layer_output_norm_bias"], cfg.ln_eps)

    xf = x.float()
    if cfg.pooling == "cls":
        pooled = xf[:, 0]
    else:
        m = valid[:, :, None].float()
        pooled = (xf * m).sum(dim=1) / lengths.to(dev)[:, None].float().clamp(min=1.0)
    norm = (pooled * pooled).sum(dim=-1, keepdim=True).sqrt()
    return pooled / norm.clamp(min=1e-12)
