"""Model hyper-parameters derived from GGUF metadata.

The dense architectures whose graph ``models.llama`` builds: llama (Llama
2/3, Mistral, TinyLlama), qwen2, qwen3, gemma, gemma2, gemma3, phi3,
starcoder2, granite, command-r and olmo2, from the keys llama.cpp's
converters write, as the JAX package's ``models/config.py`` reads them. MoE
files (any ``expert_count`` > 0) and the other architectures (deepseek2's
latent attention among them) raise a ``ValueError`` naming what the file
asked for, so a load never runs a graph this package does not build.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

from ..gguf.constants import Keys

SUPPORTED_ARCHES = ("llama", "qwen2", "qwen3", "gemma", "gemma2", "gemma3", "phi3",
                    "starcoder2", "granite", "command-r", "olmo2")
ROPE_SCALINGS = ("none", "linear", "llama3", "yarn", "longrope")
# GGUF rope style per architecture (llama.cpp ``llama_rope_type``): "norm" =
# interleaved pairs (the converters permute Q/K for these; command-r's layout
# is interleaved already); every other architecture ships "neox" = halves
_ROPE_NORM_ARCHES = ("llama", "mixtral", "minicpm", "deci", "deepseek2", "granite",
                     "command-r")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "llama"
    vocab_size: int = 32000
    dim: int = 4096                  # embedding_length
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    head_dim: int = 128
    ffn_dim: int = 11008
    rms_eps: float = 1e-5
    rope_base: float = 10000.0
    rope_dim: int = 128              # rotary dims per head
    rope_interleaved: bool = True    # GGUF "norm" rope style; False: neox halves
    context_length: int = 4096
    # rope scaling (long-context): "none" | "linear" | "llama3" | "yarn" |
    # "longrope" (phi3: per-dim factor tensors)
    rope_scaling_type: str = "none"
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_orig_ctx: int = 0
    rope_attn_factor: float = 1.0    # cos/sin magnitude (longrope)
    # -- per-architecture graph variations ----------------------------------
    act: str = "silu"                # FFN activation: "silu" | "gelu_tanh"
    embedding_scale: float = 1.0     # gemma: sqrt(dim); granite: its key
    attn_scale: float = 0.0          # 0: 1/sqrt(head_dim)
    attn_softcap: float = 0.0        # gemma2: softcap * tanh(scores / softcap)
    final_softcap: float = 0.0       # gemma2: the same on the logits
    sliding_window: int = 0          # keys a sliding layer sees (0: all)
    swa_pattern: int = 0             # every Nth layer (i % N == N - 1) is global
    rope_local_base: float = 0.0     # gemma3: the sliding layers' rope base
    norm_type: str = "rms"           # "rms" | "layernorm" (starcoder2, command-r)
    ffn_gated: bool = True           # False: up -> act -> down (starcoder2)
    residual_scale: float = 1.0      # granite: on each residual add
    logit_multiplier: float = 1.0    # command-r: logit_scale; granite: 1/logit_scale
    parallel_residual: bool = False  # command-r: x + attn(n) + ffn(n)

    def is_sliding(self, layer_idx: int) -> bool:
        """Whether layer ``layer_idx`` attends over a sliding window: every
        layer at pattern 1 (phi3); else every layer but each pattern-th
        (gemma2's 2: even layers slide; gemma3's 6: five of six)."""
        if self.sliding_window <= 0 or self.swa_pattern <= 0:
            return False
        if self.swa_pattern == 1:
            return True
        return layer_idx % self.swa_pattern != self.swa_pattern - 1

    @staticmethod
    def from_gguf_metadata(md: Mapping[str, Any]) -> "ModelConfig":
        arch = str(md.get(Keys.ARCHITECTURE, "llama"))
        if arch not in SUPPORTED_ARCHES:
            raise ValueError(
                f"unsupported GGUF architecture {arch!r} "
                f"(supported: {', '.join(SUPPORTED_ARCHES)})")
        if int(md.get(f"{arch}.expert_count", 0)):
            raise ValueError(f"GGUF architecture {arch!r} with experts (MoE) "
                             "is not supported")

        def k(template: str):
            return template.format(arch=arch)

        dim = int(md[k(Keys.EMBEDDING_LENGTH)])
        n_heads = int(md[k(Keys.HEAD_COUNT)])
        # key_length overrides head_dim (qwen3, gemma: head_dim != dim / heads)
        head_dim = int(md.get(f"{arch}.attention.key_length", dim // n_heads))
        vocab = md.get(k(Keys.VOCAB_SIZE))
        if vocab is None:
            vocab = len(md[Keys.TOKENIZER_TOKENS])
        scaling = str(md.get(k(Keys.ROPE_SCALING_TYPE), "none"))
        if scaling not in ROPE_SCALINGS:
            raise ValueError(f"unsupported rope scaling {scaling!r} "
                             f"(supported: {', '.join(ROPE_SCALINGS)})")
        n_layers = int(md[k(Keys.BLOCK_COUNT)])

        # per-architecture graph variations, as llama.cpp's builders (real
        # gemma files carry their norm weights with the +1 baked in)
        v: dict[str, Any] = {}
        rope_base = 10000.0
        if arch in ("gemma", "gemma2", "gemma3"):
            v.update(act="gelu_tanh", embedding_scale=math.sqrt(dim))
        if arch == "gemma2":
            v.update(attn_softcap=float(md.get("gemma2.attn_logit_softcapping", 50.0)),
                     final_softcap=float(md.get("gemma2.final_logit_softcapping", 30.0)),
                     sliding_window=int(md.get("gemma2.attention.sliding_window", 4096)),
                     swa_pattern=2,
                     # 1/sqrt(head_dim), but the 27B (46 layers) scales by
                     # 1/sqrt(dim / n_heads) (HF query_pre_attn_scalar)
                     attn_scale=1.0 / math.sqrt(dim / n_heads if n_layers == 46 else head_dim))
        if arch == "phi3":
            window = int(md.get("phi3.attention.sliding_window", 0))
            v.update(sliding_window=window, swa_pattern=1 if window else 0)
        if arch == "gemma3":
            # five sliding layers to one global; the sliding ones rope with
            # their own base and no long-context scaling
            rope_base = 1_000_000.0
            v.update(sliding_window=int(md.get("gemma3.attention.sliding_window", 1024)),
                     swa_pattern=6,
                     rope_local_base=float(md.get("gemma3.rope.local_freq_base",
                                                  md.get("gemma3.rope.freq_base_swa",
                                                         10000.0))))
            # 1b/4b/12b scale queries by 1/sqrt(head_dim); the 27B (62 layers)
            # by 1/sqrt(dim / n_heads), which no llama.cpp key carries
            scalar = float(md.get("gemma3.attention.query_pre_attn_scalar",
                                  dim / n_heads if n_layers == 62 else head_dim))
            if scalar != head_dim:
                v["attn_scale"] = 1.0 / math.sqrt(scalar)
        if arch == "starcoder2":
            # biased LayerNorm, a bias on every projection, un-gated gelu MLP
            v.update(norm_type="layernorm", ffn_gated=False, act="gelu_tanh")
        if arch == "granite":
            ls = float(md.get("granite.logit_scale", 0.0))
            v.update(embedding_scale=float(md.get("granite.embedding_scale", 1.0)),
                     residual_scale=float(md.get("granite.residual_scale", 1.0)),
                     attn_scale=float(md.get("granite.attention.scale", 0.0)),
                     logit_multiplier=1.0 / ls if ls > 0.0 else 1.0)
        if arch == "command-r":
            # bias-free LayerNorm, one pre-norm for both parallel branches
            v.update(norm_type="layernorm", parallel_residual=True,
                     logit_multiplier=float(md.get("command-r.logit_scale", 1.0)))

        # longrope's magnitude: its key, else HF's sqrt(1 + ln(ctx / orig) /
        # ln(orig)) where the file extends the context
        orig_ctx = int(md.get(f"{arch}.rope.scaling.original_context_length", 0))
        ctx_len = int(md.get(k(Keys.CONTEXT_LENGTH), 4096))
        attn_factor = float(md.get(f"{arch}.rope.scaling.attn_factor", 0.0))
        if attn_factor <= 0.0:
            attn_factor = 1.0
            if scaling == "longrope" and 0 < orig_ctx < ctx_len:
                attn_factor = math.sqrt(1.0 + math.log(ctx_len / orig_ctx) / math.log(orig_ctx))

        return ModelConfig(
            arch=arch,
            vocab_size=int(vocab),
            dim=dim,
            n_layers=n_layers,
            n_heads=n_heads,
            n_kv_heads=int(md.get(k(Keys.HEAD_COUNT_KV), n_heads)),
            head_dim=head_dim,
            ffn_dim=int(md[k(Keys.FEED_FORWARD_LENGTH)]),
            rms_eps=float(md.get(k(Keys.LAYERNORM_RMS_EPS),
                                 md.get(f"{arch}.attention.layer_norm_epsilon", 1e-5))),
            rope_base=float(md.get(k(Keys.ROPE_FREQ_BASE), rope_base)),
            rope_dim=int(md.get(k(Keys.ROPE_DIMENSION_COUNT), head_dim)),
            rope_interleaved=arch in _ROPE_NORM_ARCHES,
            context_length=ctx_len,
            rope_scaling_type=scaling,
            rope_scaling_factor=float(md.get(k(Keys.ROPE_SCALING_FACTOR), 1.0)),
            rope_low_freq_factor=float(
                md.get(f"{arch}.rope.scaling.low_freq_factor", 1.0)),
            rope_high_freq_factor=float(
                md.get(f"{arch}.rope.scaling.high_freq_factor", 4.0)),
            rope_orig_ctx=orig_ctx,
            rope_attn_factor=attn_factor,
            **v,
        )
