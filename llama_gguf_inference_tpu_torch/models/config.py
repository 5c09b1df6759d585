"""Model hyper-parameters derived from GGUF metadata.

The llama architecture only: dense llama-family GGUFs (Llama 2/3, Mistral,
TinyLlama). Other architectures and MoE files raise a ``ValueError`` naming
what the file asked for, so a load never runs a graph this package does not
build.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from ..gguf.constants import Keys

SUPPORTED_ARCHES = ("llama",)
ROPE_SCALINGS = ("none", "linear", "llama3")


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
    rope_interleaved: bool = True    # GGUF "norm" rope style (llama arch)
    context_length: int = 4096
    # rope scaling (long-context): "none" | "linear" | "llama3"
    rope_scaling_type: str = "none"
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_orig_ctx: int = 0

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
        head_dim = int(md.get(f"{arch}.attention.key_length", dim // n_heads))
        vocab = md.get(k(Keys.VOCAB_SIZE))
        if vocab is None:
            vocab = len(md[Keys.TOKENIZER_TOKENS])
        scaling = str(md.get(k(Keys.ROPE_SCALING_TYPE), "none"))
        if scaling not in ROPE_SCALINGS:
            raise ValueError(f"unsupported rope scaling {scaling!r} "
                             f"(supported: {', '.join(ROPE_SCALINGS)})")
        return ModelConfig(
            arch=arch,
            vocab_size=int(vocab),
            dim=dim,
            n_layers=int(md[k(Keys.BLOCK_COUNT)]),
            n_heads=n_heads,
            n_kv_heads=int(md.get(k(Keys.HEAD_COUNT_KV), n_heads)),
            head_dim=head_dim,
            ffn_dim=int(md[k(Keys.FEED_FORWARD_LENGTH)]),
            rms_eps=float(md.get(k(Keys.LAYERNORM_RMS_EPS), 1e-5)),
            rope_base=float(md.get(k(Keys.ROPE_FREQ_BASE), 10000.0)),
            rope_dim=int(md.get(k(Keys.ROPE_DIMENSION_COUNT), head_dim)),
            rope_interleaved=True,
            context_length=int(md.get(k(Keys.CONTEXT_LENGTH), 4096)),
            rope_scaling_type=scaling,
            rope_scaling_factor=float(md.get(k(Keys.ROPE_SCALING_FACTOR), 1.0)),
            rope_low_freq_factor=float(
                md.get(f"{arch}.rope.scaling.low_freq_factor", 1.0)),
            rope_high_freq_factor=float(
                md.get(f"{arch}.rope.scaling.high_freq_factor", 4.0)),
            rope_orig_ctx=int(
                md.get(f"{arch}.rope.scaling.original_context_length", 0)),
        )
