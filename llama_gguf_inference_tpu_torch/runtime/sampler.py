"""Token sampling: greedy, temperature, top-k, min-p, top-p, seeded.

The chain follows the JAX package's sampler: temperature first, then top-k,
min-p and top-p masks on the tempered distribution, then a categorical draw
from the slot's own ``torch.Generator`` (seeded per request, so a seeded
request is reproducible; the draws are not the JAX package's, whose random
bits differ). Temperature <= 0 is greedy argmax.

Typical-p, presence/frequency/repeat penalties, mirostat, logit bias,
logprobs and grammars are not implemented yet: :func:`unsupported` names
the ones a request sets away from their defaults, and the engine and server
refuse such requests instead of ignoring the setting.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SamplingParams:
    """Host-side per-request sampling configuration (OpenAI + llama.cpp knobs)."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0               # 0 = disabled
    min_p: float = 0.0
    typical_p: float = 1.0       # 1.0 = disabled (llama.cpp typical sampling)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repeat_penalty: float = 1.0  # 1.0 = disabled
    mirostat: int = 0            # 0 = off, 1 / 2 = mirostat v1 / v2
    mirostat_tau: float = 5.0    # target surprise (bits)
    mirostat_eta: float = 0.1    # learning rate
    seed: int = 0
    max_tokens: int = 256
    stop: tuple[str, ...] = ()
    logit_bias: dict[int, float] | None = None
    n_probs: int = 0             # logprobs per token (OpenAI `logprobs`)
    grammar: str = ""            # GBNF text (response_format / grammar)


_NOT_YET = ("typical_p", "presence_penalty", "frequency_penalty",
            "repeat_penalty", "mirostat", "logit_bias", "n_probs", "grammar")


def unsupported(p: SamplingParams) -> list[str]:
    """Names of the fields ``p`` sets that this sampler cannot honour."""
    default = SamplingParams()
    return [f for f in _NOT_YET
            if getattr(p, f) not in (getattr(default, f), {}, ())]


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    k = min(k, logits.shape[-1])
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < thresh, float("-inf"))


def _mask_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    pmax = probs.max(dim=-1, keepdim=True).values
    return logits.masked_fill(probs < min_p * pmax, float("-inf"))


def _mask_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep the smallest prefix of the sorted distribution whose mass
    reaches ``top_p`` (always at least one token)."""
    probs = torch.softmax(logits, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < top_p
    last = (keep_sorted.sum(dim=-1, keepdim=True) - 1).clamp(min=0)
    thresh = torch.gather(sp, -1, last)
    return logits.masked_fill(probs < thresh, float("-inf"))


def sample(logits: torch.Tensor, params: list[SamplingParams | None],
           generators: list[torch.Generator | None]) -> torch.Tensor:
    """logits (B, V) f32 -> token ids (B,) int64. Row b samples with
    ``params[b]`` and ``generators[b]``; a None row (a free slot) and a
    greedy row take the argmax."""
    tok = logits.argmax(dim=-1)
    for b, p in enumerate(params):
        if p is None or p.temperature <= 0.0:
            continue
        row = logits[b:b + 1] / max(p.temperature, 1e-6)
        if p.top_k > 0:
            row = _mask_top_k(row, p.top_k)
        if p.min_p > 0.0:
            row = _mask_min_p(row, p.min_p)
        if p.top_p < 1.0:
            row = _mask_top_p(row, p.top_p)
        probs = torch.softmax(row, dim=-1)
        tok[b] = torch.multinomial(probs, 1, generator=generators[b])[0, 0]
    return tok
