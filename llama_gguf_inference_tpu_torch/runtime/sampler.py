"""Batched token sampling on the device.

The JAX package's sampler (``runtime/sampler.py``), stage for stage: every
slot of a decode batch samples in one call with per-slot parameter vectors
kept on the device (:class:`SampleState`), and nothing is read back to the
host. Supported: temperature (0 => greedy), top_k, top_p, min_p, typical_p,
presence/frequency penalties (OpenAI semantics), repeat penalty (llama.cpp
semantics, applied to any token seen in the sequence so far, the prompt
included), logit_bias, mirostat v1/v2 (per-slot adaptive surprise ``mu`` on
the device) and top-k logprobs.

Where the JAX sampler gates each stage with ``lax.cond`` on "any slot needs
it", the caller decides on the host from the active slots'
:class:`SamplingParams` (:class:`Gates`); a stage leaves a row that does not
ask for it unchanged, so a gate moves the time, not the tokens.

The draw is Gumbel-max over noise hashed on the device from (seed, step,
token index): a row's token depends only on its seed, its step and its
logits, never on the batch around it, and no ``torch.Generator`` or global
RNG is involved. The bits are not the JAX package's (``jax.random``), so a
seeded request draws other tokens there; greedy tokens are the same.

Chain order (the JAX package's, not llama.cpp's default): temperature
FIRST, then top-k, typical, min-p and top-p on the tempered distribution;
mirostat replaces that chain for its slots.

A grammar reaches the sampler only as its slot's bias row: the engine's
host-side matcher writes ``-inf`` on every token the grammar forbids
(:meth:`SampleState.set_bias_row`), so every stage sees rows where only a
few tokens are finite.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
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


class Gates(NamedTuple):
    """Which stages a batch runs: the host's counterpart of the JAX
    sampler's ``lax.cond`` predicates, decided from the active slots'
    parameters (see :meth:`of`)."""

    penalties: bool = False
    greedy: bool = True          # every slot greedy: argmax only
    top_k: bool = False
    typical: bool = False
    min_p: bool = False
    top_p: bool = False
    mirostat: bool = False

    @staticmethod
    def of(params) -> "Gates":
        ps = list(params)
        return Gates(
            penalties=any(p.presence_penalty != 0.0 or p.frequency_penalty != 0.0
                          or p.repeat_penalty != 1.0 for p in ps),
            greedy=all(p.temperature <= 0.0 for p in ps),
            top_k=any(p.top_k > 0 for p in ps),
            typical=any(p.typical_p < 1.0 for p in ps),
            min_p=any(p.min_p > 0.0 for p in ps),
            top_p=any(p.top_p < 1.0 for p in ps),
            mirostat=any(p.mirostat > 0 for p in ps))


@dataclasses.dataclass
class SampleState:
    """Device-side per-slot sampling state (all (B, ...) tensors), updated in
    place: counts, step and miro_mu by :func:`sample`, a slot's row by
    :meth:`write_slot`."""

    temperature: torch.Tensor    # (B,) f32
    top_p: torch.Tensor          # (B,) f32
    top_k: torch.Tensor          # (B,) i64
    min_p: torch.Tensor          # (B,) f32
    typical: torch.Tensor        # (B,) f32 — typical_p (1.0 = off)
    presence: torch.Tensor       # (B,) f32
    frequency: torch.Tensor      # (B,) f32
    repeat: torch.Tensor         # (B,) f32
    miro: torch.Tensor           # (B,) i64 — mirostat mode 0/1/2
    miro_tau: torch.Tensor       # (B,) f32
    miro_eta: torch.Tensor       # (B,) f32
    miro_mu: torch.Tensor        # (B,) f32 — adaptive state (init 2*tau)
    seed: torch.Tensor           # (B,) i64, in [0, 2**32)
    counts: torch.Tensor         # (B, vocab) i32 — tokens seen so far
    step: torch.Tensor           # (B,) i64 — draw counter
    bias: torch.Tensor           # (B, vocab) f32 — logit_bias

    @staticmethod
    def init(batch: int, vocab: int, device: str | torch.device = "cpu") -> "SampleState":
        f = lambda v: torch.full((batch,), v, dtype=torch.float32, device=device)
        i = lambda: torch.zeros(batch, dtype=torch.int64, device=device)
        return SampleState(
            temperature=f(1.0), top_p=f(1.0), top_k=i(), min_p=f(0.0), typical=f(1.0),
            presence=f(0.0), frequency=f(0.0), repeat=f(1.0), miro=i(),
            miro_tau=f(0.0), miro_eta=f(0.0), miro_mu=f(0.0), seed=i(),
            counts=torch.zeros((batch, vocab), dtype=torch.int32, device=device),
            step=i(), bias=torch.zeros((batch, vocab), dtype=torch.float32, device=device))

    def row(self, b: int) -> "SampleState":
        """Views of slot b's state (updates land in this state)."""
        return SampleState(**{f.name: getattr(self, f.name)[b:b + 1]
                              for f in dataclasses.fields(self)})

    def write_slot(self, b: int, p: SamplingParams, prompt_ids=(),
                   bias: np.ndarray | None = None) -> None:
        """(Re)initialize slot b for a request, as the JAX package's
        ``write_slot_device`` does: every parameter (f32 as there), mirostat's
        mu at 2 * tau, the step at 0, the counts to the prompt's ids and the
        bias row (``bias``, else ``p``'s logit_bias). Scalars go over as
        kernel arguments and the ids and bias row through pinned memory, so
        nothing waits for the card."""
        dev = self.counts.device
        vals = dict(temperature=p.temperature, top_p=p.top_p, min_p=p.min_p,
                    typical=p.typical_p, presence=p.presence_penalty,
                    frequency=p.frequency_penalty, repeat=p.repeat_penalty,
                    miro_tau=p.mirostat_tau, miro_eta=p.mirostat_eta,
                    top_k=p.top_k, miro=p.mirostat, seed=p.seed & 0xFFFFFFFF, step=0)
        for name, v in vals.items():
            getattr(self, name)[b] = v
        self.miro_mu[b] = 2.0 * float(np.float32(p.mirostat_tau))
        self.counts[b].zero_()
        if len(prompt_ids):
            ids = to_device(np.asarray(prompt_ids, np.int64), dev)
            self.counts[b].index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
        self.set_bias_row(b, bias_row(p, self.bias.shape[1]) if bias is None else bias)

    def set_bias_row(self, b: int, row: np.ndarray) -> None:
        """Replace slot b's (V,) bias row (a grammar mask update): a copy
        through pinned memory, in stream order, that never reads the card."""
        self.bias[b] = to_device(np.asarray(row, np.float32), self.bias.device)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``: to a card through pinned memory without waiting
    for the card's queue (a copy from pageable memory would)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def bias_row(p: SamplingParams, vocab: int) -> np.ndarray:
    """(V,) f32 static logit bias for a request: OpenAI ``logit_bias``
    entries applied additively (llama.cpp semantics — raw addition)."""
    row = np.zeros(vocab, np.float32)
    if p.logit_bias:
        for tid, v in p.logit_bias.items():
            t = int(tid)
            if 0 <= t < vocab:
                row[t] = float(v)
    return row


def apply_penalties(logits: torch.Tensor, st: SampleState) -> torch.Tensor:
    """logits (B, V) f32 with OpenAI presence/frequency + llama.cpp repeat."""
    seen = st.counts > 0
    logits = logits - st.presence[:, None] * seen.float()
    logits = logits - st.frequency[:, None] * st.counts.float()
    rp = st.repeat[:, None]
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    return torch.where(seen, penalized, logits)


_NEG_INF = float("-inf")


def _mask_top_k(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Keep each row's ``k`` largest logits (ties at the k-th kept; k <= 0
    keeps all)."""
    V = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_eff = torch.where(k > 0, k.clamp(1, V), torch.full_like(k, V))
    thresh = torch.gather(sorted_desc, -1, (k_eff - 1)[:, None])
    return logits.masked_fill(logits < thresh, _NEG_INF)


def _mask_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Keep the smallest prefix of the sorted distribution whose mass
    reaches ``top_p`` (always at least one token)."""
    probs = torch.softmax(logits, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < top_p[:, None]
    last = (keep_sorted.sum(dim=-1) - 1).clamp(min=0)
    thresh = torch.gather(sp, -1, last[:, None])
    return logits.masked_fill(probs < thresh, _NEG_INF)


def _mask_min_p(logits: torch.Tensor, min_p: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    pmax = probs.max(dim=-1, keepdim=True).values
    return logits.masked_fill(probs < min_p[:, None] * pmax, _NEG_INF)


def _mask_typical(logits: torch.Tensor, typ: torch.Tensor) -> torch.Tensor:
    """llama.cpp typical sampling: keep the smallest set of tokens — ordered
    by |−log p − H| ascending (closest to the distribution's entropy) —
    whose cumulative probability reaches ``typ`` (always >= 1 token, even
    for typ <= 0)."""
    lp = torch.log_softmax(logits, dim=-1)
    p = lp.exp()
    ent = -torch.where(p > 0, p * lp, torch.zeros_like(p)).sum(dim=-1, keepdim=True)
    dev = (-lp - ent).abs()
    order = torch.argsort(dev, dim=-1, stable=True)
    p_ord = torch.gather(p, -1, order)
    keep_ord = (torch.cumsum(p_ord, dim=-1) - p_ord) < typ[:, None]
    keep_ord[:, 0] = True
    keep = torch.zeros_like(keep_ord).scatter(-1, order, keep_ord)
    keep = keep | (typ >= 1.0)[:, None]
    return logits.masked_fill(~keep, _NEG_INF)


_MIRO_V1_M = 100   # llama.cpp mirostat v1: Zipf exponent fit over the top m
_LN2 = math.log(2.0)


def _mirostat_mask(scaled: torch.Tensor, st: SampleState) -> torch.Tensor:
    """Per-slot mirostat truncation of the tempered logits (llama.cpp): v2
    keeps tokens with surprise −log2(p) <= mu; v1 derives a top-k from the
    Zipf-fit estimate over the ``m`` most probable tokens. Rows with
    mirostat off pass through unchanged."""
    B, V = scaled.shape
    lp = torch.log_softmax(scaled, dim=-1)
    surprise = -lp / _LN2
    keep2 = surprise <= st.miro_mu[:, None]
    m1 = min(_MIRO_V1_M, V - 1)
    sp = torch.sort(lp, dim=-1, descending=True).values[:, :m1 + 1]
    i = torch.arange(m1, dtype=torch.float32, device=scaled.device)
    t_i = torch.log((i + 2.0) / (i + 1.0))
    b_i = sp[:, :-1] - sp[:, 1:]
    s_hat = (t_i * b_i).sum(dim=-1) / (t_i * t_i).sum()
    eps = (s_hat - 1.0).clamp(min=1e-5)
    k1 = ((eps * torch.exp2(st.miro_mu)) / (1.0 - float(V) ** (-eps))) \
        ** (1.0 / s_hat.clamp(min=1e-5))
    # under a grammar mask fewer than m1 + 1 tokens may be finite: their
    # differences are -inf - -inf = NaN, and so is k1. XLA converts NaN to
    # 0 (keep every token), the CPU to INT64_MIN and the card to its own
    # value; make it 0 here on every device, as the JAX sampler has it
    k1 = torch.where(torch.isnan(k1), torch.zeros_like(k1), k1.clamp(1.0, float(V)))
    k1 = k1.to(torch.int64)
    keep1 = _mask_top_k(scaled, k1) > _NEG_INF
    keep = torch.where((st.miro == 2)[:, None], keep2, keep1)
    keep = keep | (lp >= lp.max(dim=-1, keepdim=True).values)
    on = (st.miro > 0)[:, None]
    return scaled.masked_fill(on & ~keep, _NEG_INF)


def _mirostat_update(scaled_masked: torch.Tensor, tok: torch.Tensor,
                     st: SampleState) -> torch.Tensor:
    """mu <- mu - eta * (observed_surprise - tau) for mirostat slots, the
    surprise measured on the truncated, renormalized distribution the token
    was drawn from (llama.cpp semantics)."""
    lp = torch.log_softmax(scaled_masked, dim=-1)
    obs = -torch.gather(lp, -1, tok[:, None])[:, 0] / _LN2
    mu = st.miro_mu - st.miro_eta * (obs - st.miro_tau)
    return torch.where(st.miro > 0, mu, st.miro_mu)


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) of int64 values in
    [0, 2**32); multipliers below 2**31 keep every product inside int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x6C8E9CF5) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 15)


def gumbel_noise(seed: torch.Tensor, step: torch.Tensor, V: int) -> torch.Tensor:
    """(B, V) f32 Gumbel noise, a function of (seed[b], step[b], token index)
    alone: 24-bit uniforms in (0, 1) from a counter hash, then -log(-log u)."""
    key = _mix32(_mix32(seed & _M32) ^ (step & _M32))
    idx = torch.arange(V, dtype=torch.int64, device=seed.device)
    bits = _mix32(key[:, None] ^ ((idx * 0x9E3779B1) & _M32))
    u = ((bits >> 8).float() + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, st: SampleState, gates: Gates) -> torch.Tensor:
    """logits (B, V) f32 -> token ids (B,) i64; counts, step and miro_mu of
    ``st`` advance in place, as the JAX sampler returns them. One call for
    all B rows: no loop over rows, nothing read back to the host."""
    B, V = logits.shape
    # logit_bias: a plain (B, V) add, never gated (as in the JAX sampler)
    logits = logits + st.bias
    if gates.penalties:
        logits = apply_penalties(logits, st)
    greedy = st.temperature <= 0.0
    tok = logits.argmax(dim=-1)
    if not gates.greedy:
        one = torch.ones_like(st.temperature)
        temp = torch.where(greedy, one, st.temperature.clamp(min=1e-6))
        scaled = logits / temp[:, None]
        chain = scaled
        if gates.top_k:
            chain = _mask_top_k(chain, st.top_k)
        if gates.typical:
            chain = _mask_typical(chain, st.typical)
        if gates.min_p:
            chain = _mask_min_p(chain, st.min_p)
        if gates.top_p:
            chain = _mask_top_p(chain, st.top_p)
        # mirostat replaces the truncation chain for its slots (llama.cpp:
        # the mirostat sampler is exclusive with top-k/p/typical)
        masked = chain
        if gates.mirostat:
            masked = torch.where((st.miro > 0)[:, None], _mirostat_mask(scaled, st), chain)
        drawn = (masked + gumbel_noise(st.seed, st.step, V)).argmax(dim=-1)
        if gates.mirostat:
            st.miro_mu.copy_(_mirostat_update(masked, drawn, st))
        tok = torch.where(greedy, tok, drawn)
    st.counts.scatter_add_(1, tok[:, None], torch.ones((B, 1), dtype=st.counts.dtype,
                                                        device=logits.device))
    st.step += 1
    return tok


def token_logprobs(logits: torch.Tensor, tok: torch.Tensor, n: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chosen tokens' logprobs (B,) and the top-n (logprob, token) per
    row, of the model's distribution (before bias and penalties), from one
    log-softmax, as the JAX engine's logprob dispatches compute them (its
    ``top_logprobs``) for OpenAI ``logprobs`` responses."""
    lp = torch.log_softmax(logits, dim=-1)
    vals, idx = torch.topk(lp, n, dim=-1)
    return torch.gather(lp, -1, tok[:, None])[:, 0], vals, idx
