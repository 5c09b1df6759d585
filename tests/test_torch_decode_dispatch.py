"""The port engine's decode dispatch on the CPU: multi-step decode, the
pipelined continuation, sampling state on the device and logprobs, against
the JAX package's engine.

Both engines run the tiny Q4_K_M model of ``test_torch_model.py``; the JAX
one with its Pallas kernels forced on in interpret mode (and, for the paged
q8_0 cache, its flash kernels: ``LGT_FORCE_FLASH=1``), the function the
port's plain versions compute, as in ``test_torch_engine.py`` and
``test_torch_engine_kv.py``, whose margins show that a greedy token
mismatch there is a bug, never rounding. Both engines are stepped by hand
(``step()``) with the same staggered admissions: two requests, a few
scheduler steps, then two more.

Seeded sampled tokens are the port's own (its draw is not ``jax.random``):
they are held to themselves across ``multi_step`` 1 and 4.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from llama_gguf_inference_tpu.gguf import GGMLType as JGGMLType
from llama_gguf_inference_tpu.ops import matmul_kernels as jmk
from llama_gguf_inference_tpu.runtime import engine as jengine
from llama_gguf_inference_tpu.runtime.sampler import SamplingParams as JParams
from llama_gguf_inference_tpu.utils.testing import write_tiny_llama
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
from test_torch_model import write_tiny_q4km

torch.set_num_threads(1)

PROMPTS = ["hello world", "over the world and", "a quick dog", "to the lazy dog"]
MAX_TOKENS = (8, 5, 8, 3)
CTX = PAGE = 128
KINDS = {"bf16-contig": ("bf16", "contig"), "q8_0-paged": ("q8_0", "paged")}


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    return str(write_tiny_q4km(tmp_path_factory.mktemp("dd") / "tiny.gguf"))


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setattr(jmk, "_on_tpu", lambda: True)
    monkeypatch.setenv("LGT_FORCE_FLASH", "1")


def _port(path, kind="bf16-contig", multi_step=1, slots=4):
    kv_dtype, layout = KINDS[kind]
    return tengine.InferenceEngine(path, tengine.EngineConfig(
        max_slots=slots, ctx=CTX, kv_dtype=kv_dtype, kv_layout=layout,
        kv_page_size=PAGE, multi_step=multi_step), device="cpu")


def _jax(path, kind="bf16-contig", multi_step=4):
    kv_dtype, layout = KINDS[kind]
    return jengine.InferenceEngine(path, jengine.EngineConfig(
        max_slots=4, ctx=CTX, multi_step=multi_step, prefix_cache=False,
        kv_dtype=jnp.bfloat16 if kv_dtype == "bf16" else kv_dtype,
        kv_layout=layout, kv_page_size=PAGE))


def _staggered(eng, params, first_steps=3):
    """Submit the first two requests, step the scheduler ``first_steps``
    times, submit the other two and step until every request ends. Returns
    each request's events."""
    outs = [eng.submit(p, q)[1] for p, q in zip(PROMPTS[:2], params[:2])]
    for _ in range(first_steps):
        eng.step()
    outs += [eng.submit(p, q)[1] for p, q in zip(PROMPTS[2:], params[2:])]
    for _ in range(500):
        if not eng.step() and all(o.qsize() and list(o.queue)[-1].finished for o in outs):
            break
    evs = []
    for o in outs:
        e = []
        while not o.empty():
            e.append(o.get_nowait())
        assert e and e[-1].finished, e
        evs.append(e)
    return evs


def _tokens(evs):
    return [[e.token_id for e in ev] for ev in evs]


@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_multi_step_matches_jax_engine(kind, tiny_path, pallas):
    """Tokens at multi_step 1, 2 and 4 equal the JAX engine's at multi_step
    4, over 4 slots with staggered admissions; max_tokens is respected."""
    jparams = [JParams(temperature=0.0, max_tokens=n) for n in MAX_TOKENS]
    want = _tokens(_staggered(_jax(tiny_path, kind), jparams))
    assert [len(t) for t in want] == list(MAX_TOKENS)
    params = [SamplingParams(temperature=0.0, max_tokens=n) for n in MAX_TOKENS]
    for n in (1, 2, 4):
        eng = _port(tiny_path, kind, n)
        got = _tokens(_staggered(eng, params))
        assert got == want, n
        if eng.alloc is not None:
            assert eng.alloc.free_pages == eng.alloc.table.shape[1]
        assert eng.stats()["total_generated"] == sum(MAX_TOKENS)


PENALIZED = [
    dict(logit_bias={17: -1e9, 40: 2.0, 81: 1.5}),
    dict(presence_penalty=1.5, frequency_penalty=0.5),
    dict(repeat_penalty=1.8),
    dict(repeat_penalty=1.3, presence_penalty=0.7, logit_bias={81: 3.0}),
]


@pytest.mark.parametrize("case", range(len(PENALIZED)))
def test_bias_and_penalties_match_jax_engine(case, tiny_path, pallas):
    """Greedy requests with logit_bias and the presence, frequency and
    repeat penalties (counts include the prompt) give the JAX engine's
    tokens; the port decodes at multi_step 4."""
    kw = PENALIZED[case]
    jparams = [JParams(temperature=0.0, max_tokens=8, **kw) for _ in PROMPTS]
    want = _tokens(_staggered(_jax(tiny_path, multi_step=1), jparams))
    got = _tokens(_staggered(_port(tiny_path, multi_step=4),
                             [SamplingParams(temperature=0.0, max_tokens=8, **kw)
                              for _ in PROMPTS]))
    assert got == want
    if "logit_bias" in kw:
        assert not any(17 in t for t in got)


def test_seeded_sampling_same_at_multi_step_1_and_4(tiny_path):
    """Seeded sampled requests with temperature, top-k/p, min-p, typical-p,
    penalties and mirostat: the same tokens at multi_step 1 and 4, the same
    twice, and another seed draws others."""
    base = SamplingParams(temperature=0.9, top_k=40, top_p=0.95, min_p=0.02,
                          typical_p=0.9, presence_penalty=0.3, repeat_penalty=1.1,
                          seed=11, max_tokens=12)
    params = [base, dataclasses.replace(base, seed=12),
              SamplingParams(temperature=1.0, mirostat=2, mirostat_tau=4.0, seed=3,
                             max_tokens=12),
              SamplingParams(temperature=0.0, max_tokens=12)]
    runs = [_tokens(_staggered(_port(tiny_path, multi_step=n), params)) for n in (1, 4, 4)]
    assert runs[0] == runs[1] == runs[2]
    assert runs[0][0] != runs[0][1]


def test_continuations_are_counted(tiny_path):
    """At multi_step 4 a long request's dispatches are issued from the
    previous one's on-device outputs; at multi_step 1 never."""
    for n, want_cont in ((1, False), (4, True)):
        eng = _port(tiny_path, multi_step=n)
        evs = _staggered(eng, [SamplingParams(temperature=0.0, max_tokens=24)] * 4)
        assert [len(e) for e in evs] == [24] * 4
        st = eng.stats()
        assert (st["continuations"] > 0) == want_cont, st
        assert st["dispatches"] >= st["continuations"]


def test_logprobs_events(tiny_path):
    """Per-token logprobs and top lists at multi_step 1 and 4 agree with a
    log-softmax of the forward's logits, replayed on a one-sequence cache
    (its prompt padded to the engine's 16-row bucket): the chosen token
    first, each logprob (and each rank's) within twice test_torch_engine.py's logit
    bound (0.5% of the step's largest |logit|, once for the token's logit
    and once for the log-sum-exp), the difference of a one-row step and a
    four-row batch."""
    p = SamplingParams(temperature=0.0, max_tokens=6, n_probs=3)
    for n in (1, 4):
        eng = _port(tiny_path, multi_step=n)
        evs = _staggered(eng, [p, SamplingParams(temperature=0.0, max_tokens=6)] * 2)
        ev = evs[0]
        assert all(len(e.top_logprobs) == 3 for e in ev) and evs[1][0].logprob is None
        ids = eng.tokenizer.encode(PROMPTS[0])
        cache = tllama.KVCache.zeros(eng.cfg, 1, CTX, "cpu")
        tok = torch.zeros((1, 16), dtype=torch.int32)
        tok[0, :len(ids)] = torch.tensor(ids)
        with torch.inference_mode():
            lg = tllama.forward(eng.params, eng.cfg, tok, torch.zeros(1, dtype=torch.int32),
                                cache, logits_at=torch.tensor([len(ids) - 1]))[0, 0]
            for i, e in enumerate(ev):
                lp = torch.log_softmax(lg, -1)
                tol = 2 * 0.005 * float(lg.abs().max())
                assert e.top_logprobs[0][0] == e.token_id == int(lg.argmax())
                assert abs(e.logprob - float(lp[e.token_id])) <= tol
                assert e.top_logprobs[0][1] == e.logprob
                vals = [v for _, v in e.top_logprobs]
                assert vals == sorted(vals, reverse=True)
                for (t, v), best in zip(e.top_logprobs, torch.topk(lp, 3).values.tolist()):
                    assert abs(v - float(lp[t])) <= tol and v >= best - tol
                lg = tllama.forward(eng.params, eng.cfg,
                                    torch.tensor([[e.token_id]], dtype=torch.int32),
                                    torch.tensor([len(ids) + i], dtype=torch.int32),
                                    cache)[0, 0]


SYNCS = [("nonzero", torch), ("nonzero", torch.Tensor), ("item", torch.Tensor),
         ("tolist", torch.Tensor), ("cpu", torch.Tensor), ("numpy", torch.Tensor),
         ("__bool__", torch.Tensor), ("__int__", torch.Tensor), ("__float__", torch.Tensor)]


@pytest.mark.parametrize("kind", ["bf16", "q8_0", "q4_0", "q4_1", "paged-bf16", "paged-q8_0",
                                  "qwen3moe", "deepseek2"])
def test_forward_and_dispatch_read_nothing_back(kind, tiny_path, tmp_path, monkeypatch):
    """A spy on every call that reads a tensor back to the host: a prefill
    chunk's and a decode step's forward over each cache kind, and the
    engine's decode dispatches (multi_step 4, continuations included), call
    none of them. ``qwen3moe`` and ``deepseek2`` run the JAX package's tiny
    MoE files (4 experts, 2 a token; deepseek2's latent attention) on the
    bf16 cache: the routing, the expert-indexed decode path and the
    capacity path read nothing back either."""
    if kind in ("qwen3moe", "deepseek2"):
        tiny_path = str(write_tiny_llama(
            tmp_path / f"{kind}.gguf", dim=64, n_layers=2, n_heads=4,
            n_kv_heads=4 if kind == "deepseek2" else 2, ffn_dim=128, n_experts=4,
            n_experts_used=2, quant=JGGMLType.Q8_0, arch=kind))
        kind = "bf16"
    paged = kind.startswith("paged")
    kv_dtype = kind.split("-")[-1]
    eng = tengine.InferenceEngine(tiny_path, tengine.EngineConfig(
        max_slots=2, ctx=CTX, kv_dtype=kv_dtype, kv_layout="paged" if paged else "contig",
        kv_page_size=PAGE, multi_step=4), device="cpu")
    armed, calls = [False], []
    for name, owner in SYNCS:
        orig = getattr(owner, name)

        def spy(*a, _orig=orig, _name=name, **k):
            if armed[0]:
                calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(owner, name, spy)

    def armed_call(fn):
        def run(*a, **k):
            armed[0] = True
            try:
                return fn(*a, **k)
            finally:
                armed[0] = False
        return run

    armed_call(lambda: torch.zeros(2).nonzero().tolist())()
    assert calls == ["nonzero", "tolist"]          # the spies see such calls
    calls.clear()
    if paged:
        eng.cache.page_table[0, 0] = 1
    with torch.inference_mode():
        for T in (16, 17):      # the expert-indexed and the capacity path
            armed_call(tllama.forward)(eng.params, eng.cfg,
                                       torch.ones((1, T), dtype=torch.int32),
                                       torch.zeros(1, dtype=torch.int32), eng.cache.slot(0),
                                       logits_at=torch.tensor([5]))
        armed_call(tllama.forward)(eng.params, eng.cfg, torch.ones((2, 1), dtype=torch.int32),
                                   torch.tensor([16, 0], dtype=torch.int32), eng.cache)
    assert calls == []
    if paged:
        eng.cache.page_table[0, 0] = -1
    eng._issue = armed_call(eng._issue)
    evs = _staggered(eng, [SamplingParams(temperature=0.7, seed=1, max_tokens=16,
                                          top_k=5, repeat_penalty=1.2, n_probs=2)] * 4)
    assert [len(e) for e in evs] == [16] * 4
    assert calls == [] and eng.stats()["continuations"] > 0
