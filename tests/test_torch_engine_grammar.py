"""The port engine's grammar-constrained decoding on the CPU, against the
JAX package's engine on the same tiny Q4_K_M GGUF.

Both engines run the model of ``test_torch_model.py`` (the JAX one with its
Pallas kernels forced on in interpret mode, the function the port's plain
versions compute), stepped by hand with the same staggered admissions:
constrained requests (a JSON schema, with and without a ``logit_bias`` that
bans every end-of-generation token, and a digits grammar) beside an
unconstrained one. Greedy tokens are equal, for a bf16
and a q8_0 cache, with the port at ``multi_step`` 1 and 4 (a batch holding
a constrained slot decodes one step a dispatch in both).

Seeded sampled draws are the port's own (its noise is not ``jax.random``):
they are held to the schema and to themselves. Mirostat under a grammar's
mask, where fewer tokens are finite than its v1 fit reads (101), is held
to the JAX sampler: the kept set, mu's update and, where the kept set is
one token, the draw.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.ops import matmul_kernels as jmk
from llama_gguf_inference_tpu.runtime import engine as jengine
from llama_gguf_inference_tpu.runtime import sampler as js
from llama_gguf_inference_tpu_torch.grammar import json_schema_to_gbnf
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime import sampler as ts
from test_torch_model import write_tiny_q4km

torch.set_num_threads(1)

CTX = 128
SCHEMA = {"type": "object",
          "properties": {"a": {"type": "integer"}, "b": {"enum": ["x", "y"]}},
          "required": ["a", "b"]}
GRAMMAR = json_schema_to_gbnf(SCHEMA)
EOG = (2,)                                  # the tiny vocab's </s>
PROMPTS = ["hello world", "over the world and", "a quick dog", "to the lazy dog"]
# (grammar, extra fields) of each of the four requests
REQUESTS = [(GRAMMAR, {}), ("", {}),
            (GRAMMAR, {"logit_bias": {t: -1e9 for t in EOG} | {40: 2.0}}),
            ('root ::= [0-9]{1,6} "."', {})]


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    return str(write_tiny_q4km(tmp_path_factory.mktemp("eg") / "tiny.gguf"))


def _port(path, kv_dtype="bf16", multi_step=1, slots=4):
    return tengine.InferenceEngine(path, tengine.EngineConfig(
        max_slots=slots, ctx=CTX, kv_dtype=kv_dtype, multi_step=multi_step), device="cpu")


def _staggered(eng, params):
    """The first two requests, three scheduler steps, the other two, then
    steps until every request ends; each request's events."""
    outs = [eng.submit(p, q)[1] for p, q in zip(PROMPTS[:2], params[:2])]
    for _ in range(3):
        eng.step()
    outs += [eng.submit(p, q)[1] for p, q in zip(PROMPTS[2:], params[2:])]
    for _ in range(800):
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


def _params(cls):
    return [cls(**{"temperature": 0.0, "max_tokens": 40, "grammar": g, **extra})
            for g, extra in REQUESTS]


@pytest.fixture(scope="module")
def jax_tokens(tiny_path):
    """The JAX engine's greedy tokens per cache kind, computed once."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jmk, "_on_tpu", lambda: True)
    out = {}
    try:
        for kind in ("bf16", "q8_0"):
            eng = jengine.InferenceEngine(tiny_path, jengine.EngineConfig(
                max_slots=4, ctx=CTX, multi_step=4, prefix_cache=False,
                kv_dtype=jnp.bfloat16 if kind == "bf16" else kind))
            out[kind] = [[e.token_id for e in ev] for ev in
                         _staggered(eng, _params(js.SamplingParams))]
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("multi_step", [1, 4])
@pytest.mark.parametrize("kind", ["bf16", "q8_0"])
def test_constrained_greedy_tokens_match_jax(kind, multi_step, tiny_path, jax_tokens):
    eng = _port(tiny_path, kind, multi_step)
    evs = _staggered(eng, _params(ts.SamplingParams))
    assert [[e.token_id for e in ev] for ev in evs] == jax_tokens[kind]
    text = ["".join(e.text for e in ev) for ev in evs]
    for i in (0, 2):
        val = json.loads(text[i])
        assert set(val) == {"a", "b"} and val["b"] in ("x", "y")
        assert evs[i][-1].finish_reason == "stop"
    assert evs[2][-1].token_id in EOG                  # the mask forced the banned EOG
    assert text[3].rstrip(".").isdigit() and text[3].endswith(".")
    assert all(s.matcher is None for s in eng.slots)


def test_seeded_constrained_sampling(tiny_path):
    """Sampled (temperature 1, top-k, penalties) under the schema: valid
    JSON of the schema's keys, the same twice, at multi_step 1 and 4."""
    runs = []
    for n in (1, 4, 4):
        eng = _port(tiny_path, multi_step=n)
        params = [ts.SamplingParams(temperature=1.0, top_k=50, repeat_penalty=1.2,
                                    seed=s, max_tokens=64, grammar=GRAMMAR)
                  for s in range(4)]
        evs = _staggered(eng, params)
        runs.append(["".join(e.text for e in ev) for ev in evs])
    assert runs[0] == runs[1] == runs[2]
    for t in runs[0]:
        val = json.loads(t)
        assert set(val) == {"a", "b"} and isinstance(val["a"], int) and val["b"] in "xy"
    assert len(set(runs[0])) > 1


def test_bad_grammar_fails_only_its_request(tiny_path):
    eng = _port(tiny_path, multi_step=4)
    good = ts.SamplingParams(temperature=0.0, max_tokens=5)
    bad = ts.SamplingParams(temperature=0.0, max_tokens=5, grammar="root ::= [broken")
    evs = _staggered(eng, [good, bad, bad, good])
    for i in (1, 2):
        assert len(evs[i]) == 1 and evs[i][0].finish_reason == "error"
        assert evs[i][0].text.startswith("invalid grammar: ")
    assert [len(evs[i]) for i in (0, 3)] == [5, 5]
    assert eng.n_active() == 0


def test_unconstrained_after_constrained_is_unchanged(tiny_path):
    """A constrained request leaves no trace on a later unconstrained one in
    the same slot: its bias row is rewritten at admission."""
    eng = _port(tiny_path, slots=1)
    plain = ts.SamplingParams(temperature=0.0, max_tokens=8)
    before = [e.token_id for e in _run_one(eng, "same prompt", plain)]
    _run_one(eng, "hello", ts.SamplingParams(temperature=0.0, max_tokens=16,
                                             grammar=GRAMMAR, logit_bias={40: 5.0}))
    after = [e.token_id for e in _run_one(eng, "same prompt", plain)]
    assert before == after and len(before) == 8


def _run_one(eng, prompt, params):
    """Drive one request to its end through step(), no loop thread."""
    _, out = eng.submit(prompt, params)
    evs = []
    while not (evs and evs[-1].finished):
        eng.step()
        while not out.empty():
            evs.append(out.get_nowait())
    return evs


MIRO = [(mode, n_valid) for mode in (1, 2) for n_valid in (1, 2, 7, 60, 100)]


@pytest.mark.parametrize("mode,n_valid", MIRO)
def test_mirostat_under_a_mask_matches_jax(mode, n_valid):
    """Rows whose bias leaves ``n_valid`` < 101 tokens finite (the rest
    -inf, as a grammar's mask): the mirostat kept set and mu's update equal
    the JAX sampler's, v1's NaN fit keeping every valid token as XLA's NaN
    to 0 has it; where one token is kept, both samplers draw it."""
    B, V = 3, 512
    rng = np.random.default_rng(10 * mode + n_valid)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    bias = np.full((B, V), -np.inf, np.float32)
    for b in range(B):
        bias[b, rng.choice(V, n_valid, replace=False)] = 0.0
    # row 2 at a small mu: v2 then keeps the row's argmax alone
    p = [dict(temperature=1.0, mirostat=mode, mirostat_tau=t, mirostat_eta=0.1, seed=s)
         for t, s in ((5.0, 1), (3.0, 2), (0.01, 3))]
    jst, tst = js.SampleState.init(B, V), ts.SampleState.init(B, V)
    for b in range(B):
        jst = jst.write_slot(b, js.SamplingParams(**p[b]))
        tst.write_slot(b, ts.SamplingParams(**p[b]), bias=bias[b])
    jst = jst._replace(bias=jnp.asarray(bias))
    masked = logits + bias
    want = np.asarray(js._mirostat_mask(jnp.asarray(masked), jst))
    got = ts._mirostat_mask(torch.from_numpy(masked), tst).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert not np.isnan(got).any()
    if mode == 1 and n_valid < 100:
        assert np.array_equal(np.isneginf(got), np.isneginf(masked))   # keeps all valid
    tok = np.where(np.isneginf(want), -np.inf, want).argmax(-1)
    np.testing.assert_allclose(
        ts._mirostat_update(torch.from_numpy(got), torch.from_numpy(tok), tst).numpy(),
        np.asarray(js._mirostat_update(jnp.asarray(want), jnp.asarray(tok.astype(np.int32)),
                                       jst)), rtol=1e-6)
    jt, jst2 = js.sample(jnp.asarray(logits), jst)
    tt = ts.sample(torch.from_numpy(logits), tst, ts.Gates.of(
        ts.SamplingParams(**q) for q in p))
    single = (~np.isneginf(want)).sum(-1) == 1
    assert np.array_equal(tt.numpy()[single], np.asarray(jt)[single])
    assert all(bias[b, t] == 0.0 for b, t in enumerate(tt.tolist()))
    assert single[2] or mode == 1
    np.testing.assert_allclose(tst.miro_mu.numpy()[single], np.asarray(jst2.miro_mu)[single],
                               rtol=1e-6)


SYNCS = [("nonzero", torch), ("nonzero", torch.Tensor), ("item", torch.Tensor),
         ("tolist", torch.Tensor), ("cpu", torch.Tensor), ("numpy", torch.Tensor),
         ("__bool__", torch.Tensor), ("__int__", torch.Tensor), ("__float__", torch.Tensor)]


def test_constrained_dispatch_reads_nothing_back(tiny_path, monkeypatch):
    """A spy on every call that reads a tensor back to the host, armed over
    the grammar masks' flush and the decode dispatch (multi_step 4, with
    constrained and unconstrained slots): neither calls one. A batch with a
    constrained slot decodes a step a dispatch; the unconstrained request's
    tail, alone in the batch, pipelines."""
    eng = _port(tiny_path, multi_step=4)
    armed, calls, flushed = [False], [], [0]
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

    flush = eng._flush_grammar_masks

    def counted_flush(active):
        flushed[0] += sum(eng.slots[b].mask_dirty for b in active)
        flush(active)
    eng._issue = armed_call(eng._issue)
    eng._flush_grammar_masks = armed_call(counted_flush)
    params = _params(ts.SamplingParams)
    params[1].max_tokens = 64
    evs = _staggered(eng, params)
    assert calls == [] and flushed[0] > 10
    assert len(evs[1]) == 64 and eng.stats()["continuations"] > 0
    assert json.loads("".join(e.text for e in evs[0]))["b"] in ("x", "y")


WEATHER = {"type": "function", "function": {
    "name": "get_weather",
    "parameters": {"type": "object", "properties": {"city": {"enum": ["Oslo", "Rome"]}},
                   "required": ["city"], "additionalProperties": False}}}


async def test_served_tool_calls_and_fanout(tiny_path):
    """Through the port's server on a CPU engine: a forced tool call comes
    back as a ``tool_calls`` message whose arguments fit the function's
    schema, the same streamed; ``n = 3`` gives choices 0, 1 and 2, choice 0
    the ``n = 1`` answer; a json_schema answer parses."""
    from llama_gguf_inference_tpu_torch.serving.openai_server import (BackendConfig,
                                                                      OpenAIServer)
    from test_torch_engine import KEY, _http
    eng = tengine.InferenceEngine(tiny_path, tengine.EngineConfig(
        max_slots=4, ctx=1024, multi_step=4), device="cpu")
    eng.start()
    srv = OpenAIServer(eng, BackendConfig(host="127.0.0.1", port=0, api_key=KEY))
    await srv.start()
    try:
        tool = {"messages": [{"role": "user", "content": "weather in Oslo?"}],
                "tools": [WEATHER], "tool_choice": "required", "max_tokens": 512,
                "temperature": 0}
        st, body = await _http(srv.port, "POST", "/v1/chat/completions", tool)
        choice = json.loads(body)["choices"][0]
        assert st == 200 and choice["finish_reason"] == "tool_calls", body
        calls = choice["message"]["tool_calls"]
        assert all(c["function"]["name"] == "get_weather" and
                   json.loads(c["function"]["arguments"])["city"] in ("Oslo", "Rome")
                   for c in calls)
        st, body = await _http(srv.port, "POST", "/v1/chat/completions",
                               {**tool, "stream": True})
        chunks = [json.loads(ln[6:]) for ln in body.decode().split("\n")
                  if ln.startswith("data: ") and ln != "data: [DONE]"]
        deltas = [d for c in chunks for d in c["choices"][0]["delta"].get("tool_calls", [])]
        streamed = [{"name": a["function"]["name"], "arguments": b["function"]["arguments"]}
                    for a, b in zip(deltas[::2], deltas[1::2])]
        assert streamed == [{k: c["function"][k] for k in ("name", "arguments")}
                            for c in calls]
        assert chunks[-1]["choices"][0]["finish_reason"] == "tool_calls"
        fan = {"prompt": "a quick dog", "max_tokens": 12, "temperature": 0.8, "seed": 77}
        st, body = await _http(srv.port, "POST", "/v1/completions", {**fan, "n": 3})
        choices = json.loads(body)["choices"]
        assert st == 200 and [c["index"] for c in choices] == [0, 1, 2]
        st, body = await _http(srv.port, "POST", "/v1/completions", fan)
        assert json.loads(body)["choices"][0]["text"] == choices[0]["text"]
        assert len({c["text"] for c in choices}) > 1
        st, body = await _http(srv.port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "json"}], "max_tokens": 64,
            "response_format": {"type": "json_schema", "json_schema": {"schema": SCHEMA}}})
        val = json.loads(json.loads(body)["choices"][0]["message"]["content"])
        assert set(val) == {"a", "b"}
    finally:
        await srv.close()
        eng.stop()
