"""Start-up of the port's server, on the CPU, against the JAX package.

The warm-up: on the same configurations both engines' ``warmup_async``
send the same synthetic prompts with the same ``max_tokens`` (a spy on
``generate``); on the card the kernels' build comes first; a failure prints
its traceback and ``[backend] warm-up failed``; a real one on a tiny engine
ends with ``[backend] warm-up done``. ``main()`` starts it unless
``ENGINE_WARMUP`` is 0, false or no, and never on the mock.

The mock backend: ``MockEngine`` against the JAX package's (the same text,
tokens, events, embedding and stats keys); both servers over their mocks
answer every path with the same statuses and JSON (ids and timestamps
aside); ``build_engine_from_env`` returns the mock without ``MODEL_PATH`` or
with ``MOCK_BACKEND``.
"""

import asyncio
import json

import jax.numpy as jnp
import pytest
import torch

from llama_gguf_inference_tpu.runtime import engine as jengine
from llama_gguf_inference_tpu.runtime import mock as jmock
from llama_gguf_inference_tpu.runtime.sampler import SamplingParams as JParams
from llama_gguf_inference_tpu.serving import openai_server as jsrv
from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime import mock as tmock
from llama_gguf_inference_tpu_torch.runtime.engine import GenEvent
from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
from llama_gguf_inference_tpu_torch.serving import openai_server as tsrv
from test_torch_model import write_tiny_q4km

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_tiny_q4km(str(tmp_path_factory.mktemp("startup") / "q.gguf"))


# -- warm-up ------------------------------------------------------------------

CONFIGS = [dict(ctx=64, multi_step=1), dict(ctx=2048, multi_step=4),
           dict(ctx=512, multi_step=2, kv_layout="paged", kv_page_size=256)]


def _spy(eng):
    """Replace ``eng.generate`` by a recorder that finishes each request at
    once; returns the record of (prompt, max_tokens, temperature)."""
    calls = []

    def generate(prompt, params=None, timeout=0):
        calls.append((list(prompt), params.max_tokens, params.temperature))
        yield GenEvent(finished=True, finish_reason="length")

    eng.generate = generate
    return calls


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_warmup_requests_match_jax(tiny, cfg):
    je = jengine.InferenceEngine(tiny, jengine.EngineConfig(max_slots=2, kv_dtype=jnp.bfloat16,
                                                            **cfg))
    te = tengine.InferenceEngine(tiny, tengine.EngineConfig(max_slots=2, **cfg), device="cpu")
    assert te._slot_cap_max() == je._slot_cap_max()
    want, got = _spy(je), _spy(te)
    je.warmup_async().join(timeout=60)
    te.warmup_async().join(timeout=60)
    assert got == want and len(got) >= 2
    assert got[-1][1] == max(2, 3 * cfg["multi_step"] + 2)
    if cfg["ctx"] > 1024 + 64:        # one prompt past the largest bucket
        assert max(len(p) for p, _, _ in got) == 1024 + 16


def test_warmup_builds_the_kernels_first_on_the_card(tiny, monkeypatch, capsys):
    te = tengine.InferenceEngine(tiny, tengine.EngineConfig(max_slots=2, ctx=64), device="cpu")
    order = []
    monkeypatch.setattr(_build, "build_all", lambda: order.append("build") or {})
    calls = _spy(te)
    spy = te.generate

    def generate(*a, **k):
        order.append("request")
        yield from spy(*a, **k)
    te.generate = generate
    te.warmup_async().join(timeout=60)
    assert order and "build" not in order          # the CPU builds nothing
    order.clear()
    te.device = torch.device("cuda")               # as an engine on the card sees itself
    te.warmup_async().join(timeout=60)
    assert order[0] == "build" and order.count("build") == 1 and len(calls) > 2
    assert capsys.readouterr().out.count("[backend] warm-up done in") == 2


@pytest.mark.parametrize("how", ["build", "request", "error_event"])
def test_warmup_failure_is_printed(tiny, monkeypatch, capsys, how):
    te = tengine.InferenceEngine(tiny, tengine.EngineConfig(max_slots=2, ctx=64), device="cpu")
    if how == "build":
        te.device = torch.device("cuda")

        def fail():
            raise RuntimeError("nvcc failed: stand-in")
        monkeypatch.setattr(_build, "build_all", fail)
    elif how == "request":
        def generate(prompt, params=None, timeout=0):
            raise RuntimeError("stand-in request failure")
            yield
        te.generate = generate
    else:
        def generate(prompt, params=None, timeout=0):
            yield GenEvent(finished=True, finish_reason="error")
        te.generate = generate
    te.warmup_async().join(timeout=60)
    out = capsys.readouterr()
    assert "Traceback" in out.err and "RuntimeError" in out.err
    assert "[backend] warm-up failed" in out.out and "warm-up done" not in out.out


def test_warmup_runs_on_a_tiny_engine(tiny, capsys):
    te = tengine.InferenceEngine(tiny, tengine.EngineConfig(max_slots=2, ctx=64,
                                                            prefix_cache=False), device="cpu")
    te.start()
    try:
        te.warmup_async().join(timeout=300)
    finally:
        te.stop()
    assert "[backend] warm-up done in" in capsys.readouterr().out
    # prompts of 16 and 32 tokens (32 = ctx // 2): 2 tokens, then the last
    # 3 * multi_step + 2
    assert te.total_prompt_tokens == 48 and te.total_generated == 2 + 5


class _Fake:
    model_name = "fake"

    def __init__(self, log):
        self.log = log

    def start(self):
        self.log.append("start")

    def stop(self):
        self.log.append("stop")

    def warmup_async(self):
        self.log.append("warmup")


@pytest.mark.parametrize("env,warm", [({}, True), ({"ENGINE_WARMUP": "1"}, True),
                                      ({"ENGINE_WARMUP": "0"}, False),
                                      ({"ENGINE_WARMUP": "false"}, False),
                                      ({"ENGINE_WARMUP": "no"}, False),
                                      ({"MOCK_BACKEND": "true"}, False)])
def test_main_starts_the_warmup(monkeypatch, env, warm):
    log = []
    for k in ("ENGINE_WARMUP", "MOCK_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tsrv, "build_engine_from_env", lambda: _Fake(log))

    async def serve(srv, engine):
        log.append("serve")
    monkeypatch.setattr(tsrv, "_serve_until_signal", serve)
    tsrv.main()
    assert log == ["start", *(["warmup"] if warm else []), "serve", "stop"]


# -- the mock backend -----------------------------------------------------------

def _events(eng, params, prompt="one two three"):
    _, out = eng.submit(prompt, params)
    evs = []
    while not (evs and evs[-1].finished):
        evs.append(out.get(timeout=10))
    return [(e.token_id, e.text, e.finished, e.finish_reason, e.n_prompt, e.n_generated)
            for e in evs]


@pytest.mark.parametrize("max_tokens", [1, 5, 16, 40])
def test_mock_engine_matches_jax(max_tokens):
    je, te = jmock.MockEngine(), tmock.MockEngine()
    assert _events(te, SamplingParams(max_tokens=max_tokens)) == \
        _events(je, JParams(max_tokens=max_tokens))
    assert te.generate_text("a b", SamplingParams(max_tokens=3)) == \
        je.generate_text("a b", JParams(max_tokens=3)) == "mock-token-0 mock-token-1 mock-token-2"
    assert te.embed("x y z") == je.embed("x y z")
    assert te.stats().keys() == je.stats().keys() and te.stats() == je.stats()
    tok, jtok = te.tokenizer, je.tokenizer
    for text in ("", "hello", "a b c d"):
        assert tok.encode(text) == jtok.encode(text)
        assert tok.decode(tok.encode(text)) == jtok.decode(jtok.encode(text))
    assert [tok.piece(i) for i in range(6)] == [jtok.piece(i) for i in range(6)]


def test_mock_engine_failure_matches_jax():
    je, te = jmock.MockEngine(fail_after=2), tmock.MockEngine(fail_after=2)
    assert _events(te, SamplingParams(max_tokens=8)) == _events(je, JParams(max_tokens=8))


class _Writer:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def close(self):
        pass


def _http(srv, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else b""
    req = (f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {len(data)}\r\n\r\n"
           ).encode() + data

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(req)
        reader.feed_eof()
        w = _Writer()
        await srv.handle_client(reader, w)
        return w.data

    head, _, payload = asyncio.run(go()).partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    if b"text/event-stream" in head:
        return status, [ln[6:] if ln[6:] == "[DONE]" else json.loads(ln[6:])
                        for ln in payload.decode().split("\n") if ln.startswith("data: ")]
    return status, json.loads(payload) if payload else None


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items()
                if k not in ("id", "created", "uptime_seconds")}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


CHAT = {"messages": [{"role": "user", "content": "hi there"}], "max_tokens": 4}
REQUESTS = [
    ("GET", "/health", None), ("GET", "/v1/models", None), ("GET", "/props", None),
    ("POST", "/v1/chat/completions", CHAT),
    ("POST", "/v1/chat/completions", {**CHAT, "stream": True}),
    ("POST", "/v1/chat/completions", {**CHAT, "n": 2}),
    ("POST", "/v1/chat/completions", {**CHAT, "max_tokens": 40}),
    ("POST", "/v1/chat/completions", {"messages": "nope"}),
    ("POST", "/v1/completions", {"prompt": "a b c", "max_tokens": 3}),
    ("POST", "/v1/completions", {"prompt": "a b c", "max_tokens": 3, "stream": True,
                                 "stream_options": {"include_usage": True}}),
    ("POST", "/completion", {"prompt": "x", "n_predict": 2}),
    ("POST", "/v1/embeddings", {"input": ["a b", "c"]}),
    ("POST", "/v1/rerank", {"query": "q", "documents": ["a", "b c"], "top_n": 1}),
    ("POST", "/tokenize", {"content": "one two", "with_pieces": True}),
    ("POST", "/detokenize", {"tokens": [1, 3, 4]}),
    ("POST", "/detokenize", {"tokens": [99]}),
    ("POST", "/apply-template", {"messages": [{"role": "user", "content": "hi"}]}),
    ("GET", "/slots", None),
    ("POST", "/slots/0?action=save", {"filename": "x"}),
    ("POST", "/infill", {"input_prefix": "a", "input_suffix": "b"}),
    ("GET", "/nope", None),
]


@pytest.mark.parametrize("i", range(len(REQUESTS)), ids=lambda i: REQUESTS[i][1])
def test_servers_answer_the_same_on_the_mock(i):
    method, path, body = REQUESTS[i]
    want, got = [_http(srv, method, path, body) for srv in (
        jsrv.OpenAIServer(jmock.MockEngine(), jsrv.BackendConfig()),
        tsrv.OpenAIServer(tmock.MockEngine(), tsrv.BackendConfig()))]
    assert got[0] == want[0]
    assert _scrub(got[1]) == _scrub(want[1])


def test_build_engine_from_env_serves_the_mock(monkeypatch, tiny):
    monkeypatch.delenv("MODEL_PATH", raising=False)
    monkeypatch.delenv("MOCK_BACKEND", raising=False)
    monkeypatch.setenv("MODEL_NAME", "mocked")
    monkeypatch.setenv("MOCK_DELAY_S", "0.001")
    eng = tsrv.build_engine_from_env()          # no card needed: the mock
    assert isinstance(eng, tmock.MockEngine) and eng.model_name == "mocked"
    assert eng.delay_s == 0.001 and eng.stats()["mock"] is True
    monkeypatch.setenv("MODEL_PATH", str(tiny))
    monkeypatch.setenv("MOCK_BACKEND", "yes")
    assert isinstance(tsrv.build_engine_from_env(device="cpu"), tmock.MockEngine)
    monkeypatch.setenv("MOCK_BACKEND", "0")
    assert isinstance(tsrv.build_engine_from_env(device="cpu"), tengine.InferenceEngine)
