"""The port server's sampling fields and logprob responses against the JAX
package's server, on the CPU.

Both parse the same request bodies (``_parse_logit_bias``,
``_params_from_request``), and both shape responses from the same stream of
engine events (a stub engine hands each server the same events), so the
JSON each sends must agree but for its id and creation time: chat,
completion and streamed chat responses with ``logprobs``.
"""

import asyncio
import dataclasses
import json
import queue

import pytest

from llama_gguf_inference_tpu.serving import openai_server as jsrv
from llama_gguf_inference_tpu_torch.runtime.engine import GenEvent
from llama_gguf_inference_tpu_torch.serving import openai_server as tsrv

LOGIT_BIAS_BODIES = [
    {"logit_bias": {"15": 2.5, "7": -100, "3": False}},       # OpenAI, string keys
    {"logit_bias": {15: 1}},
    {"logit_bias": [[15, 2.5], [7, False], [9]]},              # llama.cpp pairs
    {"logit_bias": {}},
    {},
    {"logit_bias": None},
]
BAD_LOGIT_BIAS = [{"logit_bias": "x"}, {"logit_bias": {"a": 1.0}},
                  {"logit_bias": [[1, "many"]]}]


@pytest.mark.parametrize("body", LOGIT_BIAS_BODIES)
def test_parse_logit_bias_matches_jax(body):
    assert tsrv._parse_logit_bias(body) == jsrv._parse_logit_bias(body)


@pytest.mark.parametrize("body", BAD_LOGIT_BIAS)
def test_bad_logit_bias_is_refused_as_by_jax(body):
    with pytest.raises(ValueError):
        jsrv._parse_logit_bias(body)
    with pytest.raises(ValueError, match="logit_bias"):
        tsrv._params_from_request(body)


PARAM_BODIES = [
    {"temperature": 0.7, "top_p": 0.9, "top_k": 40, "min_p": 0.05, "typical_p": 0.8},
    {"presence_penalty": 0.5, "frequency_penalty": 0.25, "repeat_penalty": 1.3},
    {"mirostat": 2, "mirostat_tau": 3.5, "mirostat_eta": 0.2},
    {"mirostat": 1},
    {"logprobs": True},
    {"logprobs": True, "top_logprobs": 3},
    {"logprobs": True, "top_logprobs": 20},
    {"logprobs": 5},
    {"logprobs": False, "top_logprobs": 3},
    {"max_tokens": 7, "stop": "x", "seed": 4, "logit_bias": {"3": False}},
]


@pytest.mark.parametrize("body", PARAM_BODIES)
def test_params_match_jax(body):
    body = {"seed": 1, **body}
    want = dataclasses.asdict(jsrv._params_from_request(body))
    got = dataclasses.asdict(tsrv._params_from_request(body))
    assert got == want


class _Tokenizer:
    @staticmethod
    def piece(i: int) -> str:
        return f"<{i}>"


class _StubEngine:
    """Hands every request the same events."""

    model_name = "stub"
    tokenizer = _Tokenizer()
    metadata: dict = {}

    def __init__(self, events):
        self.events = events

    def submit(self, prompt, params, request_id=None):
        q: queue.Queue = queue.Queue()
        for ev in self.events:
            q.put(ev)
        return "rid", q

    def cancel(self, rid):
        return True


class _Writer:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b

    async def drain(self):
        pass


EVENTS = [
    GenEvent(token_id=5, text="Hi", n_prompt=3, n_generated=1, logprob=-0.25,
             top_logprobs=[(5, -0.25), (9, -1.5)]),
    GenEvent(token_id=9, text=" there", n_prompt=3, n_generated=2, logprob=-1.0,
             top_logprobs=[(9, -1.0), (5, -2.0)]),
    GenEvent(token_id=2, text="", finished=True, finish_reason="stop", n_prompt=3,
             n_generated=3, logprob=-0.5, top_logprobs=[(2, -0.5), (7, -3.0)]),
]


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _parse(raw: bytes, stream: bool):
    body = raw.partition(b"\r\n\r\n")[2].decode()
    if not stream:
        return _scrub(json.loads(body))
    return [_scrub(json.loads(ln[6:])) if ln[6:] != "[DONE]" else ln[6:]
            for ln in body.split("\n") if ln.startswith("data: ")]


@pytest.mark.parametrize("chat,stream", [(True, False), (False, False), (True, True)])
def test_logprob_responses_match_jax(chat, stream):
    body = {"logprobs": True, "top_logprobs": 2, "seed": 1}
    out = []
    for mod in (jsrv, tsrv):
        params = mod._params_from_request(body)
        srv = mod.OpenAIServer(_StubEngine(EVENTS), mod.BackendConfig())
        w = _Writer()
        obj = "chat.completion" if chat else "text_completion"
        if mod is jsrv:
            coro = srv._stream(w, "x", obj + ".chunk", "p", params, chat) if stream \
                else srv._complete(w, "x", obj, "p", params, chat)
        else:
            pres = [srv.engine.submit("p", params)]
            coro = srv._stream(w, "x", obj + ".chunk", pres, chat, False, params) if stream \
                else srv._complete(w, "x", obj, pres, chat, params)
        asyncio.run(coro)
        out.append(_parse(w.data, stream))
    assert out[1] == out[0]
    if not stream:
        lp = out[1]["choices"][0]["logprobs"]
        assert (lp["content"][1]["top_logprobs"][0]["token"] if chat
                else lp["token_logprobs"]) in ("<9>", [-0.25, -1.0, -0.5])
