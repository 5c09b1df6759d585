"""The port server's structured output, tool calls and ``n`` fan-out
against the JAX package's server, on the CPU.

Both servers parse the same request bodies and send what they build to a
stub engine that records every submission and hands each the same events,
so for each body the two must submit the same prompts with the same
sampling parameters (the grammar each field resolves to, each choice's
seed) and answer with the same status and JSON but for ids and creation
times: ``grammar``, ``json_schema`` and ``response_format``; ``tools``
with ``tool_choice`` (``tool_calls`` messages and streamed deltas); ``n``
choices and their indexes; and the 400s of malformed fields.
"""

import asyncio
import dataclasses
import json
import queue

import pytest

from llama_gguf_inference_tpu.serving import openai_server as jsrv
from llama_gguf_inference_tpu_torch.runtime.engine import GenEvent
from llama_gguf_inference_tpu_torch.serving import openai_server as tsrv

SCHEMA = {"type": "object",
          "properties": {"color": {"enum": ["red", "green"]}, "ok": {"type": "boolean"}},
          "required": ["color", "ok"]}
WEATHER = {"type": "function", "function": {
    "name": "get_weather", "description": "Get the weather for a city",
    "parameters": {"type": "object", "properties": {"city": {"enum": ["Oslo", "Rome"]}},
                   "required": ["city"], "additionalProperties": False}}}
TIME = {"type": "function", "function": {
    "name": "get_time",
    "parameters": {"type": "object", "properties": {}, "additionalProperties": False}}}
MSGS = [{"role": "user", "content": "weather in Oslo?"}]

GRAMMAR_BODIES = [
    {},
    {"grammar": 'root ::= [0-9]+'},
    {"json_schema": SCHEMA},
    {"json_schema": {}},
    {"response_format": {"type": "text"}},
    {"response_format": {"type": "json_object"}},
    {"response_format": {"type": "json_object", "schema": SCHEMA}},
    {"response_format": {"type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}}},
    {"grammar": 'root ::= "a"', "json_schema": SCHEMA},          # grammar wins
    {"grammar": "", "response_format": {"type": "json_object"}},
]
BAD_GRAMMAR_BODIES = [
    {"grammar": "root ::= [broken"},
    {"grammar": "nonsense"},
    {"json_schema": False},
    {"json_schema": {"allOf": [{"type": "integer"}, {"type": "string"}]}},
    {"response_format": "json"},
    {"response_format": {"type": "wat"}},
    {"response_format": {"type": "json_schema"}},
    {"response_format": {"type": "json_schema", "json_schema": {"name": "t"}}},
]


@pytest.mark.parametrize("i", range(len(GRAMMAR_BODIES)))
def test_resolve_grammar_matches_jax(i):
    assert tsrv._resolve_grammar(GRAMMAR_BODIES[i]) == jsrv._resolve_grammar(GRAMMAR_BODIES[i])


@pytest.mark.parametrize("i", range(len(BAD_GRAMMAR_BODIES)))
def test_resolve_grammar_refuses_as_jax(i):
    with pytest.raises(ValueError) as want:
        jsrv._resolve_grammar(BAD_GRAMMAR_BODIES[i])
    with pytest.raises(ValueError) as got:
        tsrv._resolve_grammar(BAD_GRAMMAR_BODIES[i])
    assert str(got.value) == str(want.value)


N_VALUES = [1, 2, 8, 0, 9, -1, None, 2.0, "2", True, False, [2]]


@pytest.mark.parametrize("n", N_VALUES, ids=repr)
def test_parse_n_matches_jax(n):
    for body in ({"n": n}, {}):
        assert tsrv._parse_n(body) == jsrv.OpenAIServer._parse_n(body)
    assert tsrv._parse_n({"n": n}) == (n if type(n) is int and n in (1, 2, 8) else
                                      1 if n is None else None)


class _Special:
    bos_id, eos_id = 1, 2


class _Tokenizer:
    tokens = ["<unk>", "<s>", "</s>"]
    special = _Special()

    @staticmethod
    def piece(i: int) -> str:
        return f"<{i}>"


def _events(texts, finish="stop"):
    evs = [GenEvent(token_id=10 + i, text=t, n_prompt=7, n_generated=i + 1)
           for i, t in enumerate(texts)]
    evs.append(GenEvent(token_id=2, text="", finished=True, finish_reason=finish,
                        n_prompt=7, n_generated=len(texts) + 1))
    return evs


class _StubEngine:
    """Records each submission; hands the k-th one ``script(k)``'s events."""

    model_name = "stub"
    tokenizer = _Tokenizer()
    metadata: dict = {}

    def __init__(self, script):
        self.script = script
        self.submitted: list = []
        self.cancelled: list = []

    def submit(self, prompt, params, request_id=None):
        k = len(self.submitted)
        self.submitted.append((prompt, dataclasses.asdict(params)))
        q: queue.Queue = queue.Queue()
        for ev in self.script(k):
            q.put(ev)
        return f"rid{k}", q

    def cancel(self, rid):
        self.cancelled.append(rid)
        return True


class _Writer:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b

    async def drain(self):
        pass


@dataclasses.dataclass
class _Req:
    body: bytes
    method: str = "POST"
    path: str = "/"
    headers: dict = dataclasses.field(default_factory=dict)


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items()
                if k not in ("created",) and not (k == "id" and isinstance(v, str))}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _parse(raw: bytes):
    head, _, body = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    if b"text/event-stream" not in head:
        return status, _scrub(json.loads(body))
    return status, [_scrub(json.loads(ln[6:])) if ln[6:] != "[DONE]" else ln[6:]
                    for ln in body.decode().split("\n") if ln.startswith("data: ")]


def _serve(body, chat, script):
    """Each server's (status, scrubbed response, submissions, cancelled)."""
    out = []
    for mod in (jsrv, tsrv):
        eng = _StubEngine(script)
        srv = mod.OpenAIServer(eng, mod.BackendConfig())
        w, req = _Writer(), _Req(json.dumps(body).encode())
        if mod is jsrv:
            coro = srv.handle_chat(req, w) if chat else srv.handle_completions(req, w)
        else:
            coro = srv.handle_generate(req, w, chat=chat)
        asyncio.run(coro)
        out.append((*_parse(w.data), eng.submitted, eng.cancelled))
    return out


TOOL_TEXT = ['{"tool_calls": [{"name": "get_weather", ', '"arguments": {"city": "Oslo"}}]}']
CASES = {
    # name: (body, chat, the events of the k-th submission)
    "json_schema": ({"messages": MSGS, "response_format": {
        "type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}}},
        True, lambda k: _events(['{"color": ', '"red", "ok": true}'])),
    "json_object": ({"messages": MSGS, "response_format": {"type": "json_object"}},
                    True, lambda k: _events(["{}"])),
    "grammar_completion": ({"prompt": "count: ", "grammar": "root ::= [0-9]+"},
                           False, lambda k: _events(["1", "2"])),
    "tools_required": ({"messages": MSGS, "tools": [WEATHER, TIME],
                        "tool_choice": "required"}, True, lambda k: _events(TOOL_TEXT)),
    "tools_named": ({"messages": MSGS, "tools": [WEATHER, TIME], "tool_choice": {
        "type": "function", "function": {"name": "get_weather"}}},
        True, lambda k: _events(TOOL_TEXT)),
    "tools_auto_call": ({"messages": MSGS, "tools": [WEATHER]}, True,
                        lambda k: _events(TOOL_TEXT)),
    "tools_auto_text": ({"messages": MSGS, "tools": [WEATHER], "logprobs": True},
                        True, lambda k: _events(["It is ", "sunny."])),
    "tools_none": ({"messages": MSGS, "tools": [WEATHER], "tool_choice": "none"},
                   True, lambda k: _events(TOOL_TEXT)),
    "tool_turns": ({"messages": MSGS + [
        {"role": "assistant", "tool_calls": [{"id": "call_1", "type": "function",
                                              "function": {"name": "get_weather",
                                                           "arguments": '{"city": "Oslo"}'}}]},
        {"role": "tool", "name": "get_weather", "content": "4 C"}]},
        True, lambda k: _events(["Cold."])),
    "n3_chat": ({"messages": MSGS, "n": 3, "temperature": 0.8}, True,
                lambda k: _events([f"choice {k}", "!"], "length" if k == 1 else "stop")),
    "n3_completion": ({"prompt": "p", "n": 3, "logprobs": 2}, False,
                      lambda k: _events([f"c{k}"])),
    "n2_schema": ({"messages": MSGS, "n": 2, "json_schema": SCHEMA}, True,
                  lambda k: _events(['{"color": "green", "ok": false}'])),
    "n2_error": ({"prompt": "p", "n": 3}, False,
                 lambda k: _events(["x"], "error" if k == 1 else "stop")),
    "error_first": ({"messages": MSGS, "tools": [WEATHER], "tool_choice": "required"},
                    True, lambda k: _events([], "error")),
}
BAD = {
    "n0": ({"messages": MSGS, "n": 0}, True),
    "n9": ({"prompt": "p", "n": 9}, False),
    "n_str": ({"prompt": "p", "n": "2"}, False),
    "n_tools": ({"messages": MSGS, "n": 2, "tools": [WEATHER]}, True),
    "forced_grammar": ({"messages": MSGS, "tools": [WEATHER], "tool_choice": "required",
                        "grammar": 'root ::= "a"'}, True),
    "forced_format": ({"messages": MSGS, "tools": [WEATHER], "tool_choice": "required",
                       "response_format": {"type": "json_object"}}, True),
    "bad_choice": ({"messages": MSGS, "tools": [WEATHER], "tool_choice": "sometimes"}, True),
    "bad_tools": ({"messages": MSGS, "tools": "x"}, True),
    "bad_schema": ({"messages": MSGS, "response_format": {"type": "json_schema"}}, True),
    "bad_grammar": ({"prompt": "p", "grammar": "root ::= [broken"}, False),
    "bad_format": ({"messages": MSGS, "response_format": {"type": "wat"}}, True),
}


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_responses_match_jax(case, stream):
    body, chat, script = CASES[case]
    body = {"seed": 5, "max_tokens": 16, **body, "stream": stream,
            **({"stream_options": {"include_usage": True}} if stream else {})}
    (js, jr, jsub, jcan), (ts, tr, tsub, tcan) = _serve(body, chat, script)
    assert (ts, tr) == (js, jr)
    assert tsub == jsub and tcan == jcan
    n = body.get("n", 1)
    assert [s[1]["seed"] for s in tsub] == [5 + i for i in range(n)]
    if case.startswith("tools_") and case not in ("tools_none", "tools_auto_text"):
        if stream:
            deltas = [c["choices"][0]["delta"] for c in tr if c != "[DONE]" and c["choices"]]
            calls = [d["tool_calls"][0] for d in deltas if "tool_calls" in d]
            assert calls[0]["function"]["name"] == "get_weather"
            assert json.loads(calls[1]["function"]["arguments"]) == {"city": "Oslo"}
            assert tr[-3]["choices"][0]["finish_reason"] == "tool_calls"
        else:
            msg = tr["choices"][0]["message"]
            assert msg["content"] is None and tr["choices"][0]["finish_reason"] == "tool_calls"
            assert json.loads(msg["tool_calls"][0]["function"]["arguments"]) == {"city": "Oslo"}
    if case in ("tools_required", "tools_named"):
        assert tsub[0][1]["grammar"] and "get_weather" in tsub[0][1]["grammar"]
        assert ("get_time" in tsub[0][1]["grammar"]) == (case == "tools_required")
    if case.startswith("n3") and not stream:
        assert [c["index"] for c in tr["choices"]] == [0, 1, 2]
    if case.startswith("n3") and stream:
        idx = [c["choices"][0]["index"] for c in tr[:-1] if c["choices"]]
        assert idx == sorted(idx) and set(idx) == {0, 1, 2}


@pytest.mark.parametrize("case", list(BAD))
def test_malformed_fields_are_400_as_in_jax(case):
    body, chat = BAD[case]
    (js, jr, jsub, _), (ts, tr, tsub, _) = _serve(body, chat, lambda k: _events(["x"]))
    assert ts == js == 400 and tr == jr and tr["error"]["type"] == "invalid_request_error"
    assert tsub == jsub == []
