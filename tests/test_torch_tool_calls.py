"""The port's tool-call module against the JAX package's, on the CPU.

``validate_tools``, ``tool_grammar``, ``tools_system_prompt``,
``parse_tool_calls`` (but for each call's random id) and
``prepare_messages`` give the same results on the cases of
``test_tool_calls.py`` and a few more, and refuse the same bodies with the
same ``ToolRequestError`` message.
"""

import copy
import json

import pytest

from llama_gguf_inference_tpu.serving import tool_calls as jtc
from llama_gguf_inference_tpu_torch.serving import tool_calls as ttc

WEATHER = {"type": "function", "function": {
    "name": "get_weather", "description": "Get the weather for a city",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string", "maxLength": 8}},
                   "required": ["city"], "additionalProperties": False}}}
TIME = {"type": "function", "function": {
    "name": "get_time",
    "parameters": {"type": "object", "properties": {}, "additionalProperties": False}}}
NO_PARAMS = {"type": "function", "function": {"name": "ping"}}

BODIES = [
    {"tools": [WEATHER, TIME]},
    {"tools": [WEATHER], "tool_choice": "required"},
    {"tools": [WEATHER, TIME], "tool_choice": {"type": "function",
                                               "function": {"name": "get_time"}}},
    {"tools": [WEATHER], "tool_choice": "none"},
    {"tools": [WEATHER], "tool_choice": "auto"},
    {"tools": [NO_PARAMS], "tool_choice": "required"},
    {},
    {"tools": []},
    {"tools": None, "tool_choice": "auto"},
]
BAD_BODIES = [
    {"tools": "x"},
    {"tools": [{"type": "function"}]},
    {"tools": [{"type": "function", "function": {"description": "no name"}}]},
    {"tools": [WEATHER], "tool_choice": "sometimes"},
    {"tools": [WEATHER], "tool_choice": {"type": "function", "function": {"name": "nope"}}},
    {"tool_choice": "required"},
    {"tools": [], "tool_choice": {"type": "function", "function": {"name": "x"}}},
    {"tools": [{"type": "function", "function": {
        "name": "f", "parameters": {"type": "object",
                                    "properties": {"x": {"allOf": [{"type": "integer"},
                                                                   {"type": "string"}]}}}}}],
     "tool_choice": "required"},
]
TEXTS = [
    '{"tool_calls": [{"name": "get_weather", "arguments": {"city": "Oslo"}}]}',
    '```json\n{"tool_calls": [{"name": "get_time", "arguments": {}}]}\n```',
    '  {"tool_calls": [{"name": "get_time", "arguments": "{}"}, '
    '{"name": "get_weather", "arguments": {"city": "Rome"}}]} ',
    "sure, calling now", '{"a": 1}', '{"tool_calls": []}',
    '{"tool_calls": [{"name": "unknown", "arguments": {}}]}',
    '{"tool_calls": "x"}', "{broken", "",
]
MESSAGES = [
    [{"role": "user", "content": "weather in Oslo?"},
     {"role": "assistant", "tool_calls": [
         {"id": "call_1", "type": "function",
          "function": {"name": "get_weather", "arguments": '{"city": "Oslo"}'}}]},
     {"role": "tool", "tool_call_id": "call_1", "name": "get_weather",
      "content": '{"temp_c": 4}'}],
    [{"role": "system", "content": "be brief"}],
    [{"role": "user", "content": "hi"}, {"role": "tool", "content": {"ok": True}},
     {"role": "assistant", "tool_calls": [{"function": {"name": "get_time",
                                                        "arguments": "not json"}}]}],
]


def _run(fn, *a):
    """fn(*a) on a deep copy of the arguments, and whether it changed them."""
    args = copy.deepcopy(a)
    out = fn(*args)
    return out, args == a


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_validate_tools_matches_jax(i):
    got = _run(ttc.validate_tools, BODIES[i])
    assert got == _run(jtc.validate_tools, BODIES[i])


@pytest.mark.parametrize("i", range(len(BAD_BODIES)))
def test_validate_tools_refuses_as_jax(i):
    def err(mod):
        with pytest.raises(mod.ToolRequestError) as e:
            tools, forced, on = mod.validate_tools(BAD_BODIES[i])
            if on and forced is not None:
                mod.tool_grammar(tools, forced)
        return str(e.value)
    assert issubclass(ttc.ToolRequestError, ValueError)
    assert err(ttc) == err(jtc)


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_tool_grammar_and_prompt_match_jax(i):
    tools, forced, on = jtc.validate_tools(BODIES[i])
    if not tools:
        return
    assert ttc.tool_grammar(tools, forced) == jtc.tool_grammar(tools, forced)
    assert ttc.tools_system_prompt(tools) == jtc.tools_system_prompt(tools)


def _scrub(calls):
    if calls is None:
        return None
    assert all(c["id"].startswith("call_") and len(c["id"]) == 29 for c in calls)
    return [{k: v for k, v in c.items() if k != "id"} for c in calls]


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_parse_tool_calls_matches_jax(i):
    tools = [WEATHER["function"], TIME["function"]]
    got = _scrub(ttc.parse_tool_calls(TEXTS[i], tools))
    assert got == _scrub(jtc.parse_tool_calls(TEXTS[i], tools))
    if got:
        assert all(isinstance(c["function"]["arguments"], str) for c in got)
        json.loads(got[0]["function"]["arguments"])


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_prepare_messages_matches_jax(i, enabled):
    tools = [WEATHER["function"]]
    got = _run(ttc.prepare_messages, MESSAGES[i], tools, enabled)
    assert got == _run(jtc.prepare_messages, MESSAGES[i], tools, enabled)
