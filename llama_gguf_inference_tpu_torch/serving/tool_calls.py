"""OpenAI tool/function calling over the grammar machinery.

llama-server supports ``tools``/``tool_choice`` on ``/v1/chat/completions``; for models
without a family-specific call format it uses a *generic* handler: the tool
schemas are templated into the prompt and the model is asked to answer with
a single JSON object naming the calls.  This module is that generic handler:

- :func:`tools_system_prompt` renders the schemas + instructions into a
  system-message block;
- :func:`tool_grammar` builds a GBNF grammar (via
  ``grammar.json_schema_to_gbnf``) that constrains decoding to a valid
  ``{"tool_calls": [{"name": ..., "arguments": {...}}]}`` object — applied
  when ``tool_choice`` forces a call (``required`` or a named function),
  exactly the cases where free text would violate the contract;
- :func:`parse_tool_calls` recognizes the emitted JSON and shapes it into
  OpenAI ``tool_calls`` entries (``arguments`` re-serialized as a string);
- :func:`prepare_messages` folds ``role:"tool"`` results and prior
  assistant ``tool_calls`` turns into plain renderable messages for GGUF
  chat templates that know nothing about tools.
"""

from __future__ import annotations

import json
import uuid
from typing import Any

TOOLS_PROMPT = (
    "You have access to the following functions ('tools'). To call one or "
    "more of them, reply with ONLY a JSON object of the form\n"
    '{"tool_calls": [{"name": "<function-name>", "arguments": {...}}]}\n'
    "with arguments matching the function's JSON-Schema parameters. "
    "If no function is needed, answer normally.\n\nAvailable functions:\n"
)


class ToolRequestError(ValueError):
    """Malformed tools/tool_choice in the request (-> HTTP 400)."""


def validate_tools(body: dict) -> tuple[list[dict], str | None, bool]:
    """Extract (tools, forced_name, enabled) from a request body.

    ``forced_name`` is the function name when ``tool_choice`` names one,
    ``"*"`` for ``required`` (any tool, but a call MUST happen), and None
    for ``auto``.  ``enabled`` is False when there are no usable tools or
    ``tool_choice`` is ``none``.
    """
    tools_in = body.get("tools")
    if tools_in is None or tools_in == []:
        # tool_choice that FORCES a call with no usable tools is a client
        # error (OpenAI returns 400) — not a directive to silently ignore
        choice = body.get("tool_choice", "auto")
        forces = (choice == "required"
                  or (isinstance(choice, dict)
                      and choice.get("type") == "function"))
        if forces:
            raise ToolRequestError(
                "tool_choice requires a tool call but the request has no "
                "tools")
        return [], None, False
    if not isinstance(tools_in, list):
        raise ToolRequestError("tools must be an array")
    tools: list[dict] = []
    for t in tools_in:
        if not isinstance(t, dict) or t.get("type") != "function" \
                or not isinstance(t.get("function"), dict):
            raise ToolRequestError(
                "each tool must be {'type': 'function', 'function': {...}}")
        fn = t["function"]
        if not fn.get("name"):
            raise ToolRequestError("tool function.name is required")
        tools.append(fn)

    choice = body.get("tool_choice", "auto")
    if choice == "none" or not tools:
        return tools, None, False
    if choice == "auto":
        return tools, None, True
    if choice == "required":
        return tools, "*", True
    if isinstance(choice, dict) and choice.get("type") == "function":
        name = (choice.get("function") or {}).get("name")
        if not any(fn["name"] == name for fn in tools):
            raise ToolRequestError(
                f"tool_choice names unknown function {name!r}")
        return tools, str(name), True
    raise ToolRequestError(
        "tool_choice must be 'none', 'auto', 'required' or "
        "{'type': 'function', 'function': {'name': ...}}")


def tools_system_prompt(tools: list[dict]) -> str:
    specs = [{"name": fn["name"],
              "description": fn.get("description", ""),
              "parameters": fn.get("parameters", {"type": "object"})}
             for fn in tools]
    return TOOLS_PROMPT + "\n".join(json.dumps(s) for s in specs)


def tool_grammar(tools: list[dict], forced_name: str | None = None) -> str:
    """GBNF constraining output to a tool_calls JSON object.

    ``forced_name`` narrows the alternatives to one function; schema errors
    in a tool's ``parameters`` surface as ToolRequestError (-> 400).
    """
    from ..grammar import json_schema_to_gbnf
    from ..grammar.json_schema import SchemaError

    active = [fn for fn in tools
              if forced_name in (None, "*") or fn["name"] == forced_name]
    call_schemas = [{
        "type": "object",
        "properties": {
            "name": {"const": fn["name"]},
            "arguments": fn.get("parameters") or {"type": "object"},
        },
        "required": ["name", "arguments"],
        "additionalProperties": False,
    } for fn in active]
    schema = {
        "type": "object",
        "properties": {
            "tool_calls": {
                # maxItems is a runaway guard: the grammar must terminate
                # even if the model never prefers "]" (8 parallel calls is
                # far beyond any sane request)
                "type": "array", "minItems": 1, "maxItems": 8,
                "items": (call_schemas[0] if len(call_schemas) == 1
                          else {"anyOf": call_schemas}),
            },
        },
        "required": ["tool_calls"],
        "additionalProperties": False,
    }
    try:
        return json_schema_to_gbnf(schema)
    except SchemaError as e:
        raise ToolRequestError(f"unsupported tool parameters schema: {e}") from e


def parse_tool_calls(text: str, tools: list[dict]) -> list[dict] | None:
    """Shape emitted text into OpenAI tool_calls, or None if it isn't one.

    Accepts only a single JSON object with a well-formed non-empty
    ``tool_calls`` array naming known functions — free text, partial JSON,
    or unknown names return None (the response is then served as content).
    """
    known = {fn["name"] for fn in tools}
    s = text.strip()
    if s.startswith("```"):
        # models love fencing JSON; tolerate ```json ... ``` wrappers
        s = s.strip("`")
        if s.startswith("json"):
            s = s[4:]
        s = s.strip()
    if not s.startswith("{"):
        return None
    try:
        obj = json.loads(s)
    except json.JSONDecodeError:
        return None
    calls = obj.get("tool_calls") if isinstance(obj, dict) else None
    if not isinstance(calls, list) or not calls:
        return None
    out = []
    for c in calls:
        if not isinstance(c, dict) or c.get("name") not in known:
            return None
        args = c.get("arguments", {})
        out.append({
            "id": "call_" + uuid.uuid4().hex[:24],
            "type": "function",
            "function": {
                "name": c["name"],
                "arguments": (args if isinstance(args, str)
                              else json.dumps(args)),
            },
        })
    return out


def prepare_messages(messages: list, tools: list[dict],
                     enabled: bool) -> list[dict[str, Any]]:
    """Messages ready for a tools-unaware chat template.

    - injects the tools block into the FIRST system message (or prepends
      one) when tools are enabled;
    - an assistant turn carrying ``tool_calls`` renders as the call JSON
      (what the model actually emitted in that turn);
    - ``role:"tool"`` results keep their role with the payload as content,
      prefixed by the originating function where provided.
    """
    out: list[dict[str, Any]] = []
    for m in messages:
        if not isinstance(m, dict):
            out.append(m)
            continue
        role = m.get("role")
        if role == "assistant" and m.get("tool_calls"):
            calls = [{"name": (c.get("function") or {}).get("name"),
                      "arguments": _args_value(c)}
                     for c in m["tool_calls"] if isinstance(c, dict)]
            out.append({"role": "assistant",
                        "content": json.dumps({"tool_calls": calls})})
        elif role == "tool":
            content = m.get("content", "")
            if not isinstance(content, str):
                content = json.dumps(content)
            name = m.get("name") or ""
            out.append({"role": "tool",
                        "content": (f"[{name}] {content}" if name
                                    else content)})
        else:
            out.append(dict(m))
    if enabled and tools:
        block = tools_system_prompt(tools)
        for m in out:
            if m.get("role") == "system":
                m["content"] = f"{m.get('content', '')}\n\n{block}"
                break
        else:
            out.insert(0, {"role": "system", "content": block})
    return out


def _args_value(call: dict) -> Any:
    args = (call.get("function") or {}).get("arguments", "{}")
    if isinstance(args, str):
        try:
            return json.loads(args)
        except json.JSONDecodeError:
            return args
    return args
