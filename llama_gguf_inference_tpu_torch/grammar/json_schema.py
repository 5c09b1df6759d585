"""JSON Schema -> GBNF conversion (llama.cpp ``json_schema_to_grammar``
parity for the subset llama-server's clients exercise).

Supported: ``type`` (object/array/string/number/integer/boolean/null and
lists thereof), ``properties``/``required``/``additionalProperties``,
``items``/``prefixItems``/``minItems``/``maxItems``, ``enum``/``const``,
``anyOf``/``oneOf``/``allOf`` (single-element), ``$ref`` into ``$defs``/
``definitions`` (recursion allowed), string ``minLength``/``maxLength``.
``pattern``/``format``/numeric bounds are accepted but not enforced
(the value space is a superset — same failure mode as older llama.cpp).

The produced grammar terminates: unbounded numeric/string repetition is
capped per-token-run the same way llama.cpp caps digit runs.
"""

from __future__ import annotations

import json
from typing import Any

from .gbnf import GBNFError

# generic JSON value grammar: response_format {"type": "json_object"}
# (llama-server constrains to a top-level object, not any value)
JSON_GBNF = r"""
root ::= object
value ::= object | array | string | number | boolean | null
object ::= "{" space ( member ( "," space member )* )? "}" space
member ::= string ":" space value
array ::= "[" space ( value ( "," space value )* )? "]" space
string ::= "\"" char* "\"" space
char ::= [^"\\\x00-\x1F] | "\\" (["\\/bfnrt] | "u" [0-9a-fA-F]{4})
number ::= "-"? ( "0" | [1-9] [0-9]{0,15} ) ( "." [0-9]{1,15} )? ( [eE] [-+]? [0-9]{1,4} )? space
boolean ::= ( "true" | "false" ) space
null ::= "null" space
space ::= " "?
""".strip() + "\n"

_PRIMITIVES = {
    "string": 'string ::= "\\"" char* "\\"" space',
    "char": 'char ::= [^"\\\\\\x00-\\x1F] | "\\\\" (["\\\\/bfnrt] | "u" [0-9a-fA-F]{4})',
    "number": 'number ::= "-"? ( "0" | [1-9] [0-9]{0,15} ) ( "." [0-9]{1,15} )? ( [eE] [-+]? [0-9]{1,4} )? space',
    "integer": 'integer ::= "-"? ( "0" | [1-9] [0-9]{0,15} ) space',
    "boolean": 'boolean ::= ( "true" | "false" ) space',
    "null": 'null ::= "null" space',
    "space": 'space ::= " "?',
    "value": "value ::= object | array | string | number | boolean | null",
    "object": 'object ::= "{" space ( member ( "," space member )* )? "}" space',
    "member": 'member ::= string ":" space value',
    "array": 'array ::= "[" space ( value ( "," space value )* )? "]" space',
}

_PRIM_DEPS = {
    "string": ["char", "space"], "number": ["space"], "integer": ["space"],
    "boolean": ["space"], "null": ["space"],
    "value": ["object", "array", "string", "number", "boolean", "null"],
    "object": ["member", "space"], "member": ["string", "value", "space"],
    "array": ["value", "space"],
}


class SchemaError(ValueError):
    pass


def _lit(value: Any) -> str:
    """A GBNF literal matching json.dumps(value)."""
    s = json.dumps(value)
    out = s.replace("\\", "\\\\").replace('"', '\\"')
    return f'"{out}"'


class _Converter:
    def __init__(self, schema: dict):
        self.root_schema = schema
        self.rules: dict[str, str] = {}
        self.refs: dict[str, str] = {}      # $ref path -> rule name
        self.counter = 0

    # -- plumbing -----------------------------------------------------------
    def _prim(self, name: str) -> str:
        if name not in self.rules:
            self.rules[name] = _PRIMITIVES[name]
            for dep in _PRIM_DEPS.get(name, []):
                self._prim(dep)
        return name

    def _add(self, hint: str, body: str) -> str:
        """Register a rule, deduping identical bodies."""
        for name, line in self.rules.items():
            if line.split("::=", 1)[1].strip() == body.strip():
                return name
        name = hint
        while name in self.rules:
            self.counter += 1
            name = f"{hint}{self.counter}"
        self.rules[name] = f"{name} ::= {body}"
        return name

    def _resolve_ref(self, ref: str) -> Any:
        if not ref.startswith("#/"):
            raise SchemaError(f"unsupported $ref {ref!r} (only #/ fragments)")
        node: Any = self.root_schema
        for part in ref[2:].split("/"):
            part = part.replace("~1", "/").replace("~0", "~")
            if isinstance(node, list):
                node = node[int(part)]
            elif isinstance(node, dict) and part in node:
                node = node[part]
            else:
                raise SchemaError(f"$ref {ref!r} does not resolve")
        return node

    # -- schema -> rule name --------------------------------------------------
    def visit(self, schema: Any, hint: str) -> str:
        if schema is True or schema == {}:
            return self._prim("value")
        if schema is False:
            raise SchemaError("schema 'false' matches nothing")
        if not isinstance(schema, dict):
            raise SchemaError(f"schema must be an object, got {type(schema)}")

        if "$ref" in schema:
            ref = schema["$ref"]
            if ref in self.refs:
                return self.refs[ref]
            name = f"ref{len(self.refs)}"
            # pre-register so recursive schemas terminate
            self.refs[ref] = name
            target = self._resolve_ref(ref)
            body_rule = self.visit(target, name + "-body")
            self.rules[name] = f"{name} ::= {body_rule}"
            return name

        for key in ("anyOf", "oneOf"):
            if key in schema:
                subs = [self.visit(s, f"{hint}-alt{i}")
                        for i, s in enumerate(schema[key])]
                return self._add(hint, " | ".join(subs))
        if "allOf" in schema:
            if len(schema["allOf"]) == 1:
                merged = {**schema["allOf"][0],
                          **{k: v for k, v in schema.items() if k != "allOf"}}
                return self.visit(merged, hint)
            raise SchemaError("allOf with multiple subschemas is unsupported")

        if "const" in schema:
            return self._add(hint, f'{_lit(schema["const"])} {self._prim("space")}')
        if "enum" in schema:
            alts = " | ".join(_lit(v) for v in schema["enum"])
            return self._add(hint, f'( {alts} ) {self._prim("space")}')

        t = schema.get("type")
        if isinstance(t, list):
            subs = [self.visit({**schema, "type": one}, f"{hint}-{one}")
                    for one in t]
            return self._add(hint, " | ".join(subs))

        if t == "object" or (t is None and ("properties" in schema
                                            or "additionalProperties" in schema)):
            return self._object(schema, hint)
        if t == "array" or (t is None and ("items" in schema
                                           or "prefixItems" in schema)):
            return self._array(schema, hint)
        if t == "string":
            lo = int(schema.get("minLength", 0))
            hi = schema.get("maxLength")
            if lo == 0 and hi is None:
                return self._prim("string")
            rep = f"{{{lo},{hi}}}" if hi is not None else f"{{{lo},512}}"
            self._prim("char")
            return self._add(hint, f'"\\"" char{rep} "\\"" {self._prim("space")}')
        if t in ("number", "integer", "boolean", "null"):
            return self._prim(t)
        if t is None:
            return self._prim("value")
        raise SchemaError(f"unsupported schema type {t!r}")

    def _object(self, schema: dict, hint: str) -> str:
        props: dict = schema.get("properties", {}) or {}
        required = set(schema.get("required", []) or [])
        addl = schema.get("additionalProperties",
                          False if props else True)
        space = self._prim("space")

        kv_rules = {}
        for pname, pschema in props.items():
            vr = self.visit(pschema, f"{hint}-{_sanitize(pname)}")
            kv_rules[pname] = self._add(
                f"{hint}-{_sanitize(pname)}-kv",
                f'{_lit(pname)} {space} ":" {space} {vr}')

        addl_kv = None
        if addl is not False:
            vr = self._prim("value") if addl in (True, {}) \
                else self.visit(addl, f"{hint}-addl")
            addl_kv = self._add(f"{hint}-addl-kv",
                                f'{self._prim("string")} ":" {space} {vr}')

        # members in declaration order; optionals may be skipped.
        # tail(i, started) = helper rule matching props[i:] (+ the
        # additionalProperties tail), given whether a member was already
        # emitted.  Memoized -> at most 2n helper rules, no term blowup.
        names = list(props)
        memo: dict[tuple[int, bool], str] = {}

        def tail(i: int, started: bool) -> str:
            """Returns a GBNF expression ('' = matches only ε)."""
            key = (i, started)
            if key in memo:
                return memo[key]
            if i == len(names):
                if addl_kv is None:
                    body = ""
                elif started:
                    body = f'( "," {space} {addl_kv} )*'
                else:
                    body = f'( {addl_kv} ( "," {space} {addl_kv} )* )?'
            else:
                kv = kv_rules[names[i]]
                lead = f'"," {space} {kv}' if started else kv
                rest = tail(i + 1, True)
                with_it = f"{lead} {rest}".strip()
                if names[i] in required:
                    body = with_it
                else:
                    skip = tail(i + 1, started)
                    body = f"( {with_it} )?" if not skip else \
                        f"( {with_it} ) | ( {skip} )"
            if body and (" | " in body or (i < len(names)
                                           and names[i] not in required)):
                body = self._add(f"{hint}-m{i}{'s' if started else ''}", body)
            memo[key] = body
            return body

        inner = tail(0, False)
        rule = (f'"{{" {space} {inner} "}}" {space}' if inner
                else f'"{{" {space} "}}" {space}')
        return self._add(hint, rule)

    def _array(self, schema: dict, hint: str) -> str:
        space = self._prim("space")
        prefix = schema.get("prefixItems")
        if prefix:
            subs = [self.visit(s, f"{hint}-item{i}")
                    for i, s in enumerate(prefix)]
            seq = f' "," {space} '.join(subs)
            return self._add(hint, f'"[" {space} {seq} "]" {space}')
        items = schema.get("items", True)
        ir = self.visit(items if items is not None else True, f"{hint}-item")
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        more = f'( "," {space} {ir} )'
        if lo == 0:
            tail_rep = f"{more}*" if hi is None else f"{more}{{0,{max(0, int(hi) - 1)}}}"
            body = f'"[" {space} ( {ir} {tail_rep} )? "]" {space}' \
                if hi != 0 else f'"[" {space} "]" {space}'
        else:
            rep = f"{more}{{{lo - 1},{int(hi) - 1}}}" if hi is not None \
                else f"{more}{{{lo - 1},}}"
            body = f'"[" {space} {ir} {rep} "]" {space}'
        return self._add(hint, body)


def _sanitize(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "-" else "-" for c in name)
    return out.strip("-") or "prop"


def json_schema_to_gbnf(schema: Any) -> str:
    """Convert a JSON Schema to GBNF text with rule ``root``.

    Raises :class:`SchemaError` (a ValueError) on unsupported constructs —
    the serving layer maps that to HTTP 400."""
    conv = _Converter(schema if isinstance(schema, dict) else {})
    try:
        root = conv.visit(schema, "root0")
    except RecursionError as e:
        raise SchemaError("schema nests too deep") from e
    lines = [f"root ::= {root}"]
    lines.extend(conv.rules.values())
    text = "\n".join(lines) + "\n"
    # parse what we produced: conversion bugs must fail the REQUEST (400),
    # never reach the sampler half-formed
    from .gbnf import parse_gbnf
    try:
        parse_gbnf(text)
    except GBNFError as e:   # pragma: no cover — converter invariant
        raise SchemaError(f"internal: generated grammar invalid: {e}") from e
    return text
