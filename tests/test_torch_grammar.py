"""The port's grammar modules against the JAX package's, on the CPU.

Both packages hold their own copy of the GBNF parser, the JSON-Schema
converter and the matcher. For every GBNF text and schema of
``test_grammar.py`` (and the tool-call grammars of ``test_tool_calls.py``),
the port's parse and conversion equal the JAX package's, and the same
inputs are refused with the same message. On the tiny GGUF both packages'
vocab tries hold the same token texts and end-of-generation ids, and along
seeded walks of valid tokens the two matchers' masks are equal, bit for
bit, at every step.
"""

import numpy as np
import pytest

from llama_gguf_inference_tpu import grammar as jg
from llama_gguf_inference_tpu.gguf.reader import GGUFReader as JReader
from llama_gguf_inference_tpu.grammar import gbnf as jgbnf
from llama_gguf_inference_tpu.grammar import json_schema as jjs
from llama_gguf_inference_tpu.runtime.tokenizer import from_gguf_metadata as jtok
from llama_gguf_inference_tpu.serving import tool_calls as jtc
from llama_gguf_inference_tpu_torch import grammar as tg
from llama_gguf_inference_tpu_torch.gguf.reader import GGUFReader as TReader
from llama_gguf_inference_tpu_torch.grammar import gbnf as tgbnf
from llama_gguf_inference_tpu_torch.grammar import json_schema as tjs
from llama_gguf_inference_tpu_torch.runtime.tokenizer import from_gguf_metadata as ttok
from llama_gguf_inference_tpu_torch.serving import tool_calls as ttc
from test_torch_model import write_tiny_q4km

GBNF_OK = [
    'root ::= "a" | "b" root',
    'root ::= "ab"',
    'root ::= [0-9]+',
    'root ::= "a"? "b"',
    'root ::= "x"{2,3}',
    'root ::= ("a" | "bc")*',
    'root ::= [^xyz]',
    'root ::= "\\"" [a-z]* "\\""',
    'root ::= "(" root ")" | ""',
    'root ::= item{1,}\nitem ::= [a-c] # a comment\n',
    'root ::= "\\x41\\u00e9\\n" .',
    jg.JSON_GBNF,
]
GBNF_BAD = ["", "nonsense", 'root ::= "unterminated', "root ::= [a-",
            'other ::= "x"', "root ::= undefined_rule", 'root ::= "a"\nroot ::= "b"',
            'root ::= "\\q"']
LANGUAGE = [
    ('root ::= "ab"', ["ab"], ["a", "abc", ""]),
    ('root ::= [0-9]+', ["1", "123"], ["", "a", "12a"]),
    ('root ::= "a"? "b"', ["b", "ab"], ["a", "aab"]),
    ('root ::= "x"{2,3}', ["xx", "xxx"], ["x", "xxxx"]),
    ('root ::= ("a" | "bc")*', ["", "a", "bca", "aabc"], ["b"]),
    ('root ::= [^xyz]', ["a", "0"], ["x", "z", "aa"]),
    ('root ::= "\\"" [a-z]* "\\""', ['"abc"', '""'], ['"abc', "abc"]),
    ('root ::= "(" root ")" | ""', ["((()))", ""], ["(()"]),
    (jg.JSON_GBNF, ['{"a": [1, 2.5, true, null, "s"], "b": {"c": {}}}'],
     ["[1]", '{"a": }']),
]
SCHEMA = {"type": "object",
          "properties": {"a": {"type": "integer"}, "b": {"enum": ["x", "y"]}},
          "required": ["a", "b"]}
SCHEMAS = [
    SCHEMA,
    {"type": "object", "properties": {"a": {"type": "integer"}, "b": {"type": "string"}},
     "required": ["a"]},
    {"type": "object", "properties": {"a": {"type": "integer"}},
     "additionalProperties": True},
    {"type": "array", "items": {"type": "integer"}, "minItems": 1, "maxItems": 3},
    {"enum": ["a", 1, None]},
    {"const": {"k": [1]}},
    {"anyOf": [{"type": "integer"}, {"type": "null"}]},
    {"$defs": {"node": {"type": "object",
                        "properties": {"next": {"anyOf": [{"$ref": "#/$defs/node"},
                                                          {"type": "null"}]}},
                        "required": ["next"]}},
     "$ref": "#/$defs/node"},
    {"type": "string", "minLength": 2, "maxLength": 3},
    {"type": ["string", "null"]},
    {"prefixItems": [{"type": "boolean"}, {"type": "number"}]},
    {"allOf": [{"type": "object", "properties": {"z": {"type": "boolean"}}}]},
    True,
    {},
]
SCHEMAS_BAD = [False, {"allOf": [{"type": "integer"}, {"type": "string"}]},
               {"$ref": "http://external"}, {"type": "tuple"}, {"$ref": "#/nowhere"}]
WEATHER = {"name": "get_weather", "description": "Get the weather for a city",
           "parameters": {"type": "object",
                          "properties": {"city": {"type": "string", "maxLength": 8}},
                          "required": ["city"], "additionalProperties": False}}
TIME = {"name": "get_time", "parameters": {"type": "object", "properties": {},
                                           "additionalProperties": False}}
TOOL_GRAMMARS = [([WEATHER, TIME], None), ([WEATHER, TIME], "*"),
                 ([WEATHER, TIME], "get_time"), ([WEATHER], "get_weather")]


def _g(g):
    return g.rules, g.root, g.text


@pytest.mark.parametrize("src", GBNF_OK)
def test_parse_gbnf_matches_jax(src):
    assert _g(tgbnf.parse_gbnf(src)) == _g(jgbnf.parse_gbnf(src))


@pytest.mark.parametrize("src", GBNF_BAD)
def test_parse_gbnf_refuses_as_jax(src):
    with pytest.raises(jgbnf.GBNFError) as want:
        jgbnf.parse_gbnf(src)
    with pytest.raises(tgbnf.GBNFError) as got:
        tgbnf.parse_gbnf(src)
    assert str(got.value) == str(want.value)


class _NoVocab:
    vocab_size, eog_ids = 0, set()


def _accepts(mod, src, text):
    m = mod.GrammarMatcher(mod.parse_gbnf(src), mod.TokenTrie(_NoVocab()))
    return any(not s for s in m._accepts(m.state, text))


@pytest.mark.parametrize("src,ok,bad", LANGUAGE)
def test_matcher_language_matches_jax(src, ok, bad):
    for text in ok + bad:
        assert _accepts(tg, src, text) == _accepts(jg, src, text) == (text in ok)


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_json_schema_to_gbnf_matches_jax(i):
    got = tjs.json_schema_to_gbnf(SCHEMAS[i])
    assert got == jjs.json_schema_to_gbnf(SCHEMAS[i])
    assert _g(tgbnf.parse_gbnf(got)) == _g(jgbnf.parse_gbnf(got))


@pytest.mark.parametrize("i", range(len(SCHEMAS_BAD)))
def test_json_schema_refuses_as_jax(i):
    with pytest.raises(jjs.SchemaError) as want:
        jjs.json_schema_to_gbnf(SCHEMAS_BAD[i])
    with pytest.raises(tjs.SchemaError) as got:
        tjs.json_schema_to_gbnf(SCHEMAS_BAD[i])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tools,forced", TOOL_GRAMMARS)
def test_tool_grammar_matches_jax(tools, forced):
    got = ttc.tool_grammar(tools, forced)
    assert got == jtc.tool_grammar(tools, forced)
    assert _g(tgbnf.parse_gbnf(got)) == _g(jgbnf.parse_gbnf(got))


@pytest.fixture(scope="module")
def tries(tmp_path_factory):
    path = str(write_tiny_q4km(tmp_path_factory.mktemp("gram") / "tiny.gguf"))
    out = []
    for reader, tok, mod in ((TReader, ttok, tg), (JReader, jtok, jg)):
        r = reader(path)
        out.append(mod.TokenTrie(tok(r.metadata)))
        r.close()
    return out


def test_token_tries_match_jax(tries):
    t, j = tries
    assert t.vocab_size == j.vocab_size == 512
    assert t.token_text == j.token_text and t.eog_ids == j.eog_ids
    assert sum(x is not None for x in t.token_text) > 300   # bytes, words, extras


WALK_GRAMMARS = [jg.JSON_GBNF, jjs.json_schema_to_gbnf(SCHEMA), 'root ::= [0-9]+',
                 'root ::= "(" root ")" | ""', jtc.tool_grammar([WEATHER, TIME], "*")]


@pytest.mark.parametrize("gi", range(len(WALK_GRAMMARS)))
def test_masks_along_seeded_walks_match_jax(gi, tries):
    """Four walks per grammar, each at most 48 tokens: at every step both
    matchers' masks are equal; the walk takes a random valid token (an EOG
    one only when nothing else is valid) and both accept it alike."""
    src = WALK_GRAMMARS[gi]
    t_trie, j_trie = tries
    eog = sorted(j_trie.eog_ids)
    for seed in range(4):
        rng = np.random.default_rng(100 * gi + seed)
        tm = tg.GrammarMatcher(tg.parse_gbnf(src), t_trie)
        jm = jg.GrammarMatcher(jg.parse_gbnf(src), j_trie)
        for _ in range(48):
            mt, mj = tm.valid_mask(), jm.valid_mask()
            assert mt.dtype == mj.dtype == bool and np.array_equal(mt, mj)
            assert tm.can_stop() == jm.can_stop()
            text = np.flatnonzero(mt & ~np.isin(np.arange(len(mt)), eog))
            tok = int(rng.choice(text)) if len(text) else eog[0]
            assert tm.accept_token(tok) == jm.accept_token(tok)
            if tok in eog or tm.is_dead():
                break
