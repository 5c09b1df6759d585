"""Grammar-constrained decoding (llama-server ``response_format`` /
``grammar`` / ``json_schema`` parity), the JAX package's ``grammar`` in
the port's own copy:

- :mod:`gbnf` parses llama.cpp's GBNF grammar format into a compact
  rule graph;
- :mod:`json_schema` converts JSON Schema (the useful subset llama.cpp's
  ``json_schema_to_grammar`` covers) to GBNF;
- :mod:`matcher` runs the grammar as an incremental pushdown automaton
  over the *token* stream: a vocab trie walk computes the set of valid
  next tokens per automaton state (cached per state), which the engine
  writes to the slot's logit-bias row on the card as ``-inf`` on every
  invalid token (``runtime.sampler.SampleState.set_bias_row``).

The automaton (irregular, data-dependent, tiny) steps on the host between
decode dispatches; the card sees only the (B, V) bias, one add inside
``sampler.sample``, so a constrained slot costs the card nothing more
than an unconstrained one.
"""

from .gbnf import Grammar, parse_gbnf
from .json_schema import JSON_GBNF, json_schema_to_gbnf
from .matcher import GrammarMatcher, TokenTrie

__all__ = ["Grammar", "parse_gbnf", "json_schema_to_gbnf", "JSON_GBNF",
           "GrammarMatcher", "TokenTrie"]
