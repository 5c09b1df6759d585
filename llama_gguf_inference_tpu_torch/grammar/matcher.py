"""Incremental grammar matcher + valid-token mask computation.

Semantics follow llama.cpp's grammar sampler: the parse state is a SET
of pushdown stacks (one per live derivation); a token is valid iff every
one of its characters is consumable from the current state.  End-of-
generation tokens are valid iff the grammar can terminate (some stack is
empty).

Division of labor: this module runs on the host (irregular, tiny); its
output is a vocab-sized boolean mask the engine turns into a ``-inf`` logit
bias row on the card, added to the logits inside ``sampler.sample``. Masks
are cached per automaton state: JSON-ish grammars revisit a handful of
states (inside a string, after a digit, ...), so steady-state decode costs
one dict lookup per token.

Stack representation: tuple of items, TOP LAST.  Items are the compiled
grammar's ``("c", ranges, neg)`` / ``("r", rule_id)``.  States are
normalized: every stack's top is a char matcher (refs expanded through
their alternates), except the empty stack which marks "grammar may stop
here".
"""

from __future__ import annotations

import numpy as np

from .gbnf import Grammar, GBNFError

_MAX_STACKS = 512          # runaway-ambiguity guard (llama.cpp has no cap;
#                            practical grammars stay < 16)


def _char_matches(item: tuple, cp: int) -> bool:
    _, ranges, neg = item
    hit = any(lo <= cp <= hi for lo, hi in ranges)
    return hit != neg


class GrammarMatcher:
    """One per constrained request; holds the automaton state."""

    def __init__(self, grammar: Grammar, trie: "TokenTrie"):
        self.grammar = grammar
        self.trie = trie
        # caches shared per (grammar, trie) pair via the trie's registry so
        # concurrent requests with the same schema reuse masks
        key = grammar.text
        reg = trie._mask_caches.setdefault(key, ({}, {}))
        self._mask_cache: dict = reg[0]       # state -> np.bool_ (V,)
        self._adv_cache: dict = reg[1]        # (state, cp) -> state
        self.state = self._init_state()

    # -- automaton ----------------------------------------------------------
    def _norm(self, stack: tuple, out: set, depth: int = 0) -> None:
        """Expand refs until the top is a char matcher (or stack empty)."""
        if depth > 256:
            raise GBNFError("grammar nests too deep (left recursion?)")
        if not stack or stack[-1][0] == "c":
            out.add(stack)
            return
        base = stack[:-1]
        for alt in self.grammar.rules[stack[-1][1]]:
            self._norm(base + tuple(reversed(alt)), out, depth + 1)

    def _init_state(self) -> frozenset:
        out: set = set()
        self._norm((("r", self.grammar.root),), out)
        return frozenset(out)

    def _advance(self, state: frozenset, cp: int) -> frozenset:
        key = (state, cp)
        hit = self._adv_cache.get(key)
        if hit is not None:
            return hit
        out: set = set()
        for stack in state:
            if stack and _char_matches(stack[-1], cp):
                self._norm(stack[:-1], out)
        if len(out) > _MAX_STACKS:
            raise GBNFError("grammar state explosion")
        res = frozenset(out)
        self._adv_cache[key] = res
        return res

    def _accepts(self, state: frozenset, text: str) -> frozenset:
        """State after consuming text; empty frozenset = dead."""
        for ch in text:
            if not state:
                return frozenset()
            state = self._advance(state, ord(ch))
        return state

    # -- public API -----------------------------------------------------------
    def can_stop(self) -> bool:
        """True when the grammar accepts the text generated so far."""
        return any(not s for s in self.state)

    def is_dead(self) -> bool:
        return not self.state

    def accept_token(self, token_id: int) -> bool:
        """Advance the automaton past token_id's text.  EOG tokens don't
        advance (the slot is finishing).  Returns False if the token was
        not actually valid (state becomes dead — caller stops)."""
        if token_id in self.trie.eog_ids:
            return self.can_stop()
        text = self.trie.token_text[token_id]
        if text is None:
            self.state = frozenset()
            return False
        self.state = self._accepts(self.state, text)
        return bool(self.state)

    def valid_mask(self) -> np.ndarray:
        """(V,) bool — tokens consumable from the current state.  EOG ids
        are marked iff the grammar can stop; if NOTHING else is valid the
        EOG ids are forced on so generation always terminates cleanly."""
        mask = self._mask_cache.get(self.state)
        if mask is None:
            mask = self._compute_mask()
            self._mask_cache[self.state] = mask
        return mask

    def _compute_mask(self) -> np.ndarray:
        V = self.trie.vocab_size
        mask = np.zeros(V, bool)
        # iterative DFS over the vocab trie, advancing the stack-set
        work = [(self.trie.root, self.state)]
        while work:
            node, state = work.pop()
            for cp, child in node.children.items():
                ns = self._advance(state, cp)
                if ns:
                    if child.token_ids:
                        mask[child.token_ids] = True
                    if child.children:
                        work.append((child, ns))
        eog = list(self.trie.eog_ids)
        if self.can_stop() or not mask.any():
            mask[eog] = True
        mask.setflags(write=False)
        return mask


class _TrieNode:
    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: dict[int, _TrieNode] = {}
        self.token_ids: list[int] = []


class TokenTrie:
    """Vocab trie over token text code points.  Built once per tokenizer
    (lazily, on the first constrained request) and shared by every
    matcher.  Tokens that are not complete UTF-8 on their own (byte-
    fallback fragments) and control tokens are excluded — they are never
    valid under a grammar.  EOG ids are handled as stop markers, not
    text."""

    def __init__(self, tokenizer):
        self.vocab_size = tokenizer.vocab_size
        self.eog_ids = frozenset(tokenizer.eog_ids)
        self.root = _TrieNode()
        self.token_text: list[str | None] = [None] * self.vocab_size
        self._mask_caches: dict = {}      # grammar text -> (mask, adv) caches
        for tid in range(self.vocab_size):
            if tid in self.eog_ids:
                continue
            raw = tokenizer.piece_bytes(tid)
            if not raw:
                continue
            try:
                text = raw.decode("utf-8")
            except UnicodeDecodeError:
                continue                   # partial multi-byte fragment
            self.token_text[tid] = text
            node = self.root
            for ch in text:
                cp = ord(ch)
                nxt = node.children.get(cp)
                if nxt is None:
                    nxt = node.children[cp] = _TrieNode()
                node = nxt
            node.token_ids.append(tid)
