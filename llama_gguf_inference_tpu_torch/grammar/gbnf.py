"""GBNF (llama.cpp grammar format) parser.

Format reference: llama.cpp ``grammars/README.md`` — rules
``name ::= body``, alternation ``|``, grouping ``( )``, literals
``"..."`` (escapes ``\\n \\r \\t \\\\ \\" \\x.. \\u....``), char classes
``[a-z0-9_]`` / negated ``[^...]`` (ranges over Unicode code points),
repetition ``? * +`` and ``{m}`` ``{m,}`` ``{m,n}``, line comments ``#``.

Compiled form (consumed by :mod:`matcher`):

- ``Grammar.rules``: rule_id -> tuple of alternates
- alternate: tuple of items, each ``("c", ranges, negated)`` with
  ``ranges = ((lo, hi), ...)`` over code points, or ``("r", rule_id)``
- repetition desugars into fresh helper rules (``e*`` becomes
  ``R ::= e R | ε`` etc.), so the matcher only ever sees sequences of
  char-matchers and rule refs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Grammar:
    rules: tuple[tuple[tuple, ...], ...]   # rule_id -> alternates -> items
    root: int
    text: str = ""                         # original GBNF (diagnostics)


class GBNFError(ValueError):
    pass


_ESCAPES = {"n": "\n", "r": "\r", "t": "\t", "\\": "\\", '"': '"',
            "'": "'", "[": "[", "]": "]"}


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0
        self.rule_ids: dict[str, int] = {}
        self.rules: dict[int, list[tuple]] = {}

    # -- low-level ---------------------------------------------------------
    def _ws(self, newlines: bool = True) -> None:
        while self.pos < len(self.src):
            c = self.src[self.pos]
            if c == "#":
                while self.pos < len(self.src) and self.src[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            else:
                break

    def _peek(self) -> str:
        return self.src[self.pos] if self.pos < len(self.src) else ""

    def _expect(self, s: str) -> None:
        if not self.src.startswith(s, self.pos):
            raise GBNFError(f"expected {s!r} at offset {self.pos} "
                            f"(near {self.src[self.pos:self.pos + 20]!r})")
        self.pos += len(s)

    def _name(self) -> str:
        start = self.pos
        while self._peek().isalnum() or self._peek() in ("-", "_"):
            self.pos += 1
        if self.pos == start:
            raise GBNFError(f"expected rule name at offset {self.pos}")
        return self.src[start:self.pos]

    def _rule_id(self, name: str) -> int:
        if name not in self.rule_ids:
            self.rule_ids[name] = len(self.rule_ids)
        return self.rule_ids[name]

    def _fresh_rule(self, alts: list[tuple]) -> int:
        rid = self._rule_id(f"_aux_{len(self.rule_ids)}")
        self.rules[rid] = alts
        return rid

    def _escape_char(self) -> str:
        if self.pos >= len(self.src):
            raise GBNFError("unexpected end of grammar")
        c = self.src[self.pos]
        self.pos += 1
        if c != "\\":
            return c
        if self.pos >= len(self.src):
            raise GBNFError("unexpected end of grammar after backslash")
        e = self.src[self.pos]
        self.pos += 1
        if e in _ESCAPES:
            return _ESCAPES[e]
        if e == "x":
            h = self.src[self.pos:self.pos + 2]
            self.pos += 2
            return chr(int(h, 16))
        if e == "u":
            h = self.src[self.pos:self.pos + 4]
            self.pos += 4
            return chr(int(h, 16))
        if e == "U":
            h = self.src[self.pos:self.pos + 8]
            self.pos += 8
            return chr(int(h, 16))
        raise GBNFError(f"unknown escape \\{e} at offset {self.pos}")

    # -- grammar constructs --------------------------------------------------
    def _char_class(self) -> tuple:
        self._expect("[")
        neg = False
        if self._peek() == "^":
            neg = True
            self.pos += 1
        ranges = []
        while self._peek() != "]":
            if not self._peek():
                raise GBNFError("unterminated char class")
            lo = self._escape_char()
            hi = lo
            if self._peek() == "-" and self.src[self.pos + 1:self.pos + 2] != "]":
                self.pos += 1
                hi = self._escape_char()
            ranges.append((ord(lo), ord(hi)))
        self._expect("]")
        return ("c", tuple(ranges), neg)

    def _literal(self) -> list[tuple]:
        self._expect('"')
        items = []
        while self._peek() != '"':
            if not self._peek():
                raise GBNFError("unterminated literal")
            ch = self._escape_char()
            items.append(("c", ((ord(ch), ord(ch)),), False))
        self._expect('"')
        return items

    def _repeat(self, items: list[tuple], lo: int, hi: int | None) -> list[tuple]:
        """Desugar items{lo,hi} into a sequence (helper rules as needed)."""
        seq_rid = None
        if len(items) != 1:
            seq_rid = self._fresh_rule([tuple(items)])
            unit = [("r", seq_rid)]
        else:
            unit = items
        out: list[tuple] = []
        out.extend(unit * lo)
        if hi is None:                     # unbounded tail: S ::= unit S | ε
            rid = self._rule_id(f"_aux_{len(self.rule_ids)}")
            self.rules[rid] = [tuple(unit + [("r", rid)]), ()]
            out.append(("r", rid))
        else:
            # bounded optional tail: O_k ::= unit O_{k-1} | ε
            tail = None
            for _ in range(hi - lo):
                alt = tuple(unit + ([("r", tail)] if tail is not None else []))
                tail = self._fresh_rule([alt, ()])
            if tail is not None:
                out.append(("r", tail))
        return out

    def _sequence(self) -> tuple:
        items: list[tuple] = []
        while True:
            self._ws(newlines=False)
            c = self._peek()
            unit: list[tuple]
            if c == '"':
                unit = self._literal()
            elif c == "[":
                unit = [self._char_class()]
            elif c == "(":
                self.pos += 1
                alts = self._alternates()
                self._expect(")")
                unit = [("r", self._fresh_rule(alts))]
            elif c == ".":                 # any char
                self.pos += 1
                unit = [("c", ((0, 0x10FFFF),), False)]
            elif c.isalpha() or c == "_":
                unit = [("r", self._rule_id(self._name()))]
            else:
                break
            # repetition suffix binds to the LAST unit
            self._ws(newlines=False)
            suf = self._peek()
            if suf and suf in "?*+":
                self.pos += 1
                lo, hi = {"?": (0, 1), "*": (0, None), "+": (1, None)}[suf]
                unit = self._repeat(unit, lo, hi)
            elif suf == "{":
                self.pos += 1
                self._ws(newlines=False)
                start = self.pos
                while self._peek().isdigit():
                    self.pos += 1
                lo = int(self.src[start:self.pos])
                hi: int | None = lo
                self._ws(newlines=False)
                if self._peek() == ",":
                    self.pos += 1
                    self._ws(newlines=False)
                    start = self.pos
                    while self._peek().isdigit():
                        self.pos += 1
                    hi = int(self.src[start:self.pos]) if self.pos > start else None
                self._ws(newlines=False)
                self._expect("}")
                unit = self._repeat(unit, lo, hi)
            items.extend(unit)
        return tuple(items)

    def _alternates(self) -> list[tuple]:
        alts = [self._sequence()]
        while True:
            self._ws(newlines=False)
            if self._peek() == "|":
                self.pos += 1
                alts.append(self._sequence())
            else:
                return alts

    def parse(self) -> Grammar:
        while True:
            self._ws()
            if self.pos >= len(self.src):
                break
            name = self._name()
            rid = self._rule_id(name)
            self._ws(newlines=False)
            self._expect("::=")
            alts = self._alternates()
            if rid in self.rules and not name.startswith("_aux_"):
                raise GBNFError(f"duplicate rule {name!r}")
            self.rules[rid] = alts
            self._ws(newlines=False)
            if self._peek() in ("\r", "\n"):
                self.pos += 1
        if "root" not in self.rule_ids:
            raise GBNFError("grammar has no 'root' rule")
        n = len(self.rule_ids)
        missing = [name for name, rid in self.rule_ids.items()
                   if rid not in self.rules]
        if missing:
            raise GBNFError(f"undefined rule(s): {', '.join(missing)}")
        table = tuple(tuple(self.rules[rid]) for rid in range(n))
        return Grammar(rules=table, root=self.rule_ids["root"], text=self.src)


def parse_gbnf(src: str) -> Grammar:
    """Parse GBNF text; raises :class:`GBNFError` on malformed input."""
    if len(src) > 1 << 20:
        raise GBNFError("grammar too large")
    return _Parser(src).parse()
