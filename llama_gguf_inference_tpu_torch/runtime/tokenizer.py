"""Tokenizers driven entirely by GGUF metadata.

The reference delegates tokenization to llama.cpp inside ``llama-server``
(SURVEY.md §2.9); here we implement the three vocab families GGUF carries:

- ``tokenizer.ggml.model == "llama"``: SentencePiece-style vocab — greedy
  highest-score bigram merging with ``<0xNN>`` byte fallback
- ``tokenizer.ggml.model == "gpt2"``:  byte-level BPE with explicit merges
- ``tokenizer.ggml.model == "bert"``: WordPiece, the encoder family's vocab
  (uncased basic normalization, greedy longest-prefix pieces with ``##``
  continuations, [CLS] ... [SEP] framing)

All three are pure Python on the host.
"""

from __future__ import annotations

import unicodedata

import heapq
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from ..gguf.constants import Keys, TokenType

SPM_SPACE = "▁"  # ▁


@dataclass
class SpecialTokens:
    bos_id: int = -1
    eos_id: int = -1
    unk_id: int = -1
    pad_id: int = -1
    add_bos: bool = True
    add_eos: bool = False
    # fill-in-the-middle ids (llama.cpp /infill); -1 = model has no FIM
    fim_pre_id: int = -1
    fim_suf_id: int = -1
    fim_mid_id: int = -1


class Tokenizer:
    """Common interface; construct via :func:`from_gguf_metadata`."""

    def __init__(self, tokens: Sequence[str], token_types: Sequence[int],
                 special: SpecialTokens):
        self.tokens = list(tokens)
        self.token_types = list(token_types)
        self.special = special
        self.vocab_size = len(self.tokens)
        self._index = {t: i for i, t in enumerate(self.tokens)}
        self._byte_tokens = {}
        for i, (t, tt) in enumerate(zip(self.tokens, self.token_types)):
            if tt == TokenType.BYTE and t.startswith("<0x") and t.endswith(">"):
                self._byte_tokens[int(t[3:-1], 16)] = i
        self.eog_ids = {i for i, tt in enumerate(self.token_types)
                        if tt == TokenType.CONTROL and
                        self.tokens[i] in ("</s>", "<|endoftext|>", "<|eot_id|>",
                                           "<|end_of_text|>", "<|im_end|>", "<|end|>",
                                           "<end_of_turn>", "<|eom_id|>")}
        if special.eos_id >= 0:
            self.eog_ids.add(special.eos_id)

    # -- API ----------------------------------------------------------------
    def encode(self, text: str, add_bos: bool | None = None,
               add_eos: bool | None = None) -> list[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def piece(self, token_id: int) -> str:
        """Decoded text of a single token, streaming-safe: no prefix-space
        stripping (the stream consumer strips once at stream start)."""
        return self.decode([token_id], _strip_prefix=False)

    def piece_bytes(self, token_id: int) -> bytes:
        """Raw UTF-8 bytes of one token.  Streaming emitters must buffer at
        UTF-8 boundaries themselves: byte-fallback tokens carry partial
        multi-byte sequences."""
        if not 0 <= token_id < self.vocab_size:
            return b""
        tt = self.token_types[token_id]
        if tt == TokenType.BYTE:
            t = self.tokens[token_id]
            if t.startswith("<0x") and t.endswith(">"):
                return bytes([int(t[3:-1], 16)])
        if tt == TokenType.CONTROL:
            return b""
        return self.piece(token_id).encode("utf-8")

    def is_eog(self, token_id: int) -> bool:
        return token_id in self.eog_ids

    def _wrap(self, ids: list[int], add_bos, add_eos) -> list[int]:
        add_bos = self.special.add_bos if add_bos is None else add_bos
        add_eos = self.special.add_eos if add_eos is None else add_eos
        if add_bos and self.special.bos_id >= 0:
            ids = [self.special.bos_id] + ids
        if add_eos and self.special.eos_id >= 0:
            ids = ids + [self.special.eos_id]
        return ids


class SPMTokenizer(Tokenizer):
    """SentencePiece-style greedy bigram-merge tokenizer (vocab "llama")."""

    def __init__(self, tokens, scores, token_types, special: SpecialTokens,
                 add_space_prefix: bool = True):
        super().__init__(tokens, token_types, special)
        self.scores = list(scores)
        self.add_space_prefix = add_space_prefix

    def encode(self, text: str, add_bos=None, add_eos=None) -> list[int]:
        ids: list[int] = []
        if text:
            if self.add_space_prefix:
                text = " " + text
            text = text.replace(" ", SPM_SPACE)
            ids = self._merge(text)
        return self._wrap(ids, add_bos, add_eos)

    def _merge(self, text: str) -> list[int]:
        # symbols start as single unicode chars; greedy merge of the adjacent
        # pair whose concatenation has the highest vocab score
        chars = list(text)
        n = len(chars)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        pieces = chars[:]
        alive = [True] * n

        heap: list[tuple[float, int, int, str]] = []

        def try_pair(i: int):
            j = nxt[i]
            if i < 0 or j >= n:
                return
            cat = pieces[i] + pieces[j]
            tid = self._index.get(cat)
            if tid is not None:
                heapq.heappush(heap, (-self.scores[tid], i, j, cat))

        for i in range(n - 1):
            try_pair(i)

        while heap:
            _, i, j, cat = heapq.heappop(heap)
            if not alive[i] or not alive[j] or nxt[i] != j or pieces[i] + pieces[j] != cat:
                continue
            pieces[i] = cat
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < n:
                prev[nxt[i]] = i
            try_pair(i)
            if prev[i] >= 0:
                try_pair(prev[i])

        out: list[int] = []
        i = 0
        while i < n:
            if alive[i]:
                tid = self._index.get(pieces[i])
                if tid is not None:
                    out.append(tid)
                else:
                    for b in pieces[i].encode("utf-8"):
                        bid = self._byte_tokens.get(b)
                        if bid is not None:
                            out.append(bid)
                        elif self.special.unk_id >= 0:
                            out.append(self.special.unk_id)
            i = nxt[i] if alive[i] else i + 1
        return out

    def decode(self, ids: Sequence[int], _strip_prefix: bool = True) -> str:
        buf = bytearray()
        for tid in ids:
            if not 0 <= tid < self.vocab_size:
                continue
            tt = self.token_types[tid]
            if tt == TokenType.BYTE:
                t = self.tokens[tid]
                buf.append(int(t[3:-1], 16))
            elif tt == TokenType.CONTROL:
                continue  # control tokens render as nothing (llama.cpp behavior)
            else:
                buf.extend(self.tokens[tid].replace(SPM_SPACE, " ").encode("utf-8"))
        text = buf.decode("utf-8", errors="replace")
        if _strip_prefix and self.add_space_prefix and text.startswith(" "):
            return text[1:]
        return text


class WordPieceTokenizer(Tokenizer):
    """BERT WordPiece (tokenizer.ggml.model == "bert"): the encoder-model
    tokenizer (llama.cpp ``llm_tokenizer_wpm``).

    Basic normalization matches HF's uncased BasicTokenizer: lowercase,
    NFD accent-strip, punctuation split, CJK chars isolated.  Per word,
    greedy longest-prefix matching over the vocab with ``##``
    continuations; words with no match become [UNK].  ``bos``/``eos`` in
    :class:`SpecialTokens` carry [CLS]/[SEP] (llama.cpp maps them the same
    way), so ``_wrap`` produces the [CLS] ... [SEP] frame.
    """

    MAX_WORD_CHARS = 100

    def __init__(self, tokens, token_types, special):
        super().__init__(tokens, token_types, special)

    @staticmethod
    def _is_punct(ch: str) -> bool:
        cp = ord(ch)
        if (33 <= cp <= 47) or (58 <= cp <= 64) \
                or (91 <= cp <= 96) or (123 <= cp <= 126):
            return True
        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_cjk(ch: str) -> bool:
        cp = ord(ch)
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF)

    def _basic_tokens(self, text: str) -> list[str]:
        text = unicodedata.normalize("NFD", text.lower())
        out: list[str] = []
        word: list[str] = []

        def flush():
            if word:
                out.append("".join(word))
                word.clear()

        for ch in text:
            cat = unicodedata.category(ch)
            if cat == "Mn":          # strip accents (uncased BERT)
                continue
            if ch.isspace():
                flush()
            elif self._is_punct(ch) or self._is_cjk(ch):
                flush()
                out.append(ch)
            elif cat.startswith("C"):   # control chars
                continue
            else:
                word.append(ch)
        flush()
        return out

    def encode(self, text: str, add_bos: bool | None = None,
               add_eos: bool | None = None) -> list[int]:
        ids: list[int] = []
        unk = self.special.unk_id
        for word in self._basic_tokens(text):
            if len(word) > self.MAX_WORD_CHARS:
                if unk >= 0:
                    ids.append(unk)
                continue
            start, pieces = 0, []
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self._index:
                        cur = self._index[sub]
                        break
                    end -= 1
                if cur is None:
                    pieces = None
                    break
                pieces.append(cur)
                start = end
            if pieces is not None:
                ids.extend(pieces)
            elif unk >= 0:
                # guard like _wrap: a bert GGUF missing unknown_token_id
                # must not emit id -1 (would wrap in the embedding gather)
                ids.append(unk)
        return self._wrap(ids, add_bos, add_eos)

    def decode(self, ids, _strip_prefix: bool = True) -> str:
        parts: list[str] = []
        for i in ids:
            if not 0 <= i < self.vocab_size:
                continue
            if self.token_types[i] == TokenType.CONTROL:
                continue
            t = self.tokens[i]
            if t.startswith("##"):
                parts.append(t[2:])
            else:
                if parts:
                    parts.append(" ")
                parts.append(t)
        return "".join(parts)


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte<->unicode table (public algorithm)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    m = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + m)
            m += 1
    return dict(zip(bs, map(chr, cs)))


class BPETokenizer(Tokenizer):
    """Byte-level BPE (vocab "gpt2") with explicit merge ranks."""

    def __init__(self, tokens, token_types, merges: Sequence[str],
                 special: SpecialTokens):
        super().__init__(tokens, token_types, special)
        self.byte_to_uni = _bytes_to_unicode()
        self.uni_to_byte = {v: k for k, v in self.byte_to_uni.items()}
        self.merge_ranks: dict[tuple[str, str], int] = {}
        for rank, m in enumerate(merges):
            a, _, b = m.partition(" ")
            self.merge_ranks[(a, b)] = rank

    def encode(self, text: str, add_bos=None, add_eos=None) -> list[int]:
        ids: list[int] = []
        # coarse pre-tokenization: split on spaces, keeping the space attached
        # to the following word (gpt2 style "Ġword")
        for word in self._pretokenize(text):
            mapped = "".join(self.byte_to_uni[b] for b in word.encode("utf-8"))
            for piece in self._bpe(mapped):
                tid = self._index.get(piece)
                if tid is not None:
                    ids.append(tid)
                elif self.special.unk_id >= 0:
                    ids.append(self.special.unk_id)
        add_bos = False if add_bos is None and self.special.bos_id < 0 else add_bos
        return self._wrap(ids, add_bos, add_eos)

    @staticmethod
    def _pretokenize(text: str) -> list[str]:
        """GPT-2-style pre-tokenization without the `regex` module.

        Scanner equivalent of the gpt2 pattern
        ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|
        \\s+(?!\\S)|\\s+`` using unicodedata categories.
        """
        import unicodedata

        def is_letter(c: str) -> bool:
            return unicodedata.category(c).startswith("L")

        def is_number(c: str) -> bool:
            return unicodedata.category(c).startswith("N")

        out: list[str] = []
        i, n = 0, len(text)
        contractions = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d",
                        "'S", "'T", "'RE", "'VE", "'M", "'LL", "'D")
        while i < n:
            c = text[i]
            matched = False
            if c == "'":
                for con in contractions:
                    if text.startswith(con, i):
                        out.append(con)
                        i += len(con)
                        matched = True
                        break
                if matched:
                    continue
            if c.isspace():
                j = i
                while j < n and text[j].isspace():
                    j += 1
                if j < n and j - i > 1:
                    # \s+(?!\S): trailing space attaches to the next word
                    out.append(text[i:j - 1])
                    i = j - 1
                elif j < n and j - i == 1 and text[i] == " ":
                    i = i  # single space: falls through to the word branches
                else:
                    out.append(text[i:j])
                    i = j
                    continue
            start = i
            if text[i] == " " and i + 1 < n:
                i += 1
            if i < n and is_letter(text[i]):
                while i < n and is_letter(text[i]):
                    i += 1
                out.append(text[start:i])
            elif i < n and is_number(text[i]):
                while i < n and is_number(text[i]):
                    i += 1
                out.append(text[start:i])
            elif i < n and not text[i].isspace():
                while i < n and not text[i].isspace() \
                        and not is_letter(text[i]) and not is_number(text[i]):
                    i += 1
                out.append(text[start:i])
            else:
                # lone space before whitespace/end
                out.append(text[start:i + 1] if i < n else text[start:])
                i = max(i + 1, start + 1)
        return [t for t in out if t]

    def _bpe(self, word: str) -> list[str]:
        parts = list(word)
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.merge_ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return parts

    def decode(self, ids: Sequence[int], _strip_prefix: bool = True) -> str:
        # _strip_prefix is accepted (and ignored — BPE has no SPM space
        # prefix) so the base-class piece()/piece_bytes() streaming path
        # works identically for both vocab families.
        buf = bytearray()
        for tid in ids:
            if not 0 <= tid < self.vocab_size:
                continue
            if self.token_types[tid] == TokenType.CONTROL:
                continue
            for ch in self.tokens[tid]:
                b = self.uni_to_byte.get(ch)
                if b is not None:
                    buf.append(b)
                else:
                    buf.extend(ch.encode("utf-8"))
        return buf.decode("utf-8", errors="replace")


def from_gguf_metadata(md: Mapping[str, Any]) -> Tokenizer:
    model = md.get(Keys.TOKENIZER_MODEL, "llama")
    tokens = list(md[Keys.TOKENIZER_TOKENS])
    n = len(tokens)
    token_types = list(md.get(Keys.TOKENIZER_TOKEN_TYPE, [TokenType.NORMAL] * n))
    special = SpecialTokens(
        bos_id=int(md.get(Keys.TOKENIZER_BOS, -1)),
        eos_id=int(md.get(Keys.TOKENIZER_EOS, -1)),
        unk_id=int(md.get(Keys.TOKENIZER_UNK, -1)),
        pad_id=int(md.get(Keys.TOKENIZER_PAD, -1)),
        add_bos=bool(md.get(Keys.TOKENIZER_ADD_BOS, model == "llama")),
        add_eos=bool(md.get(Keys.TOKENIZER_ADD_EOS, False)),
        fim_pre_id=int(md.get(Keys.TOKENIZER_FIM_PRE,
                              md.get(Keys.TOKENIZER_PREFIX, -1))),
        fim_suf_id=int(md.get(Keys.TOKENIZER_FIM_SUF,
                              md.get(Keys.TOKENIZER_SUFFIX, -1))),
        fim_mid_id=int(md.get(Keys.TOKENIZER_FIM_MID,
                              md.get(Keys.TOKENIZER_MIDDLE, -1))),
    )
    if model == "llama":
        scores = list(md.get(Keys.TOKENIZER_SCORES, [0.0] * n))
        return SPMTokenizer(tokens, scores, token_types, special)
    if model == "gpt2":
        merges = list(md.get(Keys.TOKENIZER_MERGES, []))
        return BPETokenizer(tokens, token_types, merges, special)
    if model == "bert":
        # encoder models frame sequences as [CLS] ... [SEP]; llama.cpp
        # stores the ids under cls/seperator keys (their spelling) and
        # treats them as bos/eos
        cls_id = int(md.get("tokenizer.ggml.cls_token_id",
                            special.bos_id))
        sep_id = int(md.get("tokenizer.ggml.seperator_token_id",
                            special.eos_id))
        special.bos_id, special.eos_id = cls_id, sep_id
        special.add_bos = bool(md.get(Keys.TOKENIZER_ADD_BOS, True))
        special.add_eos = bool(md.get(Keys.TOKENIZER_ADD_EOS, True))
        return WordPieceTokenizer(tokens, token_types, special)
    raise NotImplementedError(f"tokenizer model {model!r}")
