"""The port's WordPiece tokenizer (``tokenizer.ggml.model == "bert"``) on
the CPU, against the JAX package's and ``transformers.BertTokenizer``.

Two vocabs: a small one with accented, CJK and punctuation pieces, and the
30522-piece vocab of ``tools.synth.bert_vocab`` (BERT's special ids). Each is
given to all three tokenizers (a GGUF metadata dict for the two packages, a
``vocab.txt`` for transformers); the parametrised texts cover accents (NFD
stripping), CJK isolation, ASCII and Unicode punctuation, control characters,
whitespace runs, a word of 100 and one of 101 characters (past
``MAX_WORD_CHARS``: [UNK]) and words with no piece ([UNK]). The ids must be
equal on every case; decode and the special ids too.
"""

import pytest

transformers = pytest.importorskip("transformers")

from llama_gguf_inference_tpu.runtime import tokenizer as jtok
from llama_gguf_inference_tpu_torch.runtime import tokenizer as ttok
from llama_gguf_inference_tpu_torch.tools.synth import bert_vocab

SMALL = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + ["hello", "world", "quick", "brown", "fox", "jumps", "the", "over", "lazy",
            "dog", ".", ",", "!", "?", "'", "-", "(", ")", "$", "^", "`", "~", "¿", "—",
            "un", "##believ", "##able", "##s", "he", "##llo", "cafe", "naive", "resume",
            "中", "文", "日", "本", "a", "##a", "b", "##b", "t", "##e", "##x", "##t",
            "angstrom", "umlaut", "x", "##y", "##z", "😀", "tab", "and", "new", "##line",
            "control", "chars", "s", "##ome"])

TEXTS = ["Hello world.", "The quick brown fox jumps over the lazy dog",
         "unbelievable worlds, hello", "HELLO, WORLD.", "Café naïve résumé",
         "中文 text 日本", "tab\tand\nnewline\r\n", "control\x00\x07\x1b chars",
         "a" * 100, "a" * 101, "b" + "b" * 100 + " hello", "punct!!!?... (x) $^`~",
         "hello-world's (test)", "", "   ", "😀 hi", "Ångström ümlaut", "¿qué—tal?",
         "Some words have no pieces: zebra xylophone", "helloworld unbelievables"]


def _md(tokens):
    types = [3 if t.startswith("[") and t.endswith("]") else 1 for t in tokens]
    idx = {t: i for i, t in enumerate(tokens)}
    return {"tokenizer.ggml.model": "bert", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.cls_token_id": idx["[CLS]"],
            "tokenizer.ggml.seperator_token_id": idx["[SEP]"],
            "tokenizer.ggml.unknown_token_id": idx["[UNK]"],
            "tokenizer.ggml.padding_token_id": idx["[PAD]"],
            "tokenizer.ggml.add_bos_token": True, "tokenizer.ggml.add_eos_token": True}


@pytest.fixture(scope="module", params=["small", "synth"])
def tokenizers(request, tmp_path_factory):
    tokens = SMALL if request.param == "small" else bert_vocab(30522)[0]
    path = tmp_path_factory.mktemp("wp") / "vocab.txt"
    path.write_text("\n".join(tokens) + "\n", encoding="utf-8")
    hf = transformers.BertTokenizer(str(path), do_lower_case=True)
    md = _md(tokens)
    return ttok.from_gguf_metadata(md), jtok.from_gguf_metadata(md), hf


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_ids_match_jax_and_transformers(tokenizers, text):
    port, jax_tok, hf = tokenizers
    got = port.encode(text)
    assert got == jax_tok.encode(text)
    assert got == hf(text)["input_ids"], (text, got)
    assert port.encode(text, add_bos=False, add_eos=False) == \
        jax_tok.encode(text, add_bos=False, add_eos=False) == got[1:-1]
    assert port.decode(got) == jax_tok.decode(got)


def test_special_ids_and_limits(tokenizers):
    port, jax_tok, hf = tokenizers
    assert isinstance(port, ttok.WordPieceTokenizer)
    assert port.MAX_WORD_CHARS == jax_tok.MAX_WORD_CHARS == 100
    for f in ("bos_id", "eos_id", "unk_id", "pad_id", "add_bos", "add_eos"):
        assert getattr(port.special, f) == getattr(jax_tok.special, f), f
    assert (port.special.bos_id, port.special.eos_id) == (hf.cls_token_id, hf.sep_token_id)
    assert port.eog_ids == jax_tok.eog_ids
    assert [port.piece(i) for i in range(40)] == [jax_tok.piece(i) for i in range(40)]


def test_synth_vocab_has_berts_special_ids():
    tokens, types = bert_vocab(30522)
    assert len(tokens) == len(types) == 30522 and len(set(tokens)) == 30522
    assert [tokens[i] for i in (0, 100, 101, 102, 103)] == \
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    assert types[101] == 3 and types[tokens.index("fox")] == 1
    assert "##s" in tokens and "hello" in tokens


def test_unk_guard_without_unk_id():
    """A bert vocab whose GGUF lacks unknown_token_id emits no -1 (both)."""
    md = _md(SMALL)
    del md["tokenizer.ggml.unknown_token_id"]
    port, jax_tok = ttok.from_gguf_metadata(md), jtok.from_gguf_metadata(md)
    text = "zebra " + "a" * 101 + " hello"
    assert port.encode(text) == jax_tok.encode(text) == [2, SMALL.index("hello"), 3]
