"""Synthesize a quantized llama GGUF with random weights from a seed.

Q4_K (``quant="q4_k"``, the default), Q2_K (``quant="q2_k"``) or Q5_K
(``quant="q5_k"``) projections and embedding, a Q6_K output head, F32 norms,
and a small
SentencePiece-style vocab padded with filler pieces to the shape's vocab
size. Decode cost depends on the weights' shapes, not their values, so the
file stands in for a real checkpoint of the same shape. A small random pool
is quantized once per format and its wire bytes are tiled over every
tensor; the pool length is a multiple of every block size, so this equals
quantizing the tiled floats.

The output is byte-identical to the JAX package's ``bench.py``
``bench_model_path`` for the same shape and quant (whose ``general.name``
reads ``bench-llama3-<shape>-q4km`` whatever the quant). Two options leave
every tensor of the layers they keep as it was: ``n_layers`` cuts the depth
(full widths, fewer layers: the tensors of the kept layers, the embedding
and the head are the same bytes), and ``fim`` makes the last three filler
pieces the control tokens ``<|fim_prefix|>``, ``<|fim_suffix|>`` and
``<|fim_middle|>`` and writes their ids to the FIM metadata keys (llama.cpp's
``/infill``). ``synth_lora`` writes a GGUF LoRA adapter for such a model.

``synth_bert`` writes a BERT encoder GGUF (``general.architecture`` bert,
the tensor and key names of llama.cpp's ``convert_hf_to_gguf.py::BertModel``
as the JAX package's ``tools/convert_hf.py`` writes them) at the widths of
bge-large-en-v1.5 (``BERT_SHAPES``), Q8_0 (or Q4_K) projections, F32 norms
and biases, F16 embedding tables and a WordPiece vocab of 30522 pieces with
BERT's special ids; ``cached_bert`` keeps it as ``cached_model`` keeps a
llama.

    python -m llama_gguf_inference_tpu_torch.tools.synth --shape 8b [--quant q2_k|q5_k] [--layers N] [--fim] --out model.gguf
    python -m llama_gguf_inference_tpu_torch.tools.synth --bert [--shape bge-large] [--quant q8_0|q4_k] [--layers N] --out encoder.gguf
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import os
import tempfile
import time

import numpy as np

from ..gguf.constants import GGMLType, Keys, TokenType, type_block_info
from ..gguf.writer import GGUFWriter
from ..quant.numpy_ref import quantize

SHAPES = {
    # Llama-3-8B: dim 4096, 32 layers, GQA 32/8, head_dim 128, ffn 14336
    "8b": dict(dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
               ffn_dim=14336, vocab=128256, rope_base=500000.0),
    # small shape for CPU runs
    "160m": dict(dim=512, n_layers=8, n_heads=8, n_kv_heads=4,
                 ffn_dim=1536, vocab=32000, rope_base=10000.0),
}


def make_tiny_vocab() -> tuple[list[str], list[float], list[int]]:
    """A minimal SPM-style vocab: specials, byte fallbacks, a few words."""
    tokens = ["<unk>", "<s>", "</s>"]
    types = [TokenType.UNKNOWN, TokenType.CONTROL, TokenType.CONTROL]
    scores = [0.0, 0.0, 0.0]
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        types.append(TokenType.BYTE)
        scores.append(0.0)
    words = ["▁the", "▁quick", "▁brown", "▁fox", "▁jumps", "▁over", "▁lazy",
             "▁dog", "▁hello", "▁world", "▁a", "▁of", "▁to", "▁and", "▁in",
             "he", "ll", "o", "w", "or", "ld", "▁", "s", "t", "e", "a", "i",
             "n", "r", "d", "u", "m", "th", "er", "on", "an"]
    # SPM greedy merging needs every prefix of a word present; synthesize
    # the intermediate pieces with worse scores
    pieces: dict[str, float] = {}
    for rank, wd in enumerate(words):
        for plen in range(2, len(wd) + 1):
            pre = wd[:plen]
            pieces.setdefault(pre, -float(rank) if pre == wd else -100.0 - plen)
        pieces[wd] = -float(rank)
    for wd, score in pieces.items():
        tokens.append(wd)
        types.append(TokenType.NORMAL)
        scores.append(score)
    return tokens, scores, [int(t) for t in types]


QUANTS = ("q4_k", "q2_k", "q5_k")


FIM_PIECES = ("<|fim_prefix|>", "<|fim_suffix|>", "<|fim_middle|>")


def synth_model(path: str, shape: str = "8b", seed: int = 0, quant: str = "q4_k",
                n_layers: int | None = None, fim: bool = False) -> str:
    """Write the ``shape`` model with ``quant`` weights to ``path``; returns
    ``path``. ``n_layers`` keeps the first layers only; ``fim`` adds the
    three FIM tokens (the module's docstring)."""
    if quant not in QUANTS:
        raise ValueError(f"quant {quant!r} is not one of {QUANTS}")
    wq = GGMLType[quant.upper()]
    d = dict(SHAPES[shape])
    if n_layers is not None:
        if not 1 <= n_layers <= d["n_layers"]:
            raise ValueError(f"n_layers {n_layers} is not in [1, {d['n_layers']}]")
        d["n_layers"] = n_layers
    rng = np.random.default_rng(seed)
    head_dim = d["dim"] // d["n_heads"]
    vocab = d["vocab"]
    tokens, scores, types = make_tiny_vocab()
    tokens += [f"<extra_{i}>" for i in range(len(tokens), vocab)]
    scores += [-1e6] * (vocab - len(scores))
    types += [int(TokenType.UNUSED)] * (vocab - len(types))
    fim_ids = range(vocab - len(FIM_PIECES), vocab)
    if fim:
        for i, piece in zip(fim_ids, FIM_PIECES):
            tokens[i], scores[i], types[i] = piece, 0.0, int(TokenType.CONTROL)

    w = GGUFWriter(path)
    w.add(Keys.ARCHITECTURE, "llama")
    w.add(Keys.NAME, f"bench-llama3-{shape}-q4km")
    w.add("llama.context_length", 8192)
    w.add("llama.embedding_length", d["dim"])
    w.add("llama.block_count", d["n_layers"])
    w.add("llama.feed_forward_length", d["ffn_dim"])
    w.add("llama.attention.head_count", d["n_heads"])
    w.add("llama.attention.head_count_kv", d["n_kv_heads"])
    w.add("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add("llama.rope.freq_base", d["rope_base"])
    w.add("llama.rope.dimension_count", head_dim)
    w.add(Keys.TOKENIZER_MODEL, "llama")
    w.add(Keys.TOKENIZER_TOKENS, tokens)
    w.add(Keys.TOKENIZER_SCORES, np.asarray(scores, np.float32))
    w.add(Keys.TOKENIZER_TOKEN_TYPE, np.asarray(types, np.int32))
    w.add(Keys.TOKENIZER_BOS, 1)
    w.add(Keys.TOKENIZER_EOS, 2)
    w.add(Keys.TOKENIZER_UNK, 0)
    if fim:
        for key, i in zip((Keys.TOKENIZER_FIM_PRE, Keys.TOKENIZER_FIM_SUF,
                           Keys.TOKENIZER_FIM_MID), fim_ids):
            w.add(key, i)

    pool = (rng.standard_normal(1 << 20) * 0.02).astype(np.float32)
    qpool: dict[GGMLType, np.ndarray] = {}

    def add_q(name, rows, cols, t):
        if t not in qpool:
            qpool[t] = np.frombuffer(quantize(pool.reshape(1, -1), t), np.uint8)
        qp = qpool[t]
        blk, bpb = type_block_info(t)
        nbytes = rows * cols // blk * bpb
        raw = np.tile(qp, -(-nbytes // qp.size))[:nbytes].tobytes()
        w.add_raw_tensor(name, (cols, rows), t, raw)

    ones = np.ones(d["dim"], np.float32)
    add_q("token_embd.weight", vocab, d["dim"], wq)
    for i in range(d["n_layers"]):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", ones, GGMLType.F32)
        add_q(p + "attn_q.weight", d["dim"], d["dim"], wq)
        add_q(p + "attn_k.weight", d["n_kv_heads"] * head_dim, d["dim"], wq)
        add_q(p + "attn_v.weight", d["n_kv_heads"] * head_dim, d["dim"], wq)
        add_q(p + "attn_output.weight", d["dim"], d["dim"], wq)
        w.add_tensor(p + "ffn_norm.weight", ones, GGMLType.F32)
        add_q(p + "ffn_gate.weight", d["ffn_dim"], d["dim"], wq)
        add_q(p + "ffn_up.weight", d["ffn_dim"], d["dim"], wq)
        add_q(p + "ffn_down.weight", d["dim"], d["ffn_dim"], wq)
    w.add_tensor("output_norm.weight", ones, GGMLType.F32)
    add_q("output.weight", vocab, d["dim"], GGMLType.Q6_K)
    w.write()
    return path


def synth_lora(path: str, shape: str = "8b", seed: int = 0, rank: int = 16,
               alpha: float = 32.0, n_layers: int | None = None) -> str:
    """Write a GGUF LoRA adapter for the ``shape`` model (its first
    ``n_layers`` layers): ``general.type=adapter``, ``adapter.type=lora``,
    ``adapter.lora.alpha`` and, for all seven projections of every layer and
    the head, F32 ``.lora_a`` (rank, in) and ``.lora_b`` (out, rank) pairs
    drawn from ``seed`` times 0.02."""
    d = SHAPES[shape]
    layers = d["n_layers"] if n_layers is None else n_layers
    kv = d["n_kv_heads"] * (d["dim"] // d["n_heads"])
    dims = {"attn_q": (d["dim"], d["dim"]), "attn_k": (kv, d["dim"]),
            "attn_v": (kv, d["dim"]), "attn_output": (d["dim"], d["dim"]),
            "ffn_gate": (d["ffn_dim"], d["dim"]), "ffn_up": (d["ffn_dim"], d["dim"]),
            "ffn_down": (d["dim"], d["ffn_dim"])}
    shapes = {f"blk.{i}.{t}.weight": dt for i in range(layers) for t, dt in dims.items()}
    shapes["output.weight"] = (d["vocab"], d["dim"])
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path)
    w.add("general.type", "adapter")
    w.add(Keys.ARCHITECTURE, "llama")
    w.add("adapter.type", "lora")
    w.add("adapter.lora.alpha", np.float32(alpha))
    for name, (out, inn) in shapes.items():
        w.add_tensor(name + ".lora_a",
                     (rng.standard_normal((rank, inn)) * 0.02).astype(np.float32), GGMLType.F32)
        w.add_tensor(name + ".lora_b",
                     (rng.standard_normal((out, rank)) * 0.02).astype(np.float32), GGMLType.F32)
    w.write()
    return path


BERT_SHAPES = {
    # BAAI/bge-large-en-v1.5 (a BERT-large; its config.json): hidden 1024,
    # 24 layers, 16 heads (head_dim 64), intermediate 4096, 512 positions,
    # vocab 30522, 2 token types; CLS pooling (its sentence-transformers
    # config), llama.cpp pooling_type 2
    "bge-large": dict(dim=1024, n_layers=24, n_heads=16, ffn_dim=4096,
                      max_positions=512, vocab=30522, n_types=2, pooling=2),
    # small shape for CPU runs (in multiples of Q4_K's 256-element blocks)
    "tiny": dict(dim=256, n_layers=2, n_heads=4, ffn_dim=512,
                 max_positions=512, vocab=30522, n_types=2, pooling=2),
}
BERT_QUANTS = ("q8_0", "q4_k")
BERT_WORDS = ("the quick brown fox jumps over lazy dog hello world a story of two "
              "cities sleeps all day and in to is it on for with as was he she they "
              "we you this that what time people search query document answer "
              "embedding model text").split()


def bert_vocab(vocab: int) -> tuple[list[str], list[int]]:
    """A WordPiece vocab of ``vocab`` pieces with BERT's special ids ([PAD]
    0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, [unusedN] between), the
    ASCII punctuation, digits and letters alone and as ``##`` pieces, some
    words and suffixes, and ``[unusedN]`` filler for the rest. Types as the
    converter gives them: CONTROL for a bracketed piece, else NORMAL."""
    tokens = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + \
        ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = [chr(c) for c in range(33, 127) if not chr(c).isupper()]
    tokens += chars + ["##" + c for c in chars if c.isalnum()]
    tokens += list(BERT_WORDS) + ["##ing", "##ed", "##ly", "##er"]
    tokens = list(dict.fromkeys(tokens))      # a piece once ("a", "##s")
    n_unused = 99
    while len(tokens) < vocab:
        tokens.append(f"[unused{n_unused}]")
        n_unused += 1
    types = [int(TokenType.CONTROL) if t.startswith("[") and t.endswith("]")
             else int(TokenType.NORMAL) for t in tokens[:vocab]]
    return tokens[:vocab], types


def synth_bert(path: str, seed: int = 0, quant: str = "q8_0", n_layers: int | None = None,
               shape: str = "bge-large", pooling: int | None = None) -> str:
    """Write the ``shape`` BERT encoder (``BERT_SHAPES``) with ``quant``
    projections to ``path``; returns ``path``. ``n_layers`` keeps the first
    layers only (every kept tensor the same bytes); ``pooling`` overrides the
    shape's llama.cpp pooling_type (1 mean, 2 cls). The projections tile a
    quantized random pool of std 0.02 (BERT's initializer range) from a
    random block offset each; the tables draw N(0, 0.02), the norms' weights
    1 + N(0, 0.02) and every bias N(0, 0.02)."""
    if quant not in BERT_QUANTS:
        raise ValueError(f"quant {quant!r} is not one of {BERT_QUANTS}")
    wq = GGMLType[quant.upper()]
    d = dict(BERT_SHAPES[shape])
    if n_layers is not None:
        if not 1 <= n_layers <= d["n_layers"]:
            raise ValueError(f"n_layers {n_layers} is not in [1, {d['n_layers']}]")
        d["n_layers"] = n_layers
    dim, ffn = d["dim"], d["ffn_dim"]
    rng = np.random.default_rng(seed)
    tokens, types = bert_vocab(d["vocab"])

    w = GGUFWriter(path)
    w.add(Keys.ARCHITECTURE, "bert")
    w.add(Keys.NAME, f"synth-bge-{shape}-{quant}")
    w.add("bert.context_length", d["max_positions"])
    w.add("bert.embedding_length", dim)
    w.add("bert.block_count", d["n_layers"])
    w.add("bert.feed_forward_length", ffn)
    w.add("bert.attention.head_count", d["n_heads"])
    w.add("bert.attention.layer_norm_epsilon", 1e-12)
    w.add("bert.vocab_size", d["vocab"])
    w.add("bert.attention.causal", False)
    w.add("bert.pooling_type", int(pooling or d["pooling"]))
    w.add(Keys.TOKENIZER_MODEL, "bert")
    w.add(Keys.TOKENIZER_TOKENS, tokens)
    w.add(Keys.TOKENIZER_TOKEN_TYPE, np.asarray(types, np.int32))
    w.add("tokenizer.ggml.cls_token_id", 101)
    w.add("tokenizer.ggml.seperator_token_id", 102)
    w.add(Keys.TOKENIZER_UNK, 100)
    w.add(Keys.TOKENIZER_PAD, 0)
    w.add(Keys.TOKENIZER_ADD_BOS, True)
    w.add(Keys.TOKENIZER_ADD_EOS, True)

    def rand(*shape_):
        return (rng.standard_normal(shape_) * 0.02).astype(np.float32)

    pool = rand(1 << 20)
    qp = np.frombuffer(quantize(pool.reshape(1, -1), wq), np.uint8)
    blk, bpb = type_block_info(wq)

    def add_q(name, rows, cols):
        nbytes = rows * cols // blk * bpb
        start = int(rng.integers(qp.size // bpb)) * bpb
        src = np.concatenate([qp[start:], qp[:start]])
        raw = np.tile(src, -(-nbytes // src.size))[:nbytes].tobytes()
        w.add_raw_tensor(name, (cols, rows), wq, raw)

    w.add_tensor("token_embd.weight", rand(d["vocab"], dim), GGMLType.F16)
    w.add_tensor("position_embd.weight", rand(d["max_positions"], dim), GGMLType.F16)
    w.add_tensor("token_types.weight", rand(d["n_types"], dim), GGMLType.F16)
    w.add_tensor("token_embd_norm.weight", 1 + rand(dim), GGMLType.F32)
    w.add_tensor("token_embd_norm.bias", rand(dim), GGMLType.F32)
    for i in range(d["n_layers"]):
        p = f"blk.{i}."
        for name, rows, cols in (("attn_q", dim, dim), ("attn_k", dim, dim),
                                 ("attn_v", dim, dim), ("attn_output", dim, dim),
                                 ("ffn_up", ffn, dim), ("ffn_down", dim, ffn)):
            add_q(p + name + ".weight", rows, cols)
            w.add_tensor(p + name + ".bias", rand(rows), GGMLType.F32)
        for name in ("attn_output_norm", "layer_output_norm"):
            w.add_tensor(p + name + ".weight", 1 + rand(dim), GGMLType.F32)
            w.add_tensor(p + name + ".bias", rand(dim), GGMLType.F32)
    w.write()
    return path


def _cached(directory: str | None, stem: str, key: tuple, write) -> str:
    """``write(path)`` once under ``directory`` (the temp dir by default),
    the file reused after. The file name holds a hash of ``key`` and of the
    code that writes it, so a file left by another version of the
    synthesizer is never taken for this one's."""
    h = hashlib.sha256(repr(key).encode())
    for src in (__file__, inspect.getsourcefile(GGUFWriter), inspect.getsourcefile(quantize)):
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(directory or tempfile.gettempdir(),
                        f"{stem}_{h.hexdigest()[:12]}.gguf")
    if not os.path.exists(path):
        write(path + ".part")
        os.replace(path + ".part", path)
    return path


def cached_model(shape: str = "8b", seed: int = 0, directory: str | None = None,
                 quant: str = "q4_k", n_layers: int | None = None, fim: bool = False) -> str:
    """The ``shape`` model with ``quant`` weights from ``seed`` under
    ``directory`` (the temp dir by default), written on first use and reused
    after (``_cached``: the shape, the seed, the quant and the options are in
    the file name's hash)."""
    opts = () if n_layers is None and not fim else (n_layers, fim)
    extra = {} if not opts else {"n_layers": n_layers, "fim": fim}
    return _cached(directory, f"llama_gguf_port_{shape}_{quant}",
                   (SHAPES[shape], seed, quant, *opts),
                   lambda p: synth_model(p, shape, seed, quant=quant, **extra))


def cached_bert(n_layers: int | None = None) -> str:
    """:func:`synth_bert`'s bge-large Q8_0 encoder from seed 0 in the temp
    dir, kept as :func:`cached_model` keeps a llama."""
    return _cached(None, "llama_gguf_port_bert_bge-large_q8_0",
                   ("bert", BERT_SHAPES["bge-large"], 0, "q8_0", n_layers),
                   lambda p: synth_bert(p, 0, quant="q8_0", n_layers=n_layers))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bert", action="store_true",
                    help="write a BERT encoder (shape bge-large by default, quant q8_0)")
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES) + sorted(BERT_SHAPES))
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", default=None, choices=QUANTS + BERT_QUANTS)
    ap.add_argument("--layers", type=int, default=None, help="keep the first N layers")
    ap.add_argument("--fim", action="store_true", help="add the three FIM tokens")
    a = ap.parse_args()
    t0 = time.time()
    if a.bert:
        shape, quant = a.shape or "bge-large", a.quant or "q8_0"
        if shape not in BERT_SHAPES or quant not in BERT_QUANTS or a.fim:
            ap.error(f"--bert takes --shape {'|'.join(BERT_SHAPES)} and "
                     f"--quant {'|'.join(BERT_QUANTS)}, no --fim")
        synth_bert(a.out, a.seed, quant=quant, n_layers=a.layers, shape=shape)
    else:
        shape, quant = a.shape or "8b", a.quant or "q4_k"
        if shape not in SHAPES or quant not in QUANTS:
            ap.error(f"--shape takes {'|'.join(SHAPES)} and --quant {'|'.join(QUANTS)} "
                     "without --bert")
        synth_model(a.out, shape, a.seed, quant=quant, n_layers=a.layers, fim=a.fim)
    print(f"wrote {a.out} ({os.path.getsize(a.out) / 1e9:.2f} GB) in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
