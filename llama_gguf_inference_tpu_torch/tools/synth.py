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
reads ``bench-llama3-<shape>-q4km`` whatever the quant).

    python -m llama_gguf_inference_tpu_torch.tools.synth --shape 8b [--quant q2_k|q5_k] --out model.gguf
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


def synth_model(path: str, shape: str = "8b", seed: int = 0, quant: str = "q4_k") -> str:
    """Write the ``shape`` model with ``quant`` weights to ``path``; returns
    ``path``."""
    if quant not in QUANTS:
        raise ValueError(f"quant {quant!r} is not one of {QUANTS}")
    wq = GGMLType[quant.upper()]
    d = SHAPES[shape]
    rng = np.random.default_rng(seed)
    head_dim = d["dim"] // d["n_heads"]
    vocab = d["vocab"]
    tokens, scores, types = make_tiny_vocab()
    tokens += [f"<extra_{i}>" for i in range(len(tokens), vocab)]
    scores += [-1e6] * (vocab - len(scores))
    types += [int(TokenType.UNUSED)] * (vocab - len(types))

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


def cached_model(shape: str = "8b", seed: int = 0, directory: str | None = None,
                 quant: str = "q4_k") -> str:
    """The ``shape`` model with ``quant`` weights from ``seed`` under
    ``directory`` (the temp dir by default), written on first use and reused
    after. The file name holds a hash of the code that writes it, the shape,
    the seed and the quant, so a file left by another version of the
    synthesizer is never taken for this one's."""
    h = hashlib.sha256(repr((SHAPES[shape], seed, quant)).encode())
    for src in (__file__, inspect.getsourcefile(GGUFWriter), inspect.getsourcefile(quantize)):
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(directory or tempfile.gettempdir(),
                        f"llama_gguf_port_{shape}_{quant}_{h.hexdigest()[:12]}.gguf")
    if not os.path.exists(path):
        synth_model(path + ".part", shape, seed, quant=quant)
        os.replace(path + ".part", path)
    return path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="8b", choices=sorted(SHAPES))
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", default="q4_k", choices=QUANTS)
    a = ap.parse_args()
    t0 = time.time()
    synth_model(a.out, a.shape, a.seed, quant=a.quant)
    print(f"wrote {a.out} ({os.path.getsize(a.out) / 1e9:.2f} GB) in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
