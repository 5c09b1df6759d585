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

    python -m llama_gguf_inference_tpu_torch.tools.synth --shape 8b [--quant q2_k|q5_k] [--layers N] [--fim] --out model.gguf
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


def cached_model(shape: str = "8b", seed: int = 0, directory: str | None = None,
                 quant: str = "q4_k", n_layers: int | None = None, fim: bool = False) -> str:
    """The ``shape`` model with ``quant`` weights from ``seed`` under
    ``directory`` (the temp dir by default), written on first use and reused
    after. The file name holds a hash of the code that writes it, the shape,
    the seed, the quant and the options, so a file left by another version of
    the synthesizer is never taken for this one's."""
    opts = () if n_layers is None and not fim else (n_layers, fim)
    h = hashlib.sha256(repr((SHAPES[shape], seed, quant, *opts)).encode())
    for src in (__file__, inspect.getsourcefile(GGUFWriter), inspect.getsourcefile(quantize)):
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(directory or tempfile.gettempdir(),
                        f"llama_gguf_port_{shape}_{quant}_{h.hexdigest()[:12]}.gguf")
    if not os.path.exists(path):
        extra = {} if not opts else {"n_layers": n_layers, "fim": fim}
        synth_model(path + ".part", shape, seed, quant=quant, **extra)
        os.replace(path + ".part", path)
    return path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="8b", choices=sorted(SHAPES))
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", default="q4_k", choices=QUANTS)
    ap.add_argument("--layers", type=int, default=None, help="keep the first N layers")
    ap.add_argument("--fim", action="store_true", help="add the three FIM tokens")
    a = ap.parse_args()
    t0 = time.time()
    synth_model(a.out, a.shape, a.seed, quant=a.quant, n_layers=a.layers, fim=a.fim)
    print(f"wrote {a.out} ({os.path.getsize(a.out) / 1e9:.2f} GB) in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
