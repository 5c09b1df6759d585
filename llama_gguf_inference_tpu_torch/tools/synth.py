"""Synthesize a quantized llama or gemma3 GGUF with random weights from a
seed.

Q4_K (``quant="q4_k"``, the default), Q2_K (``quant="q2_k"``), Q5_K
(``quant="q5_k"``) or a grid-codebook format (``quant="iq2_xxs"`` and the
other IQ1/IQ2/IQ3 names; the embedding then Q4_K) projections and
embedding, a Q6_K output head, F32 norms, and a small
SentencePiece-style vocab padded with filler pieces to the shape's vocab
size. The ``gemma3-12b`` shape (``gemma3-tiny`` at CPU size) is written as
llama.cpp writes a gemma3 GGUF: its keys, per-head q/k norms, post-norms, a
Q6_K embedding and a head tied to it. The ``deepseek-v2-lite`` shape
(``deepseek2-tiny`` at CPU size) is a deepseek2 GGUF: latent attention, a
leading dense layer, stacked routed experts, shared experts, yarn
(``_synth_deepseek2``; its quantization is fixed). Decode cost depends on the weights'
shapes, not their values, so the file stands in for a real checkpoint of
the same shape. A small random pool
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

    python -m llama_gguf_inference_tpu_torch.tools.synth --shape 8b [--quant q2_k|q5_k|iq2_xxs|...] [--layers N] [--fim] --out model.gguf
    python -m llama_gguf_inference_tpu_torch.tools.synth --shape gemma3-12b [--layers N] --out gemma3.gguf
    python -m llama_gguf_inference_tpu_torch.tools.synth --shape deepseek-v2-lite [--layers N] --out dsv2.gguf
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
    # google/gemma-3-12b-it, its config.json text_config: hidden 3840, 48
    # layers, 16 heads over 8 kv heads of 256, intermediate 15360, vocab
    # 262208, sliding window 1024 on five layers of six, rope_theta 1e6 with
    # linear scaling x8 on the global layers, rope_local_base_freq 1e4,
    # query_pre_attn_scalar 256 (= head_dim), rms_norm_eps 1e-6, tied
    # embeddings, 131072 positions
    "gemma3-12b": dict(arch="gemma3", dim=3840, n_layers=48, n_heads=16, n_kv_heads=8,
                       head_dim=256, ffn_dim=15360, vocab=262208, rope_base=1e6,
                       rope_local_base=1e4, rope_linear=8.0, window=1024, rms_eps=1e-6,
                       context=131072),
    # the same at CPU size: 6 layers of 256 (one global), head_dim 64, a
    # window of 16
    "gemma3-tiny": dict(arch="gemma3", dim=256, n_layers=6, n_heads=4, n_kv_heads=2,
                        head_dim=64, ffn_dim=512, vocab=1024, rope_base=1e6,
                        rope_local_base=1e4, rope_linear=8.0, window=16, rms_eps=1e-6,
                        context=4096),
    # deepseek-ai/DeepSeek-V2-Lite, its config.json: hidden 2048, 27 layers,
    # 16 heads, vocab 102400, q_lora_rank null, kv_lora_rank 512,
    # qk_nope_head_dim 128, qk_rope_head_dim 64, v_head_dim 128, 64 routed
    # experts of 1408 (6 a token) and 2 shared, first_k_dense_replace 1 with
    # intermediate 10944, n_group 1, topk_group 1, norm_topk_prob false,
    # routed_scaling_factor 1.0, rope_theta 1e4 with yarn factor 40 over
    # 4096 (mscale_all_dim 0.707: yarn_log_multiplier 0.0707, as the JAX
    # package's convert_hf writes it), rms_norm_eps 1e-6, head not tied,
    # 163840 positions
    "deepseek-v2-lite": dict(arch="deepseek2", dim=2048, n_layers=27, n_heads=16,
                             vocab=102400, q_lora=0, kv_lora=512, qk_nope=128, qk_rope=64,
                             v_head=128, n_experts=64, n_used=6, n_shared=2, n_dense=1,
                             ffn_dim=10944, expert_ffn=1408, groups=(1, 1), renorm=False,
                             routed_scale=1.0, rope_base=1e4, yarn=(40.0, 4096, 0.0707),
                             rms_eps=1e-6, context=163840),
    # the same layout at CPU size: 3 layers of 256 (one dense), 8 experts of
    # 256 (2 a token, 2 shared), yarn past 64 positions
    "deepseek2-tiny": dict(arch="deepseek2", dim=256, n_layers=3, n_heads=4, vocab=1024,
                           q_lora=0, kv_lora=256, qk_nope=32, qk_rope=16, v_head=32,
                           n_experts=8, n_used=2, n_shared=2, n_dense=1, ffn_dim=320,
                           expert_ffn=256, groups=(1, 1), renorm=False, routed_scale=1.0,
                           rope_base=1e4, yarn=(40.0, 64, 0.0707), rms_eps=1e-6,
                           context=4096),
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


QUANTS = ("q4_k", "q2_k", "q5_k", "iq1_s", "iq1_m", "iq2_xxs", "iq2_xs", "iq2_s",
          "iq3_xxs", "iq3_s")


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
    if d.get("arch") == "gemma3":
        _synth_gemma3(w, d, shape, rng, tokens, scores, types, wq)
        return path
    if d.get("arch") == "deepseek2":
        _synth_deepseek2(w, d, shape, rng, tokens, scores, types)
        return path
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

    add_q = _tiler(w, rng)
    ones = np.ones(d["dim"], np.float32)
    add_q("token_embd.weight", vocab, d["dim"], _embd_type(wq))
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


def _tiler(w: GGUFWriter | None, rng: np.random.Generator):
    """``add_q(name, rows, cols, t)``: the wire bytes of a (rows, cols)
    tensor of type ``t`` that tile one quantized random pool of 2^20 values
    (std 0.02) drawn from ``rng``, written to ``w`` under ``name`` (and
    returned)."""
    pool = (rng.standard_normal(1 << 20) * 0.02).astype(np.float32)
    qpool: dict[GGMLType, np.ndarray] = {}

    def add_q(name, rows, cols, t):
        if t not in qpool:
            qpool[t] = np.frombuffer(quantize(pool.reshape(1, -1), t), np.uint8)
        qp = qpool[t]
        blk, bpb = type_block_info(t)
        nbytes = rows * cols // blk * bpb
        raw = np.tile(qp, -(-nbytes // qp.size))[:nbytes].tobytes()
        if w is not None and name is not None:
            w.add_raw_tensor(name, (cols, rows), t, raw)
        return raw

    return add_q


def tiled_weight(t: GGMLType, rows: int, cols: int, seed: int = 0) -> bytes:
    """The wire bytes of one (rows, cols) weight of type ``t`` as
    :func:`synth_model` writes its tensors (a quantized pool from ``seed``,
    tiled)."""
    return _tiler(None, np.random.default_rng(seed))("", rows, cols, GGMLType(t))


def _embd_type(wq: GGMLType) -> GGMLType:
    """The embedding's type: the projections', but Q4_K beside grid-codebook
    projections (their repack is numpy only, the 128256-row table's would
    take most of a load)."""
    return GGMLType.Q4_K if wq.name.startswith("IQ") else wq


def _synth_gemma3(w: GGUFWriter, d: dict, shape: str, rng: np.random.Generator,
                  tokens, scores, types, wq: GGMLType) -> None:
    """A gemma3 GGUF as llama.cpp's converter writes one: the ``gemma3.*``
    keys (the sliding window, the local rope base, the linear rope scaling
    of the global layers), per layer ``attn_q_norm``/``attn_k_norm`` over a
    head, ``attn_post_norm`` and ``ffn_post_norm`` beside the pre-norms,
    ``wq`` projections, a Q6_K ``token_embd`` and no ``output.weight`` (the
    head is tied)."""
    dim, hd = d["dim"], d["head_dim"]
    w.add(Keys.ARCHITECTURE, "gemma3")
    w.add(Keys.NAME, f"synth-{shape}-{wq.name.lower()}")
    w.add("gemma3.context_length", d["context"])
    w.add("gemma3.embedding_length", dim)
    w.add("gemma3.block_count", d["n_layers"])
    w.add("gemma3.feed_forward_length", d["ffn_dim"])
    w.add("gemma3.attention.head_count", d["n_heads"])
    w.add("gemma3.attention.head_count_kv", d["n_kv_heads"])
    w.add("gemma3.attention.key_length", hd)
    w.add("gemma3.attention.value_length", hd)
    w.add("gemma3.attention.layer_norm_rms_epsilon", d["rms_eps"])
    w.add("gemma3.attention.sliding_window", d["window"])
    w.add("gemma3.rope.freq_base", d["rope_base"])
    w.add("gemma3.rope.local_freq_base", d["rope_local_base"])
    w.add("gemma3.rope.scaling.type", "linear")
    w.add("gemma3.rope.scaling.factor", d["rope_linear"])
    w.add(Keys.TOKENIZER_MODEL, "llama")
    w.add(Keys.TOKENIZER_TOKENS, tokens)
    w.add(Keys.TOKENIZER_SCORES, np.asarray(scores, np.float32))
    w.add(Keys.TOKENIZER_TOKEN_TYPE, np.asarray(types, np.int32))
    w.add(Keys.TOKENIZER_BOS, 1)
    w.add(Keys.TOKENIZER_EOS, 2)
    w.add(Keys.TOKENIZER_UNK, 0)
    w.add(Keys.TOKENIZER_ADD_BOS, True)
    add_q = _tiler(w, rng)
    ones = np.ones(dim, np.float32)
    add_q("token_embd.weight", d["vocab"], dim, GGMLType.Q6_K)
    q_out, kv_out = d["n_heads"] * hd, d["n_kv_heads"] * hd
    for i in range(d["n_layers"]):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", ones, GGMLType.F32)
        add_q(p + "attn_q.weight", q_out, dim, wq)
        add_q(p + "attn_k.weight", kv_out, dim, wq)
        add_q(p + "attn_v.weight", kv_out, dim, wq)
        w.add_tensor(p + "attn_q_norm.weight", np.ones(hd, np.float32), GGMLType.F32)
        w.add_tensor(p + "attn_k_norm.weight", np.ones(hd, np.float32), GGMLType.F32)
        add_q(p + "attn_output.weight", dim, q_out, wq)
        w.add_tensor(p + "attn_post_norm.weight", ones, GGMLType.F32)
        w.add_tensor(p + "ffn_norm.weight", ones, GGMLType.F32)
        add_q(p + "ffn_gate.weight", d["ffn_dim"], dim, wq)
        add_q(p + "ffn_up.weight", d["ffn_dim"], dim, wq)
        add_q(p + "ffn_down.weight", dim, d["ffn_dim"], wq)
        w.add_tensor(p + "ffn_post_norm.weight", ones, GGMLType.F32)
    w.add_tensor("output_norm.weight", ones, GGMLType.F32)
    w.write()


def _synth_deepseek2(w: GGUFWriter, d: dict, shape: str, rng: np.random.Generator,
                     tokens, scores, types) -> None:
    """A deepseek2 GGUF as llama.cpp's converter writes one: the
    ``deepseek2.*`` keys (the latent ranks and head dims, the routed,
    shared and leading dense counts, the routing, yarn), per layer the latent
    attention (``attn_q``, ``attn_kv_a_mqa`` and its norm, ``attn_kv_b``),
    then a dense FFN (the leading layers) or a router, the routed experts as
    stacked ``ffn_*_exps`` tensors and the shared ones (``ffn_*_shexp``, the
    two as one of twice the width). Q4_K on every projection whose input is a
    multiple of 256, else Q8_0 (the experts' and the dense layer's
    ffn_down: llama.cpp falls back from Q4_K to Q5_0 there, from Q6_K to
    Q8_0), a Q4_K embedding, a Q6_K head, F32 norms and routers (the routers
    random from the seed, std 0.02)."""
    dim, H = d["dim"], d["n_heads"]
    dk = d["qk_nope"] + d["qk_rope"]
    factor, orig, log_mul = d["yarn"]
    a = "deepseek2"
    w.add(Keys.ARCHITECTURE, a)
    w.add(Keys.NAME, f"synth-{shape}-q4_k")
    for key, val in (("context_length", d["context"]), ("embedding_length", dim),
                     ("block_count", d["n_layers"]), ("feed_forward_length", d["ffn_dim"]),
                     ("attention.head_count", H), ("attention.head_count_kv", H),
                     ("attention.layer_norm_rms_epsilon", d["rms_eps"]),
                     ("attention.key_length", dk), ("attention.value_length", d["v_head"]),
                     ("attention.kv_lora_rank", d["kv_lora"]),
                     ("rope.dimension_count", d["qk_rope"]), ("rope.freq_base", d["rope_base"]),
                     ("rope.scaling.type", "yarn"), ("rope.scaling.factor", factor),
                     ("rope.scaling.original_context_length", orig),
                     ("rope.scaling.yarn_log_multiplier", log_mul),
                     ("expert_count", d["n_experts"]), ("expert_used_count", d["n_used"]),
                     ("expert_shared_count", d["n_shared"]),
                     ("expert_feed_forward_length", d["expert_ffn"]),
                     ("leading_dense_block_count", d["n_dense"]),
                     ("expert_weights_scale", d["routed_scale"]),
                     ("expert_weights_norm", d["renorm"]),
                     ("expert_group_count", d["groups"][0]),
                     ("expert_group_used_count", d["groups"][1])):
        w.add(f"{a}.{key}", val)
    if d["q_lora"]:
        w.add(f"{a}.attention.q_lora_rank", d["q_lora"])
    w.add(Keys.TOKENIZER_MODEL, "llama")
    w.add(Keys.TOKENIZER_TOKENS, tokens)
    w.add(Keys.TOKENIZER_SCORES, np.asarray(scores, np.float32))
    w.add(Keys.TOKENIZER_TOKEN_TYPE, np.asarray(types, np.int32))
    w.add(Keys.TOKENIZER_BOS, 1)
    w.add(Keys.TOKENIZER_EOS, 2)
    w.add(Keys.TOKENIZER_UNK, 0)
    w.add(Keys.TOKENIZER_ADD_BOS, True)
    add_q = _tiler(w, rng)

    def proj(name, rows, cols, n_exp=0):
        t = GGMLType.Q4_K if cols % 256 == 0 else GGMLType.Q8_0
        if not n_exp:
            add_q(name, rows, cols, t)
            return
        raw = add_q(None, n_exp * rows, cols, t)
        w.add_raw_tensor(name, (cols, rows, n_exp), t, raw)

    ones = np.ones(dim, np.float32)
    E, F = d["n_experts"], d["expert_ffn"]
    add_q("token_embd.weight", d["vocab"], dim, GGMLType.Q4_K)
    for i in range(d["n_layers"]):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", ones, GGMLType.F32)
        proj(p + "attn_q.weight", H * dk, dim)
        proj(p + "attn_kv_a_mqa.weight", d["kv_lora"] + d["qk_rope"], dim)
        w.add_tensor(p + "attn_kv_a_norm.weight", np.ones(d["kv_lora"], np.float32),
                     GGMLType.F32)
        proj(p + "attn_kv_b.weight", H * (d["qk_nope"] + d["v_head"]), d["kv_lora"])
        proj(p + "attn_output.weight", dim, H * d["v_head"])
        w.add_tensor(p + "ffn_norm.weight", ones, GGMLType.F32)
        if i < d["n_dense"]:
            proj(p + "ffn_gate.weight", d["ffn_dim"], dim)
            proj(p + "ffn_up.weight", d["ffn_dim"], dim)
            proj(p + "ffn_down.weight", dim, d["ffn_dim"])
            continue
        w.add_tensor(p + "ffn_gate_inp.weight",
                     (rng.standard_normal((E, dim)) * 0.02).astype(np.float32), GGMLType.F32)
        proj(p + "ffn_gate_exps.weight", F, dim, E)
        proj(p + "ffn_up_exps.weight", F, dim, E)
        proj(p + "ffn_down_exps.weight", dim, F, E)
        sh = d["n_shared"] * F
        proj(p + "ffn_gate_shexp.weight", sh, dim)
        proj(p + "ffn_up_shexp.weight", sh, dim)
        proj(p + "ffn_down_shexp.weight", dim, sh)
    w.add_tensor("output_norm.weight", ones, GGMLType.F32)
    add_q("output.weight", d["vocab"], dim, GGMLType.Q6_K)
    w.write()


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
