"""The port's loader and forward against the JAX package, on the CPU, over a
tiny Q4_K_M llama GGUF written with the JAX package's writer.

Tolerances: with its Pallas kernels forced on (interpret mode on the CPU),
the JAX forward computes the port's function, and the two differ by f32 sum
order and the bf16 roundings that order flips: within 0.5% of the logits'
scale (measured 0.31%). The JAX forward's own CPU path dequantizes each Q4_K
weight to bf16(q·s − m), while the port (like the Pallas fsplit kernel)
rounds bf16(q·s) and subtracts the min term in f32; through two layers that
moves logits by up to 3% of their scale (measured 1.7%). Prefill and incremental decode run the
same kernels on different row groupings: f32 sum order and bf16 rounding of
activations leave them within 1.5% of the logits' scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.gguf.constants import GGMLType, Keys
from llama_gguf_inference_tpu.gguf.writer import GGUFWriter
from llama_gguf_inference_tpu.models import llama as jllama
from llama_gguf_inference_tpu.ops import linear as jlinear
from llama_gguf_inference_tpu.ops import matmul_kernels as jmk
from llama_gguf_inference_tpu.runtime import loader as jloader
from llama_gguf_inference_tpu.utils.testing import make_tiny_vocab
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.ops.linear import (DenseLinear, QuantEmbedding,
                                                       QuantLinear)
from llama_gguf_inference_tpu_torch.runtime import loader as tloader
from llama_gguf_inference_tpu_torch.runtime.convert import params_from_numpy

torch.set_num_threads(1)

DIM, LAYERS, HEADS, KV_HEADS, FFN, VOCAB = 256, 2, 4, 2, 512, 512


def write_tiny_q4km(path, seed=0):
    """dim 256, 2 layers, 4 heads over 2 KV heads, ffn 512, vocab 512:
    Q4_K embedding and projections, Q6_K head, random f32 norms."""
    rng = np.random.default_rng(seed)
    tokens, scores, types = make_tiny_vocab()
    tokens += [f"<extra_{i}>" for i in range(len(tokens), VOCAB)]
    scores += [-1e6] * (VOCAB - len(scores))
    types += [5] * (VOCAB - len(types))
    w = GGUFWriter(path)
    w.add(Keys.ARCHITECTURE, "llama")
    w.add(Keys.NAME, "tiny-q4km")
    w.add("llama.context_length", 256)
    w.add("llama.embedding_length", DIM)
    w.add("llama.block_count", LAYERS)
    w.add("llama.feed_forward_length", FFN)
    w.add("llama.attention.head_count", HEADS)
    w.add("llama.attention.head_count_kv", KV_HEADS)
    w.add("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add("llama.rope.freq_base", 10000.0)
    w.add("llama.rope.dimension_count", DIM // HEADS)
    w.add(Keys.TOKENIZER_MODEL, "llama")
    w.add(Keys.TOKENIZER_TOKENS, tokens)
    w.add(Keys.TOKENIZER_SCORES, np.asarray(scores, np.float32))
    w.add(Keys.TOKENIZER_TOKEN_TYPE, np.asarray(types, np.int32))
    w.add(Keys.TOKENIZER_BOS, 1)
    w.add(Keys.TOKENIZER_EOS, 2)
    w.add(Keys.TOKENIZER_UNK, 0)

    def rand(*shape, s=0.08):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm():
        return (1.0 + rand(DIM, s=0.1)).astype(np.float32)

    hd = DIM // HEADS
    w.add_tensor("token_embd.weight", rand(VOCAB, DIM, s=1.0), GGMLType.Q4_K)
    for i in range(LAYERS):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", norm(), GGMLType.F32)
        w.add_tensor(p + "attn_q.weight", rand(HEADS * hd, DIM), GGMLType.Q4_K)
        w.add_tensor(p + "attn_k.weight", rand(KV_HEADS * hd, DIM), GGMLType.Q4_K)
        w.add_tensor(p + "attn_v.weight", rand(KV_HEADS * hd, DIM), GGMLType.Q4_K)
        w.add_tensor(p + "attn_output.weight", rand(DIM, DIM), GGMLType.Q4_K)
        w.add_tensor(p + "ffn_norm.weight", norm(), GGMLType.F32)
        w.add_tensor(p + "ffn_gate.weight", rand(FFN, DIM), GGMLType.Q4_K)
        w.add_tensor(p + "ffn_up.weight", rand(FFN, DIM), GGMLType.Q4_K)
        w.add_tensor(p + "ffn_down.weight", rand(DIM, FFN), GGMLType.Q4_K)
    w.add_tensor("output_norm.weight", norm(), GGMLType.F32)
    w.add_tensor("output.weight", rand(VOCAB, DIM, s=0.3), GGMLType.Q6_K)
    return w.write()


def to_numpy_tree(node):
    """JAX parameter tree -> the plain tree ``params_from_numpy`` takes."""
    if isinstance(node, jlinear.QuantEmbedding):
        return {"table": to_numpy_tree(node.table)}
    if isinstance(node, jlinear.QuantLinear):
        return {f.name: (None if getattr(node, f.name) is None
                         else np.asarray(getattr(node, f.name))
                         if isinstance(getattr(node, f.name), jax.Array)
                         else getattr(node, f.name))
                for f in dataclasses.fields(node)}
    if isinstance(node, jlinear.DenseLinear):
        return {"w": np.asarray(node.w)}
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    if isinstance(node, list | tuple):
        return [to_numpy_tree(v) for v in node]
    return np.asarray(node)


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    return str(write_tiny_q4km(tmp_path_factory.mktemp("tiny") / "tiny.gguf"))


@pytest.fixture(scope="module")
def models(tiny_path):
    jcfg, jparams, _ = jloader.load_model(tiny_path, fuse=True)
    tcfg, tparams, _ = tloader.load_model(tiny_path, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _assert_same(a, b, where="params"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, QuantEmbedding):
        _assert_same(a.table, b.table, where + ".table")
    elif isinstance(a, QuantLinear | DenseLinear):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y), f"{where}.{f.name}"
            else:
                assert x == y, f"{where}.{f.name}"
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), where


def test_load_model_equals_converted_jax_params(models):
    jcfg, jparams, tcfg, tparams = models
    assert (tcfg.dim, tcfg.n_layers, tcfg.n_heads, tcfg.n_kv_heads, tcfg.ffn_dim,
            tcfg.vocab_size) == (jcfg.dim, jcfg.n_layers, jcfg.n_heads,
                                 jcfg.n_kv_heads, jcfg.ffn_dim, jcfg.vocab_size)
    assert "attn_qkv" in tparams["layers"][0] and "ffn_gateup" in tparams["layers"][0]
    _assert_same(tparams, params_from_numpy(to_numpy_tree(jparams), "cpu"))


def _jax_logits(jcfg, jparams, ids, S):
    cache = jllama.KVCache.zeros(jcfg, 1, S)
    logits, _ = jllama.forward(jparams, jcfg, jnp.asarray(ids[None]),
                               jnp.zeros(1, jnp.int32), cache,
                               jnp.asarray([len(ids)], jnp.int32))
    return np.asarray(logits[0])


@pytest.mark.parametrize("jax_path,tol", [("pallas", 0.005), ("xla", 0.03)])
def test_forward_matches_jax(models, jax_path, tol, monkeypatch):
    jcfg, jparams, tcfg, tparams = models
    if jax_path == "pallas":   # all three Pallas kernels, in interpret mode
        monkeypatch.setattr(jmk, "_on_tpu", lambda: True)
        monkeypatch.setenv("LGT_FORCE_FLASH", "1")
    ids = np.array([1, 300, 311, 290, 305, 17, 400, 263], np.int32)
    want = _jax_logits(jcfg, jparams, ids, 32)
    cache = tllama.KVCache.zeros(tcfg, 1, 32, "cpu")
    with torch.inference_mode():
        got = tllama.forward(tparams, tcfg, torch.from_numpy(ids[None]),
                             torch.zeros(1, dtype=torch.int32), cache)[0].numpy()
    assert got.shape == (8, VOCAB)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale
    # the single-row head (the engine's prefill path) returns the same row
    cache = tllama.KVCache.zeros(tcfg, 1, 32, "cpu")
    with torch.inference_mode():
        last = tllama.forward(tparams, tcfg, torch.from_numpy(ids[None]),
                              torch.zeros(1, dtype=torch.int32), cache,
                              logits_at=torch.tensor([7]))
    assert torch.equal(last[0, 0], torch.from_numpy(got[7]))


def test_prefill_equals_incremental_decode(models):
    _, _, cfg, params = models
    ids = torch.tensor([[1, 263, 270, 275, 268, 280, 301]], dtype=torch.int32)
    T, S = ids.shape[1], 16
    with torch.inference_mode():
        full = tllama.forward(params, cfg, ids, torch.zeros(1, dtype=torch.int32),
                              tllama.KVCache.zeros(cfg, 1, S, "cpu"))[0]
        cache = tllama.KVCache.zeros(cfg, 1, S, "cpu")
        steps = torch.stack([
            tllama.forward(params, cfg, ids[:, t:t + 1],
                           torch.tensor([t], dtype=torch.int32), cache)[0, 0]
            for t in range(T)])
    scale = full.abs().max()
    assert (steps - full).abs().max() <= 0.015 * scale


def test_write_kv_drops_rows_past_capacity():
    """A padded chunk running past S writes only the rows that fit."""
    cache = torch.zeros(2, 1, 8, 2)
    new = torch.arange(2 * 4 * 2, dtype=torch.float32).reshape(2, 4, 1, 2)
    idx = tllama._write_index(torch.tensor([2, 6], dtype=torch.int32), 4, 8)
    tllama._write_kv(cache, new, idx)
    assert torch.equal(cache[0, 0, 2:6], new[0, :, 0])
    assert torch.equal(cache[1, 0, 6:8], new[1, :2, 0])
    assert cache[0, 0, :2].abs().sum() == 0 and cache[1, 0, :6].abs().sum() == 0


def test_rope_scaling_matches_jax():
    from llama_gguf_inference_tpu.models.config import ModelConfig as JConfig
    from llama_gguf_inference_tpu_torch.models.config import ModelConfig as TConfig
    pos = np.array([[0, 5, 1000, 9000]], np.int32)
    for kind, extra in (("none", {}), ("linear", {"rope_scaling_factor": 4.0}),
                        ("llama3", {"rope_scaling_factor": 8.0,
                                    "rope_orig_ctx": 8192})):
        jc = JConfig(rope_scaling_type=kind, **extra)
        tc = TConfig(rope_scaling_type=kind, **extra)
        jcos, jsin = jllama.rope_angles(jnp.asarray(pos), 128, 128, 500000.0, jc)
        tcos, tsin = tllama.rope_angles(torch.from_numpy(pos), 128, 500000.0, tc)
        assert np.allclose(tcos.numpy(), np.asarray(jcos), atol=2e-3), kind
        assert np.allclose(tsin.numpy(), np.asarray(jsin), atol=2e-3), kind


def test_config_rejects_other_architectures():
    from llama_gguf_inference_tpu_torch.models.config import ModelConfig
    with pytest.raises(ValueError, match="qwen2"):
        ModelConfig.from_gguf_metadata({"general.architecture": "qwen2"})
