"""GGUF LoRA adapters and dense residency in the port, on the CPU, against
the JAX package (``tests/test_lora.py``'s cases).

The adapter parse and its refusals; ``LoraLinear.matmul`` against the JAX
package's on the same numpy A, B and quantized base; a base and delta that
nearly cancel, which fails if the base output is rounded to bf16 before the
delta is added; the forward with an adapter against the JAX forward with the
same adapter and against a merged dense oracle; adapted projections left
unfused; the engine end to end and from the environment. Dense residency
(``mode="dense"``): the loaded weights equal the JAX package's dense ones,
and the forward matches the JAX dense forward and the port's quantized one.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.gguf.constants import GGMLType
from llama_gguf_inference_tpu.models import llama as jllama
from llama_gguf_inference_tpu.ops import linear as jlinear
from llama_gguf_inference_tpu.runtime import engine as jengine
from llama_gguf_inference_tpu.runtime import loader as jloader
from llama_gguf_inference_tpu.runtime import lora as jlora
from llama_gguf_inference_tpu.runtime.sampler import SamplingParams as JParams
from llama_gguf_inference_tpu.utils.testing import make_tiny_vocab, write_tiny_llama
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.ops.linear import DenseLinear, LoraLinear, QuantLinear
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime import loader as tloader
from llama_gguf_inference_tpu_torch.runtime import lora as tlora
from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
from llama_gguf_inference_tpu_torch.tools import synth
from test_lora import ALPHA, RANK, _write_adapter

torch.set_num_threads(1)

DIM, FFN = 64, 96
LOGITS_TOL = 0.03          # of max |logit|: the port's plain path against JAX's XLA path
MERGED_TOL = 0.05          # tests/test_lora.py's atol/rtol against the merged weights


@pytest.fixture(scope="module")
def base_model(tmp_path_factory):
    p = tmp_path_factory.mktemp("lora") / "base.gguf"
    write_tiny_llama(p, dim=DIM, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=FFN,
                     quant=GGMLType.Q8_0)
    return str(p)


@pytest.fixture(scope="module")
def adapter(tmp_path_factory):
    vocab = len(make_tiny_vocab()[0])
    p = tmp_path_factory.mktemp("lora") / "adapter.gguf"
    _write_adapter(p, {"blk.0.attn_q.weight": (DIM, DIM), "blk.1.ffn_down.weight": (DIM, FFN),
                       "blk.1.attn_v.weight": (32, DIM), "output.weight": (vocab, DIM)},
                   np.random.default_rng(3), mag=0.1)
    return str(p)


def test_load_adapter_matches_jax(adapter):
    alpha, pairs = tlora.load_adapter(adapter)
    jalpha, jpairs = jlora.load_adapter(adapter)
    assert alpha == jalpha == ALPHA and pairs.keys() == jpairs.keys()
    for k in pairs:
        for got, want in zip(pairs[k], jpairs[k]):
            np.testing.assert_array_equal(got, want)
    assert pairs["blk.1.ffn_down.weight"][0].shape == (RANK, FFN)


def test_rejections(base_model, tmp_path, caplog):
    with pytest.raises(ValueError, match="not a GGUF LoRA adapter"):
        tlora.load_adapter(base_model)
    p = tmp_path / "qwen.gguf"
    from llama_gguf_inference_tpu.gguf.writer import GGUFWriter
    w = GGUFWriter(p)
    for k, v in (("general.type", "adapter"), ("general.architecture", "qwen2"),
                 ("adapter.type", "lora"), ("adapter.lora.alpha", np.float32(8.0))):
        w.add(k, v)
    w.write()
    with pytest.raises(ValueError, match="architecture"):
        tlora.load_adapter(str(p), arch="llama")
    tlora.load_adapter(str(p), arch="qwen2")
    bad = tmp_path / "bad.gguf"
    _write_adapter(bad, {"blk.0.attn_q.weight": (32, DIM)}, np.random.default_rng(0))
    _, params, reader = tloader.load_model(base_model, "cpu", fuse=False)
    reader.close()
    with pytest.raises(ValueError, match="shape mismatch"):
        tlora.apply_lora(params, str(bad), device="cpu")
    extra = tmp_path / "extra.gguf"
    _write_adapter(extra, {"token_embd.weight": (256, DIM), "blk.0.attn_q.weight": (DIM, DIM),
                           "blk.9.attn_q.weight": (DIM, DIM)}, np.random.default_rng(1))
    with caplog.at_level(logging.WARNING):
        assert tlora.apply_lora(params, str(extra), device="cpu") == 1
    assert isinstance(params["layers"][0]["attn_q"], LoraLinear)
    assert "skipping token_embd.weight" in caplog.text and "blk.9" in caplog.text
    if not torch.cuda.is_available():   # the card by default
        with pytest.raises(RuntimeError, match="cuda"):
            tlora.apply_lora(params, str(extra))


def _bases(base_model):
    _, jp, jr = jloader.load_model(base_model, mode="quant")
    jr.close()
    _, tp, tr = tloader.load_model(base_model, "cpu", fuse=False)
    tr.close()
    return jp["layers"][1]["ffn_down"], tp["layers"][1]["ffn_down"]


def test_matmul_matches_jax(base_model):
    jw, tw = _bases(base_model)
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((RANK, FFN)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((DIM, RANK)) * 0.5).astype(np.float32)
    x = rng.standard_normal((8, FFN)).astype(np.float32)
    jl = jlinear.LoraLinear(base=jw, a=jnp.asarray(a, jnp.bfloat16),
                            b=jnp.asarray(b, jnp.bfloat16), scale=2.0)
    tl = LoraLinear(base=tw, a=torch.from_numpy(a).bfloat16(), b=torch.from_numpy(b).bfloat16(),
                    scale=2.0)
    want = np.asarray(jl.matmul(jnp.asarray(x, jnp.bfloat16), jnp.float32))
    got = tl.matmul(torch.from_numpy(x).bfloat16(), torch.float32).numpy()
    # the same bf16 values summed in f32 in another order
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(tl.dequantize(torch.float32).numpy(),
                               np.asarray(jl.dequantize(jnp.float32)), rtol=1e-6, atol=1e-6)


def test_base_stays_f32_until_the_delta(base_model):
    """A = I, B = -W (the bf16 weights the base's kernels decode) and scale
    1 - 2^-8: the delta cancels all but 2^-8 of the base output. Kept in f32
    the sum is right to f32 rounding; rounded to bf16 first, the base leaves
    an error of up to 2^-9 of its own size, half the answer."""
    jw, tw = _bases(base_model)
    w = tw.dequantize(torch.bfloat16)                    # (DIM, FFN), bf16
    a, b, scale = torch.eye(FFN).bfloat16(), -w, 1.0 - 2.0 ** -8
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, FFN)).astype(
        np.float32)).bfloat16()
    base = x.double() @ w.double().t()
    exact = base * 2.0 ** -8
    got = LoraLinear(base=tw, a=a, b=b, scale=scale).matmul(x, torch.float32).double()
    want = np.asarray(jlinear.LoraLinear(
        base=jw, a=jnp.asarray(a.float().numpy(), jnp.bfloat16),
        b=jnp.asarray(b.float().numpy(), jnp.bfloat16), scale=scale).matmul(
            jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.float32), np.float64)
    tol = 0.01 * exact.abs().max().item()
    assert (got - exact).abs().max().item() <= tol
    assert np.abs(want - exact.numpy()).max() <= tol
    rounded = tw.matmul(x, torch.float32).bfloat16().double() - scale * base
    assert (rounded - exact).abs().max().item() > 10 * tol


def _jax_logits(cfg, params, ids):
    logits, _ = jllama.forward(params, cfg, jnp.asarray(ids), jnp.zeros(1, jnp.int32),
                               jllama.KVCache.zeros(cfg, 1, 16),
                               jnp.full(1, ids.shape[1], jnp.int32))
    return np.asarray(logits, np.float32)


def _port_logits(cfg, params, ids):
    with torch.inference_mode():
        return tllama.forward(params, cfg, torch.from_numpy(ids),
                              torch.zeros(1, dtype=torch.int32),
                              tllama.KVCache.zeros(cfg, 1, 16, "cpu")).float().numpy()


IDS = np.random.default_rng(11).integers(3, 250, size=(1, 8)).astype(np.int32)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_forward_with_adapter_matches_jax_and_merged(base_model, adapter, scale):
    cfg, params, r = tloader.load_model(base_model, "cpu", lora_path=adapter, lora_scale=scale)
    r.close()
    lw = params["layers"][0]["attn_q"]
    assert isinstance(lw, LoraLinear) and lw.scale == scale * ALPHA / RANK
    assert isinstance(lw.base, QuantLinear) and isinstance(params["output"], LoraLinear)
    got = _port_logits(cfg, params, IDS)
    jcfg, jparams, jr = jloader.load_model(base_model, mode="quant", fuse=True,
                                           lora_path=adapter, lora_scale=scale)
    jr.close()
    want = _jax_logits(jcfg, jparams, IDS)
    assert np.abs(got - want).max() <= LOGITS_TOL * np.abs(want).max()
    # the merged dense oracle: W + scale * B @ A in f32 for every adapted weight
    alpha, pairs = tlora.load_adapter(adapter)
    _, merged, r2 = tloader.load_model(base_model, "cpu", fuse=False)
    r2.close()
    for name, (a, b) in pairs.items():
        cont, key = tlora._resolve(merged, name)
        w = cont[key]
        m = w.dequantize(torch.float32) + scale * alpha / RANK * torch.from_numpy(b @ a)
        cont[key] = DenseLinear(w=m, out_features=w.out_features, in_features=w.in_features)
    oracle = _port_logits(cfg, merged, IDS)
    np.testing.assert_allclose(got, oracle, atol=MERGED_TOL, rtol=MERGED_TOL)
    _, plain, r3 = tloader.load_model(base_model, "cpu")
    r3.close()
    assert np.abs(got - _port_logits(cfg, plain, IDS)).max() > 0.1   # the adapter moves logits


def test_adapted_projections_stay_unfused(base_model, adapter):
    _, params, r = tloader.load_model(base_model, "cpu", lora_path=adapter)
    r.close()
    l0, l1 = params["layers"]
    # layer 0: q adapted, so q, k and v stay apart; gate and up fuse
    assert isinstance(l0["attn_q"], LoraLinear) and "attn_qkv" not in l0
    assert isinstance(l0["attn_k"], QuantLinear) and "ffn_gateup" in l0
    # layer 1: v adapted; ffn_down adapted outside any fusion
    assert isinstance(l1["attn_v"], LoraLinear) and "attn_qkv" not in l1
    assert isinstance(l1["ffn_down"], LoraLinear) and "ffn_gateup" in l1


def _greedy(path, **kw):
    return _tokens(tengine.InferenceEngine(
        path, tengine.EngineConfig(max_slots=1, ctx=64, **kw), device="cpu"))


def _tokens(eng):
    out = eng.submit("hello world", SamplingParams(temperature=0.0, max_tokens=8))[1]
    evs = []
    while not (evs and evs[-1].finished):
        eng.step()
        while not out.empty():
            evs.append(out.get_nowait())
    return [e.token_id for e in evs]


def test_engine_end_to_end_with_lora(base_model, adapter, monkeypatch):
    with_lora = _greedy(base_model, lora_path=adapter)
    without = _greedy(base_model)
    assert len(with_lora) == 8 and with_lora != without
    from llama_gguf_inference_tpu_torch.serving.openai_server import build_engine_from_env
    monkeypatch.setenv("MODEL_PATH", base_model)
    monkeypatch.setenv("MAX_SLOTS", "1")
    monkeypatch.setenv("CTX", "64")
    monkeypatch.setenv("LORA_PATH", adapter)
    monkeypatch.setenv("LORA_SCALE", "1.0")
    monkeypatch.setenv("CTX_SHIFT", "1")
    eng = build_engine_from_env(device="cpu")
    assert (eng.ecfg.lora_path, eng.ecfg.lora_scale, eng.ecfg.ctx_shift) == (adapter, 1.0, True)
    assert _tokens(eng) == with_lora


def test_dense_mode_matches_jax_and_quant(base_model):
    cfg, dense, r = tloader.load_model(base_model, "cpu", mode="dense")
    r.close()
    jcfg, jdense, jr = jloader.load_model(base_model, mode="dense", fuse=True)
    jr.close()
    assert isinstance(dense["tok_embd"], torch.Tensor) and dense["tok_embd"].dtype == torch.bfloat16
    np.testing.assert_array_equal(dense["tok_embd"].float().numpy(),
                                  np.asarray(jdense["tok_embd"], np.float32))
    q, jq = dense["layers"][0]["attn_qkv"], jdense["layers"][0]["attn_qkv"]
    assert isinstance(q, DenseLinear)
    np.testing.assert_array_equal(q.w.float().numpy(), np.asarray(jq.w, np.float32))
    got = _port_logits(cfg, dense, IDS)
    want = _jax_logits(jcfg, jdense, IDS)
    assert np.abs(got - want).max() <= LOGITS_TOL * np.abs(want).max()
    _, quant, r2 = tloader.load_model(base_model, "cpu")
    r2.close()
    assert np.abs(got - _port_logits(cfg, quant, IDS)).max() <= LOGITS_TOL * np.abs(got).max()
    with pytest.raises(ValueError, match="mode"):
        tloader.load_model(base_model, "cpu", mode="fp8")


def test_dense_engine_matches_jax_engine(base_model):
    """An engine with ``mode="dense"`` gives the JAX engine's greedy tokens
    in the same mode on the same prompt."""
    eng = tengine.InferenceEngine(base_model, tengine.EngineConfig(
        max_slots=1, ctx=64, mode="dense"), device="cpu")
    assert isinstance(eng.params["layers"][0]["attn_qkv"], DenseLinear)
    got = _tokens(eng)
    jeng = jengine.InferenceEngine(base_model, jengine.EngineConfig(
        max_slots=1, ctx=64, mode="dense", prefill_buckets=(16, 32)))
    jeng.start()
    try:
        ids = jeng.tokenizer.encode("hello world")
        want = [e.token_id for e in jeng.generate(ids, JParams(temperature=0.0, max_tokens=8))]
    finally:
        jeng.stop()
    assert got == want


def test_synth_lora_parses(tmp_path):
    """The synthesizer's adapter for a shape: rank, alpha and every
    projection of every kept layer and the head, the shapes the model's
    weights have."""
    p = synth.synth_lora(str(tmp_path / "a.gguf"), "160m", rank=4, alpha=8.0, n_layers=2)
    alpha, pairs = tlora.load_adapter(p, arch="llama")
    d = synth.SHAPES["160m"]
    kv = d["n_kv_heads"] * d["dim"] // d["n_heads"]
    assert alpha == 8.0 and len(pairs) == 2 * 7 + 1
    assert pairs["blk.1.attn_k.weight"][1].shape == (kv, 4)
    assert pairs["blk.0.ffn_down.weight"][0].shape == (4, d["ffn_dim"])
    assert pairs["output.weight"][1].shape == (d["vocab"], 4)
