"""The Q2_K slice of the port against the JAX package, on the CPU: loader,
forward and engine over two tiny llama GGUFs (dim 512, ffn 1024, so every
projection's in_features is a multiple of 512 and the JAX package takes its
qsplit kernel), under the ``auto`` and ``mixed`` scale layouts, and the
Q2_K synthesizer against ``bench.py``.

- ``q2k``: Q2_K embedding and projections, Q6_K head;
- ``q2k_mix``: llama.cpp's Q2_K mix, Q2_K q/k/gate/up and embedding, Q4_K v,
  Q3_K o/down, Q6_K head.

Tolerances, as in ``test_torch_model.py``: with its Pallas kernels forced on
(interpret mode) the JAX forward computes the port's function up to f32 sum
order and the bf16 roundings that order flips (0.5% of the logits' scale,
measured 0.35-0.38%); its XLA path dequantizes each weight to bf16(q·s − m)
where the kernels round bf16(q·s) and subtract the min term in f32 (3%).
Both sides' logits are bf16, so one flipped rounding of a logit near the
largest costs 2⁻⁸ to 2⁻⁷ of the scale; the JAX package's own flat and mixed
forwards of one model differ by that much. The weights are drawn small
enough (0.04 per layer) that such flips stay single. The port's engine
and its one-sequence forward group rows differently: each token the engine
chose lies within 1.5% of the logits' scale of the forward's largest logit.
"""

import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.gguf.constants import GGMLType, Keys
from llama_gguf_inference_tpu.gguf.writer import GGUFWriter
from llama_gguf_inference_tpu.ops import matmul_kernels as jmk
from llama_gguf_inference_tpu.runtime import loader as jloader
from llama_gguf_inference_tpu.utils.testing import make_tiny_vocab
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime import loader as tloader
from llama_gguf_inference_tpu_torch.runtime.convert import params_from_numpy
from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
from test_torch_model import _assert_same, _jax_logits, to_numpy_tree

torch.set_num_threads(1)

DIM, LAYERS, HEADS, KV_HEADS, FFN, VOCAB = 512, 2, 8, 4, 1024, 512
Q2, Q3, Q4, Q6 = GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q6_K
MIXES = {
    "q2k": dict(embd=Q2, q=Q2, k=Q2, v=Q2, o=Q2, gate=Q2, up=Q2, down=Q2),
    "q2k_mix": dict(embd=Q2, q=Q2, k=Q2, v=Q4, o=Q3, gate=Q2, up=Q2, down=Q3),
}
IDS = np.array([1, 300, 311, 290, 305, 17, 400, 263], np.int32)


def write_tiny_lowbit(path, mix, seed=0):
    """dim 512, 2 layers, 8 heads over 4 KV heads, ffn 1024, vocab 512, the
    tensor types of ``MIXES[mix]``, a Q6_K head, random f32 norms."""
    t = MIXES[mix]
    rng = np.random.default_rng(seed)
    tokens, scores, types = make_tiny_vocab()
    tokens += [f"<extra_{i}>" for i in range(len(tokens), VOCAB)]
    scores += [-1e6] * (VOCAB - len(scores))
    types += [5] * (VOCAB - len(types))
    w = GGUFWriter(path)
    w.add(Keys.ARCHITECTURE, "llama")
    w.add(Keys.NAME, f"tiny-{mix}")
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

    def rand(*shape, s=0.04):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm():
        return (1.0 + rand(DIM, s=0.1)).astype(np.float32)

    hd = DIM // HEADS
    w.add_tensor("token_embd.weight", rand(VOCAB, DIM, s=1.0), t["embd"])
    for i in range(LAYERS):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", norm(), GGMLType.F32)
        w.add_tensor(p + "attn_q.weight", rand(HEADS * hd, DIM), t["q"])
        w.add_tensor(p + "attn_k.weight", rand(KV_HEADS * hd, DIM), t["k"])
        w.add_tensor(p + "attn_v.weight", rand(KV_HEADS * hd, DIM), t["v"])
        w.add_tensor(p + "attn_output.weight", rand(DIM, DIM), t["o"])
        w.add_tensor(p + "ffn_norm.weight", norm(), GGMLType.F32)
        w.add_tensor(p + "ffn_gate.weight", rand(FFN, DIM), t["gate"])
        w.add_tensor(p + "ffn_up.weight", rand(FFN, DIM), t["up"])
        w.add_tensor(p + "ffn_down.weight", rand(DIM, FFN), t["down"])
    w.add_tensor("output_norm.weight", norm(), GGMLType.F32)
    w.add_tensor("output.weight", rand(VOCAB, DIM, s=0.38), Q6)
    return w.write()


@pytest.fixture(scope="module", params=[(m, lay) for m in MIXES for lay in ("auto", "mixed")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def models(request, tmp_path_factory):
    """(mix, layout, path, JAX cfg and params, port cfg and params), both
    loaded under ``LGT_SCALE_LAYOUT=layout``."""
    mix, layout = request.param
    path = str(write_tiny_lowbit(tmp_path_factory.mktemp(mix) / f"{mix}.gguf", mix))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGT_SCALE_LAYOUT", layout)
        jcfg, jparams, _ = jloader.load_model(path, fuse=True)
        tcfg, tparams, _ = tloader.load_model(path, device="cpu")
    return mix, layout, path, jcfg, jparams, tcfg, tparams


def test_load_model_equals_converted_jax_params(models):
    mix, layout, _, jcfg, jparams, tcfg, tparams = models
    layer = tparams["layers"][0]
    # v is Q4_K in the mix, so q/k/v cannot fuse there
    assert ("attn_qkv" in layer) == (mix == "q2k") and "ffn_gateup" in layer
    w2 = layer["ffn_gateup"]
    assert (w2.fmt, w2.bits, w2.min_size) == ("q2_k", 2, 256 if layout == "mixed" else 0)
    assert tparams["tok_embd"].table.fmt == "q2_k"
    _assert_same(tparams, params_from_numpy(to_numpy_tree(jparams), "cpu"))


@pytest.mark.parametrize("jax_path,tol", [("pallas", 0.005), ("xla", 0.03)])
def test_forward_matches_jax(models, jax_path, tol, monkeypatch):
    mix, _, _, jcfg, jparams, tcfg, tparams = models
    if jax_path == "pallas":   # the Pallas kernels, in interpret mode
        monkeypatch.setattr(jmk, "_on_tpu", lambda: True)
        monkeypatch.setenv("LGT_FORCE_FLASH", "1")
    want = _jax_logits(jcfg, jparams, IDS, 32)
    _build.reset_launches()
    cache = tllama.KVCache.zeros(tcfg, 1, 32, "cpu")
    with torch.inference_mode():
        got = tllama.forward(tparams, tcfg, torch.from_numpy(IDS[None]),
                             torch.zeros(1, dtype=torch.int32), cache)[0].numpy()
    assert got.shape == (8, VOCAB)
    assert _build.LAUNCHES[qm.NAME_2BIT + ".plain"] > 0
    assert (_build.LAUNCHES.get(qm.NAME_4BIT + ".plain", 0) > 0) == (mix == "q2k_mix")
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale


def test_engine_greedy_agrees_with_forward(models, monkeypatch):
    _, layout, path, _, _, tcfg, tparams = models
    monkeypatch.setenv("LGT_SCALE_LAYOUT", layout)
    eng = tengine.InferenceEngine(path, tengine.EngineConfig(max_slots=2, ctx=64),
                                  device="cpu")
    prompt = "hello world"
    eng.start()
    try:
        toks = [ev.token_id for ev in eng.generate(
            prompt, SamplingParams(temperature=0.0, max_tokens=6))]
    finally:
        eng.stop()
    assert len(toks) == 6
    ids = eng.tokenizer.encode(prompt)
    cache = tllama.KVCache.zeros(tcfg, 1, 64, "cpu")
    with torch.inference_mode():
        lg = tllama.forward(tparams, tcfg, torch.tensor([ids], dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32), cache)[0, -1]
        for i, t in enumerate(toks):
            assert lg.max() - lg[t] <= 0.015 * lg.abs().max(), (i, t)
            lg = tllama.forward(tparams, tcfg, torch.tensor([[t]], dtype=torch.int32),
                                torch.tensor([len(ids) + i], dtype=torch.int32), cache)[0, 0]


def test_synth_q2k_matches_bench(tmp_path, monkeypatch):
    import bench
    from llama_gguf_inference_tpu_torch.tools.synth import synth_model
    monkeypatch.setenv("BENCH_MODEL", str(tmp_path / "bench.gguf"))
    want = bench.bench_model_path("160m", "q2_k")
    got = synth_model(str(tmp_path / "synth.gguf"), "160m", quant="q2_k")
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="q5_k"):
        synth_model(str(tmp_path / "x.gguf"), "160m", quant="q5_k")
