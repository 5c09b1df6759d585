"""The Q5_K slice of the port against the JAX package, on the CPU: loader,
forward and engine over two tiny llama GGUFs (dim 512, ffn 1024), under the
``auto`` (compact) and ``flat`` scale layouts, the Q5_K synthesizer against
``bench.py``, and the Q4_K_M and Q2_K models' forwards under each
``LGT_MM_VARIANT``.

- ``q5k``: Q5_K embedding and projections, Q6_K head;
- ``q5k_m``: llama.cpp's Q5_K_M mix, Q6_K ``attn_v`` and ``ffn_down`` in
  layer 0 (so its q/k/v cannot fuse), Q5_K elsewhere, Q6_K head.

Tolerances, as in ``test_torch_model.py``: with its Pallas kernels forced on
(interpret mode) the JAX forward computes the port's function up to f32 sum
order and the bf16 roundings that order flips (0.5% of the logits' scale).
The 8-bit base body decodes each weight as ``dequantize_bm`` does, so the
JAX package's XLA path computes the same function too, to the same 0.5%.
Under a variant, the port and the JAX package run the same body (each
matmul of the tiny Q4_K model agrees to 5e-7 of its scale), but the logits
are bf16: one rounding that an f32 sum order flips, on a logit near the
largest, costs one bf16 ulp, up to 2⁻⁷ of the scale (measured: xsum 0.61%,
split and int8 0.31%, Q2_K under base 0.38%), so those forwards are held to
2⁻⁷. The 4-bit models' XLA path is not compared here (``test_torch_model.py``
and ``test_torch_model_lowbit.py`` do). The
port's engine and its one-sequence forward group rows differently: each
token the engine chose lies within 1.5% of the logits' scale of the
forward's largest logit.
"""

import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.gguf.constants import GGMLType
from llama_gguf_inference_tpu.ops import matmul_kernels as jmk
from llama_gguf_inference_tpu.ops import pallas_matmul as jpm
from llama_gguf_inference_tpu.runtime import loader as jloader
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime import loader as tloader
from llama_gguf_inference_tpu_torch.runtime.convert import params_from_numpy
from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
from test_torch_model import _assert_same, _jax_logits, to_numpy_tree
from test_torch_model_lowbit import write_tiny_lowbit

torch.set_num_threads(1)

Q5, Q6 = GGMLType.Q5_K, GGMLType.Q6_K
MIXES = {   # a list gives one type per layer
    "q5k": dict(embd=Q5, q=Q5, k=Q5, v=Q5, o=Q5, gate=Q5, up=Q5, down=Q5),
    "q5k_m": dict(embd=Q5, q=Q5, k=Q5, v=[Q6, Q5], o=Q5, gate=Q5, up=Q5, down=[Q6, Q5]),
}
VOCAB = 512
IDS = np.array([1, 300, 311, 290, 305, 17, 400, 263], np.int32)


@pytest.fixture(scope="module", params=[(m, lay) for m in ("q5k", "q5k_m")
                                        for lay in ("auto", "flat")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def models(request, tmp_path_factory):
    """(mix, layout, path, JAX cfg and params, port cfg and params), both
    loaded under ``LGT_SCALE_LAYOUT=layout``."""
    mix, layout = request.param
    path = str(write_tiny_lowbit(tmp_path_factory.mktemp(mix) / f"{mix}.gguf", mix,
                                 tensor_types=MIXES[mix]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGT_SCALE_LAYOUT", layout)
        jcfg, jparams, _ = jloader.load_model(path, fuse=True)
        tcfg, tparams, _ = tloader.load_model(path, device="cpu")
    return mix, layout, path, jcfg, jparams, tcfg, tparams


def test_load_model_equals_converted_jax_params(models):
    mix, layout, _, jcfg, jparams, tcfg, tparams = models
    l0, l1 = tparams["layers"]
    # the Q6_K v of layer 0 in the mix keeps its q/k/v apart
    assert ("attn_qkv" in l0) == (mix == "q5k") and "attn_qkv" in l1
    assert "ffn_gateup" in l0 and "ffn_gateup" in l1
    w = l1["attn_qkv"]
    assert (w.fmt, w.bits, w.dmin is not None) == ("q5_k", 8, True)
    assert (w.sc is not None) == (layout == "auto")
    assert l0["ffn_down"].fmt == ("q6_k" if mix == "q5k_m" else "q5_k")
    assert tparams["tok_embd"].table.fmt == "q5_k"
    _assert_same(tparams, params_from_numpy(to_numpy_tree(jparams), "cpu"))


@pytest.mark.parametrize("jax_path", ["pallas", "xla"])
def test_forward_matches_jax(models, jax_path, monkeypatch):
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
    assert _build.LAUNCHES[qm.NAME_8BIT_MIN + ".plain"] > 0      # Q5_K projections
    assert _build.LAUNCHES[qm.NAME_8BIT + ".plain"] > 0          # Q6_K head (and mix)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.005 * scale


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


def test_synth_q5k_matches_bench(tmp_path, monkeypatch):
    import bench
    from llama_gguf_inference_tpu_torch.tools.synth import synth_model
    monkeypatch.setenv("BENCH_MODEL", str(tmp_path / "bench.gguf"))
    want = bench.bench_model_path("160m", "q5_k")
    got = synth_model(str(tmp_path / "synth.gguf"), "160m", quant="q5_k")
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def q4km(tmp_path_factory):
    Q4 = GGMLType.Q4_K
    path = str(write_tiny_lowbit(tmp_path_factory.mktemp("q4km") / "q4km.gguf", "q4k",
                                 tensor_types=dict(embd=Q4, q=Q4, k=Q4, v=Q4, o=Q4,
                                                   gate=Q4, up=Q4, down=Q4)))
    jcfg, jparams, _ = jloader.load_model(path, fuse=True)
    tcfg, tparams, _ = tloader.load_model(path, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def q2k_mixed(tmp_path_factory):
    path = str(write_tiny_lowbit(tmp_path_factory.mktemp("q2k") / "q2k.gguf", "q2k"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGT_SCALE_LAYOUT", "mixed")
        jcfg, jparams, _ = jloader.load_model(path, fuse=True)
        tcfg, tparams, _ = tloader.load_model(path, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _variant_forward(monkeypatch, variant, model, names):
    """Both forwards under ``variant``, the JAX one on its Pallas kernels
    (a spy collects which bodies it ran), the port's launches counted."""
    jcfg, jparams, tcfg, tparams = model
    monkeypatch.setenv("LGT_MM_VARIANT", variant)
    monkeypatch.setattr(jmk, "_on_tpu", lambda: True)
    monkeypatch.setenv("LGT_FORCE_FLASH", "1")
    bodies = set()
    for name, tag in (("_quant_matmul_2d", "base"), ("_quant_matmul_2d_int8", "int8"),
                      ("_quant_matmul_2d_xsum", None)):
        real = getattr(jpm, name)

        def fn(*a, _real=real, _tag=tag, **k):
            bodies.add(_tag or k.get("kern"))
            return _real(*a, **k)
        monkeypatch.setattr(jpm, name, fn)
    want = _jax_logits(jcfg, jparams, IDS, 32)
    _build.reset_launches()
    cache = tllama.KVCache.zeros(tcfg, 1, 32, "cpu")
    with torch.inference_mode():
        got = tllama.forward(tparams, tcfg, torch.from_numpy(IDS[None]),
                             torch.zeros(1, dtype=torch.int32), cache)[0].numpy()
    for n in names:
        assert _build.LAUNCHES.get(n + ".plain", 0) > 0, (n, _build.LAUNCHES)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2 ** -7 * scale
    return bodies, dict(_build.LAUNCHES)


@pytest.mark.parametrize("variant,name", [
    ("base", qm.NAME_4BIT_BASE), ("xsum", qm.NAME_4BIT_XSUM),
    ("split", qm.NAME_4BIT_SPLIT), ("int8", qm.NAME_4BIT_INT8)])
def test_q4km_forward_under_each_variant(q4km, variant, name, monkeypatch):
    """The Q4_K_M model's Q4_K projections take the variant's body in both
    packages; the Q6_K head stays on the 8-bit branch; fsplit never runs."""
    bodies, launches = _variant_forward(monkeypatch, variant, q4km, [name, qm.NAME_8BIT])
    assert bodies == {variant} | {"base"}
    assert qm.NAME_4BIT + ".plain" not in launches


def test_q2k_forward_under_base(q2k_mixed, monkeypatch):
    """The mixed-layout Q2_K model under ``base``: its projections take the
    dequantize path in both packages (``matmul_xla`` in JAX), the Q6_K head
    the 8-bit branch."""
    _, launches = _variant_forward(monkeypatch, "base", q2k_mixed, [qm.NAME_8BIT])
    assert launches.get(qm.NAME_DEQUANT, 0) > 0
    assert not any(n.startswith(qm.NAME_2BIT) for n in launches)
