"""The dense architectures in the port, on the CPU, against the JAX package:
qwen2, qwen3, gemma, gemma2, gemma3, phi3, starcoder2, granite, command-r
and olmo2.

- ``ModelConfig.from_gguf_metadata`` field by field against the JAX
  package's, for every architecture's tiny file, gemma2's 46-layer and
  gemma3's 62-layer scale rules, phi3's longrope and window, a yarn file;
- loader + forward: each architecture's tiny GGUF (the JAX package's
  ``write_tiny_llama``, Q8_0 and F32; gemma2/gemma3 with a window of 8;
  phi3 rewritten with its QKV and gate+up fused, a window of 8 and longrope
  factors) loaded by both packages and run over a 20-token prefill, longer
  than the window, then 3 decode steps fed the same tokens, on the bf16,
  q8_0 and paged bf16 caches of each package. The JAX forward on the CPU
  computes every layer on its XLA path; the port's runs the plain version of
  the flash kernel on global layers and ``masked_attention`` on sliding or
  softcapped ones. Both read the same Q8_0 codes; logits within 2% of
  their scale. Measured: 0.3% at most on the bf16 and paged caches (f32 sum
  order where the port fuses Q/K/V and gate+up, and the bf16 roundings that
  order flips); up to 1.3% on q8_0, whose global layers the JAX package's
  CPU path reads dequantized to bf16 and the port's plain flash version in
  f32 (its sliding and softcapped layers read the bf16 view in both);
- where ``transformers`` is installed, the HF argmax chain of the JAX
  package's ``tests/test_archs.py`` through the JAX package's converter;
- ``ctx_shift`` refused for sliding-window and longrope models, and the neox
  shift of a qwen2 cache against the JAX package's ``shift_cache_slot``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.gguf.constants import GGMLType as JGGMLType
from llama_gguf_inference_tpu.models import llama as jllama
from llama_gguf_inference_tpu.models.config import ModelConfig as JConfig
from llama_gguf_inference_tpu.runtime import kv_cache as jkv
from llama_gguf_inference_tpu.runtime import paged_kv as jpaged
from llama_gguf_inference_tpu.runtime.loader import load_model as jload
from llama_gguf_inference_tpu.utils.testing import write_tiny_llama
from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
from llama_gguf_inference_tpu_torch.gguf.reader import GGUFReader
from llama_gguf_inference_tpu_torch.gguf.writer import GGUFWriter
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.models.config import ModelConfig as TConfig
from llama_gguf_inference_tpu_torch.runtime import kv_cache as tkv
from llama_gguf_inference_tpu_torch.runtime import paged_kv as tpaged
from llama_gguf_inference_tpu_torch.runtime.loader import load_model as tload

torch.set_num_threads(1)

ARCHES = ["qwen2", "qwen3", "gemma", "gemma2", "gemma3", "phi3", "starcoder2",
          "granite", "command-r", "olmo2"]
WINDOW = 8
PREFILL, STEPS = 20, 3
S, PAGE_S = 64, 16
LOGITS_TOL = 0.02
CACHES = ["bf16", "q8_0", "paged"]


def _rewrite(src, dst, extra_md=None, fuse=False, tensors=None):
    """Copy the GGUF ``src`` to ``dst`` with ``extra_md`` keys, ``tensors``
    (name -> f32 array) added and, with ``fuse``, each layer's Q/K/V rows
    joined into ``attn_qkv`` and gate+up into a double-height ``ffn_up`` (as
    phi3's converter writes them; row-major blocks join by bytes)."""
    r = GGUFReader(src)
    w = GGUFWriter(dst)
    for k, v in r.metadata.items():
        if not k.startswith("GGUF."):
            w.add(k, v)
    for k, v in (extra_md or {}).items():
        w.add(k, v)
    names = list(r.tensors)
    groups = {}
    if fuse:
        for n in names:
            for parts, into in ((("attn_q", "attn_k", "attn_v"), "attn_qkv"),
                                (("ffn_gate", "ffn_up"), "ffn_up")):
                pre, _, base = n.rpartition(".weight")[0].rpartition(".")
                if base in parts:
                    groups.setdefault(f"{pre}.{into}.weight", []).append(n)
    done = set()
    for n in names:
        grp = next((g for g, ms in groups.items() if n in ms), None)
        if grp is None:
            info = r.tensors[n]
            w.add_raw_tensor(n, tuple(reversed(info.shape)), info.ggml_type,
                             bytes(r.tensor_bytes(n)))
            continue
        if grp in done:
            continue
        done.add(grp)
        infos = [r.tensors[m] for m in groups[grp]]
        rows = sum(i.shape[0] for i in infos)
        w.add_raw_tensor(grp, (infos[0].shape[1], rows), infos[0].ggml_type,
                         b"".join(bytes(r.tensor_bytes(m)) for m in groups[grp]))
    for n, a in (tensors or {}).items():
        w.add_tensor(n, a, GGMLType.F32)
    r.close()
    w.write()
    return dst


def _phi3_extras(head_dim=16):
    half = head_dim // 2
    md = {"phi3.attention.sliding_window": WINDOW, "phi3.rope.scaling.type": "longrope",
          "phi3.rope.scaling.original_context_length": 32, "phi3.context_length": 256}
    ts = {"rope_factors_short.weight": np.array([1.0 + 0.05 * i for i in range(half)],
                                                np.float32),
          "rope_factors_long.weight": np.array([2.0 + 0.1 * i for i in range(half)],
                                               np.float32)}
    return md, ts


def tiny(arch, tmp_path, quant=JGGMLType.Q8_0, seed=0):
    path = tmp_path / f"{arch}-{quant.name}.gguf"
    window = WINDOW if arch in ("gemma2", "gemma3") else 0
    write_tiny_llama(path, dim=64, n_layers=7 if arch == "gemma3" else 2, n_heads=4,
                     n_kv_heads=2, ffn_dim=128, quant=quant, seed=seed, arch=arch,
                     sliding_window=window, tie_output=arch == "starcoder2")
    if arch == "phi3":
        md, ts = _phi3_extras()
        return _rewrite(path, tmp_path / f"phi3-fused-{quant.name}.gguf", md, True, ts)
    return path


# -- config -------------------------------------------------------------------

def _same_config(md):
    t = TConfig.from_gguf_metadata(md)
    j = JConfig.from_gguf_metadata(md)
    for f in TConfig.__dataclass_fields__:
        a, b = getattr(t, f), getattr(j, f)
        assert a == b, (f, a, b)
    for i in range(t.n_layers):
        assert t.is_sliding(i) == j.is_sliding(i), i
    return t


@pytest.mark.parametrize("arch", ARCHES)
def test_config_matches_jax(arch, tmp_path):
    r = GGUFReader(tiny(arch, tmp_path))
    cfg = _same_config(r.metadata)
    r.close()
    assert cfg.arch == arch
    assert cfg.rope_interleaved == (arch in ("granite", "command-r"))


@pytest.mark.parametrize("case", ["gemma2-27b", "gemma2-9b", "gemma3-27b", "gemma3-12b",
                                  "gemma3-scalar", "phi3-longrope", "yarn",
                                  "gemma3-linear8"])
def test_config_scale_rules_match_jax(case):
    """The per-size rules llama.cpp applies without a key for them, and the
    rope scalings, as metadata alone."""
    arch = "qwen2" if case == "yarn" else case.split("-")[0]
    md = {"general.architecture": arch, f"{arch}.embedding_length": 3840,
          f"{arch}.block_count": 48, f"{arch}.attention.head_count": 16,
          f"{arch}.attention.head_count_kv": 8, f"{arch}.attention.key_length": 256,
          f"{arch}.feed_forward_length": 15360, f"{arch}.vocab_size": 262208}
    if case == "gemma2-27b":
        md.update({"gemma2.embedding_length": 4608, "gemma2.block_count": 46,
                   "gemma2.attention.head_count": 32, "gemma2.attention.key_length": 128})
    if case == "gemma3-27b":
        md.update({"gemma3.embedding_length": 5376, "gemma3.block_count": 62,
                   "gemma3.attention.head_count": 32, "gemma3.attention.key_length": 128})
    if case == "gemma3-scalar":
        md["gemma3.attention.query_pre_attn_scalar"] = 64.0
    if case == "gemma3-linear8":
        md.update({"gemma3.rope.scaling.type": "linear", "gemma3.rope.scaling.factor": 8.0,
                   "gemma3.rope.freq_base": 1e6, "gemma3.rope.local_freq_base": 1e4,
                   "gemma3.attention.sliding_window": 1024})
    if case == "phi3-longrope":
        md.update({"phi3.rope.scaling.type": "longrope", "phi3.context_length": 131072,
                   "phi3.rope.scaling.original_context_length": 4096,
                   "phi3.attention.sliding_window": 262144})
    if case == "yarn":
        md.update({"qwen2.rope.scaling.type": "yarn", "qwen2.rope.scaling.factor": 4.0,
                   "qwen2.rope.scaling.original_context_length": 32768})
    cfg = _same_config(md)
    if case == "gemma2-27b":
        assert cfg.attn_scale == pytest.approx((4608 / 32) ** -0.5)
    if case == "gemma3-27b":
        assert cfg.attn_scale == pytest.approx((5376 / 32) ** -0.5)
    if case == "gemma3-12b":
        assert cfg.attn_scale == 0.0 and cfg.swa_pattern == 6
        assert [cfg.is_sliding(i) for i in range(6)] == [True] * 5 + [False]
    if case == "phi3-longrope":
        assert cfg.rope_attn_factor == pytest.approx(
            math.sqrt(1 + math.log(131072 / 4096) / math.log(4096)))


def test_yarn_and_longrope_angles_match_jax():
    pos = np.array([[0, 5, 1000, 9000]], np.int32)
    ff = np.linspace(1.0, 3.0, 32).astype(np.float32)
    for kw, factors in ((dict(rope_scaling_type="yarn", rope_scaling_factor=4.0,
                              rope_orig_ctx=4096), None),
                        (dict(rope_scaling_type="longrope", rope_attn_factor=1.19,
                              rope_orig_ctx=4096), ff)):
        jc, tc = JConfig(**kw), TConfig(**kw)
        jcos, jsin = jllama.rope_angles(jnp.asarray(pos), 64, 64, 10000.0, jc,
                                        None if factors is None else jnp.asarray(factors))
        tcos, tsin = tllama.rope_angles(torch.from_numpy(pos), 64, 10000.0, tc,
                                        None if factors is None else torch.from_numpy(factors))
        assert np.allclose(tcos.numpy(), np.asarray(jcos), atol=2e-3), kw
        assert np.allclose(tsin.numpy(), np.asarray(jsin), atol=2e-3), kw


# -- loader + forward -----------------------------------------------------------

def _caches(kind, jcfg, tcfg):
    """One sequence's cache in each package: contiguous of S slots, or a
    paged pool of S / PAGE_S pages through a shuffled table."""
    if kind == "bf16":
        return jllama.KVCache.zeros(jcfg, 1, S), tllama.KVCache.zeros(tcfg, 1, S, "cpu")
    if kind == "q8_0":
        return jkv.QuantKV.zeros(jcfg, 1, S), tkv.QuantKV.zeros(tcfg, 1, S, "cpu")
    npages = S // PAGE_S
    table = np.random.default_rng(1).permutation(npages).astype(np.int32)[None]
    jc = jpaged.PagedKV.zeros(jcfg, 1, npages, PAGE_S)._replace(page_table=jnp.asarray(table))
    tc = tpaged.PagedKV.zeros(tcfg, 1, npages, PAGE_S, "cpu")
    tc.page_table.copy_(torch.from_numpy(table))
    return jc, tc


def _run_both(path, kind, ids, prefill=PREFILL):
    jcfg, jp, jr = jload(path, mode="quant", fuse=True)
    jr.close()
    tcfg, tp, tr = tload(path, device="cpu")
    tr.close()
    jc, tc = _caches(kind, jcfg, tcfg)
    errs = []
    with torch.inference_mode():
        for off, chunk in [(0, ids[:prefill])] + [(prefill + i, ids[prefill + i:prefill + i + 1])
                                                  for i in range(STEPS)]:
            tok = np.asarray([chunk], np.int32)
            want, jc = jllama.forward(jp, jcfg, jnp.asarray(tok), jnp.full(1, off, jnp.int32),
                                      jc, jnp.full(1, tok.shape[1], jnp.int32))
            got = tllama.forward(tp, tcfg, torch.from_numpy(tok),
                                 torch.full((1,), off, dtype=torch.int32), tc)
            want = np.asarray(want)
            assert got.shape == want.shape and np.isfinite(got.numpy()).all()
            errs.append(np.abs(got.numpy() - want).max() / np.abs(want).max())
    return tcfg, tp, errs


@pytest.mark.parametrize("kind", CACHES)
@pytest.mark.parametrize("arch", ARCHES)
def test_forward_matches_jax(arch, kind, tmp_path):
    ids = np.random.default_rng(3).integers(3, 250, PREFILL + STEPS).tolist()
    cfg, params, errs = _run_both(tiny(arch, tmp_path), kind, ids)
    assert max(errs) <= LOGITS_TOL, errs
    layer = params["layers"][0]
    if arch == "phi3":
        assert cfg.sliding_window == WINDOW and cfg.rope_scaling_type == "longrope"
        assert "rope_factors_short" in params and "ffn_gateup" in layer
    if arch in ("qwen2",):
        assert "attn_qkv" in layer and "attn_qkv_bias" in layer
    if arch == "olmo2":
        assert "attn_q" in layer and "attn_norm" not in layer     # flat q/k norms: unfused
    if arch == "gemma3":
        assert [cfg.is_sliding(i) for i in range(7)] == [True] * 5 + [False, True]


@pytest.mark.parametrize("arch", ["gemma2", "gemma3", "qwen3", "starcoder2"])
def test_forward_f32_matches_jax(arch, tmp_path):
    """The same over F32 projections (bf16 ``DenseLinear`` in both)."""
    ids = np.random.default_rng(4).integers(3, 250, PREFILL + STEPS).tolist()
    _, _, errs = _run_both(tiny(arch, tmp_path, JGGMLType.F32), "bf16", ids)
    assert max(errs) <= LOGITS_TOL, errs


def test_yarn_file_matches_jax(tmp_path):
    """A qwen2 file rewritten with yarn scaling (factor 4 over an original
    context of 16, so the 23 positions run past it): config and forward."""
    path = _rewrite(tiny("qwen2", tmp_path), tmp_path / "yarn.gguf",
                    {"qwen2.rope.scaling.type": "yarn", "qwen2.rope.scaling.factor": 4.0,
                     "qwen2.rope.scaling.original_context_length": 16})
    r = GGUFReader(path)
    cfg = _same_config(r.metadata)
    r.close()
    assert (cfg.rope_scaling_type, cfg.rope_orig_ctx) == ("yarn", 16)
    ids = np.random.default_rng(6).integers(3, 250, PREFILL + STEPS).tolist()
    _, _, errs = _run_both(path, "bf16", ids)
    assert max(errs) <= LOGITS_TOL, errs


def test_sliding_layers_take_masked_attention(tmp_path, monkeypatch):
    """gemma3's sliding layers go to ``masked_attention`` with the window,
    its global layer to the cache's flash wrapper; gemma2's softcap sends
    every layer to ``masked_attention``."""
    calls = []
    real = tllama.masked_attention
    monkeypatch.setattr(tllama, "masked_attention",
                        lambda *a, **k: calls.append(("masked", a[4], a[5])) or real(*a, **k))
    real_attend = tllama.KVCache.attend
    monkeypatch.setattr(tllama.KVCache, "attend",
                        lambda self, *a: calls.append(("flash",)) or real_attend(self, *a))
    for arch, want in (("gemma3", [("masked", WINDOW, 0.0)] * 5 + [("flash",)]
                        + [("masked", WINDOW, 0.0)]),
                       ("gemma2", [("masked", WINDOW, 50.0), ("masked", 0, 50.0)])):
        calls.clear()
        cfg, p, r = tload(tiny(arch, tmp_path), device="cpu")
        r.close()
        tllama.forward(p, cfg, torch.ones((1, 4), dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32), tllama.KVCache.zeros(cfg, 1, 16, "cpu"))
        assert calls == want, arch


def test_loader_requires_pre_norms(tmp_path):
    """A qwen2 file without a block's ffn_norm fails at load, naming it;
    olmo2 and command-r load without theirs."""
    path = tiny("qwen2", tmp_path)
    r = GGUFReader(path)
    w = GGUFWriter(tmp_path / "cut.gguf")
    for k, v in r.metadata.items():
        if not k.startswith("GGUF."):
            w.add(k, v)
    for n, info in r.tensors.items():
        if n != "blk.1.ffn_norm.weight":
            w.add_raw_tensor(n, tuple(reversed(info.shape)), info.ggml_type,
                             bytes(r.tensor_bytes(n)))
    r.close()
    w.write()
    with pytest.raises(KeyError, match="blk.1.ffn_norm"):
        tload(tmp_path / "cut.gguf", device="cpu")


# -- HF parity (the JAX package's test_archs.py chains) -------------------------

def _hf_parity(model, tmp_path, n_tokens=12, atol=0.35):
    from llama_gguf_inference_tpu.tools.convert_hf import convert
    hf = tmp_path / "hf"
    model.eval()
    model.save_pretrained(hf, safe_serialization=False)
    dst = tmp_path / "converted.gguf"
    convert(str(hf), str(dst), dtype="f32", verbose=False)
    cfg, params, r = tload(dst, device="cpu", mode="dense")
    r.close()
    ids = np.random.default_rng(7).integers(5, 250, size=(1, n_tokens)).astype(np.int64)
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).logits.float().numpy()[0]
        got = tllama.forward(params, cfg, torch.from_numpy(ids.astype(np.int32)),
                             torch.zeros(1, dtype=torch.int32),
                             tllama.KVCache.zeros(cfg, 1, 32, "cpu"))[0].numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=atol)
    return cfg


def _hf_model(name):
    """(torch seed, the model's factory, prompt tokens) of the JAX package's
    HF parity test for ``name``."""
    transformers = pytest.importorskip("transformers")
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                rope_theta=10000.0)
    if name == "qwen2":
        return 1, lambda: transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            **base, rms_norm_eps=1e-5, tie_word_embeddings=False)), 12
    if name == "qwen3":
        return 2, lambda: transformers.Qwen3ForCausalLM(transformers.Qwen3Config(
            **base, head_dim=16, rms_norm_eps=1e-5, tie_word_embeddings=False)), 12
    if name == "gemma2":
        return 3, lambda: transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
            **base, head_dim=16, query_pre_attn_scalar=16, sliding_window=8,
            attn_logit_softcapping=50.0, final_logit_softcapping=30.0, rms_norm_eps=1e-5,
            attn_implementation="eager")), 14
    if name in ("gemma3", "gemma3-scalar"):
        layers = 7 if name == "gemma3" else 2
        return (6 if name == "gemma3" else 10), lambda: transformers.Gemma3ForCausalLM(
            transformers.Gemma3TextConfig(
                **{**base, "num_hidden_layers": layers, "rope_theta": 1_000_000.0},
                head_dim=16, query_pre_attn_scalar=16 if name == "gemma3" else 64,
                sliding_window=8, sliding_window_pattern=6, rope_local_base_freq=10000.0,
                rms_norm_eps=1e-5, attn_implementation="eager")), \
            14 if name == "gemma3" else 10
    if name == "starcoder2":
        return 7, lambda: transformers.Starcoder2ForCausalLM(transformers.Starcoder2Config(
            **base, norm_epsilon=1e-5, use_bias=True, tie_word_embeddings=True)), 12
    if name == "granite":
        return 21, lambda: transformers.GraniteForCausalLM(transformers.GraniteConfig(
            **base, rms_norm_eps=1e-5, embedding_multiplier=12.0, residual_multiplier=0.22,
            attention_multiplier=0.0156, logits_scaling=8.0, tie_word_embeddings=False,
            attn_implementation="eager")), 12
    if name == "command-r":
        return 22, lambda: transformers.CohereForCausalLM(transformers.CohereConfig(
            **base, layer_norm_eps=1e-5, logit_scale=0.25, use_qk_norm=False,
            tie_word_embeddings=True, attn_implementation="eager")), 12
    if name == "olmo2":
        return 24, lambda: transformers.Olmo2ForCausalLM(transformers.Olmo2Config(
            **base, rms_norm_eps=1e-5, tie_word_embeddings=False,
            attn_implementation="eager")), 12
    if name == "phi3":
        return 4, lambda: transformers.Phi3ForCausalLM(transformers.Phi3Config(
            **base, rms_norm_eps=1e-5, tie_word_embeddings=False, pad_token_id=0,
            bos_token_id=1, eos_token_id=2)), 12
    half = 8
    return 5, lambda: transformers.Phi3ForCausalLM(transformers.Phi3Config(
        **{**base, "max_position_embeddings": 64}, original_max_position_embeddings=32,
        rope_scaling={"type": "longrope", "short_factor": [1.0 + 0.05 * i for i in range(half)],
                      "long_factor": [2.0 + 0.1 * i for i in range(half)]},
        rms_norm_eps=1e-5, tie_word_embeddings=False, pad_token_id=0, bos_token_id=1,
        eos_token_id=2)), 12


HF = ["qwen2", "qwen3", "gemma2", "gemma3", "gemma3-scalar", "starcoder2", "granite",
      "command-r", "olmo2", "phi3", "phi3-longrope"]


@pytest.mark.parametrize("name", HF)
def test_hf_parity(name, tmp_path):
    seed, make, n_tokens = _hf_model(name)
    torch.manual_seed(seed)
    cfg = _hf_parity(make(), tmp_path, n_tokens)
    assert cfg.arch == name.replace("-scalar", "").replace("-longrope", "")
    if name == "phi3-longrope":
        assert cfg.rope_scaling_type == "longrope" and cfg.rope_orig_ctx == 32


# -- context shift ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3", "phi3"])
def test_ctx_shift_refused(arch, tmp_path):
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
    with pytest.raises(ValueError, match="sliding-window / longrope"):
        InferenceEngine(str(tiny(arch, tmp_path)), EngineConfig(max_slots=1, ctx=64,
                                                                ctx_shift=True),
                        device="cpu")


def test_neox_shift_matches_jax(tmp_path):
    """qwen2's neox rope: ``shift_cache_slot`` on the same bf16 cache, K
    equal but for values one bf16 ulp apart where the f32 rotation rounds
    differently (few), V and the kept positions bit-identical. The
    interleaved rotation would move K far from the JAX package's."""
    r = GGUFReader(tiny("qwen2", tmp_path))
    tcfg, jcfg = TConfig.from_gguf_metadata(r.metadata), JConfig.from_gguf_metadata(r.metadata)
    r.close()
    assert not tcfg.rope_interleaved
    rng = np.random.default_rng(0)
    L, B, KVH, D = tcfg.n_layers, 2, tcfg.n_kv_heads, tcfg.head_dim
    k, v = (rng.standard_normal((2, L, B, KVH, S, D)) * 2).astype(np.float32)
    jc = jllama.KVCache(k=tuple(jnp.asarray(x, jnp.bfloat16) for x in k),
                        v=tuple(jnp.asarray(x, jnp.bfloat16) for x in v))
    tc = tllama.KVCache.zeros(tcfg, B, S, "cpu")
    for li in range(L):
        tc.k[li].copy_(torch.from_numpy(np.array(jc.k[li].astype(jnp.float32))))
        tc.v[li].copy_(torch.from_numpy(np.array(jc.v[li].astype(jnp.float32))))
    b, keep, discard = 1, 6, 13
    with torch.inference_mode():
        tllama.shift_cache_slot(tc, tcfg, b, keep, discard)
    want = jllama.shift_cache_slot(jc, jcfg, jnp.int32(b), jnp.int32(keep), jnp.int32(discard))
    for li in range(L):
        wk = np.asarray(want.k[li].astype(jnp.float32))
        gk = tc.k[li].float().numpy()
        assert np.array_equal(tc.v[li].float().numpy(), np.asarray(want.v[li].astype(jnp.float32)))
        assert np.array_equal(gk[:, :, :keep], wk[:, :, :keep])
        off = np.abs(gk - wk) > 0
        assert off.mean() < 0.01
        assert (np.abs(gk - wk)[off] <= 2 ** -7 * np.abs(wk)[off] + 1e-30).all()


def test_synth_gemma3_matches_jax(tmp_path, monkeypatch):
    """``tools.synth``'s gemma3 layout (``gemma3-tiny``: the Gemma-3-12B
    file's keys and tensors at 6 layers of 256, one global, a window of 16,
    Q4_K projections, the head tied to the Q6_K embedding) reads the same in
    both packages: the configs field by field, and logits over a 40-token
    prefill past the window and 3 steps, with the JAX matmuls on their
    Pallas kernels (interpret mode), which round Q4_K as the port does (its
    CPU path rounds bf16(q·s − m), 2% of the logits' scale away here);
    tolerance :data:`LOGITS_TOL`."""
    from llama_gguf_inference_tpu.ops import matmul_kernels as jmk
    from llama_gguf_inference_tpu_torch.tools.synth import synth_model
    monkeypatch.setattr(jmk, "_on_tpu", lambda: True)
    path = synth_model(str(tmp_path / "g3.gguf"), "gemma3-tiny")
    r = GGUFReader(path)
    cfg = _same_config(r.metadata)
    assert "output.weight" not in r.tensors
    r.close()
    assert (cfg.sliding_window, cfg.swa_pattern, cfg.rope_scaling_type,
            cfg.rope_scaling_factor, cfg.rope_local_base) == (16, 6, "linear", 8.0, 1e4)
    ids = np.random.default_rng(5).integers(3, 250, 40 + STEPS).tolist()
    _, params, errs = _run_both(path, "bf16", ids, prefill=40)
    assert params["output"] is params["tok_embd"].table
    assert max(errs) <= LOGITS_TOL, errs
