"""The port's engine and forward with quantized and paged KV caches, on the
CPU, against the JAX package.

The JAX engine and forward run with their Pallas kernels forced on in
interpret mode (``LGT_FORCE_FLASH=1`` and the matmul kernels), the function
the port's plain versions compute; caches hold 128 tokens per slot so that
every JAX attention call can take its kernel. Greedy tokens must be equal;
one forward step from the same filled cache must agree within 0.5% of the
logits' scale, the bound of ``test_torch_model.py``'s Pallas comparison.

The 4-bit caches are held against the JAX forward, stepped as a one-slot
engine steps it, and not against the JAX engine: 4-bit codes turn a
one-ulp difference into a code one step away wherever a value sits on a
rounding boundary, and the random two-layer model carries that into
another token. The JAX engine's compiled step rounds some scales one ulp
away from its own forward (0.4464286 against 0.44642857 at layer 0 of this
model), and so does a four-row decode batch against one row (f32 sum
order); both part from the forward's tokens within eight steps. With one
slot the port computes the JAX forward's function bit for bit (codecs in
``test_torch_kv_cache.py``), so its tokens must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.models import llama as jllama
from llama_gguf_inference_tpu.ops import matmul_kernels as jmk
from llama_gguf_inference_tpu.runtime import engine as jengine
from llama_gguf_inference_tpu.runtime import kv_cache as jkv
from llama_gguf_inference_tpu.runtime import loader as jloader
from llama_gguf_inference_tpu.runtime import paged_kv as jpaged
from llama_gguf_inference_tpu.runtime.sampler import SamplingParams as JParams
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime import loader as tloader
from llama_gguf_inference_tpu_torch.runtime.convert import cache_from_numpy
from llama_gguf_inference_tpu_torch.runtime.kv_cache import QuantKV
from llama_gguf_inference_tpu_torch.runtime.paged_kv import PagedQuantKV
from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
from llama_gguf_inference_tpu_torch.serving.openai_server import build_engine_from_env
from test_torch_model import write_tiny_q4km

torch.set_num_threads(1)

PROMPTS = ["hello world", "over the world and", "a quick dog", "to the lazy dog"]
CTX, PAGE = 128, 128
# (kv_dtype, kv_layout): every configuration the JAX engine accepts beyond
# the contiguous bf16 cache of test_torch_engine.py
CONFIGS = [("q8_0", "contig"), ("bf16", "paged"), ("q8_0", "paged")]
KERNEL = {("q8_0", "contig"): "flash_attention_q8", ("q4_0", "contig"): "flash_attention_q4",
          ("q4_1", "contig"): "flash_attention_q41", ("bf16", "paged"): "flash_attention_paged",
          ("q8_0", "paged"): "flash_attention_paged_q8"}


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    return str(write_tiny_q4km(tmp_path_factory.mktemp("kv") / "tiny.gguf"))


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setattr(jmk, "_on_tpu", lambda: True)
    monkeypatch.setenv("LGT_FORCE_FLASH", "1")


def _port(path, kv_dtype="bf16", kv_layout="contig", slots=4, ctx=CTX):
    return tengine.InferenceEngine(path, tengine.EngineConfig(
        max_slots=slots, ctx=ctx, kv_dtype=kv_dtype, kv_layout=kv_layout,
        kv_page_size=PAGE), device="cpu")


def _drain(outs, timeout):
    toks = []
    for out in outs:
        seq = []
        while True:
            ev = out.get(timeout=timeout)
            seq.append(ev.token_id)
            if ev.finished:
                break
        toks.append((seq, ev))
    return toks


def _greedy(eng, prompts, max_tokens=8, params=SamplingParams):
    eng.start()
    try:
        outs = [eng.submit(p, params(temperature=0.0, max_tokens=max_tokens))[1]
                for p in prompts]
        return _drain(outs, 600)
    finally:
        eng.stop()


@pytest.mark.parametrize("kv_dtype,kv_layout", CONFIGS)
def test_greedy_tokens_match_jax_engine(kv_dtype, kv_layout, tiny_path, pallas):
    jeng = jengine.InferenceEngine(tiny_path, jengine.EngineConfig(
        max_slots=4, ctx=CTX, multi_step=1, prefix_cache=False,
        kv_dtype=jnp.bfloat16 if kv_dtype == "bf16" else kv_dtype,
        kv_layout=kv_layout, kv_page_size=PAGE))
    want = [s for s, _ in _greedy(jeng, PROMPTS, params=JParams)]
    _build.reset_launches()
    got = [s for s, _ in _greedy(_port(tiny_path, kv_dtype, kv_layout), PROMPTS)]
    assert got == want
    assert all(len(s) == 8 for s in got)
    assert _build.LAUNCHES.get(KERNEL[kv_dtype, kv_layout] + ".plain", 0) > 0
    assert not _build.LAUNCHES.get("flash_attention.plain", 0)


def _greedy_jax_forward(jcfg, jparams, cache, ids, steps=8):
    """Greedy tokens of the JAX forward, stepped as the engine steps it: the
    prompt padded to the 16-token prefill bucket, then one token a step."""
    n = len(ids)
    tok = np.zeros((1, 16), np.int32)
    tok[0, :n] = ids
    lg, cache = jllama.forward(jparams, jcfg, jnp.asarray(tok), jnp.zeros(1, jnp.int32),
                               cache, jnp.asarray([n], jnp.int32))
    out = [int(np.asarray(lg[0, n - 1]).argmax())]
    while len(out) < steps:
        lg, cache = jllama.forward(jparams, jcfg, jnp.asarray([[out[-1]]], jnp.int32),
                                   jnp.full(1, n + len(out) - 1, jnp.int32), cache,
                                   jnp.asarray([1], jnp.int32))
        out.append(int(np.asarray(lg[0, 0]).argmax()))
    return out


@pytest.mark.parametrize("kv_dtype", ["q4_0", "q4_1"])
def test_greedy_tokens_4bit_match_jax_forward(kv_dtype, tiny_path, models, pallas):
    jcfg, jparams = models[:2]
    jcls = jkv.QuantKV4 if kv_dtype == "q4_0" else jkv.QuantKV41
    eng = _port(tiny_path, kv_dtype, slots=1)
    want = [_greedy_jax_forward(jcfg, jparams, jcls.zeros(jcfg, 1, CTX),
                                eng.tokenizer.encode(p)) for p in PROMPTS]
    _build.reset_launches()
    got = [s for s, _ in _greedy(eng, PROMPTS)]
    assert got == want
    assert _build.LAUNCHES.get(KERNEL[kv_dtype, "contig"] + ".plain", 0) > 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "q8_0"])
def test_paged_tokens_equal_contiguous(kv_dtype, tiny_path):
    want = _greedy(_port(tiny_path, kv_dtype, "contig"), PROMPTS)
    got = _greedy(_port(tiny_path, kv_dtype, "paged"), PROMPTS)
    assert [s for s, _ in got] == [s for s, _ in want]


def test_paged_request_longer_than_a_slot_share(tiny_path):
    """A 300-token prompt against 128 tokens per slot: paged, it runs and
    gives the tokens of a contiguous engine whose slot holds 512."""
    ids = list(np.random.default_rng(0).integers(3, 500, 300))
    eng = _port(tiny_path, "bf16", "paged")
    (seq, last), = _greedy(eng, [ids])
    assert last.n_prompt == 300 and last.finish_reason in ("stop", "length")
    assert eng.alloc.free_pages == 4
    (ref, _), = _greedy(_port(tiny_path, slots=1, ctx=512), [ids])
    assert seq == ref
    contig = _port(tiny_path)
    (_, short), = _greedy(contig, [ids])
    assert short.n_prompt == CTX - 1          # truncated to the slot's share


def test_pool_exhaustion_holds_the_line(tiny_path):
    """Two requests of 3 pages each against a pool of 4: the second waits
    at the head of the line until the first releases its pages."""
    eng = _port(tiny_path, "q8_0", "paged")
    rng = np.random.default_rng(1)
    outs = [eng.submit(list(rng.integers(3, 500, 300)),
                       SamplingParams(temperature=0.0, max_tokens=4))[1]
            for _ in range(2)]
    eng.step()
    assert [s.state for s in eng.slots[:2]] == ["active", "free"]
    assert len(eng._waiting) == 1 and eng.alloc.free_pages == 1
    assert eng._slot_cap(0) == 3 * PAGE
    for _ in range(200):
        if all(s.state == "free" for s in eng.slots) and not eng._waiting \
                and eng._queue.empty():
            break
        eng.step()
    done = _drain(outs, 1)
    assert all(ev.finished and ev.n_prompt == 300 for _, ev in done)
    assert eng.alloc.free_pages == 4 and (eng.alloc.table == -1).all()
    assert (eng.cache.page_table == -1).all()


def test_paged_q4_is_rejected_as_jax_rejects_it(tiny_path):
    with pytest.raises(ValueError) as jerr:
        jengine.InferenceEngine(tiny_path, jengine.EngineConfig(
            kv_layout="paged", kv_dtype="q4_0"))
    for kv in ("q4_0", "q4_1"):
        with pytest.raises(ValueError) as terr:
            _port(tiny_path, kv, "paged")
        assert str(terr.value) == str(jerr.value)
        assert "4-bit paged pools are not built" in str(terr.value)


def test_env_selects_the_cache(tiny_path, monkeypatch, capsys):
    monkeypatch.setenv("MODEL_PATH", tiny_path)
    monkeypatch.setenv("MAX_SLOTS", "2")
    monkeypatch.setenv("CTX", "512")
    monkeypatch.setenv("KV_CACHE_TYPE", "q5_1")
    eng = build_engine_from_env(device="cpu")
    assert eng.ecfg.kv_dtype == "q8_0" and isinstance(eng.cache, QuantKV)
    assert "KV_CACHE_TYPE=q5_1" in capsys.readouterr().out
    monkeypatch.setenv("KV_CACHE_TYPE", "q8_0")
    monkeypatch.setenv("KV_LAYOUT", "paged")
    monkeypatch.setenv("KV_PAGE_SIZE", "128")
    eng = build_engine_from_env(device="cpu")
    assert isinstance(eng.cache, PagedQuantKV)
    assert eng.cache.pool_pages == 4 and eng.cache.max_seq == 512


@pytest.fixture(scope="module")
def models(tiny_path):
    jcfg, jparams, _ = jloader.load_model(tiny_path, fuse=True)
    tcfg, tparams, _ = tloader.load_model(tiny_path, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _jax_cache(kind, cfg):
    if kind == "paged":
        c = jpaged.PagedKV.zeros(cfg, 1, 4, PAGE)
    elif kind == "paged_q8_0":
        c = jpaged.PagedQuantKV.zeros(cfg, 1, 4, PAGE)
    else:
        return {"q8_0": jkv.QuantKV, "q4_0": jkv.QuantKV4,
                "q4_1": jkv.QuantKV41}[kind].zeros(cfg, 1, CTX)
    return c._replace(page_table=jnp.asarray([[2, 0, -1, -1]], jnp.int32))


@pytest.mark.parametrize("kind", ["q8_0", "q4_0", "q4_1", "paged", "paged_q8_0"])
def test_forward_from_converted_cache_matches_jax(kind, models, pallas):
    """JAX prefills its cache; the port's forward continues from that cache
    carried across by ``convert.cache_from_numpy``, as JAX continues it."""
    jcfg, jparams, tcfg, tparams = models
    ids = np.array([[1, 300, 311, 290, 305, 17, 400, 263]], np.int32)
    _, cache = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.zeros(1, jnp.int32),
                              _jax_cache(kind, jcfg), jnp.asarray([8], jnp.int32))
    tcache = cache_from_numpy(
        {k: (np.asarray(v) if k == "page_table" else [np.asarray(a) for a in v])
         for k, v in cache._asdict().items()}, "cpu")
    nxt = np.array([[270, 281]], np.int32)
    want, _ = jllama.forward(jparams, jcfg, jnp.asarray(nxt), jnp.full(1, 8, jnp.int32),
                             cache, jnp.asarray([2], jnp.int32))
    want = np.asarray(want[0])
    with torch.inference_mode():
        got = tllama.forward(tparams, tcfg, torch.from_numpy(nxt),
                             torch.full((1,), 8, dtype=torch.int32), tcache)[0].numpy()
    assert np.abs(got - want).max() <= 0.005 * np.abs(want).max()


def test_cancel_drops_a_request_waiting_for_pages(tiny_path):
    eng = _port(tiny_path, "bf16", "paged")
    rng = np.random.default_rng(2)
    outs = [eng.submit(list(rng.integers(3, 500, 300)),
                       SamplingParams(temperature=0.0, max_tokens=4), request_id=rid)[1]
            for rid in ("a", "b")]
    eng.step()
    assert [item[0] for item in eng._waiting] == ["b"]
    eng.cancel("b")
    eng.step()
    assert not eng._waiting
    ev = outs[1].get(timeout=1)
    assert ev.finished and ev.finish_reason == "stop" and ev.n_generated == 0
    eng.cancel("a")
    eng.step()
    assert eng.alloc.free_pages == 4
