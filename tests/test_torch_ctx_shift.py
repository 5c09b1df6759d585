"""Context shift (llama-server ``--ctx-shift``) in the port, on the CPU.

``models.llama.shift_cache_slot`` against the JAX package's on the same
numpy caches for every contiguous cache kind (bf16, q8_0, q4_0, q4_1) and
rope scaling (none, linear, llama3): positions below ``keep``, and V's
codes, scales and minimums, bit-identical; bf16 K equal but for values one
bf16 ulp apart where the f32 rotation rounds differently, such values few;
quantized K codes equal or one code apart where the f32 rotation rounds
differently, such codes few; the sink rows unchanged and the cache tensors
the same objects. Then the engine tests of ``tests/test_ctx_shift.py``:
generation past the capacity, ``length`` at the capacity without the shift,
the tokens before the first shift equal to the run without it (and as many
shifts as the JAX engine makes), the paged layout and a slot too small
for the shift's margin refused, and a shifted slot's kept claim cut to the
positions its shifts kept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.gguf.constants import GGMLType
from llama_gguf_inference_tpu.models import llama as jllama
from llama_gguf_inference_tpu.models.config import ModelConfig as JConfig
from llama_gguf_inference_tpu.runtime import engine as jengine
from llama_gguf_inference_tpu.runtime import kv_cache as jkv
from llama_gguf_inference_tpu.runtime.sampler import SamplingParams as JParams
from llama_gguf_inference_tpu.utils.testing import write_tiny_llama
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.models.config import ModelConfig as TConfig
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime.convert import cache_from_numpy
from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams

torch.set_num_threads(1)

L, B, KVH, S, D = 2, 2, 2, 48, 16
KINDS = {"bf16": jllama.KVCache, "q8_0": jkv.QuantKV, "q4_0": jkv.QuantKV4,
         "q4_1": jkv.QuantKV41}
SCALINGS = {"none": {}, "linear": {"rope_scaling_type": "linear", "rope_scaling_factor": 4.0},
            "llama3": {"rope_scaling_type": "llama3", "rope_scaling_factor": 8.0,
                       "rope_orig_ctx": 32, "rope_low_freq_factor": 1.0,
                       "rope_high_freq_factor": 4.0}}
BF16_ULP = 2 ** -7             # a bf16 value's ulp, at most, relative to it


def _configs(scaling):
    kw = dict(dim=64, n_layers=L, n_heads=4, n_kv_heads=KVH, head_dim=D, rope_dim=D,
              rope_base=10000.0, **SCALINGS[scaling])
    return JConfig(**kw), TConfig(**kw)


def _caches(kind, seed=0):
    """The same cache for both packages: random K/V (quantized by the JAX
    codec for the quantized kinds), from numpy."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((2, L, B, KVH, S, D)) * 2).astype(np.float32)
    jcls = KINDS[kind]
    if kind == "bf16":
        jc = jcls(k=tuple(jnp.asarray(x, jnp.bfloat16) for x in k),
                  v=tuple(jnp.asarray(x, jnp.bfloat16) for x in v))
    else:
        parts = {}
        for prefix, x in (("k", k), ("v", v)):
            for li in range(L):
                for name, arr in zip((f"{prefix}_q", f"{prefix}_s", f"{prefix}_m"),
                                     jcls.quantize(jnp.asarray(x[li]))):
                    parts.setdefault(name, []).append(arr)
        jc = jcls(**{f: tuple(parts[f]) for f in jcls._fields})
    fields = {f: [np.asarray(a) for a in getattr(jc, f)] for f in jc._fields}
    return jc, cache_from_numpy(fields, "cpu"), fields


def _storage(t):
    """The whole storage of a cache tensor, its sink rows included."""
    return torch.as_strided(t, (t.untyped_storage().nbytes() // t.element_size(),), (1,))


@pytest.mark.parametrize("scaling", sorted(SCALINGS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_shift_matches_jax(kind, scaling):
    jcfg, tcfg = _configs(scaling)
    jc, tc, before = _caches(kind)
    b, keep, discard = 1, 6, 13
    ptrs = {f: [t.data_ptr() for t in getattr(tc, f)] for f in before}
    sinks = {f: [_storage(t)[t.numel():].clone() for t in getattr(tc, f)] for f in before}
    with torch.inference_mode():
        tllama.shift_cache_slot(tc, tcfg, b, keep, discard)
    want = jllama.shift_cache_slot(jc, jcfg, jnp.int32(b), jnp.int32(keep),
                                   jnp.int32(discard))
    near = total = 0
    for f in before:
        for li in range(L):
            t = getattr(tc, f)[li]
            assert t.data_ptr() == ptrs[f][li], f"{f}: the tensor was replaced"
            assert torch.equal(_storage(t)[t.numel():], sinks[f][li]), f"{f}: sink rows"
            got = (t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16
                   else t.numpy())
            ref = np.asarray(getattr(want, f)[li])
            orig = before[f][li]
            if ref.dtype.name == "bfloat16":
                ref, orig = ref.view(np.uint16), orig.view(np.uint16)
            # the other slot and the kept positions: bit-identical
            np.testing.assert_array_equal(got[0], orig[0], err_msg=f"{f} slot 0")
            np.testing.assert_array_equal(got[b, :, :keep], orig[b, :, :keep],
                                          err_msg=f"{f} kept")
            if f.startswith("v"):   # V rolls exactly
                np.testing.assert_array_equal(got, ref, err_msg=f"{f} rolled")
            elif kind == "bf16":
                g = t.float().numpy()
                r = np.asarray(getattr(want, f)[li], np.float32)
                diff = np.abs(g - r)
                assert (diff <= BF16_ULP * np.abs(r)).all(), f"{f}: {diff.max()}"
                near += int((diff > 0).sum())
                total += diff.size
            elif f == "k_q":
                if kind == "q8_0":
                    gc, rc = got.astype(np.int32), ref.astype(np.int32)
                else:   # planar nibbles: compare the codes, not the bytes
                    gc = np.concatenate([got & 15, got >> 4], -1).astype(np.int32)
                    rc = np.concatenate([ref & 15, ref >> 4], -1).astype(np.int32)
                diff = np.abs(gc - rc)
                assert diff.max() <= 1, f"{kind} K codes differ by {diff.max()}"
                near += int((diff > 0).sum())
                total += diff.size
            else:           # K's scales and minimums, requantized in f32
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=f)
    # a value or code one apart comes only from an f32 rotation rounding
    # across a boundary: rare
    assert near <= 0.01 * max(total, 1), f"{near} of {total} K values one apart"


@pytest.fixture(scope="module")
def q8_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("shift") / "m.gguf"
    write_tiny_llama(p, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=96,
                     quant=GGMLType.Q8_0)
    return str(p)


def _port_run(path, shift, max_tokens, kv="bf16", prompt=tuple(range(5, 25)), **kw):
    eng = tengine.InferenceEngine(path, tengine.EngineConfig(
        max_slots=1, ctx=48, multi_step=4, ctx_shift=shift, kv_dtype=kv, **kw), device="cpu")
    out = eng.submit(list(prompt), SamplingParams(temperature=0.0, max_tokens=max_tokens))[1]
    evs = []
    while not (evs and evs[-1].finished):
        eng.step()
        while not out.empty():
            evs.append(out.get_nowait())
    return eng, evs


def test_engine_generates_past_capacity(q8_path):
    eng, evs = _port_run(q8_path, True, 120)
    assert len(evs) == 120 and evs[-1].finish_reason == "length"   # max_tokens
    assert eng.stats()["ctx_shifts"] >= 2


@pytest.mark.parametrize("kv", ["q8_0", "q4_1"])
def test_engine_generates_past_capacity_quantized(q8_path, kv):
    eng, evs = _port_run(q8_path, True, 80, kv=kv, prompt=(3, 9, 4, 7))
    assert len(evs) == 80 and evs[-1].finish_reason == "length"
    assert eng.stats()["ctx_shifts"] >= 1


def test_engine_without_shift_finishes_at_capacity(q8_path):
    eng, evs = _port_run(q8_path, False, 120)
    assert len(evs) < 40 and evs[-1].finish_reason == "length"
    assert "ctx_shifts" not in eng.stats()


def test_shift_prefix_matches_no_shift_and_jax(q8_path):
    """Tokens before the first shift equal the run without it, and the
    shifted run shifts as often as the JAX engine's (the same rule for when
    and by how much). Its tokens are not held to the JAX engine's: on this
    random tiny model the two engines' greedy paths part at a near-tie
    before any shift."""
    plain = [e.token_id for e in _port_run(q8_path, False, 60)[1]]
    eng, evs = _port_run(q8_path, True, 60)
    shifted = [e.token_id for e in evs]
    assert shifted[:len(plain) - 4] == plain[:-4]
    jeng = jengine.InferenceEngine(q8_path, jengine.EngineConfig(
        max_slots=1, ctx=48, prefill_buckets=(16, 32), multi_step=4, ctx_shift=True,
        prefix_cache=False))
    jeng.start()
    try:
        want = list(jeng.generate(list(range(5, 25)), JParams(temperature=0.0, max_tokens=60)))
        assert len(want) == len(evs) == 60
        assert jeng.stats()["ctx_shifts"] == eng.stats()["ctx_shifts"] >= 2
    finally:
        jeng.stop()


def test_paged_ctx_shift_raises(q8_path):
    with pytest.raises(ValueError, match="contig"):
        tengine.InferenceEngine(q8_path, tengine.EngineConfig(
            max_slots=1, ctx=64, kv_layout="paged", kv_page_size=16, ctx_shift=True),
            device="cpu")


def test_small_ctx_shift_raises(q8_path):
    """ctx 16 at multi_step 4: a shift from offset 11 keeping 8 would
    discard its margin of 5 and write over kept rows."""
    with pytest.raises(ValueError, match="ctx >= 4"):
        tengine.InferenceEngine(q8_path, tengine.EngineConfig(
            max_slots=1, ctx=16, multi_step=4, ctx_shift=True), device="cpu")


def test_shifted_claim_keeps_only_kept_positions(q8_path):
    """After a shift only positions below ``keep`` still hold the prompt:
    the released claim stops there, and the same prompt sent again decodes
    as on a fresh engine."""
    prompt = tuple(range(5, 37))                  # 32 tokens: keep = 48 // 2 = 24
    eng, _ = _port_run(q8_path, True, 40, prompt=prompt)
    assert eng.stats()["ctx_shifts"] >= 1
    assert eng.slots[0].cached_ids == list(prompt[:24])
    out = eng.submit(list(prompt), SamplingParams(temperature=0.0, max_tokens=8))[1]
    again = []
    while not (again and again[-1].finished):
        eng.step()
        while not out.empty():
            again.append(out.get_nowait())
    assert eng.total_prefix_reused == 24
    fresh = _port_run(q8_path, True, 8, prompt=prompt)[1]
    assert [e.token_id for e in again] == [e.token_id for e in fresh]
