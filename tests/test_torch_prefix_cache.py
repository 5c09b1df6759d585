"""The port engine's slot prompt cache on the CPU: the JAX package's
``test_prefix_cache.py`` cases, run on the port for a bf16 and a q8_0
contiguous cache and held against the JAX engine on the same tiny Q4_K_M
GGUF.

A freed slot keeps its KV; admission picks the free slot with the longest
common prefix and prefills only the rest. Each case's reused token counts
equal the JAX engine's (bf16 cache), and its greedy tokens equal the port's
own with the cache disabled, the cold engine: the correctness pin of the
JAX package's test. (Tokens are not held to the JAX engine here: these
prompts of 47 to 77 byte tokens leave near-ties on the random tiny model
that the JAX package's own prefill paths already split differently.) Both
engines are stepped by hand (``step()``), so the
case where a freed slot's claim must survive pipelined ``multi_step``
decode in the other slot puts its request in at a fixed dispatch.
"""

import jax.numpy as jnp
import pytest
import torch

from llama_gguf_inference_tpu.runtime import engine as jengine
from llama_gguf_inference_tpu.runtime.sampler import SamplingParams as JParams
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
from test_torch_model import write_tiny_q4km

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    return str(write_tiny_q4km(tmp_path_factory.mktemp("pc") / "tiny.gguf"))


def _submit(eng, prompt, n):
    cls = SamplingParams if isinstance(eng, tengine.InferenceEngine) else JParams
    return eng.submit(prompt, cls(temperature=0.0, max_tokens=n))[1]


def _drain(eng, outs):
    """Step ``eng`` until every queue in ``outs`` has finished; the tokens."""
    evs = [[] for _ in outs]
    for _ in range(2000):
        eng.step()
        for e, o in zip(evs, outs):
            while not o.empty():
                e.append(o.get_nowait())
        if all(e and e[-1].finished for e in evs):
            return [[x.token_id for x in e] for e in evs]
    raise AssertionError("requests did not finish")


def _toks(eng, prompt, n=8):
    return _drain(eng, [_submit(eng, prompt, n)])[0]


def _identical(eng):
    prompt = list(range(3, 80))
    first = _toks(eng, prompt)
    r0 = eng.total_prefix_reused
    second = _toks(eng, prompt)
    return [first, second], [r0, eng.total_prefix_reused - r0]


def _shared_prefix(eng):
    sys_prefix = list(range(3, 70))
    _toks(eng, sys_prefix + [100, 101, 102])
    r0 = eng.total_prefix_reused
    got = _toks(eng, sys_prefix + [150, 151, 152, 153])
    return [got], [r0, eng.total_prefix_reused - r0]


def _best_slot(eng):
    pa, pb = list(range(3, 60)), list(range(60, 120))
    _toks(eng, pa)
    _toks(eng, pb)
    r0 = eng.total_prefix_reused
    got = _toks(eng, pb + [7, 8])
    return [got], [r0, eng.total_prefix_reused - r0]


def _extend_claim(eng):
    prompt = list(range(3, 50))
    gen = _toks(eng, prompt, 6)
    r0 = eng.total_prefix_reused
    got = _toks(eng, prompt + gen + [200, 201])
    return [gen, got], [r0, eng.total_prefix_reused - r0]


def _repeat(eng):
    prompt = list(range(3, 60))
    return [_toks(eng, prompt), _toks(eng, prompt)], [eng.total_prefix_reused]


def _after_pipelined_decode(eng):
    """B fills a slot and frees it; A decodes 40 tokens in the other slot at
    multi_step 4 (dispatches pipelined), and B comes back after A's third
    scheduler step, while A still decodes."""
    pb, pa = list(range(3, 70)), list(range(100, 140))
    first = _toks(eng, pb)
    a = _submit(eng, pa, 40)
    for _ in range(3):
        eng.step()
    r0 = eng.total_prefix_reused
    toks_a, toks_b = _drain(eng, [a, _submit(eng, pb, 8)])
    return [first, toks_a, toks_b], [r0, eng.total_prefix_reused - r0]


# case: (scenario, engine settings, the reuse counts it must show)
CASES = {
    "identical": (_identical, {}, [0, 76]),
    "shared_prefix": (_shared_prefix, {}, [0, 67]),
    "best_slot": (_best_slot, {}, [0, 60]),
    "extend_claim": (_extend_claim, {}, [0, 52]),
    "disabled": (_repeat, {"prefix_cache": False}, [0]),
    "paged": (_repeat, {"kv_layout": "paged", "kv_page_size": 64}, [0]),
    "after_pipelined": (_after_pipelined_decode, {"ctx": 128, "multi_step": 4}, [0, 66]),
}


def _port(path, kv_dtype, **kw):
    cfg = {"max_slots": 2, "ctx": 256, "kv_dtype": kv_dtype, **kw}
    return tengine.InferenceEngine(path, tengine.EngineConfig(**cfg), device="cpu")


@pytest.fixture(scope="module")
def jax_runs(tiny_path):
    """Each case on the JAX engine (bf16 cache), computed on first use."""
    runs = {}

    def get(case):
        if case not in runs:
            fn, kw, _ = CASES[case]
            cfg = {"max_slots": 2, "ctx": 256, "kv_dtype": jnp.bfloat16, **kw}
            runs[case] = fn(jengine.InferenceEngine(tiny_path, jengine.EngineConfig(**cfg)))
        return runs[case]
    return get


@pytest.mark.parametrize("kv_dtype", ["bf16", "q8_0"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefix_cache_matches_jax_and_cold(case, kv_dtype, tiny_path, jax_runs):
    fn, kw, want_reused = CASES[case]
    eng = _port(tiny_path, kv_dtype, **kw)
    toks, reused = fn(eng)
    assert reused == want_reused
    assert eng.stats()["prefix_tokens_reused"] == sum(reused)
    assert reused == jax_runs(case)[1]
    cold, cold_reused = fn(_port(tiny_path, kv_dtype, **{**kw, "prefix_cache": False}))
    assert sum(cold_reused) == 0
    assert toks == cold
    if case == "identical":
        assert toks[0] == toks[1]
    if case == "after_pipelined":
        assert eng.stats()["continuations"] > 0 and toks[2] == toks[0]
    if eng.alloc is None:
        assert all(len(s.cached_ids) <= eng.ecfg.ctx - eng.ecfg.multi_step - 1
                   for s in eng.slots)
    else:
        assert all(not s.cached_ids for s in eng.slots)


def test_free_rows_park_past_their_claim(tiny_path):
    """A free slot's decode row sits at the end of its kept claim, an active
    one at its offset, so a decode step never writes inside a claim."""
    eng = _port(tiny_path, "bf16", multi_step=4)
    _toks(eng, list(range(3, 30)), 5)
    assert len(eng.slots[0].cached_ids) == 27 + 4
    a = _submit(eng, list(range(100, 110)), 12)
    eng.step()
    active = [b for b, s in enumerate(eng.slots) if s.state == "active"]
    assert active == [1]
    _, offsets, advance = eng._decode_inputs(active)
    assert offsets.tolist() == [31, eng.slots[1].offset] and advance.tolist() == [0, 1]
    _drain(eng, [a])
