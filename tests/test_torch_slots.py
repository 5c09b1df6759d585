"""Slot save/restore/erase (llama-server ``--slot-save-path``) in the port's
engine, on the CPU, held against the JAX engine on the same tiny Q4_K_M
GGUF.

A saved slot restored into a fresh engine gives the same greedy
continuation as the engine that saved it; erase drops the claim; a busy
slot, a paged engine, a file of another cache kind or model are refused; a
file name without ``.npz`` is kept as given. The file format is the JAX
engine's, so a file saved by one engine restores into the other and gives
that engine's continuation, both ways. A restored claim is capped as a
released one is, so the free row parked at its end stays inside the slot
and the claimed rows survive another slot's decode.
"""

import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.ops import matmul_kernels as jmk
from llama_gguf_inference_tpu.runtime import engine as jengine
from llama_gguf_inference_tpu.runtime.sampler import SamplingParams as JParams
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
from test_torch_model import write_tiny_q4km

torch.set_num_threads(1)

PROMPT = "hello world"
CTX = 64


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    return str(write_tiny_q4km(tmp_path_factory.mktemp("slots") / "tiny.gguf"))


def _port(path, **kw):
    return tengine.InferenceEngine(path, tengine.EngineConfig(
        max_slots=2, ctx=CTX, **kw), device="cpu")


def _run(eng, prompt=PROMPT, n=8):
    """Greedy tokens of one request, the engine (the port's or the JAX
    package's) stepped by hand."""
    cls = SamplingParams if isinstance(eng, tengine.InferenceEngine) else JParams
    out = eng.submit(prompt, cls(temperature=0.0, max_tokens=n))[1]
    evs = []
    while not (evs and evs[-1].finished):
        eng.step()
        while not out.empty():
            evs.append(out.get_nowait())
    return [e.token_id for e in evs]


def _slot_of(eng):
    return next(b for b, s in enumerate(eng.slots) if s.cached_ids)


def test_save_restore_reproduces_the_continuation(tiny_path, tmp_path):
    a = _port(tiny_path)
    first = _run(a)
    b = _slot_of(a)
    n_claim = len(a.slots[b].cached_ids)
    out = a.slot_op("save", b, str(tmp_path / "s.npz"))
    assert out["n_saved"] == n_claim and out["filename"] == "s.npz"
    again = _run(a)
    fresh = _port(tiny_path)
    res = fresh.slot_op("restore", 0, str(tmp_path / "s.npz"))
    assert res["n_restored"] == n_claim and fresh.slots[0].cached_ids == a.slots[b].cached_ids
    got = _run(fresh)
    assert fresh.total_prefix_reused == len(fresh.tokenizer.encode(PROMPT)) - 1
    assert got == again == first


def test_erase_and_refusals(tiny_path, tmp_path):
    eng = _port(tiny_path)
    _run(eng)
    b = _slot_of(eng)
    n = len(eng.slots[b].cached_ids)
    with pytest.raises(ValueError, match="no such slot"):
        eng.slot_op("erase", 5)
    with pytest.raises(ValueError, match="no cached prompt"):
        eng.slot_op("save", 1 - b, str(tmp_path / "empty.npz"))
    # a name without .npz is kept as given
    eng.slot_op("save", b, str(tmp_path / "slot.bin"))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["slot.bin"]
    assert eng.slot_op("erase", b) == {"id_slot": b, "n_erased": n}
    assert eng.slots[b].cached_ids == []
    assert eng.slot_op("restore", b, str(tmp_path / "slot.bin"))["n_restored"] == n
    with pytest.raises(FileNotFoundError):
        eng.slot_op("restore", b, str(tmp_path / "missing.npz"))
    # another model's file
    with np.load(tmp_path / "slot.bin") as data:
        fields = dict(data)
    np.savez(tmp_path / "other.npz", **{**fields, "model": np.asarray("other-model")})
    with pytest.raises(ValueError, match="different model"):
        eng.slot_op("restore", b, str(tmp_path / "other.npz"))
    # another cache kind
    q8 = _port(tiny_path, kv_dtype="q8_0")
    with pytest.raises(ValueError, match="cache kind mismatch"):
        q8.slot_op("restore", 0, str(tmp_path / "slot.bin"))
    # a busy slot
    out = eng.submit(PROMPT, SamplingParams(temperature=0.0, max_tokens=20))[1]
    eng.step()
    busy = next(i for i, s in enumerate(eng.slots) if s.state == "active")
    for op in ("save", "restore", "erase"):
        with pytest.raises(ValueError, match="busy"):
            eng.slot_op(op, busy, str(tmp_path / "slot.bin"))
    eng.cancel(eng.slots[busy].request_id)
    eng.step()
    assert out.get_nowait().token_id >= 0
    # paged slots have no private region
    paged = _port(tiny_path, kv_layout="paged", kv_page_size=16)
    with pytest.raises(ValueError, match="contiguous"):
        paged.slot_op("save", 0, str(tmp_path / "p.npz"))


def test_slot_op_runs_on_the_scheduler_thread(tiny_path, tmp_path):
    """With the loop running (and a pipelined dispatch possibly in flight)
    the operation is queued to the scheduler thread and answered from
    there."""
    eng = _port(tiny_path, multi_step=4)
    eng.start()
    try:
        first = eng.generate_text(PROMPT, SamplingParams(temperature=0.0, max_tokens=8))
        b = _slot_of(eng)
        out = eng.slot_op("save", b, str(tmp_path / "t.npz"))
        assert out["n_saved"] == len(eng.slots[b].cached_ids)
        assert eng.slot_op("erase", b)["n_erased"] == out["n_saved"]
        assert eng.slot_op("restore", b, str(tmp_path / "t.npz"))["n_restored"] \
            == out["n_saved"]
        assert eng.generate_text(PROMPT, SamplingParams(temperature=0.0,
                                                        max_tokens=8)) == first
    finally:
        eng.stop()


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_files_exchange_with_the_jax_engine(tiny_path, tmp_path, kv, monkeypatch):
    """JAX saves, the port restores and continues as the JAX engine does;
    the port saves, the JAX engine restores and continues as the port
    does."""
    monkeypatch.setattr(jmk, "_on_tpu", lambda: True)   # the Pallas kernels, interpreted
    jkv = {"bf16": jengine.jnp.bfloat16, "q8_0": "q8_0"}[kv]
    j = jengine.InferenceEngine(tiny_path, jengine.EngineConfig(max_slots=2, ctx=CTX,
                                                                kv_dtype=jkv))
    j_first = _run(j)
    jb = _slot_of(j)
    j.slot_op("save", jb, str(tmp_path / "from_jax.npz"))
    j_again = _run(j)

    port = _port(tiny_path, kv_dtype=kv)
    port.slot_op("restore", 1, str(tmp_path / "from_jax.npz"))
    assert port.slots[1].cached_ids == j.slots[jb].cached_ids
    got = _run(port)
    assert port.total_prefix_reused == len(port.tokenizer.encode(PROMPT)) - 1
    assert got == j_again == j_first

    port2 = _port(tiny_path, kv_dtype=kv)
    p_first = _run(port2)
    pb = _slot_of(port2)
    port2.slot_op("save", pb, str(tmp_path / "from_port.npz"))
    j2 = jengine.InferenceEngine(tiny_path, jengine.EngineConfig(max_slots=2, ctx=CTX,
                                                                 kv_dtype=jkv))
    j2.slot_op("restore", 0, str(tmp_path / "from_port.npz"))
    assert j2.slots[0].cached_ids == port2.slots[pb].cached_ids
    assert _run(j2) == p_first
    assert j2.total_prefix_reused == len(port.tokenizer.encode(PROMPT)) - 1


def test_restored_claim_is_capped(tiny_path, tmp_path):
    """A file holding ctx - 1 tokens (the JAX engine restores any up to the
    slot's capacity) restores its rows, but the claim stops where a
    released one would (ctx - multi_step - 1), so the free row parked at
    its end stays inside the slot: another slot's decode leaves every
    claimed row as restored."""
    eng = _port(tiny_path)
    _run(eng)
    b = _slot_of(eng)
    eng.slot_op("save", b, str(tmp_path / "s.npz"))
    rng = np.random.default_rng(0)
    n = CTX - 1
    with np.load(tmp_path / "s.npz") as data:
        fields = {k: data[k] for k in ("kind", "model")}
        for f in ("k", "v"):
            L, H, _, D = data[f].shape
            fields[f] = (rng.standard_normal((L, H, n, D)).astype(np.float32)
                         .view(np.uint32) >> 16).astype(np.uint16)   # bf16 bits
    fields["ids"] = rng.integers(300, 500, n).astype(np.int32)
    np.savez(tmp_path / "long.npz", **fields)
    fresh = _port(tiny_path)
    res = fresh.slot_op("restore", 0, str(tmp_path / "long.npz"))
    cap = CTX - fresh.ecfg.multi_step - 1
    assert res["n_restored"] == len(fresh.slots[0].cached_ids) == cap
    assert fresh.slots[0].cached_ids == [int(t) for t in fields["ids"][:cap]]
    rows = [t[0, :, :cap].clone() for t in fresh.cache.k + fresh.cache.v]
    np.testing.assert_array_equal(
        fresh.cache.k[0][0, :, :n].view(torch.int16).numpy().view(np.uint16), fields["k"][0])
    _run(fresh, "over the world and", 12)          # decodes in slot 1
    for before, t in zip(rows, fresh.cache.k + fresh.cache.v):
        assert torch.equal(t[0, :, :cap], before)
    with pytest.raises(ValueError, match="exceeds the slot capacity"):
        np.savez(tmp_path / "too_long.npz", **{**fields, "ids": np.zeros(CTX + 1, np.int32)})
        fresh.slot_op("restore", 0, str(tmp_path / "too_long.npz"))


def test_deepseek2_slot_and_prefix_round_trip(tmp_path):
    """deepseek2's latent cache (one shared head, k 8 wide and v 32): a
    greedy run, the same prompt again from the slot's kept prefix, and the
    slot saved and restored into a fresh engine give the same tokens; the
    file holds each field at its own width."""
    from llama_gguf_inference_tpu.gguf import GGMLType as JGGMLType
    from llama_gguf_inference_tpu.utils.testing import write_tiny_llama
    path = str(write_tiny_llama(tmp_path / "ds2.gguf", dim=64, n_layers=2, n_heads=4,
                                n_kv_heads=4, ffn_dim=128, n_experts=4, n_experts_used=2,
                                quant=JGGMLType.Q8_0, arch="deepseek2"))
    a = _port(path)
    first = _run(a)
    again = _run(a)
    assert a.total_prefix_reused == len(a.tokenizer.encode(PROMPT)) - 1
    b = _slot_of(a)
    n = len(a.slots[b].cached_ids)
    a.slot_op("save", b, str(tmp_path / "ds2.npz"))
    with np.load(tmp_path / "ds2.npz") as f:
        assert f["k"].shape == (2, 1, n, 8) and f["v"].shape == (2, 1, n, 32)
    fresh = _port(path)
    assert fresh.slot_op("restore", 1, str(tmp_path / "ds2.npz"))["n_restored"] == n
    got = _run(fresh)
    assert got == again == first
