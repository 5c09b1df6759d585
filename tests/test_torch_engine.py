"""The port's engine, sampler, server and synthesizer, on the CPU.

Greedy tokens are held against the JAX package's InferenceEngine running the
same Pallas kernel functions (forced on in interpret mode), so the two
compute the same logits up to f32 sum order and single bf16 roundings: at
most 0.5% of the step's largest |logit| apart (measured 0.32% on this
model). Each step's top-2 margin must exceed twice that, so a token
mismatch is a bug, never rounding.
"""

import asyncio
import json
import os
import pytest
import torch

from llama_gguf_inference_tpu.ops import matmul_kernels as jmk
from llama_gguf_inference_tpu.runtime import engine as jengine
from llama_gguf_inference_tpu.runtime.sampler import SamplingParams as JParams
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime.sampler import (SamplingParams, sample,
                                                            unsupported)
from llama_gguf_inference_tpu_torch.serving.openai_server import (BackendConfig,
                                                                  OpenAIServer)
from test_torch_model import write_tiny_q4km

torch.set_num_threads(1)

PROMPTS = ["hello world", "over the world and", "a quick dog", "to the lazy dog"]
LOGIT_TOL = 0.005          # of the step's max |logit|
KEY = "sk-port-" + "k" * 24


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    return str(write_tiny_q4km(tmp_path_factory.mktemp("eng") / "tiny.gguf"))


@pytest.fixture(scope="module")
def port_engine(tiny_path):
    eng = tengine.InferenceEngine(
        tiny_path, tengine.EngineConfig(max_slots=4, ctx=64), device="cpu")
    eng.start()
    yield eng
    eng.stop()


def _greedy_port(eng, prompts):
    outs = [eng.submit(p, SamplingParams(temperature=0.0, max_tokens=8))[1]
            for p in prompts]
    toks = []
    for out in outs:
        seq = []
        while True:
            ev = out.get(timeout=120)
            seq.append(ev.token_id)
            if ev.finished:
                break
        toks.append(seq)
    return toks


def _greedy_jax(path, prompts, slots, monkeypatch):
    monkeypatch.setattr(jmk, "_on_tpu", lambda: True)   # Pallas, interpret mode
    eng = jengine.InferenceEngine(path, jengine.EngineConfig(
        max_slots=slots, ctx=64, multi_step=1, prefix_cache=False))
    eng.start()
    try:
        outs = [eng.submit(p, JParams(temperature=0.0, max_tokens=8))[1]
                for p in prompts]
        toks = []
        for out in outs:
            seq = []
            while True:
                ev = out.get(timeout=600)
                seq.append(ev.token_id)
                if ev.finished:
                    break
            toks.append(seq)
        return toks
    finally:
        eng.stop()


def _assert_margins(eng, prompt, toks):
    """Along the generated path, top-1 beats top-2 by more than twice the
    logit tolerance at every step."""
    ids = eng.tokenizer.encode(prompt)
    cache = tllama.KVCache.zeros(eng.cfg, 1, 64, "cpu")
    with torch.inference_mode():
        lg = tllama.forward(eng.params, eng.cfg, torch.tensor([ids], dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32), cache)[0, -1]
        pos = len(ids)
        for t in toks:
            top = torch.topk(lg, 2).values
            assert int(lg.argmax()) == t
            assert top[0] - top[1] > 2 * LOGIT_TOL * lg.abs().max(), (prompt, t)
            lg = tllama.forward(eng.params, eng.cfg, torch.tensor([[t]], dtype=torch.int32),
                                torch.tensor([pos], dtype=torch.int32), cache)[0, 0]
            pos += 1


@pytest.mark.parametrize("slots", [1, 4])
def test_greedy_tokens_match_jax_engine(slots, tiny_path, port_engine, monkeypatch):
    prompts = PROMPTS[:slots]
    want = _greedy_jax(tiny_path, prompts, slots, monkeypatch)
    got = _greedy_port(port_engine, prompts)
    assert got == want
    assert all(len(s) == 8 for s in got)
    for p, toks in zip(prompts, got):
        _assert_margins(port_engine, p, toks)


def test_stop_string_and_max_tokens(port_engine):
    full = port_engine.generate_text("hello world",
                                     SamplingParams(temperature=0.0, max_tokens=8))
    assert full
    stop = full[len(full) // 2:len(full) // 2 + 2]
    evs = list(port_engine.generate("hello world", SamplingParams(
        temperature=0.0, max_tokens=8, stop=(stop,))))
    assert evs[-1].finish_reason == "stop"
    assert "".join(e.text for e in evs) == full[:full.index(stop)]
    evs = list(port_engine.generate("brown dog", SamplingParams(temperature=0.0,
                                                            max_tokens=3)))
    assert evs[-1].finish_reason == "length" and evs[-1].n_generated == 3


def test_sampler_seeded_and_truncation():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 50, generator=g)
    p = SamplingParams(temperature=0.9, top_k=5, top_p=0.8, min_p=0.05, seed=7)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return [int(sample(logits, [p, None, p], [gen, None, gen])[i])
                for i in range(3)]

    a, b = draw(7), draw(7)
    assert a == b                                     # seeded: reproducible
    assert a[1] == int(logits[1].argmax())            # None row: greedy
    top5 = set(torch.topk(logits[0], 5).indices.tolist())
    for s in range(20):
        assert draw(s)[0] in top5                     # top-k truncation holds
    one = SamplingParams(temperature=1.0, top_k=1)
    gen = torch.Generator().manual_seed(1)
    assert int(sample(logits[:1], [one], [gen])[0]) == int(logits[0].argmax())


def test_unsupported_settings_are_named(port_engine):
    assert unsupported(SamplingParams()) == []
    p = SamplingParams(presence_penalty=0.5, mirostat=2, logit_bias={3: 1.0})
    assert unsupported(p) == ["presence_penalty", "mirostat", "logit_bias"]
    with pytest.raises(ValueError, match="presence_penalty"):
        port_engine.submit("hi", p)


async def _http(port, method, path, body=None, key=KEY):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    head = [f"{method} {path} HTTP/1.1", "Host: localhost",
            f"Content-Length: {len(data)}"]
    if key:
        head.append(f"Authorization: Bearer {key}")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(-1), timeout=120)
    writer.close()
    hdr, _, payload = raw.partition(b"\r\n\r\n")
    return int(hdr.split(b" ", 2)[1]), payload


async def test_http_round_trip(port_engine):
    srv = OpenAIServer(port_engine, BackendConfig(host="127.0.0.1", port=0,
                                                  api_key=KEY))
    await srv.start()
    try:
        msgs = [{"role": "user", "content": "hello world"}]
        st, body = await _http(srv.port, "POST", "/v1/chat/completions",
                               {"messages": msgs, "max_tokens": 4, "temperature": 0})
        assert st == 200
        resp = json.loads(body)
        assert resp["choices"][0]["message"]["role"] == "assistant"
        assert resp["usage"]["completion_tokens"] == 4
        st, body = await _http(srv.port, "POST", "/v1/chat/completions",
                               {"messages": msgs, "max_tokens": 4,
                                "temperature": 0, "stream": True})
        assert st == 200
        events = [ln[6:] for ln in body.decode().split("\n") if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
        streamed = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
        assert streamed == resp["choices"][0]["message"]["content"]
        st, body = await _http(srv.port, "POST", "/v1/completions",
                               {"prompt": "in the", "max_tokens": 3, "temperature": 0})
        assert st == 200 and json.loads(body)["choices"][0]["finish_reason"] == "length"
        st, _ = await _http(srv.port, "GET", "/v1/models", key="")
        assert st == 401
        st, _ = await _http(srv.port, "GET", "/v1/models", key="wrong")
        assert st == 401
        st, body = await _http(srv.port, "GET", "/v1/models")
        assert st == 200 and json.loads(body)["data"][0]["id"] == "tiny-q4km"
        st, body = await _http(srv.port, "POST", "/v1/completions",
                               {"prompt": "x", "logprobs": 2})
        assert st == 400 and b"logprobs" in body
        st, _ = await _http(srv.port, "GET", "/health", key="")
        assert st == 200
    finally:
        await srv.close()


def test_synth_matches_bench(tmp_path, monkeypatch):
    import bench
    from llama_gguf_inference_tpu_torch.tools.synth import synth_model
    monkeypatch.setenv("BENCH_MODEL", str(tmp_path / "bench.gguf"))
    want = bench.bench_model_path("160m")
    got = synth_model(str(tmp_path / "synth.gguf"), "160m")
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


def test_cached_model_is_keyed_by_shape_and_seed(tmp_path, monkeypatch):
    from llama_gguf_inference_tpu_torch.tools import synth
    calls = []

    def fake(path, shape, seed, quant="q4_k"):
        calls.append((shape, seed, quant))
        with open(path, "wb") as f:
            f.write(b"gguf")
        return path

    monkeypatch.setattr(synth, "synth_model", fake)
    a = synth.cached_model("160m", 0, str(tmp_path))
    assert synth.cached_model("160m", 0, str(tmp_path)) == a      # reused, not rewritten
    b = synth.cached_model("160m", 1, str(tmp_path))
    c = synth.cached_model("8b", 0, str(tmp_path))
    d = synth.cached_model("160m", 0, str(tmp_path), quant="q2_k")
    assert synth.cached_model("160m", 0, str(tmp_path), quant="q2_k") == d
    assert len({a, b, c, d}) == 4 and calls == [
        ("160m", 0, "q4_k"), ("160m", 1, "q4_k"), ("8b", 0, "q4_k"), ("160m", 0, "q2_k")]
    assert sorted(os.listdir(tmp_path)) == sorted(os.path.basename(p) for p in (a, b, c, d))


def test_cpu_path_counts_plain_launches(port_engine):
    _build.reset_launches()
    port_engine.generate_text("in the", SamplingParams(temperature=0.0, max_tokens=2))
    assert _build.LAUNCHES.get("quant_matmul_4bit.plain", 0) > 0
    assert _build.LAUNCHES.get("quant_matmul_8bit.plain", 0) > 0
    assert _build.LAUNCHES.get("flash_attention.plain", 0) > 0
    assert not any(not k.endswith(".plain") for k in _build.LAUNCHES)
