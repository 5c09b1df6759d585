"""llama-server's utility paths in the port's server, on the CPU, against the
JAX package's server: ``/tokenize``, ``/detokenize``, ``/apply-template``,
``/infill``, ``/props``, ``/completion``, ``GET /slots`` and ``POST
/slots/{id}?action=...``.

The model is the synthesizer's 160m shape with its FIM tokens
(``tools.synth``'s ``fim``), so ``/infill`` takes them from the GGUF
metadata. Both servers' handlers get the same requests: the JSON of
``/tokenize``, ``/detokenize`` and ``/apply-template`` and the status codes
and JSON of the slot actions' checks must be equal (the JAX server over a
stub engine holding the JAX package's tokenizer of the same file), and
``/infill`` must submit the same prompt ids and answer with the same JSON.
Then the port's server over its real engine through HTTP: ``/infill``,
``/completion``, ``/props``, ``/slots`` and a save, erase and restore.
"""

import asyncio
import dataclasses
import json
import queue

import pytest
import torch

from llama_gguf_inference_tpu.gguf.reader import GGUFReader as JReader
from llama_gguf_inference_tpu.runtime.tokenizer import from_gguf_metadata as jtokenizer
from llama_gguf_inference_tpu.serving import openai_server as jsrv
from llama_gguf_inference_tpu_torch.runtime import engine as tengine
from llama_gguf_inference_tpu_torch.runtime.engine import GenEvent
from llama_gguf_inference_tpu_torch.serving import openai_server as tsrv
from llama_gguf_inference_tpu_torch.tools.synth import synth_model

torch.set_num_threads(1)

KEY = "sk-util-" + "k" * 24


@pytest.fixture(scope="module")
def fim_path(tmp_path_factory):
    return synth_model(str(tmp_path_factory.mktemp("util") / "fim.gguf"), "160m", fim=True)


@pytest.fixture(scope="module")
def port_engine(fim_path):
    eng = tengine.InferenceEngine(fim_path, tengine.EngineConfig(max_slots=2, ctx=64),
                                  device="cpu")
    eng.start()
    yield eng
    eng.stop()


class _Stub:
    """A server's view of an engine: its tokenizer and metadata; records
    each submission and answers it with two tokens; slot actions echo."""

    model_name = "stub"

    def __init__(self, tokenizer, metadata):
        self.tokenizer, self.metadata = tokenizer, metadata
        self.submitted: list = []

    def submit(self, prompt, params, request_id=None):
        self.submitted.append(list(prompt))
        q: queue.Queue = queue.Queue()
        q.put(GenEvent(token_id=300, text=" x", n_prompt=len(prompt), n_generated=1))
        q.put(GenEvent(token_id=2, finished=True, finish_reason="stop",
                       n_prompt=len(prompt), n_generated=2))
        return f"rid{len(self.submitted)}", q

    def cancel(self, rid):
        return True

    def slot_op(self, op, b, path=""):
        return {"id_slot": b, "op": op, "path": path}


class _Writer:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b

    async def drain(self):
        pass


@dataclasses.dataclass
class _Req:
    body: bytes
    method: str = "POST"
    path: str = "/"
    headers: dict = dataclasses.field(default_factory=dict)


def _parse(raw: bytes):
    head, _, body = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    if b"text/event-stream" in head:
        return status, [json.loads(ln[6:]) if ln[6:] != "[DONE]" else ln[6:]
                        for ln in body.decode().split("\n") if ln.startswith("data: ")]
    return status, json.loads(body)


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def both(port_engine, fim_path):
    """(JAX server, its stub), (port server, its stub): the same file's
    tokenizer in each package."""
    r = JReader(fim_path)
    jstub = _Stub(jtokenizer(r.metadata), dict(r.metadata))
    r.close()
    tstub = _Stub(port_engine.tokenizer, port_engine.metadata)
    return ((jsrv.OpenAIServer(jstub, jsrv.BackendConfig()), jstub),
            (tsrv.OpenAIServer(tstub, tsrv.BackendConfig()), tstub))


def _call(both, handler, body, *args, raw=None, path="/"):
    """Each server's (status, scrubbed JSON, submissions) for one request."""
    out = []
    for srv, stub in both:
        w = _Writer()
        data = raw if raw is not None else json.dumps(body).encode()
        stub.submitted.clear()
        asyncio.run(getattr(srv, handler)(_Req(data, path=path), w, *args))
        status, obj = _parse(w.data)
        out.append((status, _scrub(obj), list(stub.submitted)))
    return out


TOKENIZE = [{"content": "hello world"}, {"content": "hello world", "add_special": True},
            {"content": "hi", "with_pieces": True},
            {"content": "the quick brown fox", "with_pieces": True, "add_special": True},
            {"content": ""}, {"content": 12}, {}, None]


@pytest.mark.parametrize("i", range(len(TOKENIZE)))
def test_tokenize_matches_jax(both, i):
    body = TOKENIZE[i]
    raw = b"not json" if body is None else None
    want, got = _call(both, "handle_tokenize", body, raw=raw)
    assert got == want
    assert got[0] == (200 if body and "content" in body else 400)


DETOKENIZE = [{"tokens": [1, 300, 311, 290]}, {"tokens": [31997, 300, 31999]},
              {"tokens": []}, {"tokens": [0, 10 ** 9]}, {"tokens": [-1]},
              {"tokens": ["x"]}, {"tokens": "12"}, {"nope": 1}]


@pytest.mark.parametrize("i", range(len(DETOKENIZE)))
def test_detokenize_matches_jax(both, i):
    want, got = _call(both, "handle_detokenize", DETOKENIZE[i])
    assert got == want
    assert got[0] == (200 if i < 3 else 400)


TEMPLATE = [{"messages": [{"role": "system", "content": "be brief"},
                          {"role": "user", "content": "hi"}]},
            {"messages": [{"role": "user", "content": [{"type": "text", "text": "yo"}]},
                          {"role": "assistant", "content": "hey"},
                          {"role": "user", "content": "again"}]},
            {"messages": []}, {"messages": "hi"}, {}]


@pytest.mark.parametrize("i", range(len(TEMPLATE)))
def test_apply_template_matches_jax(both, i):
    want, got = _call(both, "handle_apply_template", TEMPLATE[i])
    assert got == want and not got[2]           # nothing submitted
    assert got[0] == (200 if i < 3 else 400)


INFILL = [{"input_prefix": "def f(", "input_suffix": ")", "max_tokens": 3, "temperature": 0},
          {"input_prefix": "the quick", "input_suffix": "lazy dog", "stream": True},
          {"input_prefix": "x"}, {"input_prefix": "x", "temperature": "hot"},
          {"input_suffix": "y"}]


@pytest.mark.parametrize("i", range(len(INFILL)))
def test_infill_matches_jax(both, port_engine, i):
    want, got = _call(both, "handle_infill", INFILL[i])
    assert got == want
    if i < 3:
        sp = port_engine.tokenizer.special
        ids = got[2][0]
        assert got[0] == 200 and ids[:2] == [sp.bos_id, sp.fim_pre_id] \
            and ids[-1] == sp.fim_mid_id and sp.fim_suf_id in ids
    else:
        assert got[0] == 400 and not got[2]


def test_infill_without_fim_tokens_is_501(both, fim_path):
    r = JReader(fim_path)
    md = {k: v for k, v in r.metadata.items() if "fim" not in k}
    r.close()
    from llama_gguf_inference_tpu_torch.runtime.tokenizer import from_gguf_metadata
    out = []
    for mod, tok in ((jsrv, jtokenizer(md)), (tsrv, from_gguf_metadata(md))):
        w = _Writer()
        asyncio.run(mod.OpenAIServer(_Stub(tok, md), mod.BackendConfig()).handle_infill(
            _Req(json.dumps({"input_prefix": "def f("}).encode()), w))
        out.append(_parse(w.data))
    assert out[0] == out[1] and out[1][0] == 501
    assert out[1][1]["error"]["code"] == "not_supported"


SLOT_ACTIONS = [("/slots/0?action=erase", {}, True), ("/slots/1?action=save", {"filename": "a.npz"}, True),
                ("/slots/0?action=restore", {"filename": "../../etc/a.npz"}, True),
                ("/slots/0?action=save", {}, True), ("/slots/0?action=save", {"filename": "a"}, False),
                ("/slots/x?action=save", {"filename": "a"}, True),
                ("/slots/0?action=drop", {}, True), ("/slots/0", {}, True)]


@pytest.mark.parametrize("i", range(len(SLOT_ACTIONS)))
def test_slot_action_checks_match_jax(both, i, tmp_path, monkeypatch):
    """The same status and JSON from both servers; save and restore name
    ``SLOT_SAVE_PATH/<basename>``, and are refused without the variable."""
    path, body, with_dir = SLOT_ACTIONS[i]
    if with_dir:
        monkeypatch.setenv("SLOT_SAVE_PATH", str(tmp_path))
    else:
        monkeypatch.delenv("SLOT_SAVE_PATH", raising=False)
    url = path.split("?")[0]
    want, got = _call(both, "handle_slot_action", body, url, path=path)
    assert got[:2] == want[:2]
    ok = got[0] == 200
    assert ok == (i < 3)
    if i == 2:
        assert got[1]["path"] == str(tmp_path / "a.npz")


async def _http(port, method, path, body=None, key=KEY):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    head = [f"{method} {path} HTTP/1.1", "Host: localhost", f"Content-Length: {len(data)}"]
    if key:
        head.append(f"Authorization: Bearer {key}")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(-1), timeout=120)
    writer.close()
    hdr, _, payload = raw.partition(b"\r\n\r\n")
    return int(hdr.split(b" ", 2)[1]), json.loads(payload) if payload else None


async def test_served_utility_paths(port_engine, tmp_path, monkeypatch):
    srv = tsrv.OpenAIServer(port_engine, tsrv.BackendConfig(host="127.0.0.1", port=0,
                                                            api_key=KEY))
    await srv.start()
    try:
        st, body = await _http(srv.port, "POST", "/infill",
                               {"input_prefix": "def f(", "input_suffix": ")",
                                "max_tokens": 3, "temperature": 0})
        n_ids = 3 + len(port_engine.tokenizer.encode("def f(", add_bos=False)) \
            + len(port_engine.tokenizer.encode(")", add_bos=False)) + 1
        assert st == 200 and body["object"] == "text_completion"
        assert body["usage"] == {"prompt_tokens": n_ids, "completion_tokens": 3,
                                 "total_tokens": n_ids + 3}
        st, body = await _http(srv.port, "POST", "/completion",
                               {"prompt": "the quick brown fox", "max_tokens": 2,
                                "temperature": 0})
        assert st == 200 and body["object"] == "text_completion"
        st, props = await _http(srv.port, "GET", "/props")
        assert st == 200 and props["model"] == port_engine.model_name
        assert {"uptime_seconds", "slots_total", "slots_active", "queue_depth", "ctx",
                "total_generated", "total_prompt_tokens", "prefix_tokens_reused",
                "decode_step_ewma_ms"} <= set(props)
        assert props["total_generated"] >= 5 and props["ctx"] == 64
        st, slots = await _http(srv.port, "GET", "/slots")
        assert st == 200 and [s["id"] for s in slots] == [0, 1]
        assert all(s["state"] == 0 and s["n_ctx"] == 64 for s in slots)
        kept = [s for s in slots if s["prefix_cached_tokens"] > 0]
        assert kept
        b = kept[0]["id"]
        monkeypatch.setenv("SLOT_SAVE_PATH", str(tmp_path))
        st, saved = await _http(srv.port, "POST", f"/slots/{b}?action=save",
                                {"filename": "s.npz"})
        assert st == 200 and saved["n_saved"] == kept[0]["prefix_cached_tokens"]
        st, erased = await _http(srv.port, "POST", f"/slots/{b}?action=erase")
        assert st == 200 and erased == {"id_slot": b, "n_erased": saved["n_saved"]}
        st, err = await _http(srv.port, "POST", f"/slots/{b}?action=restore",
                              {"filename": "missing.npz"})
        assert st == 400 and err["error"]["message"] == "no such slot file"
        st, restored = await _http(srv.port, "POST", f"/slots/{b}?action=restore",
                                   {"filename": "s.npz"})
        assert st == 200 and restored["n_restored"] == saved["n_saved"]
        st, slots = await _http(srv.port, "GET", "/slots")
        assert slots[b]["prefix_cached_tokens"] == saved["n_saved"]
        st, _ = await _http(srv.port, "POST", "/tokenize", {"content": "hi"}, key="")
        assert st == 401
    finally:
        await srv.close()
