"""The port's gateway (``serving/gateway.py``) against the JAX package's, on
the CPU, over the port's mock backend.

One event loop runs the port's OpenAI server over its ``MockEngine`` (with
a backend key) and the two gateways, configured alike (a key file with a
rate-limited key, a CORS allowlist, one request at a time with a queue of
one). The same requests go to each gateway in turn, over real sockets, and
must get the same status, headers and body (chat ids and timestamps
blanked): ``/ping``, ``/health``, 401s without and with a wrong key, 200s
with the key, the rate limit's 429, CORS preflights, the full queue's 503, a
streamed chat passed through chunk by chunk, and ``/metrics`` after the same
sequence.
"""

import asyncio
import http.client
import json
import re
import threading
import time

import pytest

from llama_gguf_inference_tpu.serving import gateway as jgw
from llama_gguf_inference_tpu_torch.runtime.mock import MockEngine
from llama_gguf_inference_tpu_torch.serving import gateway as tgw
from llama_gguf_inference_tpu_torch.serving import openai_server as tsrv

BACKEND_KEY = "backend-" + "k" * 32
KEY = "sk-good-" + "a" * 24
LIMITED = "sk-limited-" + "b" * 24
CHAT = {"model": "m", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 3}


class Stack:
    def __init__(self, tmp_path):
        keys = tmp_path / "keys.txt"
        keys.write_text(f"good:{KEY}\nlimited:{LIMITED}:2\n")
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.engine = MockEngine(delay_s=0.0)
        self.engine.start()
        self.backend = self.run(self._backend())
        self.gateways = {name: self.run(self._gateway(mod, str(keys), tmp_path / name))
                         for name, mod in (("port", tgw), ("jax", jgw))}

    def run(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    async def _backend(self):
        srv = tsrv.OpenAIServer(self.engine, tsrv.BackendConfig(host="127.0.0.1", port=0,
                                                                api_key=BACKEND_KEY))
        await srv.start()
        return srv

    async def _gateway(self, mod, keys, log_dir):
        gw = mod.Gateway(mod.GatewayConfig(
            host="127.0.0.1", port=0, backend_port=self.backend.port,
            backend_api_key=BACKEND_KEY, auth_keys_file=keys, max_concurrent=1,
            max_queue_size=1, cors_origins="https://a.example", access_log=str(log_dir / "a.log")))
        await gw.start()
        return gw

    def close(self):
        for gw in self.gateways.values():
            self.run(gw.close())
        self.run(self.backend.close())
        self.engine.stop()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture
def stack(tmp_path):
    s = Stack(tmp_path)
    yield s
    s.close()


def call(port, method, path, key=None, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    h = dict(headers or {})
    if key:
        h["Authorization"] = f"Bearer {key}"
    data = None if body is None else json.dumps(body)
    if data is not None:
        h["Content-Type"] = "application/json"
    conn.request(method, path, data, h)
    r = conn.getresponse()
    out = (r.status, sorted((k, v) for k, v in r.getheaders() if k != "Content-Length"),
           _blank(r.read()))
    conn.close()
    return out


def _blank(raw: bytes) -> bytes:
    """Per-request values out of a body: ids, creation times, uptime."""
    raw = re.sub(rb'"id": ?"[^"]*"', b'"id": ""', raw)
    raw = re.sub(rb'"(created|uptime_seconds)": ?[0-9.]+', rb'"\1": 0', raw)
    raw = re.sub(rb'"queue_wait_seconds_total": ?[0-9.e-]+', b'"queue_wait_seconds_total": 0',
                 raw)
    return re.sub(rb"(gateway_uptime_seconds|gateway_queue_wait_seconds_total) [0-9.e-]+",
                  rb"\1 0", raw)


SEQUENCE = [
    ("GET", "/ping", None, None, None),
    ("GET", "/health", None, None, None),
    ("GET", "/v1/models", None, None, None),
    ("GET", "/v1/models", "sk-wrong-" + "z" * 24, None, None),
    ("GET", "/v1/models", "short", None, None),
    ("GET", "/v1/models", KEY, None, None),
    ("POST", "/v1/chat/completions", KEY, CHAT, None),
    ("POST", "/v1/chat/completions", KEY, {**CHAT, "stream": True}, None),
    ("POST", "/v1/completions", KEY, {"prompt": "a b", "max_tokens": 2}, None),
    ("GET", "/v1/models", LIMITED, None, None),
    ("GET", "/v1/models", LIMITED, None, None),
    ("GET", "/v1/models", LIMITED, None, None),          # past its 2 a minute: 429
    ("OPTIONS", "/v1/chat/completions", None, None,
     {"Origin": "https://a.example", "Access-Control-Request-Method": "POST"}),
    ("OPTIONS", "/v1/chat/completions", None, None, {"Origin": "https://evil.example"}),
    ("GET", "/v1/models", KEY, None, {"Origin": "https://a.example"}),
    ("POST", "/reload", KEY, None, None),
    ("GET", "/nope", KEY, None, None),
    ("GET", "/metrics", None, None, None),
    ("GET", "/metrics", None, None, {"Accept": "text/plain"}),
]


def test_same_answers_as_jax(stack):
    answers = {}
    for name, gw in stack.gateways.items():
        answers[name] = [call(gw.port, m, p, k, b, h) for m, p, k, b, h in SEQUENCE]
    for i, (got, want) in enumerate(zip(answers["port"], answers["jax"])):
        assert got == want, (SEQUENCE[i], got, want)
    statuses = [a[0] for a in answers["port"]]
    assert statuses == [200, 200, 401, 401, 401, 200, 200, 200, 200, 200, 200, 429, 204, 204,
                        200, 200, 404, 200, 200]
    stream = answers["port"][7][2].decode()
    events = [ln for ln in stream.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "data: [DONE]" and len(events) >= 4
    limited = dict(answers["port"][11][1])
    assert limited["Retry-After"] == "60"
    pre = dict(answers["port"][12][1])
    assert pre["Access-Control-Allow-Origin"] == "https://a.example"
    metrics = json.loads(answers["port"][17][2])["gateway"]
    assert metrics["requests_unauthorized"] == 4 and metrics["requests_success"] >= 8


def test_full_queue_same_as_jax(stack):
    """One request held by the slow backend, one queued, the third refused
    with 503 and Retry-After 5, by both gateways."""
    stack.engine.delay_s = 0.15
    out = {}
    for name, gw in stack.gateways.items():
        results = {}

        def send(i):
            results[i] = call(gw.port, "POST", "/v1/completions", KEY,
                              {"prompt": "x", "max_tokens": 6})

        first = threading.Thread(target=send, args=(0,))
        first.start()
        _wait(lambda: gw.metrics.requests_active == 1)
        second = threading.Thread(target=send, args=(1,))
        second.start()
        _wait(lambda: gw.metrics.queue_depth == 1)
        send(2)
        first.join(30)
        second.join(30)
        out[name] = [results[i] for i in range(3)]
        out[name].append(call(gw.port, "GET", "/metrics"))
    assert out["port"] == out["jax"]
    assert [r[0] for r in out["port"]] == [200, 200, 503, 200]
    assert dict(out["port"][2][1])["Retry-After"] == "5"
    m = json.loads(out["port"][3][2])["gateway"]
    assert m["queue_rejections"] == 1 and m["requests_error"] == 1


def _wait(cond, timeout=20.0):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError("timed out")
        time.sleep(0.01)
