"""The port's launcher, ``launch/start.py``, on the CPU.

``python -m llama_gguf_inference_tpu_torch serve`` with ``MOCK_BACKEND``
boots three processes of the port's own modules (the backend, the health
sidecar, the gateway; no JAX in any of them): the gateway's ``/ping``, a
401 without the key and a 200 with it, the health port on every path, a
streamed chat through the proxy; SIGTERM to the supervisor: it and each
child exit 0 and the backend key file is gone. The helpers are held to the
JAX launcher's on the same inputs; ``detect_data_dir`` departs from it where
``DATA_DIR`` is set (the port takes it first).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from llama_gguf_inference_tpu.launch import start as jstart
from llama_gguf_inference_tpu_torch.launch import start as tstart
from llama_gguf_inference_tpu_torch.serving.key_mgmt import main as key_mgmt_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def request(url, key=None, body=None, timeout=10.0):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode())
    if key:
        req.add_header("Authorization", f"Bearer {key}")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def poll(url, deadline, proc, key=None):
    """The first status ``url`` answers before ``deadline``; raises if the
    supervisor exits first."""
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"supervisor exited {proc.returncode}")
        try:
            return request(url, key, timeout=2.0)[0]
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


@pytest.mark.parametrize("line,want", [
    ("GET /v1/models -> 401", True), ("Unauthorized request", True),
    ("status=200 path=/v1/models", False), ("committed 4012 bytes", False)])
def test_scan_auth_failure_matches_jax(line, want):
    assert tstart.scan_auth_failure(line) == jstart.scan_auth_failure(line) == want


@pytest.mark.parametrize("v", ["true", "1", "YES", "on", "false", "", None, "0"])
def test_is_truthy_matches_jax(v):
    assert tstart.is_truthy(v) == jstart.is_truthy(v)


def test_resolve_model_matches_jax(tmp_path, monkeypatch):
    m = tmp_path / "a.gguf"
    m.write_bytes(b"x")
    cases = [({"MODEL_PATH": str(m), "MODEL_NAME": "other.gguf"}),
             ({"MODELS_DIR": str(tmp_path), "MODEL_NAME": "a.gguf"}),
             ({"MODELS_DIR": str(tmp_path), "MODEL_NAME": "missing.gguf"}),
             ({"MODEL_PATH": str(tmp_path / "missing.gguf")}), ({})]
    for env in cases:
        for k in ("MODEL_PATH", "MODEL_NAME", "MODELS_DIR"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tstart.resolve_model(str(tmp_path)) == jstart.resolve_model(str(tmp_path))


def test_key_file_written_and_shredded_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("BACKEND_KEY_DIR", str(tmp_path))
    for mod in (tstart, jstart):
        key, path = mod.write_backend_key()
        assert key.startswith("gateway-") and len(key) == len("gateway-") + 43
        assert open(path).read() == key and oct(os.stat(path).st_mode & 0o777) == "0o600"
        assert os.path.dirname(path) == str(tmp_path / "llama-keys")
        mod.shred_key(path)
        assert not os.path.exists(path)


def test_verify_localhost_bind_matches_jax():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        port = s.getsockname()[1]
        assert tstart.verify_localhost_bind(port) == jstart.verify_localhost_bind(port) is True
    with socket.socket() as s:
        s.bind(("0.0.0.0", 0))
        s.listen(1)
        port = s.getsockname()[1]
        assert tstart.verify_localhost_bind(port) == jstart.verify_localhost_bind(port) is False
    port = free_port()
    assert tstart.verify_localhost_bind(port) == jstart.verify_localhost_bind(port) is None


def test_detect_data_dir_takes_data_dir_first(tmp_path, monkeypatch):
    """The port's departure: an explicit DATA_DIR wins; without it both
    launchers probe the same volumes and fall back to /data."""
    monkeypatch.setenv("DATA_DIR", str(tmp_path))
    assert tstart.detect_data_dir() == str(tmp_path)
    monkeypatch.delenv("DATA_DIR")
    assert tstart.detect_data_dir() == jstart.detect_data_dir()


def test_spawns_the_port_modules():
    src = open(tstart.__file__).read()
    for mod in ("serving.openai_server", "serving.health_server", "serving.gateway"):
        assert f'"llama_gguf_inference_tpu_torch.{mod}"' in src
    assert '"llama_gguf_inference_tpu.' not in src


def test_mock_stack_boots_and_stops(tmp_path):
    gw, health, backend = free_port(), free_port(), free_port()
    keys = tmp_path / "api_keys.txt"
    assert key_mgmt_main(["--keys-file", str(keys), "generate", "--key-id", "ci",
                          "--quiet"]) == 0
    api_key = keys.read_text().strip().split(":")[1]
    env = {k: v for k, v in os.environ.items() if k not in ("MODEL_PATH", "DATA_DIR")}
    env.update({"MOCK_BACKEND": "true", "DATA_DIR": str(tmp_path),
                "GATEWAY_HOST": "127.0.0.1", "GATEWAY_PORT": str(gw),
                "PORT_HEALTH": str(health), "PORT_BACKEND": str(backend),
                "AUTH_KEYS_FILE": str(keys), "BACKEND_KEY_DIR": str(tmp_path)})
    log = tmp_path / "stack.log"
    with open(log, "wb") as log_f:
        proc = subprocess.Popen([sys.executable, "-m", "llama_gguf_inference_tpu_torch", "serve"],
                                env=env, cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 90
            assert poll(f"http://127.0.0.1:{gw}/ping", deadline, proc) == 200
            assert poll(f"http://127.0.0.1:{health}/", deadline, proc) == 200
            assert request(f"http://127.0.0.1:{health}/anything")[0] == 200
            assert request(f"http://127.0.0.1:{gw}/v1/models")[0] == 401
            assert request(f"http://127.0.0.1:{gw}/v1/models", api_key)[0] == 200
            status, body = request(f"http://127.0.0.1:{gw}/v1/chat/completions", api_key,
                                   {"messages": [{"role": "user", "content": "hi"}],
                                    "max_tokens": 3, "stream": True})
            events = [ln[6:] for ln in body.decode().splitlines() if ln.startswith("data: ")]
            assert status == 200 and events[-1] == "[DONE]" and len(events) >= 4
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=40) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    text = log.read_text()
    for name in ("backend", "health", "gateway"):
        assert f"[start] {name} exited 0" in text, text[-3000:]
    assert not list((tmp_path / "llama-keys").glob("*.key"))
    assert "jax" not in text.lower()
