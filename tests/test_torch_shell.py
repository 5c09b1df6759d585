"""The port's copies of the serving shell's small modules, on the CPU,
against the JAX package's on the same inputs: ``serving/auth.py``,
``serving/key_mgmt.py``, ``utils/logging.py``, ``serving/health_server.py``,
the benchmark client ``serving/benchmark.py`` and the unified CLI
``__main__.py``.

Each pair gets the same key files, headers, argument lists, log fields,
GET paths and SSE buffers and must answer the same (random key values and
timestamps aside). The benchmark clients run against one recording backend
and must send it the same requests. Departures pinned here: the port's
health sidecar exits 0 on SIGTERM, and its CLI names only the port's
modules.
"""

import asyncio
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from llama_gguf_inference_tpu import __main__ as jcli
from llama_gguf_inference_tpu.serving import auth as jauth
from llama_gguf_inference_tpu.serving import benchmark as jbench
from llama_gguf_inference_tpu.serving import health_server as jhealth
from llama_gguf_inference_tpu.serving import key_mgmt as jkm
from llama_gguf_inference_tpu.utils import logging as jlog
from llama_gguf_inference_tpu_torch import __main__ as tcli
from llama_gguf_inference_tpu_torch.serving import auth as tauth
from llama_gguf_inference_tpu_torch.serving import benchmark as tbench
from llama_gguf_inference_tpu_torch.serving import health_server as thealth
from llama_gguf_inference_tpu_torch.serving import key_mgmt as tkm
from llama_gguf_inference_tpu_torch.utils import logging as tlog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID = "sk-test-" + "a" * 24
KEYS = ("# comment line\n"
        f"prod:{VALID}\n"
        f"limited:sk-limited-{'b' * 24}:2\n"
        f"expired:sk-expired-{'c' * 24}::2020-01-01\n"
        f"future:sk-future-{'e' * 24}::2999-01-01T00:00:00Z\n"
        "malformed line without colon\n"
        f"bad key id!!:sk-okkey-{'d' * 24}\n"
        "shortkey:tooshort\n"
        f"zero:sk-zero-{'f' * 24}:0\n")


def _result(r):
    return (r.ok, r.key_id, r.status, r.message, r.code)


# ---------------------------------------------------------------- auth

HEADERS = [{}, {"authorization": ""}, {"authorization": "Bearer"},
           {"authorization": f"Bearer {VALID}"}, {"authorization": VALID},
           {"authorization": f"bearer {VALID}"}, {"authorization": "Bearer short"},
           {"authorization": f"Bearer sk-nope-{'z' * 24}"},
           {"authorization": f"Bearer sk-expired-{'c' * 24}"},
           {"authorization": f"Bearer sk-future-{'e' * 24}"},
           {"x-api-key": VALID}, {"authorization": f"Basic {VALID}"}]


@pytest.mark.parametrize("i", range(len(HEADERS)))
def test_validator_matches_jax(tmp_path, i):
    p = tmp_path / "keys.txt"
    p.write_text(KEYS)
    t, j = tauth.APIKeyValidator(str(p)), jauth.APIKeyValidator(str(p))
    assert t.n_keys == j.n_keys
    assert _result(t.validate(HEADERS[i])) == _result(j.validate(HEADERS[i]))


def test_rate_limit_and_reload_match_jax(tmp_path):
    p = tmp_path / "keys.txt"
    p.write_text(KEYS)
    t, j = tauth.APIKeyValidator(str(p)), jauth.APIKeyValidator(str(p))
    h = {"authorization": f"Bearer sk-limited-{'b' * 24}"}
    assert [_result(t.validate(h)) for _ in range(4)] == \
        [_result(j.validate(h)) for _ in range(4)]
    assert t.get_metrics() == j.get_metrics()
    p.write_text(f"only:{VALID}\n")
    assert t.reload_keys() == j.reload_keys() == 1
    assert _result(t.validate(h)) == _result(j.validate(h))
    assert _result(tauth.APIKeyValidator(None).validate({})) == \
        _result(jauth.APIKeyValidator(None).validate({}))
    assert _result(tauth.APIKeyValidator(None, enabled=False).validate({})) == \
        _result(jauth.APIKeyValidator(None, enabled=False).validate({}))


@pytest.mark.parametrize("value", ["2030-01-01", "2030-01-01T00:00:00Z",
                                   "2030-01-01T00:00:00+02:00", "not a date", ""])
def test_parse_expiration_ts_matches_jax(value):
    assert tauth.parse_expiration_ts(value) == jauth.parse_expiration_ts(value)


def test_access_log_matches_jax(tmp_path):
    lines = []
    for mod in (tauth, jauth):
        path = tmp_path / f"{mod.__name__}.log"
        log = mod.AccessLogger(str(path))
        log.log("prod", "GET", "/v1/models\r\nInjected: x", 200)
        log.log(None, "POST", "/v1/chat/completions", 401)
        lines.append([ln.split(" | ", 1)[1] for ln in path.read_text().splitlines()])
    assert lines[0] == lines[1] and len(lines[0]) == 2


# ---------------------------------------------------------------- key_mgmt

@pytest.mark.parametrize("spec", ["30d", "12h", "45m", "2030-01-01T00:00:00Z", "2w", "soon"])
def test_parse_expiration_matches_jax(spec):
    if spec in ("2w", "soon"):      # refused by both, with the same message
        msgs = []
        for mod in (tkm, jkm):
            with pytest.raises(SystemExit) as e:
                mod.parse_expiration(spec)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        return
    a, b = tkm.parse_expiration(spec), jkm.parse_expiration(spec)
    if spec[-1] in "dhm":       # relative: both from now, a second apart at most
        ta = time.mktime(time.strptime(a, "%Y-%m-%dT%H:%M:%SZ"))
        tb = time.mktime(time.strptime(b, "%Y-%m-%dT%H:%M:%SZ"))
        assert abs(ta - tb) <= 1
    else:
        assert a == b


@pytest.mark.parametrize("line", ["id1:sk-abc", "id1:sk-abc:50", "id1:sk-abc::2030-01-01T00:00:00Z",
                                  "# comment", "", "justonefield",
                                  "id1:sk-abc:10:2030-01-01T00:00:00Z"])
def test_key_lines_match_jax(line):
    assert tkm.parse_key_line(line) == jkm.parse_key_line(line)


def _run_keys(mod, path, argv, capsys):
    rc = mod.main(["--keys-file", str(path), *argv])
    out = capsys.readouterr()
    mask = re.compile(r"sk-[A-Za-z0-9_-]{20,}|sk-[A-Za-z0-9_-]{3}…[A-Za-z0-9_-]{4}")
    return rc, *(mask.sub("<key>", o.replace(str(path), "<file>")) for o in (out.out, out.err))


COMMANDS = [["generate", "--key-id", "prod"], ["generate", "--key-id", "ci", "--rate-limit", "5",
                                               "--expires", "2031-01-01T00:00:00Z"],
           ["generate", "--key-id", "prod"], ["generate", "--key-id", "bad id!"],
           ["list"], ["list", "--quiet"], ["rotate", "--key-id", "ci"], ["rotate", "--key-id", "nope"],
           ["remove", "--key-id", "prod"], ["remove", "--key-id", "prod"], ["list"]]


def test_key_mgmt_commands_match_jax(tmp_path, capsys):
    """The same command sequence on two files: the same exit codes and
    output (key values masked), and files of the same lines but for the
    key values, mode 0600."""
    runs = {}
    for name, mod in (("port", tkm), ("jax", jkm)):
        path = tmp_path / f"{name}.txt"
        runs[name] = [_run_keys(mod, path, argv, capsys) for argv in COMMANDS]
        body = re.sub(r"sk-[A-Za-z0-9_-]{20,}", "<key>", path.read_text())
        runs[name].append(re.sub(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ", "<ts>", body))
        assert oct(path.stat().st_mode & 0o777) == "0o600"
    assert runs["port"] == runs["jax"]


# ---------------------------------------------------------------- logging

@pytest.mark.parametrize("fmt", ["json", "text"])
def test_logging_matches_jax(fmt, monkeypatch, capsys):
    monkeypatch.setenv("LOG_FORMAT", fmt)
    out = []
    for mod in (tlog, jlog):
        mod.info("request", component="gateway", status=200, duration_ms=1.5)
        mod.warning("slow", key_id="k")
        mod.error("boom")
        err = capsys.readouterr().err
        out.append(re.sub(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d{3}Z", "<ts>", err))
    assert out[0] == out[1] and out[0].count("\n") == 3
    if fmt == "json":
        assert json.loads(out[0].splitlines()[0])["duration_ms"] == 1.5


# ---------------------------------------------------------------- health

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.headers.get("Content-Length"), r.read()


def test_health_handler_matches_jax():
    import threading
    answers = []
    for mod in (thealth, jhealth):
        srv = mod.make_server("127.0.0.1", 0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            answers.append([_get(srv.server_address[1], p) for p in ("/", "/health", "/x?y=1")])
        finally:
            srv.shutdown()
            srv.server_close()
    assert answers[0] == answers[1] == [(200, "0", b"")] * 3


def test_health_process_exits_0_on_sigterm():
    """The port's departure: SIGTERM closes the listener and exits 0 (the
    JAX sidecar dies of the signal)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "llama_gguf_inference_tpu_torch", "health"],
                            cwd=ROOT, env={**os.environ, "PORT_HEALTH": str(port)},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        end = time.monotonic() + 30
        while True:
            try:
                assert _get(port, "/")[0] == 200
                break
            except OSError:
                if time.monotonic() > end or proc.poll() is not None:
                    raise
                time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=20)
        assert proc.returncode == 0
        assert "[health] listening" in out and "[health] stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


# ---------------------------------------------------------------- benchmark client

@pytest.mark.parametrize("values", [[], [5.0], [3.0, 1.0, 2.0], list(range(1, 101)),
                                    [0.5, 9.0, 4.0, 4.0, 7.25]])
def test_benchmark_stats_match_jax(values):
    for pct in (50, 95, 99, 100):
        assert tbench.percentile(values, pct) == jbench.percentile(values, pct)
    assert tbench.compute_stats(values) == jbench.compute_stats(values)


@pytest.mark.parametrize("buf", [
    'data: {"choices":[{"delta":{"content":"a"}}]}\ndata: {"choices":[{"delta":{"con',
    'data: [DONE]\n: ping\nevent: x\ndata: not json\n\n',
    'data: {"choices":[]}\r\ndata: {"choices":[{"delta":{}}]}\r\n',
    'data: {"choices":[{"delta":{"content":"x"}}]}\ndata: {"choices":[{"delta":{"content":"y"}}]}\n',
    ""])
def test_parse_sse_tokens_matches_jax(buf):
    assert tbench.parse_sse_tokens(buf) == jbench.parse_sse_tokens(buf)


def test_benchmark_cli_and_report_match_jax():
    for argv in ([], ["--suite", "gateway", "--json", "--requests", "3"]):
        assert vars(tbench.build_parser().parse_args(argv)) == \
            vars(jbench.build_parser().parse_args(argv))
    report = {"gateway": {n: {"latency_ms": tbench.compute_stats([1.0, 2.0]), "errors": 0}
                          for n in ("ping", "health")},
              "inference": {"requests": 2, "concurrency": 1, "errors": 0,
                            "ttft_ms": tbench.compute_stats([10.0]),
                            "total_latency_ms": tbench.compute_stats([20.0]),
                            "tokens_per_second": tbench.compute_stats([3.0])}}
    assert tbench.format_text(report) == jbench.format_text(report)
    for url in ("http://h:1234/x", "https://h", "http://h"):
        t, j = tbench.Target(url, "k"), jbench.Target(url, "k")
        assert vars(t) == vars(j) and t.headers() == j.headers()


async def _recording_backend(seen: list):
    """A server that records each request (line, headers, body) and answers
    /ping and /health with 200 and chat with two SSE deltas."""
    async def handle(reader, writer):
        head = await reader.readuntil(b"\r\n\r\n")
        lines = head.decode().split("\r\n")
        headers = dict(ln.split(": ", 1) for ln in lines[1:] if ": " in ln)
        body = await reader.readexactly(int(headers.get("Content-Length", 0)))
        seen.append((lines[0], sorted(headers.items()), body))
        if lines[0].startswith("POST"):
            payload = b"".join(b"data: " + json.dumps(
                {"choices": [{"delta": {"content": t}}]}).encode() + b"\n\n"
                for t in ("hello", " world")) + b"data: [DONE]\n\n"
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                         b"Connection: close\r\n\r\n" + payload)
        else:
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\nConnection: close\r\n\r\n")
        await writer.drain()
        writer.close()

    return await asyncio.start_server(handle, "127.0.0.1", 0)


def test_benchmark_clients_send_the_same_requests():
    """Both clients against one recording backend: the same requests in
    the same counts (the JAX client's: no EOG ban), reports of the same
    keys and counts."""
    async def drive():
        out = {}
        for name, mod in (("port", tbench), ("jax", jbench)):
            seen: list = []
            srv = await _recording_backend(seen)
            port = srv.sockets[0].getsockname()[1]
            args = mod.build_parser().parse_args(
                ["--url", f"http://127.0.0.1:{port}", "--api-key", "sk-k", "--requests", "3",
                 "--concurrency", "2", "--max-tokens", "7", "--prompt", "hi there"])
            report = await mod.async_main(args)
            srv.close()
            await srv.wait_closed()
            out[name] = (sorted(seen), report)
        return out

    out = asyncio.run(drive())
    (ts, tr), (js, jr) = out["port"], out["jax"]
    norm = [(ln, [(k, v) for k, v in h if k != "Host"], b) for ln, h, b in ts]
    assert norm == [(ln, [(k, v) for k, v in h if k != "Host"], b) for ln, h, b in js]
    bodies = [json.loads(b) for _, _, b in ts if b]
    assert len(bodies) == 4 and all("logit_bias" not in b for b in bodies)
    assert bodies[0]["max_tokens"] == 7 and bodies[0]["stream"] is True
    assert tr.keys() == jr.keys() and tr["inference"]["errors"] == jr["inference"]["errors"] == 0
    assert tr["inference"]["ttft_ms"]["count"] == jr["inference"]["ttft_ms"]["count"] == 3


# ---------------------------------------------------------------- CLI

def test_cli_names_only_port_modules():
    import importlib
    for cmd, (module, fn) in tcli._COMMANDS.items():
        assert module.startswith("llama_gguf_inference_tpu_torch."), cmd
        assert callable(getattr(importlib.import_module(module), fn)), cmd
    shared = set(tcli._COMMANDS) & set(jcli._COMMANDS)
    assert shared == {"serve", "backend", "gateway", "health", "keys", "benchmark", "profile"}
    for cmd in shared:
        assert tcli._COMMANDS[cmd][0].split(".", 1)[1] == jcli._COMMANDS[cmd][0].split(".", 1)[1]


@pytest.mark.parametrize("argv,rc", [([], 0), (["--help"], 0), (["nope"], 2)])
def test_cli_dispatch_matches_jax(argv, rc, capsys):
    assert tcli.main(argv) == jcli.main(argv) == rc
    out = capsys.readouterr()
    if rc == 2:
        assert "unknown command 'nope'" in out.err


def test_cli_runs_keys_in_a_subprocess(tmp_path):
    keys = tmp_path / "k.txt"
    r = subprocess.run([sys.executable, "-m", "llama_gguf_inference_tpu_torch", "keys",
                        "--keys-file", str(keys), "generate", "--key-id", "cli", "--quiet"],
                       cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and re.fullmatch(r"sk-[A-Za-z0-9_-]{40,50}\n", r.stdout)
    assert keys.read_text().startswith("cli:" + r.stdout.strip())
