"""Lifecycle orchestrator — the ``start.sh`` equivalent (reference SURVEY §2.4/§3.1).

Boot sequence mirroring the reference ENTRYPOINT:

1. ``MOCK_BACKEND`` short-circuit: backend in mock mode + health + gateway
2. ``DATA_DIR``, else auto-detect (/runpod-volume | /workspace | /data)
3. per-session backend key: ``gateway-`` + token_urlsafe(32), written 0600 to
   ``/dev/shm`` (tmpfs) and passed to children via file, never argv
4. model resolution: ``MODEL_PATH`` wins, else ``MODELS_DIR/MODEL_NAME``
5. spawn backend (OpenAI server + engine), poll readiness (30×1s), then
   verify security: backend must REJECT unauthenticated /v1 requests
6. spawn health sidecar and gateway; unset the key from our env
7. supervise: if any child dies, shut everything down and exit non-zero
   (platform restarts the container — crash-fast, reference start.sh:781-796)

Graceful shutdown on SIGTERM/SIGINT: children get SIGTERM, 30 s grace, then
SIGKILL; each child's exit code is printed (``[start] <name> exited <rc>``;
the port's three children exit 0 on SIGTERM); the backend key file is
shredded (overwritten then unlinked).

The children are the port's own modules (``serving.openai_server``,
``serving.health_server``, ``serving.gateway``); the backend reads
``MODEL_PATH`` and the engine settings of ``openai_server.
build_engine_from_env`` (a ``bert`` GGUF gets the encoder engine) and runs
on the card.
"""

from __future__ import annotations

import os
import re
import secrets
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

GRACE_S = 30


def is_truthy(v: str | None) -> bool:
    return (v or "").strip().lower() in ("1", "true", "yes", "on")


def detect_data_dir() -> str:
    """``DATA_DIR`` when set, else the first of /runpod-volume and
    /workspace that exists, else /data. (The JAX package's launcher probes
    the two volumes first even when ``DATA_DIR`` is set.)"""
    if os.environ.get("DATA_DIR"):
        return os.environ["DATA_DIR"]
    for cand in ("/runpod-volume", "/workspace"):
        if os.path.isdir(cand):
            return cand
    return "/data"


def resolve_model(data_dir: str) -> str | None:
    """MODEL_PATH takes precedence over MODELS_DIR/MODEL_NAME
    (reference start.sh:309-343)."""
    path = os.environ.get("MODEL_PATH")
    if path:
        if not os.path.isfile(path):
            print(f"[start] FATAL: MODEL_PATH {path!r} does not exist",
                  file=sys.stderr, flush=True)
            return None
        if not os.access(path, os.R_OK):
            print(f"[start] FATAL: MODEL_PATH {path!r} not readable",
                  file=sys.stderr, flush=True)
            return None
        return path
    name = os.environ.get("MODEL_NAME")
    if name:
        models_dir = os.environ.get("MODELS_DIR", os.path.join(data_dir, "models"))
        cand = os.path.join(models_dir, name)
        if os.path.isfile(cand):
            return cand
        print(f"[start] FATAL: model {name!r} not found in {models_dir}",
              file=sys.stderr, flush=True)
        return None
    return None


def write_backend_key() -> tuple[str, str]:
    """Generate the per-session backend key; 0600 file in tmpfs
    (reference start.sh:183-232)."""
    key = "gateway-" + secrets.token_urlsafe(32)
    key_dir = os.environ.get("BACKEND_KEY_DIR",
                             "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp")
    key_dir = os.path.join(key_dir, "llama-keys")
    os.makedirs(key_dir, mode=0o700, exist_ok=True)
    key_file = os.path.join(key_dir, f"backend-{os.getpid()}.key")
    fd = os.open(key_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(key)
    return key, key_file


def shred_key(key_file: str) -> None:
    try:
        size = os.path.getsize(key_file)
        with open(key_file, "r+b") as f:
            f.write(b"\x00" * size)
            f.flush()
            os.fsync(f.fileno())
        os.unlink(key_file)
    except OSError:
        pass


def http_get(url: str, headers: dict | None = None, timeout: float = 2.0):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:  # noqa: S310
        return resp.status, resp.read()


def wait_backend_ready(port: int, key: str, tries: int = 30) -> bool:
    for _ in range(tries):
        try:
            status, _ = http_get(f"http://127.0.0.1:{port}/health",
                                 {"Authorization": f"Bearer {key}"})
            if status == 200:
                return True
        except (urllib.error.URLError, OSError, ConnectionError):
            pass
        time.sleep(1)
    return False


_LOOPBACK4 = "0100007F"                     # 127.0.0.1, /proc/net hex


def verify_localhost_bind(port: int) -> bool | None:
    """True if every LISTEN socket on ``port`` is loopback-bound, False if
    any is not, None if undeterminable (no /proc — non-Linux).

    The reference verifies via netstat/ss that llama-server never exposes
    itself off-host (start.sh:562-590); we parse /proc/net/tcp{,6} directly
    (state 0A = LISTEN; address field is little-endian hex).
    """
    found = None
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(path) as f:
                lines = f.readlines()[1:]
        except OSError:
            continue
        for line in lines:
            parts = line.split()
            if len(parts) < 4 or parts[3] != "0A":
                continue
            addr, _, phex = parts[1].partition(":")
            if int(phex, 16) != port:
                continue
            found = True if found is None else found
            loop = (addr == _LOOPBACK4 if len(addr) == 8
                    else addr == "00000000000000000000000001000000")
            if not loop:
                return False
    return found


_AUTH_FAIL_RE = re.compile(r"\b401\b|unauthorized", re.IGNORECASE)


def scan_auth_failure(line: str) -> bool:
    """True if a backend log line indicates an auth failure — the tailer
    surfaces these as audit events (reference start.sh:656-667)."""
    return bool(_AUTH_FAIL_RE.search(line))


def verify_backend_auth(port: int) -> bool:
    """Security gate: unauthenticated /v1 requests must FAIL
    (reference start.sh:562-647)."""
    try:
        status, _ = http_get(f"http://127.0.0.1:{port}/v1/models")
        return status != 200
    except urllib.error.HTTPError as e:
        return e.code in (401, 403)
    except (urllib.error.URLError, OSError):
        return False


class Supervisor:
    def __init__(self):
        self.children: dict[str, subprocess.Popen] = {}
        self.key_file: str | None = None
        self._shutting_down = False

    def spawn(self, name: str, module: str, env: dict[str, str],
              tail_auth: bool = False) -> subprocess.Popen:
        def _die_with_parent():
            # children must never outlive the supervisor, even if it is
            # SIGKILLed (crash-fast invariant; plain SIGTERM handling can't
            # cover a killed parent)
            try:
                import ctypes
                PR_SET_PDEATHSIG = 1
                ctypes.CDLL("libc.so.6").prctl(PR_SET_PDEATHSIG, signal.SIGTERM)
            except Exception:  # noqa: BLE001 — non-Linux: rely on shutdown()
                pass

        proc = subprocess.Popen(
            [sys.executable, "-m", module],
            env=env,
            stdout=subprocess.PIPE if tail_auth else None,
            stderr=subprocess.STDOUT if tail_auth else None,
            preexec_fn=_die_with_parent,
        )
        if tail_auth:
            # pass the child's output through while flagging auth failures
            # as audit events (reference start.sh:656-667 tails the backend
            # log for 401|unauthorized)
            import threading

            def _tail():
                assert proc.stdout is not None
                for raw in proc.stdout:
                    line = raw.decode("utf-8", "replace")
                    sys.stdout.write(line)
                    sys.stdout.flush()
                    if scan_auth_failure(line):
                        print(f"[start] BACKEND AUTH FAILURE detected in "
                              f"{name} log", flush=True)

            threading.Thread(target=_tail, daemon=True,
                             name=f"tail-{name}").start()
        self.children[name] = proc
        print(f"[start] spawned {name} (pid {proc.pid})", flush=True)
        return proc

    def shutdown(self, code: int = 0) -> None:
        if self._shutting_down:
            return
        self._shutting_down = True
        print("[start] shutting down...", flush=True)
        for name, proc in self.children.items():
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + GRACE_S
        for name, proc in self.children.items():
            remain = max(0.1, deadline - time.monotonic())
            try:
                proc.wait(timeout=remain)
            except subprocess.TimeoutExpired:
                print(f"[start] SIGKILL {name}", flush=True)
                proc.kill()
                proc.wait()
            print(f"[start] {name} exited {proc.returncode}", flush=True)
        if self.key_file:
            shred_key(self.key_file)
        sys.exit(code)

    def supervise(self) -> None:
        """Crash-fast: first child death takes the container down."""
        while True:
            for name, proc in self.children.items():
                rc = proc.poll()
                if rc is not None:
                    decoded = {137: "OOM-killed (137)", 139: "segfault (139)",
                               134: "abort (134)", 127: "missing dependency (127)",
                               1: "startup error (1)"}.get(rc if rc >= 0 else 128 - rc,
                                                           f"exit {rc}")
                    print(f"[start] FATAL: {name} died: {decoded}", flush=True)
                    self.shutdown(1)
            time.sleep(1)


def main() -> None:
    sup = Supervisor()
    signal.signal(signal.SIGTERM, lambda *_: sup.shutdown(0))
    signal.signal(signal.SIGINT, lambda *_: sup.shutdown(0))

    # DEBUG_SHELL hold mode (reference start.sh:250-258): dump filtered env,
    # sleep, exit — for interactive container debugging
    if is_truthy(os.environ.get("DEBUG_SHELL")):
        for k in sorted(os.environ):
            if not any(s in k.lower() for s in ("key", "token", "secret",
                                                "password", "credential")):
                print(f"{k}={os.environ[k]}", flush=True)
        print("[start] DEBUG_SHELL: holding for 300s", flush=True)
        time.sleep(300)
        sys.exit(0)

    data_dir = detect_data_dir()
    os.environ.setdefault("DATA_DIR", data_dir)
    os.makedirs(os.path.join(data_dir, "logs"), exist_ok=True)

    # boot log: timestamped file + latest.txt pointer (reference
    # start.sh:264-274); stdout still goes to the console via the platform
    worker = re.sub(r"[^a-zA-Z0-9_-]", "_",
                    os.environ.get("WORKER_TYPE", "worker"))[:64]
    boot_dir = os.path.join(data_dir, "logs", "_boot")
    os.makedirs(boot_dir, exist_ok=True)
    ts = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    boot_log = os.path.join(boot_dir, f"{ts}_boot_{worker}.log")
    try:
        with open(os.path.join(boot_dir, "latest.txt"), "w") as f:
            f.write(boot_log + "\n")
        print(f"[start] boot log: {boot_log}", flush=True)
    except OSError:
        pass

    if os.environ.get("BACKEND_PORT") and not os.environ.get("PORT_BACKEND"):
        print("[start] WARNING: BACKEND_PORT is deprecated; use PORT_BACKEND",
              flush=True)
    backend_port = int(os.environ.get("PORT_BACKEND") or
                       os.environ.get("BACKEND_PORT") or 8080)
    mock = is_truthy(os.environ.get("MOCK_BACKEND"))

    key, key_file = write_backend_key()
    sup.key_file = key_file

    child_env = dict(os.environ)
    child_env["DATA_DIR"] = data_dir
    child_env["PORT_BACKEND"] = str(backend_port)
    child_env["BACKEND_API_KEY_FILE"] = key_file

    if not mock:
        model = resolve_model(data_dir)
        if model is None:
            print("[start] no model resolved (set MODEL_PATH or MODEL_NAME); "
                  "starting in MOCK_BACKEND mode", flush=True)
            mock = True
        else:
            child_env["MODEL_PATH"] = model
            print(f"[start] model: {model}", flush=True)
    if mock:
        child_env["MOCK_BACKEND"] = "true"
        child_env.pop("MODEL_PATH", None)

    sup.spawn("backend", "llama_gguf_inference_tpu_torch.serving.openai_server",
              child_env, tail_auth=True)

    if not wait_backend_ready(backend_port, key):
        print("[start] FATAL: backend did not become ready", flush=True)
        sup.shutdown(1)
    if not verify_backend_auth(backend_port):
        print("[start] FATAL: backend accepts unauthenticated requests — "
              "refusing to start", flush=True)
        sup.shutdown(1)
    bind_ok = verify_localhost_bind(backend_port)
    if bind_ok is False:
        print("[start] FATAL: backend is listening on a non-loopback "
              "address — refusing to start", flush=True)
        sup.shutdown(1)
    print(f"[start] backend ready, auth verified, localhost bind "
          f"{'verified' if bind_ok else 'unverifiable (no /proc)'}",
          flush=True)

    sup.spawn("health", "llama_gguf_inference_tpu_torch.serving.health_server", child_env)

    gw_env = dict(child_env)
    gw_env["BACKEND_API_KEY"] = key
    sup.spawn("gateway", "llama_gguf_inference_tpu_torch.serving.gateway", gw_env)
    # key no longer needed in our env (reference start.sh:736 unsets it)
    os.environ.pop("BACKEND_API_KEY", None)

    sup.supervise()


if __name__ == "__main__":
    main()
