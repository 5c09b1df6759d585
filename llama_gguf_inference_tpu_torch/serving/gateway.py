"""The gateway: auth, rate-limit, CORS, bounded queue, metrics, streaming proxy.

Re-implements the reference gateway contract end-to-end (reference
``scripts/gateway.py``, SURVEY.md §2.1/§3.2 and ``docs/API_REFERENCE.md``):

- raw asyncio HTTP/1.1 server; clients never reach the backend directly
- routes: ``/ping`` ``/health`` ``/metrics`` ``OPTIONS *`` ``POST /reload``
  are handled locally; everything else is authenticated, queued, and proxied
  byte-for-byte (SSE streaming works by pass-through, no parsing)
- limits with exact status codes: 414/431/400/413/502/503/504/429/401
- metrics: the 11 counters/gauges of the reference, JSON + Prometheus v0.0.4
  via Accept negotiation
- bounded FIFO queue in front of a concurrency semaphore; overflow => 503 +
  ``Retry-After: 5``; rate-limit => 429 + ``Retry-After: 60``
- SIGHUP and authenticated ``POST /reload`` hot-reload the key file
- client Authorization is stripped and replaced with the backend key
  (defense-in-depth; reference gateway.py:717-746)
- SIGTERM and SIGINT close the listener and the process exits 0, as the
  backend does
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import signal
import time

from .auth import AccessLogger, APIKeyValidator
from .http import HttpLimitError, read_request, send_error, send_response


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class GatewayConfig:
    host: str = "0.0.0.0"
    port: int = 8000
    backend_host: str = "127.0.0.1"
    backend_port: int = 8080
    backend_api_key: str = ""
    auth_enabled: bool = True
    auth_keys_file: str = ""
    metrics_auth_enabled: bool = False
    max_requests_per_minute: int = 100
    max_concurrent: int = 1
    max_queue_size: int = 0            # 0 = unlimited
    max_body: int = 10 * 1024 * 1024
    max_headers: int = 64
    max_header_line: int = 8192
    max_request_line: int = 8192
    request_timeout: float = 300.0
    backend_connect_timeout: float = 10.0
    client_header_timeout: float = 30.0
    health_timeout: float = 2.0
    cors_origins: str = ""
    access_log: str = ""

    @staticmethod
    def from_env() -> "GatewayConfig":
        data_dir = os.environ.get("DATA_DIR", "/data")
        backend_port = _env_int("PORT_BACKEND", 0) or _env_int("BACKEND_PORT", 0) or 8080
        return GatewayConfig(
            host=os.environ.get("GATEWAY_HOST", "0.0.0.0"),
            port=_env_int("GATEWAY_PORT", 0) or _env_int("PORT", 0) or 8000,
            backend_host=os.environ.get("BACKEND_HOST", "127.0.0.1"),
            backend_port=backend_port,
            backend_api_key=os.environ.get("BACKEND_API_KEY", ""),
            auth_enabled=_env_bool("AUTH_ENABLED", True),
            auth_keys_file=os.environ.get("AUTH_KEYS_FILE",
                                          os.path.join(data_dir, "api_keys.txt")),
            metrics_auth_enabled=_env_bool("METRICS_AUTH_ENABLED", False),
            max_requests_per_minute=_env_int("MAX_REQUESTS_PER_MINUTE", 100),
            max_concurrent=_env_int("MAX_CONCURRENT_REQUESTS", 1),
            max_queue_size=_env_int("MAX_QUEUE_SIZE", 0),
            max_body=_env_int("MAX_REQUEST_BODY_SIZE", 10 * 1024 * 1024),
            max_headers=_env_int("MAX_HEADERS", 64),
            max_header_line=_env_int("MAX_HEADER_LINE_SIZE", 8192),
            max_request_line=_env_int("MAX_REQUEST_LINE_SIZE", 8192),
            request_timeout=_env_float("REQUEST_TIMEOUT", 300.0),
            backend_connect_timeout=_env_float("BACKEND_CONNECT_TIMEOUT", 10.0),
            client_header_timeout=_env_float("CLIENT_HEADER_TIMEOUT", 30.0),
            health_timeout=_env_float("HEALTH_TIMEOUT", 2.0),
            cors_origins=os.environ.get("CORS_ORIGINS", ""),
            access_log=os.environ.get("ACCESS_LOG",
                                      os.path.join(data_dir, "logs", "api_access.log"))
            if _env_bool("ACCESS_LOG_ENABLED", True) else "",
        )


class Metrics:
    """The reference's 11 gateway counters (docs/API_REFERENCE.md /metrics)."""

    FIELDS = [
        ("requests_total", "counter", "Total requests handled"),
        ("requests_success", "counter", "Total successful requests"),
        ("requests_error", "counter", "Total failed requests"),
        ("requests_active", "gauge", "Currently active requests"),
        ("requests_authenticated", "counter", "Total authenticated requests"),
        ("requests_unauthorized", "counter", "Total unauthorized requests"),
        ("bytes_sent", "counter", "Total bytes sent to clients"),
        ("queue_depth", "gauge", "Current requests waiting for semaphore"),
        ("queue_rejections", "counter", "Total requests rejected due to full queue"),
        ("queue_wait_seconds_total", "counter", "Cumulative queue wait time in seconds"),
        ("uptime_seconds", "gauge", "Gateway uptime in seconds"),
    ]

    def __init__(self):
        self.started = time.monotonic()
        self.requests_total = 0
        self.requests_success = 0
        self.requests_error = 0
        self.requests_active = 0
        self.requests_authenticated = 0
        self.requests_unauthorized = 0
        self.bytes_sent = 0
        self.queue_depth = 0
        self.queue_rejections = 0
        self.queue_wait_seconds_total = 0.0

    def as_dict(self) -> dict:
        d = {name: getattr(self, name) for name, _, _ in self.FIELDS
             if name != "uptime_seconds"}
        d["queue_wait_seconds_total"] = round(self.queue_wait_seconds_total, 6)
        d["uptime_seconds"] = round(time.monotonic() - self.started, 3)
        return d

    def prometheus(self) -> str:
        vals = self.as_dict()
        out = []
        for name, mtype, help_text in self.FIELDS:
            out.append(f"# HELP gateway_{name} {help_text}")
            out.append(f"# TYPE gateway_{name} {mtype}")
            out.append(f"gateway_{name} {vals[name]}")
        return "\n".join(out) + "\n"


_HOP_BY_HOP = {"connection", "keep-alive", "proxy-authenticate",
               "proxy-authorization", "te", "trailers", "transfer-encoding",
               "upgrade"}

MAX_BACKEND_HEADER_BYTES = 64 * 1024


class Gateway:
    def __init__(self, config: GatewayConfig | None = None):
        self.cfg = config or GatewayConfig.from_env()
        self.metrics = Metrics()
        self.validator = APIKeyValidator(
            keys_file=self.cfg.auth_keys_file if self.cfg.auth_enabled else None,
            enabled=self.cfg.auth_enabled,
            default_rate_limit=self.cfg.max_requests_per_minute,
        )
        self.access_log = AccessLogger(self.cfg.access_log or None)
        self.semaphore = asyncio.Semaphore(max(1, self.cfg.max_concurrent))
        self._server: asyncio.AbstractServer | None = None

    # -- CORS ---------------------------------------------------------------
    def cors_headers(self, origin: str | None, preflight: bool = False) -> dict[str, str]:
        allowed = self.cfg.cors_origins.strip()
        if not allowed:
            return {}
        headers: dict[str, str] = {}
        if allowed == "*":
            headers["Access-Control-Allow-Origin"] = "*"
        else:
            origins = [o.strip() for o in allowed.split(",") if o.strip()]
            if origin and origin in origins:
                headers["Access-Control-Allow-Origin"] = origin
                headers["Vary"] = "Origin"
            else:
                return {}
        if preflight:
            headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
            headers["Access-Control-Allow-Headers"] = "Authorization, Content-Type"
            headers["Access-Control-Max-Age"] = "86400"
        return headers

    # -- local endpoints -----------------------------------------------------
    async def handle_ping(self, writer) -> int:
        return await send_response(writer, 200)

    async def _backend_health(self) -> tuple[str, int, dict]:
        """Poll the backend /health under HEALTH_TIMEOUT."""
        try:
            fut = asyncio.open_connection(self.cfg.backend_host, self.cfg.backend_port)
            reader, bwriter = await asyncio.wait_for(fut, self.cfg.health_timeout)
            try:
                req = (f"GET /health HTTP/1.1\r\nHost: {self.cfg.backend_host}\r\n"
                       f"Connection: close\r\n")
                if self.cfg.backend_api_key:
                    req += f"Authorization: Bearer {self.cfg.backend_api_key}\r\n"
                req += "\r\n"
                bwriter.write(req.encode())
                await bwriter.drain()
                raw = await asyncio.wait_for(reader.read(65536), self.cfg.health_timeout)
            finally:
                bwriter.close()
            head, _, body = raw.partition(b"\r\n\r\n")
            status_line = head.split(b"\r\n", 1)[0].decode("latin-1", "replace")
            code = int(status_line.split(" ")[1]) if " " in status_line else 0
            try:
                parsed = json.loads(body.decode("utf-8", "replace") or "{}")
            except json.JSONDecodeError:
                parsed = {}
            return ("ok" if code == 200 else "error"), code, parsed
        except asyncio.TimeoutError:
            return "timeout", 0, {}
        except OSError:
            return "error", 0, {}

    async def handle_health(self, writer) -> int:
        status, code, backend = await self._backend_health()
        body = json.dumps({
            "status": status,
            "code": code,
            "backend": backend,
            "gateway": {"status": "ok", "metrics": self.metrics.as_dict()},
            "queue": {
                "max_concurrent": self.cfg.max_concurrent,
                "max_queue_size": self.cfg.max_queue_size,
                "active": self.metrics.requests_active,
                "waiting": self.metrics.queue_depth,
            },
            "authentication": {"enabled": self.cfg.auth_enabled},
        }).encode()
        return await send_response(writer, 200, body)

    async def handle_metrics(self, writer, headers: dict[str, str]) -> int:
        accept = headers.get("accept", "")
        if "text/plain" in accept or "application/openmetrics-text" in accept:
            body = self.metrics.prometheus().encode()
            return await send_response(
                writer, 200, body,
                content_type="text/plain; version=0.0.4; charset=utf-8")
        body = json.dumps({"gateway": self.metrics.as_dict()}).encode()
        return await send_response(writer, 200, body)

    async def handle_reload(self, writer) -> int:
        try:
            n = self.validator.reload_keys()
            body = json.dumps({"status": "ok", "keys_loaded": n}).encode()
            return await send_response(writer, 200, body)
        except Exception as e:  # noqa: BLE001 — reported to client as 500
            return await send_error(writer, 500, f"Reload failed: {e}",
                                    "server_error", "reload_failed")

    def handle_sighup(self) -> None:
        n = self.validator.reload_keys()
        print(f"[gateway] SIGHUP: reloaded {n} API keys", flush=True)

    # -- proxy --------------------------------------------------------------
    def _build_backend_request(self, req) -> bytes:
        lines = [f"{req.method} {req.path} HTTP/1.1",
                 f"Host: {self.cfg.backend_host}:{self.cfg.backend_port}"]
        for name, value in req.raw_header_lines:
            ln = name.lower()
            if ln in _HOP_BY_HOP or ln in ("host", "authorization", "content-length"):
                continue
            lines.append(f"{name}: {value}")
        if self.cfg.backend_api_key:
            lines.append(f"Authorization: Bearer {self.cfg.backend_api_key}")
        lines.append(f"Content-Length: {len(req.body)}")
        lines.append("Connection: close")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + req.body

    async def _read_backend_headers(self, breader) -> bytes | None:
        """Read response headers, cumulative cap 64KB -> None on violation."""
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = await breader.read(8192)
            if not chunk:
                return None
            buf += chunk
            if len(buf) > MAX_BACKEND_HEADER_BYTES and b"\r\n\r\n" not in buf:
                return None
        return buf

    def _inject_cors(self, header_block: bytes, origin: str | None) -> bytes:
        cors = self.cors_headers(origin)
        if not cors:
            return header_block
        head, sep, rest = header_block.partition(b"\r\n")
        extra = b"".join(f"{k}: {v}\r\n".encode("latin-1") for k, v in cors.items())
        return head + b"\r\n" + extra + rest

    async def _do_proxy(self, req, writer, origin: str | None) -> tuple[int, int]:
        """Returns (status, bytes_sent): status 200 for a streamed backend
        response, 502 when the gateway answered with its own error (connect
        failure, oversized backend headers) — so proxy_request can count
        those as errors, matching the reference's metrics/audit behavior."""
        fut = asyncio.open_connection(self.cfg.backend_host, self.cfg.backend_port)
        try:
            breader, bwriter = await asyncio.wait_for(
                fut, self.cfg.backend_connect_timeout)
        except (asyncio.TimeoutError, OSError):
            return 502, await send_response(writer, 502)
        sent = 0
        try:
            bwriter.write(self._build_backend_request(req))
            await bwriter.drain()
            buf = await self._read_backend_headers(breader)
            if buf is None:
                return 502, await send_response(writer, 502)
            head, sep, body_start = buf.partition(b"\r\n\r\n")
            out = self._inject_cors(head, origin) + sep + body_start
            writer.write(out)
            await writer.drain()
            sent += len(out)
            # HOT LOOP: byte-level pass-through (this is how SSE streams)
            while True:
                chunk = await breader.read(8192)
                if not chunk:
                    break
                writer.write(chunk)
                await writer.drain()
                sent += len(chunk)
            return 200, sent
        finally:
            bwriter.close()

    async def proxy_request(self, req, writer, key_id: str | None,
                            origin: str | None) -> None:
        from ..utils import logging as slog
        self.metrics.requests_active += 1
        t0 = time.monotonic()

        def done(status: int) -> None:
            self.access_log.log(key_id, req.method, req.path, status)
            slog.info("request", component="gateway", method=req.method,
                      path=req.path, status=status, key_id=key_id or "-",
                      duration_ms=round((time.monotonic() - t0) * 1000, 2))

        try:
            status, sent = await asyncio.wait_for(
                self._do_proxy(req, writer, origin), self.cfg.request_timeout)
            self.metrics.bytes_sent += sent
            if status == 200:
                self.metrics.requests_success += 1
            else:
                self.metrics.requests_error += 1
            done(status)
        except asyncio.TimeoutError:
            self.metrics.requests_error += 1
            await send_error(writer, 504, "Request timed out", "timeout_error", 504)
            done(504)
        except (OSError, ConnectionError):
            self.metrics.requests_error += 1
            done(502)
        finally:
            self.metrics.requests_active -= 1

    async def queued_proxy(self, req, writer, key_id: str | None,
                           origin: str | None) -> None:
        if (self.cfg.max_queue_size > 0
                and self.metrics.queue_depth >= self.cfg.max_queue_size):
            self.metrics.queue_rejections += 1
            self.metrics.requests_error += 1
            await send_error(writer, 503, "Server busy, try again later",
                             "server_error", "queue_full",
                             extra_headers={"Retry-After": "5"})
            return
        self.metrics.queue_depth += 1
        t0 = time.monotonic()
        try:
            await self.semaphore.acquire()
        except BaseException:
            self.metrics.queue_depth -= 1
            raise
        self.metrics.queue_depth -= 1
        self.metrics.queue_wait_seconds_total += time.monotonic() - t0
        try:
            await self.proxy_request(req, writer, key_id, origin)
        finally:
            self.semaphore.release()

    # -- connection handler --------------------------------------------------
    async def handle_client(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        key_id: str | None = None
        try:
            try:
                req = await read_request(
                    reader,
                    max_request_line=self.cfg.max_request_line,
                    max_header_line=self.cfg.max_header_line,
                    max_headers=self.cfg.max_headers,
                    max_body=self.cfg.max_body,
                    header_timeout=self.cfg.client_header_timeout,
                )
            except HttpLimitError as e:
                self.metrics.requests_total += 1
                self.metrics.requests_error += 1
                await send_error(writer, e.status, e.message,
                                 "invalid_request_error", e.code)
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            if req is None:
                return

            self.metrics.requests_total += 1
            origin = req.headers.get("origin")

            if req.method == "OPTIONS":
                await send_response(writer, 204,
                                    extra_headers=self.cors_headers(origin, preflight=True))
                return
            if req.path == "/ping":
                await self.handle_ping(writer)
                return
            if req.path == "/health":
                await self.handle_health(writer)
                return
            if req.path == "/metrics":
                if self.cfg.metrics_auth_enabled:
                    res = self.validator.validate(req.headers)
                    if not res.ok:
                        self.metrics.requests_unauthorized += 1
                        await self._auth_error(writer, res)
                        return
                await self.handle_metrics(writer, req.headers)
                return

            # everything else requires auth
            res = self.validator.validate(req.headers)
            if not res.ok:
                self.metrics.requests_unauthorized += 1
                self.metrics.requests_error += 1
                await self._auth_error(writer, res)
                self.access_log.log(res.key_id, req.method, req.path, res.status)
                return
            self.metrics.requests_authenticated += 1
            key_id = res.key_id

            if req.path == "/reload" and req.method == "POST":
                await self.handle_reload(writer)
                return

            await self.queued_proxy(req, writer, key_id, origin)
        except (ConnectionError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _auth_error(self, writer, res) -> None:
        extra = {"Retry-After": "60"} if res.status == 429 else None
        err_type = "rate_limit_error" if res.status == 429 else "invalid_request_error"
        await send_error(writer, res.status, res.message, err_type, res.code,
                         extra_headers=extra)

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self.handle_client, self.cfg.host, self.cfg.port)
        try:
            loop = asyncio.get_running_loop()
            loop.add_signal_handler(signal.SIGHUP, self.handle_sighup)
        except (NotImplementedError, RuntimeError):
            pass

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    @property
    def port(self) -> int:
        if self._server and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self.cfg.port


async def _serve_until_signal(gw: Gateway) -> None:
    """Serve until SIGTERM or SIGINT, then close the listener."""
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await gw.start()
    await stop.wait()
    await gw.close()


def main() -> None:
    gw = Gateway()
    print(f"[gateway] listening on {gw.cfg.host}:{gw.cfg.port} -> "
          f"backend {gw.cfg.backend_host}:{gw.cfg.backend_port} "
          f"(auth={'on' if gw.cfg.auth_enabled else 'off'}, "
          f"keys={gw.validator.n_keys})", flush=True)
    asyncio.run(_serve_until_signal(gw))
    print("[gateway] stopped", flush=True)


if __name__ == "__main__":
    main()
