"""Scale-to-zero health sidecar.

The reference contract (reference ``scripts/health_server.py``, SURVEY.md
§2.3): a separate process on ``PORT_HEALTH`` (8001) where every GET on every
path returns 200 with an empty body and no logging, so platform probes never
touch the inference backend and serverless workers can sleep. SIGTERM (and
SIGINT) close the listener and the process exits 0, as the backend does.
"""

from __future__ import annotations

import os
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class HealthHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — http.server API
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, fmt, *args):  # deliberate no-op: probes are hot
        pass


def make_server(host: str = "0.0.0.0", port: int | None = None) -> ThreadingHTTPServer:
    if port is None:
        port = int(os.environ.get("PORT_HEALTH", 8001))
    return ThreadingHTTPServer((host, port), HealthHandler)


def main() -> None:
    srv = make_server()
    print(f"[health] listening on {srv.server_address[0]}:{srv.server_address[1]}",
          flush=True)

    def stop(*_):
        # shutdown() waits for serve_forever to return: not from its thread
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, stop)
    signal.signal(signal.SIGINT, stop)
    srv.serve_forever()
    srv.server_close()
    print("[health] stopped", flush=True)


if __name__ == "__main__":
    main()
