"""Structured logging: dual text/JSONL format to stderr.

Reference contract (reference gateway.py:66-94, SURVEY §5.5):
``LOG_FORMAT=text`` (default) or ``json`` — JSONL with ts/level/msg plus
free-form fields.  Request-completion lines carry ``duration_ms``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from datetime import datetime, timezone


def _fmt() -> str:
    return os.environ.get("LOG_FORMAT", "text").strip().lower()


def log(level: str, msg: str, component: str = "app", **fields) -> None:
    ts = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"
    if _fmt() == "json":
        rec = {"ts": ts, "level": level, "component": component, "msg": msg}
        rec.update(fields)
        print(json.dumps(rec, separators=(",", ":")), file=sys.stderr, flush=True)
    else:
        extra = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"{ts} {level.upper():<5} [{component}] {msg}"
              + (f" {extra}" if extra else ""), file=sys.stderr, flush=True)


def info(msg: str, component: str = "app", **fields) -> None:
    log("info", msg, component, **fields)


def warning(msg: str, component: str = "app", **fields) -> None:
    log("warn", msg, component, **fields)


def error(msg: str, component: str = "app", **fields) -> None:
    log("error", msg, component, **fields)
