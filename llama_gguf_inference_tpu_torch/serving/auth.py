"""API-key authentication, rate limiting, and audit logging.

Re-implements the reference auth contract (reference ``scripts/auth.py``,
surveyed at SURVEY.md §2.2 and ``docs/API_REFERENCE.md`` "Authentication" /
"Error Responses"):

- flat key file, one ``key_id:api_key[:rate_limit][:expiration]`` per line
- constant-time lookup: every stored key is compared via hmac.compare_digest
  with no early return
- per-key_id sliding-window (60 s) rate limiting with per-key overrides and
  lazy 5-minute GC of idle windows
- ISO-8601 expirations; fail-closed when auth is enabled but no keys load
- atomic hot reload preserving rate-limiter state
- injection-sanitized append-only audit log
"""

from __future__ import annotations

import hmac
import os
import re
import time
from datetime import datetime, timezone

KEY_FORMAT_RE = re.compile(r"^[A-Za-z0-9_-]{16,128}$")
KEY_ID_RE = re.compile(r"^[a-zA-Z0-9_-]{1,64}$")

RATE_LIMIT_WINDOW_S = 60.0
_LIMITER_GC_INTERVAL_S = 300.0


def _now_utc() -> datetime:
    return datetime.now(timezone.utc)


def parse_expiration_ts(value: str) -> float | None:
    """ISO-8601 (date or datetime, optional Z) -> unix ts, None if unparseable."""
    v = value.strip()
    if not v:
        return None
    try:
        if v.endswith("Z"):
            v = v[:-1] + "+00:00"
        dt = datetime.fromisoformat(v)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp()
    except ValueError:
        return None


class AuthResult:
    __slots__ = ("ok", "key_id", "status", "message", "code")

    def __init__(self, ok: bool, key_id: str | None = None, status: int = 200,
                 message: str = "", code: str = ""):
        self.ok = ok
        self.key_id = key_id
        self.status = status
        self.message = message
        self.code = code


class APIKeyValidator:
    """File-backed validator.  Thread-safe for the single-threaded asyncio
    gateway (no locks needed; reload swaps dicts atomically)."""

    def __init__(self, keys_file: str | None = None, enabled: bool = True,
                 default_rate_limit: int = 100):
        self.enabled = enabled
        self.keys_file = keys_file
        self.default_rate_limit = default_rate_limit
        self._keys: dict[str, str] = {}            # api_key -> key_id
        self._rate_limits: dict[str, int] = {}     # key_id -> per-minute limit
        self._expirations: dict[str, float] = {}   # key_id -> unix ts
        self._windows: dict[str, list[float]] = {} # key_id -> request timestamps
        self._last_gc = time.monotonic()
        self.load_error: str | None = None
        if keys_file:
            self._load_keys(keys_file)

    # -- key file ------------------------------------------------------------
    @staticmethod
    def parse_key_line(line: str):
        """Returns (key_id, api_key, rate_limit|None, expiration_ts|None) or None."""
        line = line.strip()
        if not line or line.startswith("#"):
            return None
        parts = line.split(":")
        if len(parts) < 2:
            return None
        key_id, api_key = parts[0].strip(), parts[1].strip()
        if not KEY_ID_RE.match(key_id) or not KEY_FORMAT_RE.match(api_key):
            return None
        rate_limit = None
        expiration = None
        if len(parts) >= 3 and parts[2].strip():
            # Fail-closed on malformed limits (reference auth.py line
            # validation): a non-positive or unparseable rate-limit field
            # rejects the whole line rather than loading an unlimited key.
            try:
                rate_limit = int(parts[2].strip())
            except ValueError:
                return None
            if rate_limit <= 0:
                return None
        if len(parts) >= 4 and parts[3].strip():
            # expiration may itself contain ':' (ISO datetime) — join the tail.
            # Fail-closed on unparseable expirations (reference auth.py:176-185
            # skips the line): loading the key WITHOUT its intended expiry
            # would silently grant a permanent credential.
            expiration = parse_expiration_ts(":".join(parts[3:]).strip())
            if expiration is None:
                return None
        return key_id, api_key, rate_limit, expiration

    def _load_keys(self, path: str) -> int:
        keys: dict[str, str] = {}
        limits: dict[str, int] = {}
        exps: dict[str, float] = {}
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    parsed = self.parse_key_line(line)
                    if parsed is None:
                        continue
                    key_id, api_key, rl, exp = parsed
                    if api_key in keys:
                        # duplicate api_key: first line wins (reference
                        # auth.py:188-193 skips later duplicates)
                        continue
                    keys[api_key] = key_id
                    if rl is not None:
                        limits[key_id] = rl
                    if exp is not None:
                        exps[key_id] = exp
        except OSError as e:
            self.load_error = str(e)
            return 0
        # atomic swap; limiter windows intentionally preserved
        self._keys = keys
        self._rate_limits = limits
        self._expirations = exps
        self.load_error = None
        return len(keys)

    def reload_keys(self, keys_file: str | None = None) -> int:
        """Atomic reload; re-reads the path (allows runtime rotation via env)."""
        path = keys_file or os.environ.get("AUTH_KEYS_FILE") or self.keys_file
        if not path:
            return 0
        self.keys_file = path
        n = self._load_keys(path)
        return n

    @property
    def n_keys(self) -> int:
        return len(self._keys)

    # -- validation ----------------------------------------------------------
    @staticmethod
    def extract_key(headers: dict[str, str]) -> tuple[str | None, str | None]:
        """Returns (key, error_message)."""
        auth = headers.get("authorization")
        if auth is None:
            return None, "Missing Authorization header"
        auth = auth.strip()
        if auth.lower().startswith("bearer "):
            auth = auth[7:].strip()
        elif auth.lower() == "bearer":
            auth = ""
        if not auth:
            return None, "Empty Authorization header"
        return auth, None

    def _find_key(self, candidate: str) -> str | None:
        """Constant-time scan over ALL keys — no early return."""
        found: str | None = None
        cb = candidate.encode()
        for api_key, key_id in self._keys.items():
            if hmac.compare_digest(cb, api_key.encode()):
                found = key_id
        return found

    def _is_expired(self, key_id: str) -> bool:
        exp = self._expirations.get(key_id)
        return exp is not None and time.time() >= exp

    def _check_rate_limit(self, key_id: str) -> bool:
        """True if the request is allowed.  Sliding 60-second window."""
        limit = self._rate_limits.get(key_id, self.default_rate_limit)
        if limit <= 0:
            return True  # 0/absent override with 0 default = unlimited
        now = time.monotonic()
        self._maybe_gc(now)
        window = self._windows.setdefault(key_id, [])
        cutoff = now - RATE_LIMIT_WINDOW_S
        while window and window[0] <= cutoff:
            window.pop(0)
        if len(window) >= limit:
            return False
        window.append(now)
        return True

    def _maybe_gc(self, now: float) -> None:
        if now - self._last_gc < _LIMITER_GC_INTERVAL_S:
            return
        self._last_gc = now
        cutoff = now - RATE_LIMIT_WINDOW_S
        stale = [k for k, w in self._windows.items() if not w or w[-1] <= cutoff]
        for k in stale:
            del self._windows[k]

    def validate(self, headers: dict[str, str]) -> AuthResult:
        if not self.enabled:
            return AuthResult(True, key_id="anonymous")
        if not self._keys:
            # fail-closed: enabled but nothing loaded
            return AuthResult(False, status=401,
                              message="Authentication misconfigured: no API keys loaded",
                              code="invalid_api_key")
        key, err = self.extract_key(headers)
        if key is None:
            return AuthResult(False, status=401, message=err, code="invalid_api_key")
        if not KEY_FORMAT_RE.match(key):
            return AuthResult(False, status=401, message="Invalid API key format",
                              code="invalid_api_key")
        key_id = self._find_key(key)
        if key_id is None:
            return AuthResult(False, status=401, message="Invalid API key",
                              code="invalid_api_key")
        if self._is_expired(key_id):
            return AuthResult(False, status=401, message="API key expired",
                              code="invalid_api_key")
        if not self._check_rate_limit(key_id):
            return AuthResult(False, key_id=key_id, status=429,
                              message="Rate limit exceeded. Please slow down your requests.",
                              code="rate_limit_exceeded")
        return AuthResult(True, key_id=key_id)

    # -- metrics (per-key; deliberately NOT exposed unauthenticated,
    #    reference SEC-01 gateway.py:456-458) -------------------------------
    def get_metrics(self) -> dict:
        return {
            "keys_loaded": len(self._keys),
            "active_rate_windows": len(self._windows),
        }


# ---------------------------------------------------------------------------
# audit log
# ---------------------------------------------------------------------------

_SANITIZE_RE = re.compile(r"[\r\n\t\x00-\x1f\x7f]")


def _sanitize_log_field(value: str, max_len: int = 256) -> str:
    return _SANITIZE_RE.sub("_", str(value))[:max_len]


class AccessLogger:
    """Append-only audit log: ``ts | key_id | METHOD path | status``
    (reference auth.py:543-603)."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, key_id: str | None, method: str, path: str, status: int) -> None:
        if not self.path:
            return
        ts = _now_utc().strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"
        line = " | ".join([
            ts,
            _sanitize_log_field(key_id or "-", 64),
            f"{_sanitize_log_field(method, 16)} {_sanitize_log_field(path, 256)}",
            str(int(status)),
        ])
        try:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
        except OSError:
            pass
