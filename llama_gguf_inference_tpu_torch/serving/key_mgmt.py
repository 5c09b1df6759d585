"""API key management CLI: generate / list / remove / rotate.

Contract of the reference tool (reference ``scripts/key_mgmt.py``, SURVEY.md
§2.5): CSPRNG ``sk-`` keys, relative expirations (30d/24h/60m), atomic
temp-file+rename writes with 0600 perms, list never prints stored key values,
``--quiet`` for scripting.

Usage:
    python -m llama_gguf_inference_tpu_torch.serving.key_mgmt generate --key-id prod
    python -m llama_gguf_inference_tpu_torch.serving.key_mgmt list
    python -m llama_gguf_inference_tpu_torch.serving.key_mgmt remove --key-id prod
    python -m llama_gguf_inference_tpu_torch.serving.key_mgmt rotate --key-id prod
"""

from __future__ import annotations

import argparse
import os
import re
import secrets
import sys
import tempfile
from datetime import datetime, timedelta, timezone

KEY_ID_RE = re.compile(r"^[a-zA-Z0-9_-]{1,64}$")
REL_EXP_RE = re.compile(r"^(\d+)([dhm])$")


def default_keys_file() -> str:
    data_dir = os.environ.get("DATA_DIR", "/data")
    return os.environ.get("AUTH_KEYS_FILE", os.path.join(data_dir, "api_keys.txt"))


def generate_key() -> str:
    return "sk-" + secrets.token_urlsafe(32)


def parse_expiration(value: str) -> str:
    """'30d'/'24h'/'60m' relative or ISO absolute -> ISO-8601 UTC string."""
    m = REL_EXP_RE.match(value.strip())
    if m:
        n, unit = int(m.group(1)), m.group(2)
        delta = {"d": timedelta(days=n), "h": timedelta(hours=n),
                 "m": timedelta(minutes=n)}[unit]
        return (datetime.now(timezone.utc) + delta).strftime("%Y-%m-%dT%H:%M:%SZ")
    # validate absolute
    v = value.strip()
    probe = v[:-1] + "+00:00" if v.endswith("Z") else v
    try:
        datetime.fromisoformat(probe)
    except ValueError:
        raise SystemExit(f"error: invalid expiration {value!r} "
                         "(use 30d, 24h, 60m or ISO-8601)")
    return v


def build_key_line(key_id: str, api_key: str, rate_limit: int | None,
                   expiration: str | None) -> str:
    parts = [key_id, api_key]
    if rate_limit is not None or expiration is not None:
        parts.append("" if rate_limit is None else str(rate_limit))
    if expiration is not None:
        parts.append(expiration)
    return ":".join(parts)


def parse_key_line(line: str):
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    parts = line.split(":")
    if len(parts) < 2:
        return None
    key_id, api_key = parts[0], parts[1]
    rate_limit = parts[2] if len(parts) > 2 and parts[2] else None
    expiration = ":".join(parts[3:]) if len(parts) > 3 and parts[3] else None
    return key_id, api_key, rate_limit, expiration


def read_lines(path: str) -> list[str]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        return f.read().splitlines()


def atomic_write(path: str, lines: list[str]) -> None:
    """Temp file in the same directory, 0600, os.replace (reference
    key_mgmt.py:236-262)."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".keys-")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        os.chmod(tmp, 0o600)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _existing_ids(lines: list[str]) -> dict[str, int]:
    out = {}
    for i, line in enumerate(lines):
        parsed = parse_key_line(line)
        if parsed:
            out[parsed[0]] = i
    return out


def cmd_generate(args) -> int:
    if not KEY_ID_RE.match(args.key_id):
        print("error: invalid key id (alphanumeric, -, _; max 64 chars)",
              file=sys.stderr)
        return 1
    lines = read_lines(args.keys_file)
    if args.key_id in _existing_ids(lines):
        print(f"error: key id {args.key_id!r} already exists "
              "(use rotate to replace it)", file=sys.stderr)
        return 1
    api_key = generate_key()
    exp = parse_expiration(args.expires) if args.expires else None
    lines.append(build_key_line(args.key_id, api_key, args.rate_limit, exp))
    atomic_write(args.keys_file, lines)
    if args.quiet:
        print(api_key)
    else:
        print(f"Generated key for {args.key_id!r}:")
        print(f"  {api_key}")
        if args.rate_limit is not None:
            print(f"  rate limit: {args.rate_limit}/min")
        if exp:
            print(f"  expires: {exp}")
        print(f"Written to {args.keys_file} (0600). "
              "Store the key now — it is not shown again.")
    return 0


def cmd_list(args) -> int:
    lines = read_lines(args.keys_file)
    rows = []
    for line in lines:
        parsed = parse_key_line(line)
        if parsed:
            key_id, api_key, rl, exp = parsed
            # never print stored key values (reference key_mgmt.py:357-392)
            masked = api_key[:6] + "…" + api_key[-4:] if len(api_key) > 12 else "***"
            rows.append((key_id, masked, rl or "-", exp or "-"))
    if args.quiet:
        for r in rows:
            print(r[0])
        return 0
    if not rows:
        print(f"No keys in {args.keys_file}")
        return 0
    wid = max(len(r[0]) for r in rows)
    print(f"{'KEY ID':<{wid}}  {'KEY':<14}  {'RATE/MIN':<9}  EXPIRES")
    for key_id, masked, rl, exp in rows:
        print(f"{key_id:<{wid}}  {masked:<14}  {rl:<9}  {exp}")
    return 0


def cmd_remove(args) -> int:
    lines = read_lines(args.keys_file)
    ids = _existing_ids(lines)
    if args.key_id not in ids:
        print(f"error: key id {args.key_id!r} not found", file=sys.stderr)
        return 1
    del lines[ids[args.key_id]]
    atomic_write(args.keys_file, lines)
    if not args.quiet:
        print(f"Removed {args.key_id!r}")
    return 0


def cmd_rotate(args) -> int:
    lines = read_lines(args.keys_file)
    ids = _existing_ids(lines)
    if args.key_id not in ids:
        print(f"error: key id {args.key_id!r} not found", file=sys.stderr)
        return 1
    idx = ids[args.key_id]
    _, _, old_rl, old_exp = parse_key_line(lines[idx])
    api_key = generate_key()
    exp = parse_expiration(args.expires) if args.expires else old_exp
    rl = args.rate_limit if args.rate_limit is not None else (
        int(old_rl) if old_rl else None)
    lines[idx] = build_key_line(args.key_id, api_key, rl, exp)
    atomic_write(args.keys_file, lines)
    if args.quiet:
        print(api_key)
    else:
        print(f"Rotated {args.key_id!r}; new key:")
        print(f"  {api_key}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="key_mgmt",
                                description="Manage gateway API keys")
    p.add_argument("--keys-file", default=default_keys_file())
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="generate a new key")
    g.add_argument("--key-id", required=True)
    g.add_argument("--rate-limit", type=int, default=None,
                   help="requests per minute")
    g.add_argument("--expires", default=None, help="30d / 24h / 60m / ISO-8601")
    g.add_argument("--quiet", action="store_true",
                   help="print only the key (for scripting)")
    g.set_defaults(fn=cmd_generate)

    l = sub.add_parser("list", help="list key ids (values never shown)")
    l.add_argument("--quiet", action="store_true")
    l.set_defaults(fn=cmd_list)

    r = sub.add_parser("remove", help="remove a key")
    r.add_argument("--key-id", required=True)
    r.add_argument("--quiet", action="store_true")
    r.set_defaults(fn=cmd_remove)

    ro = sub.add_parser("rotate", help="replace a key's value, keep metadata")
    ro.add_argument("--key-id", required=True)
    ro.add_argument("--rate-limit", type=int, default=None)
    ro.add_argument("--expires", default=None)
    ro.add_argument("--quiet", action="store_true")
    ro.set_defaults(fn=cmd_rotate)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
