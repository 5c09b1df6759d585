"""Benchmark CLI: gateway overhead + end-to-end inference latency/throughput.

Contract of the reference tool (reference ``scripts/benchmark.py``, SURVEY.md
§2.6/§3.3): two suites — gateway (/ping, /health latency) and inference
(TTFT via first SSE ``delta.content``, tok/s, total latency) at configurable
concurrency; nearest-rank p50/p95/p99; text or JSON output; stdlib-only raw
HTTP over asyncio.

Usage:
    python -m llama_gguf_inference_tpu_torch.serving.benchmark \
        --url http://localhost:8000 --api-key KEY --suite all \
        --requests 20 --concurrency 4 --json
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import sys
import time
from urllib.parse import urlparse


def percentile(values: list[float], pct: float) -> float:
    """Nearest-rank percentile (reference benchmark.py:43-61)."""
    if not values:
        return 0.0
    s = sorted(values)
    rank = max(1, math.ceil(pct / 100.0 * len(s)))
    return s[min(rank, len(s)) - 1]


def compute_stats(values: list[float]) -> dict:
    if not values:
        return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                "p50": 0.0, "p95": 0.0, "p99": 0.0}
    return {
        "count": len(values),
        "mean": sum(values) / len(values),
        "min": min(values),
        "max": max(values),
        "p50": percentile(values, 50),
        "p95": percentile(values, 95),
        "p99": percentile(values, 99),
    }


def parse_sse_tokens(buffer: str) -> tuple[list[str], str]:
    """Extract delta.content strings from complete SSE lines; returns
    (tokens, remaining_buffer)."""
    tokens: list[str] = []
    lines = buffer.split("\n")
    remainder = lines.pop()
    for line in lines:
        line = line.strip()
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        try:
            obj = json.loads(line[6:])
            choices = obj.get("choices") or []
            if choices:
                delta = choices[0].get("delta") or {}
                content = delta.get("content")
                if content:
                    tokens.append(content)
        except json.JSONDecodeError:
            continue
    return tokens, remainder


class Target:
    def __init__(self, url: str, api_key: str | None):
        p = urlparse(url)
        self.host = p.hostname or "localhost"
        self.port = p.port or (443 if p.scheme == "https" else 80)
        self.api_key = api_key

    def headers(self) -> str:
        h = f"Host: {self.host}\r\nConnection: close\r\n"
        if self.api_key:
            h += f"Authorization: Bearer {self.api_key}\r\n"
        return h


async def _timed_get(t: Target, path: str, timeout: float = 30.0) -> tuple[float, int]:
    t0 = time.monotonic()
    reader, writer = await asyncio.open_connection(t.host, t.port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\n{t.headers()}\r\n".encode())
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(-1), timeout)
    finally:
        writer.close()
    dt = (time.monotonic() - t0) * 1000.0
    status = int(raw.split(b" ", 2)[1]) if raw else 0
    return dt, status


async def bench_endpoint(t: Target, path: str, n: int) -> dict:
    latencies = []
    errors = 0
    for _ in range(n):
        try:
            dt, status = await _timed_get(t, path)
            if status == 200:
                latencies.append(dt)
            else:
                errors += 1
        except (OSError, asyncio.TimeoutError):
            errors += 1
    return {"endpoint": path, "errors": errors,
            "latency_ms": compute_stats(latencies)}


async def run_gateway_benchmark(t: Target, n: int) -> dict:
    return {
        "ping": await bench_endpoint(t, "/ping", n),
        "health": await bench_endpoint(t, "/health", n),
    }


async def _inference_request(t: Target, prompt: str, max_tokens: int,
                             timeout: float) -> dict:
    body = json.dumps({
        "model": "any",
        "messages": [{"role": "user", "content": prompt}],
        "max_tokens": max_tokens,
        "stream": True,
    }).encode()
    t0 = time.monotonic()
    ttft = None
    tokens: list[str] = []
    reader, writer = await asyncio.open_connection(t.host, t.port)
    try:
        req = (f"POST /v1/chat/completions HTTP/1.1\r\n{t.headers()}"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(body)}\r\n\r\n").encode() + body
        writer.write(req)
        await writer.drain()
        buf = ""
        saw_headers = False
        status = 0
        deadline = t0 + timeout
        while True:
            chunk = await asyncio.wait_for(reader.read(4096),
                                           max(0.1, deadline - time.monotonic()))
            if not chunk:
                break
            buf += chunk.decode("utf-8", errors="replace")
            if not saw_headers:
                if "\r\n\r\n" in buf:
                    head, buf = buf.split("\r\n\r\n", 1)
                    status = int(head.split(" ", 2)[1])
                    saw_headers = True
                else:
                    continue
            new_tokens, buf = parse_sse_tokens(buf)
            if new_tokens and ttft is None:
                ttft = (time.monotonic() - t0) * 1000.0
            tokens.extend(new_tokens)
    finally:
        writer.close()
    total = (time.monotonic() - t0) * 1000.0
    text = "".join(tokens)
    n_words = len(text.split())  # whitespace-token count (reference :372-377)
    return {"ok": status == 200 and bool(tokens), "status": status,
            "ttft_ms": ttft, "total_ms": total, "n_tokens": n_words,
            "tok_per_s": n_words / (total / 1000.0) if total > 0 else 0.0}


async def run_inference_benchmark(t: Target, n_requests: int, concurrency: int,
                                  prompt: str, max_tokens: int,
                                  timeout: float) -> dict:
    # sequential warmup
    await _inference_request(t, prompt, max_tokens, timeout)
    sem = asyncio.Semaphore(concurrency)
    results: list[dict] = []

    async def one():
        async with sem:
            results.append(await _inference_request(t, prompt, max_tokens, timeout))

    await asyncio.gather(*(one() for _ in range(n_requests)))
    ok = [r for r in results if r["ok"]]
    return {
        "requests": n_requests,
        "concurrency": concurrency,
        "errors": n_requests - len(ok),
        "ttft_ms": compute_stats([r["ttft_ms"] for r in ok if r["ttft_ms"] is not None]),
        "total_latency_ms": compute_stats([r["total_ms"] for r in ok]),
        "tokens_per_second": compute_stats([r["tok_per_s"] for r in ok]),
    }


def format_text(report: dict) -> str:
    out = []
    if "gateway" in report:
        g = report["gateway"]
        out.append("== Gateway overhead ==")
        for name in ("ping", "health"):
            s = g[name]["latency_ms"]
            out.append(f"  /{name:<7} p50 {s['p50']:.2f} ms   p95 {s['p95']:.2f} ms   "
                       f"p99 {s['p99']:.2f} ms   errors {g[name]['errors']}")
    if "inference" in report:
        i = report["inference"]
        out.append(f"== Inference (n={i['requests']}, c={i['concurrency']}) ==")
        out.append(f"  TTFT      p50 {i['ttft_ms']['p50']:.1f} ms   "
                   f"p95 {i['ttft_ms']['p95']:.1f} ms")
        out.append(f"  latency   p50 {i['total_latency_ms']['p50']:.1f} ms   "
                   f"p95 {i['total_latency_ms']['p95']:.1f} ms")
        out.append(f"  tok/s     mean {i['tokens_per_second']['mean']:.2f}")
        out.append(f"  errors    {i['errors']}")
    return "\n".join(out)


async def async_main(args) -> dict:
    t = Target(args.url, args.api_key)
    report: dict = {"url": args.url}
    if args.suite in ("gateway", "all"):
        report["gateway"] = await run_gateway_benchmark(t, args.requests)
    if args.suite in ("inference", "all"):
        report["inference"] = await run_inference_benchmark(
            t, args.requests, args.concurrency, args.prompt, args.max_tokens,
            args.timeout)
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="benchmark")
    p.add_argument("--url", default="http://localhost:8000")
    p.add_argument("--api-key", default=None)
    p.add_argument("--suite", choices=("gateway", "inference", "all"),
                   default="all")
    p.add_argument("--requests", type=int, default=10)
    p.add_argument("--concurrency", type=int, default=1)
    p.add_argument("--prompt", default="Write a haiku about mountains.")
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--json", action="store_true", dest="json_out")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = asyncio.run(async_main(args))
    if args.json_out:
        print(json.dumps(report, indent=2))
    else:
        print(format_text(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
