"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; the first failure exits non-zero:

1. device   — require a card; print its name and power limit (nvidia-smi)
2. build    — compile the CUDA kernels from ``csrc/`` (one nvcc per source)
3. kernels  — each kernel against its plain PyTorch version at the 8B
              shapes: 4-bit matmul at the four projection shapes for 1, 4 and
              512 rows; 8-bit matmul at the Q6_K head for 1 and 4 rows; flash
              attention at decode (T=1, B=4, offsets up to 1000) and prefill
              (T=512, B=1). Prints errors, the kernel's median time, the plain
              version's, one PyTorch library call's (a yardstick only), and the
              least time the card could take (bytes over 3.35 TB/s or bf16
              operations over 989 TFLOP/s, whichever is larger)
4. forward  — synthesize the 8B Q4_K_M GGUF (``tools.synth.cached_model``:
              under the temp dir, reused when present), load it on the card,
              run a prefill and 16 greedy decode steps through the kernels,
              then again through the plain versions on the card; compare
              logits and greedy tokens
5. serve    — the port's OpenAI server in-process on localhost (4 slots, 1024
              context each): a chat completion, a streamed one, four concurrent
              completions, and a request without the key (must get 401); the
              kernel launch counters are read over this phase only
6. the ``{"kernels": [...]}`` line, the card line, and the final
   ``{"ok": true, "device": {...}}`` line

The breakdown of a decode step and a prefill chunk by kernel is
``python -m llama_gguf_inference_tpu_torch.tools.profile``.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import secrets
import statistics
import subprocess
import sys
import threading
import time
import traceback

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM data sheet, dense bf16
MATMUL_TOL = 1e-4              # f32 sum order only (same bf16 weights)
FLASH_TOL = 2 * 2 ** -8        # two bf16 ulps of the output scale
LOGITS_TOL = 0.05              # 8B forward: kernel vs plain, of max |logit|
SHAPES_4BIT = {"qkv": (6144, 4096), "o": (4096, 4096),
               "gate_up": (28672, 4096), "down": (4096, 14336)}
HEAD = (128256, 4096)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


class Timer:
    """Median time of single launches, L2 flushed before each (decode finds
    its weights cold), measured with CUDA events."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    emit({"phase": "device", "ok": True, "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return card


def phase_build():
    from llama_gguf_inference_tpu_torch.ops import _build
    t0 = time.time()
    reports = _build.build_all()
    regs = {name: [ln.split("info    : ")[-1] for ln in rep.splitlines()
                   if "registers" in ln] for name, rep in reports.items()}
    for name in _build.SOURCES:
        _build.library(name)
    emit({"phase": "build", "ok": True, "seconds": round(time.time() - t0, 3),
          "ptxas": regs})


def _err(got, want, tol):
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item() + 1e-12
    if not d <= tol * scale:
        raise AssertionError(f"max abs err {d} > {tol} * {scale}")
    return d, d / scale


def phase_kernels(torch, timer):
    import torch.nn.functional as F

    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    # 4-bit, flat Q4_K layout: codes (out, in/2) u8, d and m (out, in/32) f32
    for name, (out_f, in_f) in SHAPES_4BIT.items():
        nsub = in_f // 32
        codes = torch.randint(0, 256, (out_f, in_f // 2), generator=g,
                              device="cuda", dtype=torch.uint8)
        d = rand(out_f, nsub, scale=1e-2).abs()
        m = rand(out_f, nsub, scale=5e-2).abs()
        h = in_f // 2
        c = codes.to(torch.int32)
        sh, mh = d.repeat(1, h // nsub), m.repeat(1, h // nsub)
        w_lib = torch.cat([(c & 15).float() * sh - mh, (c >> 4).float() * sh - mh],
                          1).bfloat16()
        del c, sh, mh
        for B in (1, 4, 512):
            x = rand(B, in_f).bfloat16()
            xsum = qm._block_sums(x, 32)
            args = (x, xsum, codes, d, m)
            got = qm.quant_matmul_4bit(*args)
            want = qm.quant_matmul_4bit_plain(*args)
            err, rel = _err(got, want, MATMUL_TOL)
            nbytes = codes.numel() + 8 * out_f * nsub + B * in_f * 2 \
                + B * nsub * 4 + B * out_f * 4
            b_ms, b_by = bound(nbytes, 2.0 * B * in_f * out_f)
            rows.append({"kernel": qm.NAME_4BIT, "shape": f"{name} {out_f}x{in_f} B={B}",
                         "B": B, "max_abs_err": err, "max_rel_err": rel,
                         "ms": timer(lambda: qm.quant_matmul_4bit(*args)),
                         "plain_ms": timer(lambda: qm.quant_matmul_4bit_plain(*args), 5),
                         "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                         "bound_ms": b_ms, "bound_by": b_by})
            emit({"phase": "kernels", **rows[-1]})
        del w_lib, codes

    # 8-bit, compact Q6_K head: codes (out, in) int8, d (out, in/256) f32,
    # sc (out, in/16) int8
    out_f, in_f = HEAD
    codes = torch.randint(-32, 32, (out_f, in_f), generator=g, device="cuda",
                          dtype=torch.int8)
    d = rand(out_f, in_f // 256, scale=1e-3).abs()
    sc = torch.randint(-128, 128, (out_f, in_f // 16), generator=g,
                       device="cuda", dtype=torch.int8)
    s_sub = d.repeat(1, 16) * sc.float()
    w_lib = (codes.float() * s_sub.repeat(1, 16)).bfloat16()
    del s_sub
    for B in (1, 4):
        x = rand(B, in_f).bfloat16()
        args = (x, codes, d, sc, 16, 0)
        got = qm.quant_matmul_8bit(*args)
        want = qm.quant_matmul_8bit_plain(*args)
        err, rel = _err(got, want, MATMUL_TOL)
        nbytes = codes.numel() + sc.numel() + d.numel() * 4 + B * in_f * 2 + B * out_f * 4
        b_ms, b_by = bound(nbytes, 2.0 * B * in_f * out_f)
        rows.append({"kernel": qm.NAME_8BIT, "shape": f"head {out_f}x{in_f} B={B}",
                     "B": B, "max_abs_err": err, "max_rel_err": rel,
                     "ms": timer(lambda: qm.quant_matmul_8bit(*args)),
                     "plain_ms": timer(lambda: qm.quant_matmul_8bit_plain(*args), 5),
                     "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                     "bound_ms": b_ms, "bound_by": b_by})
        emit({"phase": "kernels", **rows[-1]})
    del w_lib, codes, sc

    # flash attention: H 32 over KVH 8, D 128, S 1024
    H, KVH, D, S = 32, 8, 128, 1024
    for label, B, T, offs in (("decode", 4, 1, [1000, 700, 300, 37]),
                              ("prefill", 1, 512, [0])):
        q = rand(B, T, H, D).bfloat16()
        k = rand(B, KVH, S, D).bfloat16()
        v = rand(B, KVH, S, D).bfloat16()
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        got = fa.flash_attention(q, k, v, off)
        want = fa.flash_attention_plain(q, k, v, off)
        err, rel = _err(got, want, FLASH_TOL)
        live = sum(o + T for o in offs)                       # keys read per kv head
        pairs = sum(o * T + T * (T + 1) // 2 for o in offs)    # (query, key) pairs
        nbytes = 2 * live * KVH * D * 2 + 2 * q.numel() * 2 + off.numel() * 4
        b_ms, b_by = bound(nbytes, 4.0 * H * D * pairs)
        pos = off.long()[:, None] + torch.arange(T, device="cuda")[None]
        mask = (torch.arange(S, device="cuda")[None, None] <= pos[:, :, None])[:, None]
        qt, kt, vt = q.transpose(1, 2), k, v

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        rows.append({"kernel": fa.NAME, "shape": f"{label} B={B} T={T} H={H} "
                     f"KVH={KVH} D={D} S={S} offsets={offs}", "B": B,
                     "max_abs_err": err, "max_rel_err": rel,
                     "ms": timer(lambda: fa.flash_attention(q, k, v, off)),
                     "plain_ms": timer(lambda: fa.flash_attention_plain(q, k, v, off), 5),
                     "library_ms": timer(lib),
                     "bound_ms": b_ms, "bound_by": b_by})
        emit({"phase": "kernels", **rows[-1]})
    return rows


@contextlib.contextmanager
def plain_versions():
    """Route the model through the plain PyTorch versions (on the card)."""
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    saved = (qm.quant_matmul_4bit, qm.quant_matmul_8bit, fa.flash_attention)
    qm.quant_matmul_4bit = qm.quant_matmul_4bit_plain
    qm.quant_matmul_8bit = qm.quant_matmul_8bit_plain
    fa.flash_attention = fa.flash_attention_plain
    try:
        yield
    finally:
        qm.quant_matmul_4bit, qm.quant_matmul_8bit, fa.flash_attention = saved


def phase_engine(torch):
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
    from llama_gguf_inference_tpu_torch.tools.synth import cached_model
    t0 = time.time()
    path = cached_model("8b", seed=0)
    t1 = time.time()
    engine = InferenceEngine(path, EngineConfig(max_slots=4, ctx=1024), device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "load", "ok": True, "synth_s": round(t1 - t0, 3),
          "load_s": round(time.time() - t1, 3), "gguf_gb": os.path.getsize(path) / 1e9,
          "device_gb": torch.cuda.memory_allocated() / 1e9,
          "layers": engine.cfg.n_layers, "dim": engine.cfg.dim,
          "vocab": engine.cfg.vocab_size})
    return engine


def _greedy_run(torch, engine, ids, steps):
    from llama_gguf_inference_tpu_torch.models.llama import KVCache, forward
    dev = engine.device
    cache = KVCache.zeros(engine.cfg, 1, 1024, dev)
    logits, toks = [], []
    with torch.inference_mode():
        lg = forward(engine.params, engine.cfg,
                     torch.tensor([ids], dtype=torch.int32, device=dev),
                     torch.zeros(1, dtype=torch.int32, device=dev), cache,
                     logits_at=torch.tensor([len(ids) - 1], device=dev))[0, 0]
        pos = len(ids)
        for _ in range(steps):
            logits.append(lg)
            toks.append(int(lg.argmax()))
            lg = forward(engine.params, engine.cfg,
                         torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev),
                         torch.tensor([pos], dtype=torch.int32, device=dev),
                         cache)[0, 0]
            pos += 1
    torch.cuda.synchronize()
    return logits, toks


def phase_forward(torch, engine):
    ids = engine.tokenizer.encode("the quick brown fox jumps over the lazy dog")
    t0 = time.time()
    k_logits, k_toks = _greedy_run(torch, engine, ids, 16)
    t1 = time.time()
    with plain_versions():
        p_logits, p_toks = _greedy_run(torch, engine, ids, 16)
    t2 = time.time()
    for lg in k_logits:
        if lg.shape != (engine.cfg.vocab_size,) or not bool(torch.isfinite(lg).all()):
            raise AssertionError("non-finite or misshapen logits")
    agree = 0
    while agree < 16 and k_toks[agree] == p_toks[agree]:
        agree += 1
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(k_logits[:agree + 1], p_logits[:agree + 1])]
    if not errs[0] <= LOGITS_TOL:
        raise AssertionError(f"prefill logits rel err {errs[0]} > {LOGITS_TOL}")
    emit({"phase": "forward", "ok": True, "prompt_tokens": len(ids),
          "greedy_tokens_agree": agree, "of": 16, "logits_rel_err_prefill": errs[0],
          "logits_rel_err_max_while_agreeing": max(errs),
          "kernel_path_s": round(t1 - t0, 3), "plain_path_s": round(t2 - t1, 3)})


def _post(port, path, body, key, stream=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Content-Type": "application/json"}
    if key:
        headers["Authorization"] = f"Bearer {key}"
    conn.request("POST", path, json.dumps(body), headers)
    return conn, conn.getresponse()


def phase_serve(torch, engine):
    import asyncio

    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.serving.openai_server import (BackendConfig,
                                                                      OpenAIServer)
    key = secrets.token_hex(16)
    srv = OpenAIServer(engine, BackendConfig(host="127.0.0.1", port=0, api_key=key))
    loop = asyncio.new_event_loop()
    ready = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(srv.start())
        ready.set()
        loop.run_forever()

    th = threading.Thread(target=run, daemon=True)
    _build.reset_launches()
    engine.start()
    th.start()
    if not ready.wait(60):
        raise RuntimeError("server did not start")
    port = srv.port
    out = {}
    try:
        msgs = [{"role": "user", "content": "hello world, the quick brown fox"}]
        t0 = time.time()
        conn, r = _post(port, "/v1/chat/completions",
                        {"messages": msgs, "max_tokens": 32, "temperature": 0}, key)
        body = json.loads(r.read())
        conn.close()
        if r.status != 200 or body["choices"][0]["message"]["role"] != "assistant":
            raise AssertionError(f"chat: {r.status} {body}")
        out["chat_s"] = round(time.time() - t0, 4)
        out["chat_completion_tokens"] = body["usage"]["completion_tokens"]

        # The server sends the role chunk when the first token arrives and the
        # finish chunk with the last, so those two stamps bracket decode. A
        # token that ends inside a UTF-8 sequence or a possible stop string
        # sends no content chunk, so tokens are counted from the usage chunk.
        t0 = time.time()
        conn, r = _post(port, "/v1/chat/completions",
                        {"messages": msgs, "max_tokens": 64, "temperature": 0,
                         "stream": True, "stream_options": {"include_usage": True}},
                        key)
        if r.status != 200:
            raise AssertionError(f"stream: {r.status}")
        events, t_first, t_last, usage = [], None, None, None
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            events.append(line[6:])
            if line[6:] == "[DONE]":
                continue
            ev = json.loads(line[6:])
            if ev["choices"] and t_first is None:
                t_first = time.time()
            if ev["choices"] and ev["choices"][0]["finish_reason"] is not None:
                t_last = time.time()
            usage = ev.get("usage") or usage
        conn.close()
        if events[-1] != "[DONE]" or t_last is None or usage is None:
            raise AssertionError("stream did not end with finish and usage chunks and [DONE]")
        n_gen = usage["completion_tokens"]
        out["ttft_s"] = round(t_first - t0, 4)
        out["stream_chunks"] = len(events)
        out["stream_completion_tokens"] = n_gen
        out["decode_tok_s_b1"] = round((n_gen - 1) / (t_last - t_first), 2)

        results = [None] * 4

        def one(i):
            c, rr = _post(port, "/v1/completions",
                          {"prompt": f"request {i}: the lazy dog", "max_tokens": 64,
                           "temperature": 0}, key)
            results[i] = (rr.status, json.loads(rr.read()))
            c.close()

        t0 = time.time()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.time() - t0
        if any(r is None or r[0] != 200 for r in results):
            raise AssertionError(f"concurrent: {results}")
        ntok = sum(r[1]["usage"]["completion_tokens"] for r in results)
        out["concurrent_completion_tokens"] = ntok
        out["aggregate_tok_s_b4"] = round(ntok / wall, 2)

        conn, r = _post(port, "/v1/chat/completions", {"messages": msgs}, "")
        r.read()
        conn.close()
        if r.status != 401:
            raise AssertionError(f"no key: {r.status}")
        out["no_key_status"] = r.status
    finally:
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        asyncio.run_coroutine_threadsafe(srv.close(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        th.join(60)
        engine.stop()
    emit({"phase": "serve", "ok": True, **out, "launches": launches})
    return launches


SOURCES = {
    # name: (source, TPU kernel body it replaces); pallas_call sites are
    # pallas_matmul.py:641 (fsplit), :247 (8-bit) and flash_attention.py:176
    "quant_matmul_4bit": ("llama_gguf_inference_tpu_torch/csrc/quant_matmul.cu",
                          "llama_gguf_inference_tpu/ops/pallas_matmul.py:421"),
    "quant_matmul_8bit": ("llama_gguf_inference_tpu_torch/csrc/quant_matmul.cu",
                          "llama_gguf_inference_tpu/ops/pallas_matmul.py:123"),
    "flash_attention": ("llama_gguf_inference_tpu_torch/csrc/flash_attention.cu",
                        "llama_gguf_inference_tpu/ops/flash_attention.py:129"),
}
# the kernels line reports each kernel at its decode shape (4 slots)
LINE_SHAPE = {"quant_matmul_4bit": "gate_up 28672x4096 B=4",
              "quant_matmul_8bit": "head 128256x4096 B=4",
              "flash_attention": "decode B=4"}


def kernels_line(rows, launches):
    out = []
    for name, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == name]
        row = next(r for r in mine if r["shape"].startswith(LINE_SHAPE[name]))
        n = launches.get(name, 0)
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        if launches.get(name + ".plain", 0):
            raise AssertionError(f"{name}: the plain version ran on the main path")
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": n, "plain_launches": launches.get(name + ".plain", 0),
                    "shape": row["shape"],
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]})
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this smoke needs an NVIDIA card",
              file=sys.stderr)
        return 3
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "llama_gguf_inference_tpu_torch")):
        print("run from a checkout: llama_gguf_inference_tpu_torch/ is missing",
              file=sys.stderr)
        return 4
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "device"
    engine = None
    try:
        card = phase_device(torch)
        phase = "build"
        phase_build()
        phase = "kernels"
        with torch.inference_mode():
            rows = phase_kernels(torch, Timer(torch))
        torch.cuda.empty_cache()
        phase = "load"
        engine = phase_engine(torch)
        phase = "forward"
        phase_forward(torch, engine)
        torch.cuda.empty_cache()
        phase = "serve"
        launches = phase_serve(torch, engine)
        emit({"phase": "memory", "max_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9})
        line = kernels_line(rows, launches)
    except Exception:  # noqa: BLE001 — report the failing phase, exit non-zero
        traceback.print_exc()
        emit({"phase": phase, "ok": False})
        return 1
    finally:
        if engine is not None:
            engine.stop()
    emit(line)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
