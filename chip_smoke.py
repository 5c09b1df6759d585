"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; the first failure exits non-zero:

1. device   — require a card; print its name and power limit (nvidia-smi)
2. build    — compile the CUDA kernels from ``csrc/`` (one nvcc per source)
3. kernels  — each kernel against its plain PyTorch version at the 8B
              shapes: 4-bit matmul (flat Q4_K) at the four projection shapes
              for 1, 4 and 512 rows, and with Q3_K's geometry (sub-blocks of
              16, code bias 4) at o and down and Q4_K in the compact and
              mixed scale layouts at gate_up; 2-bit matmul (Q2_K) at the four
              projection shapes for 1, 4 and 512 rows in the flat and mixed
              layouts and for 4 rows in compact; 8-bit matmul at the Q6_K
              head for 1 and 4 rows; flash
              attention over each cache kind (bf16, q8_0, q4_0, q4_1, paged
              bf16, paged q8_0) at decode (T=1, B=4, offsets up to 1000) and
              prefill (T=512, B=1); the paged ones through shuffled pages of
              256 with one idle slot whose table row is all -1. Prints errors,
              the kernel's median time, the plain version's, one PyTorch
              library call's (a yardstick only: SDPA over the bf16, dequantized
              or gathered cache), and the least time the card could take
              (bytes over 3.35 TB/s or bf16 operations over 989 TFLOP/s,
              whichever is larger)
4. forward  — synthesize the 8B Q4_K_M GGUF (``tools.synth.cached_model``:
              under the temp dir, reused when present), load it on the card,
              run a prefill and 16 greedy decode steps through the kernels,
              then again through the plain versions on the card, fed the
              kernel run's tokens; compare the logits of every step
5. kv-forward — the same prefill and 16 steps over each quantized or paged
              cache kind, through the kernels and then, fed the same tokens,
              with only that kind's attention wrapper swapped for its plain
              version; then three greedy requests through the engine's
              scheduler over four slots of that kind (one idle), each token
              checked against a replay on a one-sequence cache
6. serve    — the port's OpenAI server in-process on localhost (4 slots, 1024
              context each): a chat completion, a streamed one, four concurrent
              completions, and a request without the key (must get 401)
7. serve-paged — that engine freed, a second one from the environment
              (``build_engine_from_env``: q8_0 paged KV, 4 pages of 1024): a
              1,500-token prompt, longer than a slot's contiguous share, with
              three short ones; the pool cannot hold all four, so one waits
8. q2k      — that engine freed, the 8B Q2_K GGUF (Q2_K embedding and
              projections, Q6_K head; ``cached_model(quant="q2_k")``) loaded
              under ``LGT_SCALE_LAYOUT=mixed``, its resident weight bytes
              printed; a prefill and 16 greedy steps through the kernels
              held against the plain versions fed the same tokens, then the
              port's OpenAI server over it as in the serve phase
9. the ``{"kernels": [...]}`` line, the card line, and the final
   ``{"ok": true, "device": {...}}`` line

Launch counters are set to 0 just before each path that drives the kernels
(each kv-forward kernel run and engine run, the serve phase, the
serve-paged phase, the q2k phase's kernel run and its serve) and read just
after; comparison runs fall outside those windows.

The breakdown of a decode step and a prefill chunk by kernel is
``python -m llama_gguf_inference_tpu_torch.tools.profile``.
"""

from __future__ import annotations

import contextlib
import gc
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
SHAPES_2BIT = SHAPES_4BIT      # the same projections, all Q2_K in the Q2_K model
HEAD = (128256, 4096)
PAGE_S = 256                   # kernels and kv-forward phases' paged caches
KV_KINDS = {                   # cache kind: (kv_dtype, kv_layout, its attention kernel)
    "q8_0": ("q8_0", "contig", "flash_attention_q8"),
    "q4_0": ("q4_0", "contig", "flash_attention_q4"),
    "q4_1": ("q4_1", "contig", "flash_attention_q41"),
    "paged": ("bf16", "paged", "flash_attention_paged"),
    "paged_q8_0": ("q8_0", "paged", "flash_attention_paged_q8")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


class Timer:
    """Median time of single launches, L2 flushed before each (decode finds
    its weights cold), measured with CUDA events. The flush writes 1 GiB
    (about 0.3 ms of the card's time), which also keeps the card busy while
    the host runs the wrapper's Python and enqueues the timed launch, so
    the start event does not wait on the host."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

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
            args = (x, xsum, codes, d, None, m, None, 0)
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

    rows += _lowbit_rows(torch, qm, g, timer)
    rows += _attention_rows(torch, F, fa, rand, g, timer)
    return rows


def _lowbit_weight(torch, g, bits, out_f, in_f, sub, bias, layout, has_min, signed_sc):
    """A random 2- or 4-bit QuantLinear in one scale layout: flat (f32 per
    sub-block), compact (f32 per 256 times an 8-bit factor per sub-block)
    or mixed (the scale flat, the min side compact)."""
    from llama_gguf_inference_tpu_torch.ops.linear import QuantLinear
    nsub, nd = in_f // sub, in_f // 256

    def f32(n, scale):
        return torch.rand(out_f, n, generator=g, device="cuda") * scale + scale / 10

    def u8(lo):
        t = torch.randint(lo, lo + 16, (out_f, nsub), generator=g, device="cuda",
                          dtype=torch.int32)
        return t.to(torch.int8 if lo < 0 else torch.uint8)

    codes = torch.randint(0, 256, (out_f, in_f * bits // 8), generator=g, device="cuda",
                          dtype=torch.uint8)
    d = f32(nsub, 1e-2) if layout != "compact" else f32(nd, 1e-3)
    sc = u8(-8 if signed_sc else 0) if layout == "compact" else None
    dmin = mn = None
    if has_min:
        dmin = f32(nsub, 5e-2) if layout == "flat" else f32(nd, 5e-3)
        mn = None if layout == "flat" else u8(0)
    fmt = "q2_k" if bits == 2 else ("q3_k" if bias else "q4_k")
    return QuantLinear(codes=codes, d=d, sc=sc, dmin=dmin, mn=mn, fmt=fmt,
                       bits=bits, sub_size=sub, d_size=256 if layout == "compact" else sub,
                       code_bias=bias, out_features=out_f, in_features=in_f,
                       min_size=256 if layout == "mixed" else 0)


def _lowbit_rows(torch, qm, g, timer):
    """The 2-bit kernel at the Q2_K projections (flat and mixed at 1, 4 and
    512 rows, compact at 4) and the 4-bit kernel at its new geometries (Q3_K
    at o and down, Q4_K compact and mixed at gate_up, 4 rows). The bound's
    bytes count the codes and each layout's scale and min arrays as stored;
    the library call multiplies by the same weights dequantized to bf16
    ahead of time."""
    cases = []
    for name, (out_f, in_f) in SHAPES_2BIT.items():
        for layout, bs in (("flat", (1, 4, 512)), ("mixed", (1, 4, 512)), ("compact", (4,))):
            cases.append((2, f"{layout} {name}", out_f, in_f, 16, 0, layout, True, False, bs))
    for name in ("o", "down"):
        out_f, in_f = SHAPES_4BIT[name]
        cases.append((4, f"q3_k {name}", out_f, in_f, 16, 4, "flat", False, True, (1, 4)))
    for layout in ("compact", "mixed"):
        out_f, in_f = SHAPES_4BIT["gate_up"]
        cases.append((4, f"q4_k {layout} gate_up", out_f, in_f, 32, 0, layout, True, False,
                      (4,)))
    rows = []
    for bits, label, out_f, in_f, sub, bias, layout, has_min, signed, bs in cases:
        w = _lowbit_weight(torch, g, bits, out_f, in_f, sub, bias, layout, has_min, signed)
        kernel, plain, kname = ((qm.quant_matmul_2bit, qm.quant_matmul_2bit_plain, qm.NAME_2BIT)
                                if bits == 2 else
                                (qm.quant_matmul_4bit, qm.quant_matmul_4bit_plain, qm.NAME_4BIT))
        w_lib = w.dequantize_bm()
        arrays = [w.codes, w.d, w.sc, w.dmin, w.mn]
        wbytes = sum(a.numel() * a.element_size() for a in arrays if a is not None)
        nsub = in_f // sub
        for B in bs:
            x = torch.randn(B, in_f, generator=g, device="cuda").bfloat16()
            xsum = qm._block_sums(x, sub)
            if layout == "mixed":
                xsum = qm._mixed_xsum(xsum, w)
            args = (x, xsum, *arrays, bias)
            err, rel = _err(kernel(*args), plain(*args), MATMUL_TOL)
            nbytes = wbytes + B * in_f * 2 + B * nsub * 4 + B * out_f * 4
            b_ms, b_by = bound(nbytes, 2.0 * B * in_f * out_f)
            rows.append({"kernel": kname, "shape": f"{label} {out_f}x{in_f} B={B}",
                         "B": B, "max_abs_err": err, "max_rel_err": rel,
                         "bits_per_weight": 8 * wbytes / (out_f * in_f),
                         "ms": timer(lambda: kernel(*args)),
                         "plain_ms": timer(lambda: plain(*args), 5),
                         "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                         "bound_ms": b_ms, "bound_by": b_by})
            emit({"phase": "kernels", **rows[-1]})
        del w, w_lib, arrays
    return rows


def _attention_rows(torch, F, fa, rand, g, timer):
    """Every flash kernel at decode and prefill: H 32 over KVH 8, D 128,
    1024 slots per sequence (contiguous) or 4 pages of 256 (paged)."""
    from llama_gguf_inference_tpu_torch.runtime.kv_cache import QuantKV, QuantKV4, QuantKV41
    H, KVH, D, S = 32, 8, 128, 1024
    NP = S // PAGE_S
    rows = []

    def measure(name, label, args, lib_k, lib_v, key_bytes, off, table=None):
        """One row: args[0] is q; lib_k/lib_v the (B, KVH, S, D) bf16 view
        SDPA reads; key_bytes what the kernel's function reads per live key
        and kv head (K and V codes, scales, minimums)."""
        kernel, plain = getattr(fa, name), getattr(fa, name + "_plain")
        q = args[0]
        B, T = q.shape[:2]
        got, want = kernel(*args), plain(*args)
        err, rel = _err(got, want, FLASH_TOL)
        offs = off.tolist()
        live = sum(o + T for o in offs)                       # keys read per kv head
        pairs = sum(o * T + T * (T + 1) // 2 for o in offs)    # (query, key) pairs
        nbytes = live * KVH * key_bytes + 2 * q.numel() * 2 + off.numel() * 4 \
            + (0 if table is None else table.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * H * D * pairs)
        Sl = lib_k.shape[2]
        pos = off.long()[:, None] + torch.arange(T, device="cuda")[None]
        mask = (torch.arange(Sl, device="cuda")[None, None] <= pos[:, :, None])[:, None]
        qt = q.transpose(1, 2)

        def lib():
            return F.scaled_dot_product_attention(qt, lib_k, lib_v, attn_mask=mask,
                                                  enable_gqa=True)
        rows.append({"kernel": name, "shape": f"{label} B={B} T={T} H={H} KVH={KVH} "
                     f"D={D} S={Sl} offsets={offs}", "B": B,
                     "max_abs_err": err, "max_rel_err": rel,
                     "ms": timer(lambda: kernel(*args)),
                     "plain_ms": timer(lambda: plain(*args), 5),
                     "library_ms": timer(lib), "bound_ms": b_ms, "bound_by": b_by})
        emit({"phase": "kernels", **rows[-1]})

    for label, B, T, offs in (("decode", 4, 1, [1000, 700, 300, 37]),
                              ("prefill", 1, 512, [0])):
        q = rand(B, T, H, D).bfloat16()
        k = rand(B, KVH, S, D).bfloat16()
        v = rand(B, KVH, S, D).bfloat16()
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        measure(fa.NAME, label, (q, k, v, off), k, v, 2 * D * 2, off)
        for name, codec, key_bytes in ((fa.NAME_Q8, QuantKV, 2 * (D + 4)),
                                       (fa.NAME_Q4, QuantKV4, 2 * (D // 2 + 4)),
                                       (fa.NAME_Q41, QuantKV41, 2 * (D // 2 + 8))):
            kc, vc = codec.quantize(k), codec.quantize(v)
            measure(name, label, (q, *kc, *vc, off), codec.dequantize(*kc),
                    codec.dequantize(*vc), key_bytes, off)
        del k, v

        # paged: the same sequences plus one idle slot (offset 0, table row
        # all -1), over shuffled pages; a slot maps only the pages it uses
        Bp, P = B + 1, (B + 1) * NP
        qp = rand(Bp, T, H, D).bfloat16()
        offp = torch.tensor(offs + [0], dtype=torch.int32, device="cuda")
        table = torch.randperm(P, generator=g, device="cuda").int().reshape(Bp, NP)
        for b, o in enumerate(offs):
            table[b, -(-(o + T) // PAGE_S):] = -1
        table[B] = -1
        kpool = rand(P, KVH, PAGE_S, D).bfloat16()
        vpool = rand(P, KVH, PAGE_S, D).bfloat16()
        measure(fa.NAME_PAGED, label, (qp, kpool, vpool, offp, table),
                fa.gather_pages(kpool, table), fa.gather_pages(vpool, table),
                2 * D * 2, offp, table)
        kc, vc = QuantKV.quantize(kpool), QuantKV.quantize(vpool)
        lib_k, lib_v = (QuantKV.dequantize(fa.gather_pages(c, table), fa.gather_pages(s, table))
                        for c, s in (kc, vc))
        measure(fa.NAME_PAGED_Q8, label, (qp, kc[0], kc[1], vc[0], vc[1], offp, table),
                lib_k, lib_v, 2 * (D + 4), offp, table)
        del kpool, vpool, kc, vc, lib_k, lib_v
    return rows


@contextlib.contextmanager
def plain_versions():
    """Route the model through the plain PyTorch versions (on the card)."""
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    saved = (qm.quant_matmul_2bit, qm.quant_matmul_4bit, qm.quant_matmul_8bit,
             fa.flash_attention)
    qm.quant_matmul_2bit = qm.quant_matmul_2bit_plain
    qm.quant_matmul_4bit = qm.quant_matmul_4bit_plain
    qm.quant_matmul_8bit = qm.quant_matmul_8bit_plain
    fa.flash_attention = fa.flash_attention_plain
    try:
        yield
    finally:
        (qm.quant_matmul_2bit, qm.quant_matmul_4bit, qm.quant_matmul_8bit,
         fa.flash_attention) = saved


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
    return engine, path


def _greedy_run(torch, engine, ids, steps, cache=None, feed=None):
    """Prefill ``ids`` into a one-sequence cache, then ``steps`` decode
    steps, each fed the argmax of the logits before it or, when ``feed`` is
    given, its tokens (teacher forcing). Returns the steps + 1 logits and
    the tokens fed."""
    from llama_gguf_inference_tpu_torch.models.llama import KVCache, forward
    dev = engine.device
    if cache is None:
        cache = KVCache.zeros(engine.cfg, 1, 1024, dev)
    toks = []
    with torch.inference_mode():
        lg = forward(engine.params, engine.cfg,
                     torch.tensor([ids], dtype=torch.int32, device=dev),
                     torch.zeros(1, dtype=torch.int32, device=dev), cache,
                     logits_at=torch.tensor([len(ids) - 1], device=dev))[0, 0]
        logits = [lg]
        for i in range(steps):
            toks.append(int(lg.argmax()) if feed is None else feed[i])
            lg = forward(engine.params, engine.cfg,
                         torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev),
                         torch.tensor([len(ids) + i], dtype=torch.int32, device=dev),
                         cache)[0, 0]
            logits.append(lg)
    torch.cuda.synchronize()
    return logits, toks


PROMPT = "the quick brown fox jumps over the lazy dog"


def _compare(k_logits, p_logits):
    """The plain run was fed the kernel run's tokens, so the logits of every
    step compare: each within LOGITS_TOL of its scale. Returns the errors
    (prefill first) and the steps whose argmax agree."""
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(k_logits, p_logits)]
    if not max(errs) <= LOGITS_TOL:
        raise AssertionError(f"logits rel errs {errs} exceed {LOGITS_TOL}")
    agree = sum(int(a.argmax()) == int(b.argmax()) for a, b in zip(k_logits, p_logits))
    return errs, agree


def phase_forward(torch, engine):
    ids = engine.tokenizer.encode(PROMPT)
    t0 = time.time()
    k_logits, k_toks = _greedy_run(torch, engine, ids, 16)
    t1 = time.time()
    with plain_versions():
        p_logits, _ = _greedy_run(torch, engine, ids, 16, feed=k_toks)
    t2 = time.time()
    _check_logits(torch, engine, k_logits)
    errs, agree = _compare(k_logits, p_logits)
    emit({"phase": "forward", "ok": True, "prompt_tokens": len(ids),
          "steps_compared": len(errs), "argmax_agree": agree,
          "logits_rel_err_prefill": errs[0], "logits_rel_err_max": max(errs),
          "kernel_path_s": round(t1 - t0, 3), "plain_path_s": round(t2 - t1, 3)})
    return k_logits[0]


def _check_logits(torch, engine, logits):
    for lg in logits:
        if lg.shape != (engine.cfg.vocab_size,) or not bool(torch.isfinite(lg).all()):
            raise AssertionError("non-finite or misshapen logits")


def _kv_config(kind, max_slots):
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig
    kv_dtype, kv_layout, _ = KV_KINDS[kind]
    return EngineConfig(max_slots=max_slots, ctx=1024, kv_dtype=kv_dtype,
                        kv_layout=kv_layout, kv_page_size=PAGE_S)


def _kv_cache(torch, kind, engine):
    """A one-sequence cache of 1024 positions: contiguous, or 4 shuffled
    pages of 256."""
    from llama_gguf_inference_tpu_torch.runtime.engine import make_kv_cache
    cache, _ = make_kv_cache(engine.cfg, _kv_config(kind, 1), engine.device)
    if hasattr(cache, "page_table"):
        cache.page_table.copy_(torch.tensor([[2, 0, 3, 1]], dtype=torch.int32))
    return cache


@contextlib.contextmanager
def kv_engine(torch, engine, ecfg):
    """The loaded engine, idle and its loop not started, over a fresh cache
    of ``ecfg``'s kind; its own cache is rebuilt on the way out."""
    from llama_gguf_inference_tpu_torch.runtime.engine import make_kv_cache

    def swap(cfg):
        engine.cache = engine.alloc = None
        gc.collect()
        torch.cuda.empty_cache()
        engine.ecfg = cfg
        engine.cache, engine.alloc = make_kv_cache(engine.cfg, cfg, engine.device)

    saved = engine.ecfg
    swap(ecfg)
    try:
        yield engine
    finally:
        swap(saved)


ENGINE_PROMPTS = (PROMPT, "hello world, the quick brown fox", "request 2: the lazy dog")


def _engine_run(torch, engine, kind, steps):
    """Three greedy requests through the engine's scheduler (``step()``),
    over four slots of ``kind``'s cache with one slot idle; launches counted
    over this run only. Each request is then replayed, fed the engine's
    tokens, through a one-sequence cache of the same kind: every token the
    engine chose must lie within LOGITS_TOL (of the logits' scale) of the
    replay's largest logit."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
    name = KV_KINDS[kind][2]
    with kv_engine(torch, engine, _kv_config(kind, 4)):
        _build.reset_launches()
        outs = [engine.submit(p, SamplingParams(temperature=0.0, max_tokens=steps))[1]
                for p in ENGINE_PROMPTS]
        while engine.step():
            pass
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        alloc = engine.alloc
        pages = None if alloc is None else (alloc.free_pages, alloc.table.shape[1])
    if launches.get(name, 0) <= 0 or launches.get(name + ".plain", 0):
        raise AssertionError(f"{kind} engine: launches {launches}")
    if pages is not None and pages[0] != pages[1]:
        raise AssertionError(f"{kind} engine: {pages[0]} of {pages[1]} pages free")
    gaps, agree, n_tok = [], 0, []
    for prompt, out in zip(ENGINE_PROMPTS, outs):
        events = []
        while not out.empty():
            events.append(out.get_nowait())
        ids = engine.tokenizer.encode(prompt)
        toks = [ev.token_id for ev in events]
        last = events[-1] if events else None
        if last is None or not last.finished or last.finish_reason not in ("stop", "length") \
                or last.n_prompt != len(ids) or not 0 < len(toks) <= steps:
            raise AssertionError(f"{kind} engine: request ended with {last}")
        ref, _ = _greedy_run(torch, engine, ids, len(toks) - 1,
                             _kv_cache(torch, kind, engine), feed=toks)
        _check_logits(torch, engine, ref)
        for lg, tok in zip(ref, toks):
            gaps.append(((lg.max() - lg[tok]) / lg.abs().max()).item())
            agree += int(lg.argmax()) == tok
        n_tok.append(len(toks))
    if not max(gaps) <= LOGITS_TOL:
        raise AssertionError(f"{kind} engine: token below the replay's max by {max(gaps)}")
    return launches, {"engine_launches": launches[name], "engine_tokens": n_tok,
                      "engine_token_gap_max": max(gaps), "engine_argmax_agree": agree,
                      "engine_pages_free_after": None if pages is None else pages[0]}


def phase_kv_forward(torch, engine, bf16_prefill):
    """Each quantized or paged cache kind at full width: the forward with
    the kernels (launches counted), the same fed those tokens with only that
    kind's attention wrapper swapped for its plain version, then the
    engine's scheduler over four slots of that kind (launches counted)."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    ids = engine.tokenizer.encode(PROMPT)
    total: dict[str, int] = {}
    for kind, (_, _, name) in KV_KINDS.items():
        t0 = time.time()
        _build.reset_launches()
        k_logits, k_toks = _greedy_run(torch, engine, ids, 16, _kv_cache(torch, kind, engine))
        launches = dict(_build.LAUNCHES)
        t1 = time.time()
        if launches.get(name, 0) <= 0 or launches.get(name + ".plain", 0):
            raise AssertionError(f"{kind}: launches {launches}")
        saved = getattr(fa, name)
        setattr(fa, name, getattr(fa, name + "_plain"))
        try:
            p_logits, _ = _greedy_run(torch, engine, ids, 16,
                                      _kv_cache(torch, kind, engine), feed=k_toks)
        finally:
            setattr(fa, name, saved)
        _check_logits(torch, engine, k_logits)
        errs, agree = _compare(k_logits, p_logits)
        engine_launches, engine_out = _engine_run(torch, engine, kind, 16)
        for counts in (launches, engine_launches):
            for n, c in counts.items():
                total[n] = total.get(n, 0) + c
        emit({"phase": "kv-forward", "ok": True, "kind": kind, "kernel": name,
              "launches": launches[name], "steps_compared": len(errs),
              "argmax_agree": agree, "logits_rel_err_prefill": errs[0],
              "logits_rel_err_max": max(errs),
              "prefill_rel_err_vs_bf16_cache": (
                  (k_logits[0] - bf16_prefill).abs().max()
                  / bf16_prefill.abs().max()).item(),
              "kernel_path_s": round(t1 - t0, 3), **engine_out})
    return total


def _post(port, path, body, key, stream=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Content-Type": "application/json"}
    if key:
        headers["Authorization"] = f"Bearer {key}"
    conn.request("POST", path, json.dumps(body), headers)
    return conn, conn.getresponse()


@contextlib.contextmanager
def serving(torch, engine, launches: dict):
    """The engine's loop and its OpenAI server on localhost, yielding
    (port, key). Launch counters are reset once both run and read into
    ``launches`` after the last request; then both stop."""
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
    try:
        if not ready.wait(60):
            raise RuntimeError("server did not start")
        yield srv.port, key
    finally:
        torch.cuda.synchronize()
        launches.update(_build.LAUNCHES)
        if ready.is_set():
            asyncio.run_coroutine_threadsafe(srv.close(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        th.join(60)
        engine.stop()


def _stream(port, path, body, key):
    """POST a streamed request; returns (t_first, t_last, usage, n_events),
    stamped when the first and the finishing chunk arrive."""
    conn, r = _post(port, path, {**body, "stream": True,
                                 "stream_options": {"include_usage": True}}, key)
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
    return t_first, t_last, usage, len(events)


def _completions(port, key, bodies):
    """POST the completion bodies at once; (status, json) of each."""
    results = [None] * len(bodies)

    def one(i):
        c, rr = _post(port, "/v1/completions", bodies[i], key)
        results[i] = (rr.status, json.loads(rr.read()))
        c.close()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(r is None or r[0] != 200 for r in results):
        raise AssertionError(f"completions: {results}")
    return results


def phase_serve(torch, engine, label="serve"):
    launches: dict[str, int] = {}
    out = {}
    with serving(torch, engine, launches) as (port, key):
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
        t_first, t_last, usage, n_events = _stream(
            port, "/v1/chat/completions",
            {"messages": msgs, "max_tokens": 64, "temperature": 0}, key)
        n_gen = usage["completion_tokens"]
        out["ttft_s"] = round(t_first - t0, 4)
        out["stream_chunks"] = n_events
        out["stream_completion_tokens"] = n_gen
        out["decode_tok_s_b1"] = round((n_gen - 1) / (t_last - t_first), 2)

        t0 = time.time()
        results = _completions(port, key, [
            {"prompt": f"request {i}: the lazy dog", "max_tokens": 64, "temperature": 0}
            for i in range(4)])
        wall = time.time() - t0
        ntok = sum(r[1]["usage"]["completion_tokens"] for r in results)
        out["concurrent_completion_tokens"] = ntok
        out["aggregate_tok_s_b4"] = round(ntok / wall, 2)

        conn, r = _post(port, "/v1/chat/completions", {"messages": msgs}, "")
        r.read()
        conn.close()
        if r.status != 401:
            raise AssertionError(f"no key: {r.status}")
        out["no_key_status"] = r.status
    emit({"phase": label, "ok": True, **out, "launches": launches})
    return launches


def phase_serve_paged(torch, path):
    """A q8_0 paged engine from the environment: 4 slots over 4 pages of
    1024 (a contiguous slot's share is 1024). One streamed request of about
    1,500 prompt tokens and three short ones at once need 5 pages, so one
    of them waits at the head of the line until pages come back."""
    from llama_gguf_inference_tpu_torch.serving.openai_server import build_engine_from_env
    os.environ.update({"MODEL_PATH": path, "MAX_SLOTS": "4", "CTX": "4096",
                       "KV_CACHE_TYPE": "q8_0", "KV_LAYOUT": "paged",
                       "KV_PAGE_SIZE": "1024"})
    t0 = time.time()
    engine = build_engine_from_env()
    torch.cuda.synchronize()
    load_s = time.time() - t0
    alloc = engine.alloc
    if alloc is None or alloc.free_pages != 4 or engine.cache.max_seq != 4096:
        raise AssertionError("expected a paged cache of 4 pages of 1024")
    words = "the quick brown fox jumps over the lazy dog and".split()
    text = " ".join(words[i % len(words)] for i in range(1500))
    n_long = len(engine.tokenizer.encode(text))
    if not 1024 < n_long < 2000:
        raise AssertionError(f"long prompt has {n_long} tokens")
    launches: dict[str, int] = {}
    out = {"load_s": round(load_s, 3), "long_prompt_tokens": n_long}
    waiting_max = [0]
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            waiting_max[0] = max(waiting_max[0], len(engine._waiting))
            time.sleep(0.002)

    try:
        with serving(torch, engine, launches) as (port, key):
            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            long_res = {}

            def long_req():
                t = time.time()
                long_res["r"] = (t, *_stream(port, "/v1/completions",
                                             {"prompt": text, "max_tokens": 32,
                                              "temperature": 0}, key))

            t0 = time.time()
            th = threading.Thread(target=long_req)
            th.start()
            short = _completions(port, key, [
                {"prompt": f"request {i}: the lazy dog", "max_tokens": 32,
                 "temperature": 0} for i in range(3)])
            th.join(600)
            wall = time.time() - t0
            stop.set()
            watcher.join(5)
            if "r" not in long_res:
                raise AssertionError("the long request did not finish")
            t_sent, t_first, t_last, usage, _ = long_res["r"]
    finally:
        stop.set()
        engine.stop()
    if usage["prompt_tokens"] != n_long:
        raise AssertionError(f"long prompt: {usage['prompt_tokens']} != {n_long} tokens")
    if waiting_max[0] < 1:
        raise AssertionError("no request waited for pages")
    if alloc.free_pages != 4:
        raise AssertionError(f"{alloc.free_pages} of 4 pages free after the run")
    name = KV_KINDS["paged_q8_0"][2]
    if launches.get(name, 0) <= 0 or launches.get(name + ".plain", 0):
        raise AssertionError(f"serve-paged launches {launches}")
    n_gen = usage["completion_tokens"]
    ntok = n_gen + sum(r[1]["usage"]["completion_tokens"] for r in short)
    out.update({"long_prompt_usage_tokens": usage["prompt_tokens"],
                "long_ttft_s": round(t_first - t_sent, 4),
                "long_completion_tokens": n_gen,
                "long_decode_tok_s": round((n_gen - 1) / (t_last - t_first), 2),
                "max_waiting": waiting_max[0], "pages_free_after": alloc.free_pages,
                "aggregate_tok_s": round(ntok / wall, 2), "wall_s": round(wall, 3)})
    emit({"phase": "serve-paged", "ok": True, **out, "launches": launches})
    return launches


def _resident_bytes(torch, node) -> int:
    """Bytes of every tensor in a parameter tree (weights as stored)."""
    if isinstance(node, torch.Tensor):
        return node.numel() * node.element_size()
    if isinstance(node, dict):
        return sum(_resident_bytes(torch, v) for v in node.values())
    if isinstance(node, list | tuple):
        return sum(_resident_bytes(torch, v) for v in node)
    if hasattr(node, "__dataclass_fields__"):
        return sum(_resident_bytes(torch, getattr(node, f)) for f in node.__dataclass_fields__)
    return 0


def phase_q2k(torch):
    """The 8B Q2_K model under the mixed scale layout: load, a prefill and
    16 greedy steps through the kernels against the plain versions fed the
    same tokens (launches counted over the kernel run), then served."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
    from llama_gguf_inference_tpu_torch.tools.synth import cached_model
    os.environ["LGT_SCALE_LAYOUT"] = "mixed"
    t0 = time.time()
    path = cached_model("8b", seed=0, quant="q2_k")
    t1 = time.time()
    engine = InferenceEngine(path, EngineConfig(max_slots=4, ctx=1024), device="cuda")
    torch.cuda.synchronize()
    t2 = time.time()
    try:
        p = engine.params
        w = p["layers"][0]["ffn_gateup"]
        if (w.fmt, w.bits, w.min_size) != ("q2_k", 2, 256):
            raise AssertionError(f"gate+up loaded as {w.fmt}, {w.bits} bits, "
                                 f"min_size {w.min_size}")
        blocks = _resident_bytes(torch, p["layers"])
        emit({"phase": "q2k-load", "ok": True, "synth_s": round(t1 - t0, 3),
              "load_s": round(t2 - t1, 3), "gguf_gb": os.path.getsize(path) / 1e9,
              "scale_layout": "mixed", "resident_weights_gb": _resident_bytes(torch, p) / 1e9,
              "resident_block_weights_gb": blocks / 1e9,
              "resident_head_gb": _resident_bytes(torch, p["output"]) / 1e9,
              "resident_embedding_gb": _resident_bytes(torch, p["tok_embd"]) / 1e9,
              "device_gb": torch.cuda.memory_allocated() / 1e9})
        ids = engine.tokenizer.encode(PROMPT)
        _build.reset_launches()
        t0 = time.time()
        k_logits, k_toks = _greedy_run(torch, engine, ids, 16)
        t1 = time.time()
        launches = dict(_build.LAUNCHES)
        if launches.get(qm.NAME_2BIT, 0) <= 0 or any(n.endswith(".plain") for n in launches):
            raise AssertionError(f"q2k kernel run: launches {launches}")
        with plain_versions():
            p_logits, _ = _greedy_run(torch, engine, ids, 16, feed=k_toks)
        _check_logits(torch, engine, k_logits)
        errs, agree = _compare(k_logits, p_logits)
        emit({"phase": "q2k-forward", "ok": True, "prompt_tokens": len(ids),
              "steps_compared": len(errs), "argmax_agree": agree,
              "logits_rel_err_prefill": errs[0], "logits_rel_err_max": max(errs),
              "kernel_path_s": round(t1 - t0, 3), "launches": launches})
        served = phase_serve(torch, engine, "q2k-serve")
    finally:
        engine.stop()
        os.environ.pop("LGT_SCALE_LAYOUT", None)
    if served.get(qm.NAME_2BIT, 0) <= 0 or any(n.endswith(".plain") for n in served):
        raise AssertionError(f"q2k serve: launches {served}")
    return [launches, served]


_FA_CU = "llama_gguf_inference_tpu_torch/csrc/flash_attention.cu"
_FA_JAX = "llama_gguf_inference_tpu/ops/flash_attention.py"
SOURCES = {
    # name: (source, TPU kernel it replaces); pallas_call sites are
    # pallas_matmul.py:641 (qsplit, fsplit), :247 (8-bit) and
    # flash_attention.py:176, :289 (q8/q4/q4_1), :369 (paged) and :452 (paged q8_0)
    "quant_matmul_2bit": ("llama_gguf_inference_tpu_torch/csrc/quant_matmul.cu",
                          "llama_gguf_inference_tpu/ops/pallas_matmul.py:481"),
    "quant_matmul_4bit": ("llama_gguf_inference_tpu_torch/csrc/quant_matmul.cu",
                          "llama_gguf_inference_tpu/ops/pallas_matmul.py:421"),
    "quant_matmul_8bit": ("llama_gguf_inference_tpu_torch/csrc/quant_matmul.cu",
                          "llama_gguf_inference_tpu/ops/pallas_matmul.py:123"),
    "flash_attention": (_FA_CU, _FA_JAX + ":129"),
    "flash_attention_q8": (_FA_CU, _FA_JAX + ":189"),
    "flash_attention_q4": (_FA_CU, _FA_JAX + ":189"),
    "flash_attention_q41": (_FA_CU, _FA_JAX + ":189"),
    "flash_attention_paged": (_FA_CU, _FA_JAX + ":302"),
    "flash_attention_paged_q8": (_FA_CU, _FA_JAX + ":383"),
}
# the kernels line reports each kernel at its decode shape (4 slots; the
# paged ones with their idle fifth; the 2-bit one in the layout the q2k
# phase serves)
LINE_SHAPE = {"quant_matmul_2bit": "mixed gate_up 28672x4096 B=4",
              "quant_matmul_4bit": "gate_up 28672x4096 B=4",
              "quant_matmul_8bit": "head 128256x4096 B=4",
              **{name: "decode" for name in SOURCES if name.startswith("flash")}}


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
    launches: dict[str, int] = {}
    try:
        card = phase_device(torch)
        phase = "build"
        phase_build()
        phase = "kernels"
        with torch.inference_mode():
            rows = phase_kernels(torch, Timer(torch))
        torch.cuda.empty_cache()
        phase = "load"
        engine, path = phase_engine(torch)
        phase = "forward"
        bf16_prefill = phase_forward(torch, engine)
        torch.cuda.empty_cache()
        phase = "kv-forward"
        paths = [phase_kv_forward(torch, engine, bf16_prefill)]
        torch.cuda.empty_cache()
        phase = "serve"
        paths.append(phase_serve(torch, engine))
        engine.stop()
        engine = None
        gc.collect()
        torch.cuda.empty_cache()
        phase = "serve-paged"
        paths.append(phase_serve_paged(torch, path))
        gc.collect()
        torch.cuda.empty_cache()
        phase = "q2k"
        paths += phase_q2k(torch)
        emit({"phase": "memory", "max_allocated_gb":
              torch.cuda.max_memory_allocated() / 1e9})
        for counts in paths:
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
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
