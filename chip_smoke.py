"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; the first failure exits non-zero:

1. device   — require a card; print its name and power limit (nvidia-smi)
2. build    — compile the CUDA kernels from ``csrc/`` (one nvcc per source)
   plans    — the 8-bit, int8 and 2/4-bit decode kernels' launch plans at the 8B
              shapes (grid, block, shared bytes, registers, spills, resident
              warps; a spill fails the run); the 2/4-bit tensor-core (wgmma)
              kernel's plans at 32 and 512 rows, the int8 one's at
              INT8_TC_MIN_ROWS and 512 and the 8-bit one's at TC_MIN_ROWS
              and 512 (with the host's time to build a launch's tensor
              maps), and every instance of each and of the tensor-core
              flash kernel with its registers, spills and its SASS's count
              of HGMMA (bf16 wgmma) and, int8, IGMMA (s8 wgmma) (a spill,
              a missing GMMA or a wgmma ptxas serialized fails the run)
3. kernels  — each kernel against its plain PyTorch version at the 8B
              shapes: 4-bit matmul (flat Q4_K) at the four projection shapes
              for 1, 4 and 512 rows, and with Q3_K's geometry (sub-blocks of
              16, code bias 4) at o and down and Q4_K in the compact and
              mixed scale layouts at gate_up; 2-bit matmul (Q2_K) at the four
              projection shapes for 1, 4 and 512 rows in the flat and mixed
              layouts and for 4 rows in compact; 8-bit matmul at the Q6_K
              head for 1, 4 and 64 rows, and with its min term at the Q5_K
              projections (compact and flat, 1, 4 and 512 rows; compact
              gate_up and qkv also at 16, 64 and 300) and Q5_1's o; from
              TC_MIN_ROWS rows up through its tensor-core kernel, which also
              runs Q8_0's flat o at 16, 64, 300 and 512 rows; the decode and
              tensor-core 8-bit kernels side by side at the four Q5_K compact
              projections and at Q8_0's o for 8, 16, 32 and 64 rows (the
              crossover that sets TC_MIN_ROWS);
              the 4-bit base, xsum, split and int8 kernels at Q4_K gate_up and
              down (1, 4, 512 rows) and at Q4_0, Q4_1 and Q3_K's o; the base
              body's 2-bit kernel at Q2_K gate_up (flat, compact); the int8
              kernel also at Q4_K qkv and o (1 and 4 rows); the IQ2/IQ3
              value maps through fsplit and base at o; flash
              attention over each cache kind (bf16, q8_0, q4_0, q4_1, paged
              bf16, paged q8_0) at decode through the split kernel (T=1, B=4,
              offsets up to 1000, beside the unsplit kernel's time as
              PERF.md recorded it; B=1 at offset 1000 over 1024 slots and at 8191
              over 8192) and prefill (T=512, B=1, offsets 0 and 1024; bf16
              and q8_0 also at 7680 over 8192 slots, an 8K prompt's last
              chunk) through its tensor-core kernel beside the CUDA-core one, and
              at T=16, 32 and 64 (offset 1000: the crossover that sets
              FLASH_TC_MIN_ROWS); the paged ones through shuffled pages of
              256 with one idle slot whose table row is all -1; the 2- and
              4-bit tensor-core kernels at the four projections for 16, 64,
              300 and 512 rows (4-bit: Q4_K flat, compact and mixed, Q3_K at
              o and down, the IQ2/IQ3 maps at o; 2-bit: Q2_K flat, mixed and
              compact), each beside the decode kernel on the same inputs,
              and at 8, 24, 32 and 48 rows too in the served layouts (Q4_K
              flat, Q2_K mixed: the crossover that sets LOWBIT_TC_MIN_ROWS;
              at 16 and 512 rows with the host's time for one call);
              the int8 body's
              and the base rule's tensor-core kernels at the four Q4_K flat
              projections for 8, 16, 32, 64, 300 and 512 rows (int8 also 24
              and 48) and at Q4_0,
              Q4_1 and Q3_K's o for 16, 64, 300 and 512, the base_f32 rule
              at Q2_K flat and compact gate_up for 512, the xsum and split
              rules at the four Q4_K flat projections for 16, 64, 300 and
              512 rows and at gate_up for 8 and 32, each beside its
              decode kernel (the crossover that sets INT8_TC_MIN_ROWS; the
              base, xsum and split rules' against LOWBIT_TC_MIN_ROWS).
              Prints errors,
              the kernel's median time, the plain version's, one PyTorch
              library call's (a yardstick only: SDPA over the bf16, dequantized
              or gathered cache), and the least time the card could take
              (bytes over 3.35 TB/s or bf16 operations over 989 TFLOP/s,
              whichever is larger) and its share of the kernel's time
4. forward  — synthesize the 8B Q4_K_M GGUF (``tools.synth.cached_model``:
              under the temp dir, reused when present), load it on the card,
              run a prefill and 16 greedy decode steps through the kernels,
              then again through the plain versions on the card, fed the
              kernel run's tokens; compare the logits of every step; then one
              512-token prefill chunk (qkv, o and gate_up through the 4-bit
              tensor-core kernel, ffn_down through the dequantize path, the
              attention through the tensor-core flash kernel, the head's row
              through the 8-bit decode kernel; logits held against the plain
              versions) and the served time to the first token of a prompt
              of at most 512 tokens
5. kv-forward — the same prefill and 16 steps over each quantized or paged
              cache kind, through the kernels and then, fed the same tokens,
              with only that kind's attention wrapper swapped for its plain
              version; then three greedy requests through the engine's
              scheduler over four slots of that kind (one idle), each token
              checked against a replay on a one-sequence cache (their
              prefill, padded to the engine's bucket of 16 or 32 rows,
              through the kind's tensor-core flash kernel, from
              FLASH_TC_MIN_ROWS (16, the smallest bucket), their decode
              steps through its decode kernel)
6. serve    — the port's OpenAI server in-process on localhost (4 slots, 1024
              context each): a chat completion, a streamed one, four concurrent
              completions, and a request without the key (must get 401)
7. variants — the same engine under each ``LGT_MM_VARIANT`` (base, xsum,
              split, int8): a prefill and 16 greedy steps held against the
              plain versions, then three greedy requests through the server;
              each run launches that variant's kernel and never fsplit's
              (decode or tensor-core); under each then one 512-token chunk
              through that body's tensor-core kernel (qkv, o and gate_up;
              ffn_down through the dequantize path, the head through the
              8-bit decode kernel), held against the plain versions (int8:
              to INT8_LOGITS_TOL, every call shadowed)
8. serve-paged — that engine freed, a second one from the environment
              (``build_engine_from_env``: q8_0 paged KV, 4 pages of 1024): a
              1,500-token prompt, longer than a slot's contiguous share, with
              three short ones; the pool cannot hold all four, so one waits;
              the prompts' chunks through the paged q8_0 tensor-core flash
              kernel (the long prompt's time to its first token printed)
9. q2k      — that engine freed, the 8B Q2_K GGUF (Q2_K embedding and
              projections, Q6_K head; ``cached_model(quant="q2_k")``) loaded
              under ``LGT_SCALE_LAYOUT=mixed``, its resident weight bytes
              printed; a prefill and 16 greedy steps through the kernels
              held against the plain versions fed the same tokens, then the
              port's OpenAI server over it as in the serve phase, and one
              512-token prefill chunk as in the forward phase, through the
              2-bit tensor-core kernel; then
              ``LGT_MM_VARIANT=base``: two steps on the mixed weights (the
              dequantize path, as in the JAX package), and the 17 steps with
              the weights relaid flat through the base body's 2-bit kernel,
              then one 512-token chunk through its tensor-core kernel
10. q5k     — that engine freed, the 8B Q5_K GGUF (Q5_K embedding and
              projections, Q6_K head; ``cached_model(quant="q5_k")``) under
              the default layout (compact), its resident bytes printed, the
              17 steps of a longer prompt against the plain versions (its
              prefill through the tensor-core kernel), then served; then one
              512-token prefill
              chunk whose launches show the dispatch (qkv, o and gate_up
              through the tensor-core kernel, ffn_down through the
              dequantize path, as the JAX package's gate sends it to
              ``matmul_xla``) and whose logits are held against the plain
              versions, and the served time to the first token of a prompt
              of at most 512 tokens
11. the ``{"kernels": [...]}`` line, the card line, and the final
   ``{"ok": true, "device": {...}}`` line

Launch counters are set to 0 just before each path that drives the kernels
(the Q4_K_M 512-token chunk and long-prompt serve, each kv-forward kernel
run and engine run, the serve phase, each variant's
kernel run and serve, the serve-paged phase, the q2k phase's kernel run,
serve, 512-token chunk, flat base run and base chunk, the base, xsum, split
and int8 variants' chunks, the q5k phase's kernel run, serve, 512-token
chunk and long-prompt serve) and read just after; comparison runs fall
outside those windows.

The breakdown of a decode step and a prefill chunk by kernel is
``python -m llama_gguf_inference_tpu_torch.tools.profile``.
"""

from __future__ import annotations

import contextlib
import gc
import http.client
import json
import os
import re
import secrets
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM data sheet, dense bf16
INT8_OPS = 1979e12             # H100 SXM data sheet, dense int8
# a matmul kernel against its plain version, of the output's scale: the same
# bf16 weights (int8: exact int32 dots) summed in another f32 order; the
# 2/4-bit and int8 wgmma kernels also take the min term as products of split
# bf16 parts, and the int8 one rounds xs to 22 significant bits
MATMUL_TOL = 1e-4
FLASH_TOL = 2 * 2 ** -8        # two bf16 ulps of the output scale
LOGITS_TOL = 0.05              # 8B forward: kernel vs plain, of max |logit|
# LGT_MM_VARIANT=int8 forward, kernel vs plain. Its activations are quantized
# to int8 per sub-block while the min term takes their exact block sums, so a
# difference of one f32 rounding that flips one activation code moves the
# output by a step the min term does not cancel, and the two runs drift apart
# layer by layer (measured 2-12% of the logits' scale by 2 to 32 layers,
# against 0.4-1.8% for fsplit; one 17-step run reached 23%). The strict check
# is the shadow one: every call of the run, kernel against plain version on
# the same inputs, within MATMUL_TOL.
INT8_LOGITS_TOL = 0.5
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


def bound(nbytes: float, flops: float, rate: float = BF16_FLOPS) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
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
    return reports


# the 8-bit decode kernel's launch at each 8B shape it serves, B=4: (label,
# projection, sub-block size, scale side, min side), the sides as the
# kernel's Side codes (0 none, 1 flat, 2 compact u8, 3 compact i8)
PLANS_8BIT = [(f"q5_k {lay} {name}", name, 32, side, side)
              for lay, side in (("compact", 2), ("flat", 1)) for name in SHAPES_4BIT]
PLANS_8BIT += [(f"q8_0 flat {name}", name, 32, 1, 0) for name in SHAPES_4BIT]
PLANS_8BIT += [("q6_k head", "head", 16, 3, 0), ("q6_k down", "down", 16, 3, 0)]


# the int8 decode kernel's launch at the 8B shapes of the int8 body, B=4:
# (label, projection, sub-block size, scale side, min side)
PLANS_INT8 = [(f"q4_k {lay} {name}", name, 32, side, side)
              for lay, side in (("flat", 1), ("compact", 2)) for name in SHAPES_4BIT]
PLANS_INT8 += [("q4_0 flat o", "o", 32, 1, 0), ("q3_k flat o", "o", 16, 1, 0)]


# the 2/4-bit decode kernel's launch (fsplit rule) at the 8B shapes of the
# served formats, B=4: (label, projection, bits, sub-block size, scale
# side, min side)
PLANS_LOWBIT = [(f"q4_k {lay} {name}", name, 4, 32, side, side)
                for lay, side in (("flat", 1), ("compact", 2)) for name in SHAPES_4BIT]
PLANS_LOWBIT += [(f"q2_k {lay} {name}", name, 2, 16, s_side, m_side)
                 for lay, s_side, m_side in (("flat", 1, 1), ("mixed", 1, 2), ("compact", 2, 2))
                 for name in SHAPES_2BIT]
PLANS_LOWBIT += [(f"q3_k flat {name}", name, 4, 16, 1, 0) for name in ("o", "down")]

# the 2/4-bit tensor-core kernel's launch at the 8B shapes of the served
# layouts (fsplit), at B = 32 and 512: (label, projection, bits, sub-block
# size, scale side, min side)
PLANS_LOWBIT_TC = [(f"q4_k flat {name}", name, 4, 32, 1, 1) for name in ("qkv", "o", "gate_up")]
PLANS_LOWBIT_TC += [(f"q2_k mixed {name}", name, 2, 16, 1, 2) for name in ("qkv", "o", "gate_up")]

# the int8 tensor-core kernel's launch at the 8B shapes of its 512-token
# chunk (Q4_K flat) and at Q3_K's o, at B = INT8_TC_MIN_ROWS and 512:
# (label, projection, sub-block size, scale side, min side)
PLANS_INT8_TC = [(f"q4_k flat {name}", name, 32, 1, 1) for name in ("qkv", "o", "gate_up")]
PLANS_INT8_TC += [("q3_k flat o", "o", 16, 1, 0)]

# the 8-bit tensor-core kernel's launch at the 8B shapes of the Q5_K chunk
# (compact) and at the Q6_K head, at B = TC_MIN_ROWS and 512: (label,
# projection, sub-block size, scale side, min side)
PLANS_8BIT_TC = [(f"q5_k compact {name}", name, 32, 2, 2) for name in ("qkv", "o", "gate_up")]
PLANS_8BIT_TC += [("q6_k head", "head", 16, 3, 0)]


def _ptxas(report: str, kernel: str) -> dict:
    """Template arguments -> registers and spill bytes of each instance of
    ``kernel``, from ptxas's -v report (the arguments as the mangled name
    gives them, bools as 0 and 1)."""
    out = {}
    for entry in report.split("Compiling entry function")[1:]:
        head = entry.split("'")[1] if "'" in entry else ""
        if kernel + "I" not in head:
            continue
        targs = tuple(int(v) for v in re.findall(r"L[ib](\d+)E", head.split(kernel + "I")[1]))

        def num(pattern):
            return int(re.search(pattern, entry).group(1))
        out[targs] = {"ptxas_registers": num(r"Used (\d+) registers"),
                      "spill_stores": num(r"(\d+) bytes spill stores"),
                      "spill_loads": num(r"(\d+) bytes spill loads")}
    return out


def _plan_line(plan_fn, B, in_f, out_f, nsub, s_side, m_side, n, label):
    """One launch plan as the kernel's plan entry point reports it into
    int[n] (the int8 one's eighth value is the instance; the 2/4-bit
    tensor-core one's eighth the activation rows a tile, its ninth the ns
    the host takes to build the launch's tensor maps)."""
    import ctypes

    from llama_gguf_inference_tpu_torch.ops import _build
    info = (ctypes.c_int * n)()
    _build.check(plan_fn(B, in_f, out_f, nsub, s_side, m_side, info), label)
    gx, gy, threads, smem, regs, local, per_sm = list(info)[:7]
    line = {"shape": f"{label} {out_f}x{in_f} B={B}", "grid": [gx, gy], "threads": threads,
            "smem_bytes": smem, "registers": regs, "local_bytes": local,
            "blocks_per_sm": per_sm, "warps_per_sm": per_sm * threads // 32}
    if n > 7:
        line["instance"] = info[7]
    if n > 8:
        line["tensor_maps_host_us"] = info[8] / 1e3
    return line


def _sass_functions(path: str) -> dict[str, str]:
    """Mangled function name -> its SASS, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=600,
                         check=True).stdout
    return {part.split()[0]: part for part in out.split("Function : ")[1:]}


def _tc_instances(report: str, source: str, kernel: str, gmma: tuple[str, ...]) -> list[dict]:
    """Every instance of the wgmma kernel ``kernel`` of ``csrc/<source>.cu``:
    its template arguments, ptxas's registers and spills, and how many
    instructions of each SASS mnemonic of ``gmma`` (``HGMMA``, bf16 wgmma;
    ``IGMMA``, s8 wgmma) its SASS holds, and whether ptxas reports its
    wgmmas serialized; ``report`` is empty where the
    library was already built, and the source is then compiled again for
    ptxas's report. No instance, an instance without ptxas's registers, a
    spill, an instance without one of ``gmma`` or one whose wgmmas ptxas
    serialized fails the run."""
    from llama_gguf_inference_tpu_torch.ops import _build
    report = report or _build.ptxas_report(source)
    ptxas = _ptxas(report, kernel)
    serialized = [ln for ln in report.splitlines() if "wgmma" in ln and "serialized" in ln]
    out = []
    for name, sass in _sass_functions(_build._lib_path(source)).items():
        if kernel + "I" not in name:
            continue
        targs = tuple(int(v) for v in re.findall(r"L[ib](\d+)E", name.split(kernel + "I")[1]))
        counts = {op.lower(): len(re.findall(rf"\b{op}\b", sass)) for op in gmma}
        out.append({"instance": list(targs), **counts, **ptxas.get(targs, {}),
                    "wgmma_serialized": any(name in ln for ln in serialized)})
    bad = [i for i in out if not all(i[op.lower()] for op in gmma) or i.get("spill_stores", 0)
           or i.get("spill_loads", 0) or "ptxas_registers" not in i or i["wgmma_serialized"]]
    if not out or bad:
        raise AssertionError(f"{source} instances without {gmma} or spilling: {bad}")
    return out


def phase_plans(torch, reports: dict) -> None:
    """One line: the 8-bit, int8 and 2/4-bit decode kernels' grid, block,
    registers, spills and resident blocks at each 8B shape (B=4; int8: and
    the instance, 0 for sub 32 on m16n8k32, 1 for m16n8k16; 2/4-bit: 0 for
    steps of 16 sub-blocks, 1 of 32, 2 the generic instance), from each
    kernel's own launch plan (cudaFuncGetAttributes, the occupancy
    calculator) and ptxas's report; the 2/4-bit tensor-core kernel's launch
    at the served layouts' 8B shapes for 32 and 512 rows (its instance the
    activation rows a tile; its registers those at entry, before
    setmaxnreg), and each of its instances' registers, spills and HGMMA
    (:func:`_tc_instances`). A spill, or a tensor-core instance without
    HGMMA, fails the run; the int8 tensor-core kernel's the same at
    INT8_TC_MIN_ROWS and 512 rows, its instances' registers, spills and
    IGMMA and HGMMA counts; the 8-bit tensor-core kernel's at TC_MIN_ROWS
    and 512 rows, its instances' registers, spills and HGMMA counts; the
    tensor-core flash kernel's 12 instances' the same. A serialized wgmma
    fails the run too."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    report = reports["quant_matmul"]
    lib = _build.library("quant_matmul")
    ptxas8 = _ptxas(report, "quant_matmul_8bit_kernel")
    ptxas_i8 = _ptxas(report, "quant_matmul_int8_kernel")
    ptxas_lb = {inst: _ptxas(report, kernel) for inst, kernel in
                ((0, "quant_matmul_lowbit_kernel"), (2, "quant_matmul_lowbit_generic"))}
    plans, plans_i8, plans_lb = [], [], []
    for label, name, sub, s_side, m_side in PLANS_8BIT:
        out_f, in_f = HEAD if name == "head" else SHAPES_4BIT[name]
        plans.append(_plan_line(lib.lgt_quant_matmul_8bit_plan, 4, in_f, out_f, in_f // sub,
                                s_side, m_side, 7, label))
        plans[-1].update(ptxas8.get((s_side, m_side), {}))
    for label, name, sub, s_side, m_side in PLANS_INT8:
        out_f, in_f = SHAPES_4BIT[name]
        line = _plan_line(lib.lgt_quant_matmul_int8_plan, 4, in_f, out_f, in_f // sub,
                          s_side, m_side, 8, label)
        # the instance's template arguments: sides, sub 32 on m16n8k32, sub-blocks a step
        inst = line["instance"]
        line.update(ptxas_i8.get((s_side, m_side, int(inst == 0), 4 if inst == 2 else 16), {}))
        plans_i8.append(line)
    for label, name, bits, sub, s_side, m_side in PLANS_LOWBIT:
        out_f, in_f = (SHAPES_4BIT if bits == 4 else SHAPES_2BIT)[name]

        def plan_fn(*args, bits=bits):
            return lib.lgt_quant_matmul_lowbit_plan(*args[:6], bits, qm.VAR_FSPLIT, 0, args[6])
        line = _plan_line(plan_fn, 4, in_f, out_f, in_f // sub, s_side, m_side, 8, label)
        # the instance's template arguments: bits, rule, code map, sides
        line.update(ptxas_lb[2 if line["instance"] == 2 else 0].get(
            (bits, qm.VAR_FSPLIT, 0, s_side, m_side), {}))
        plans_lb.append(line)
    tc_lib = _build.library("quant_matmul_lowbit_tc")
    plans_tc = []
    for label, name, bits, sub, s_side, m_side in PLANS_LOWBIT_TC:
        out_f, in_f = SHAPES_4BIT[name]
        for B in (32, 512):

            def plan_fn(*args, bits=bits):
                return tc_lib.lgt_quant_matmul_lowbit_tc_plan(*args[:6], bits, qm.VAR_FSPLIT, 0,
                                                              args[6])
            plans_tc.append(_plan_line(plan_fn, B, in_f, out_f, in_f // sub, s_side, m_side, 9,
                                       label))
    i8_lib = _build.library("quant_matmul_int8_tc")
    plans_i8tc = [_plan_line(i8_lib.lgt_quant_matmul_int8_tc_plan, B, SHAPES_4BIT[name][1],
                             SHAPES_4BIT[name][0], SHAPES_4BIT[name][1] // sub, s_side, m_side,
                             9, label)
                  for label, name, sub, s_side, m_side in PLANS_INT8_TC
                  for B in (qm.INT8_TC_MIN_ROWS, 512)]
    t8_lib = _build.library("quant_matmul_tc")
    plans_t8 = [_plan_line(t8_lib.lgt_quant_matmul_8bit_tc_plan, B, in_f, out_f, in_f // sub,
                           s_side, m_side, 9, label)
                for label, name, sub, s_side, m_side in PLANS_8BIT_TC
                for out_f, in_f in [HEAD if name == "head" else SHAPES_4BIT[name]]
                for B in (qm.TC_MIN_ROWS, 512)]
    for line in plans + plans_i8 + plans_lb + plans_tc + plans_i8tc + plans_t8:
        if line["local_bytes"] or line.get("spill_stores", 0):
            raise AssertionError(f"kernel spills: {line}")
    emit({"phase": "plans", "quant_matmul_8bit": plans, "quant_matmul_4bit_int8": plans_i8,
          "quant_matmul_lowbit": plans_lb, "quant_matmul_lowbit_tc": plans_tc,
          "quant_matmul_lowbit_tc_instances": _tc_instances(
              reports["quant_matmul_lowbit_tc"], "quant_matmul_lowbit_tc",
              "quant_matmul_lowbit_tc_kernel", ("HGMMA",)),
          "quant_matmul_int8_tc": plans_i8tc,
          "quant_matmul_int8_tc_instances": _tc_instances(
              reports["quant_matmul_int8_tc"], "quant_matmul_int8_tc",
              "quant_matmul_int8_tc_kernel", ("IGMMA", "HGMMA")),
          "quant_matmul_8bit_tc": plans_t8,
          "quant_matmul_8bit_tc_instances": _tc_instances(
              reports["quant_matmul_tc"], "quant_matmul_tc", "quant_matmul_8bit_tc_kernel",
              ("HGMMA",)),
          "flash_attention_tc_instances": _tc_instances(
              reports["flash_attention_tc"], "flash_attention_tc", "flash_attention_tc_kernel",
              ("HGMMA",))})


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
            rows.append({"kernel": _lowbit_name(qm, 4, B, in_f, nsub, nsub, nsub),
                         "shape": f"{name} {out_f}x{in_f} B={B}",
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
    for B in (1, 4, 64):
        x = rand(B, in_f).bfloat16()
        args = (x, codes, d, sc, 16, 0)
        got = qm.quant_matmul_8bit(*args)
        want = qm.quant_matmul_8bit_plain(*args)
        err, rel = _err(got, want, MATMUL_TOL)
        nbytes = codes.numel() + sc.numel() + d.numel() * 4 + B * in_f * 2 + B * out_f * 4
        b_ms, b_by = bound(nbytes, 2.0 * B * in_f * out_f)
        ms = timer(lambda: qm.quant_matmul_8bit(*args))
        rows.append({"kernel": _8bit_name(qm, B, in_f, 16, False),
                     "shape": f"head {out_f}x{in_f} B={B}",
                     "B": B, "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                     "plain_ms": timer(lambda: qm.quant_matmul_8bit_plain(*args), 5),
                     "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                     "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms})
        emit({"phase": "kernels", **rows[-1]})
    del w_lib, codes, sc

    rows += _lowbit_rows(torch, qm, g, timer)
    rows += _lowbit_tc_rows(torch, qm, g, timer)
    rows += _variant_rows(torch, qm, g, timer)
    rows += _variant_tc_rows(torch, qm, g, timer)
    rows += _attention_rows(torch, F, fa, rand, g, timer)
    return rows


def _lowbit_name(qm, bits, B, in_f, nsub, nd, ndm):
    """The launch name of the 2/4-bit kernel the dispatching wrapper runs."""
    tc = B >= qm.LOWBIT_TC_MIN_ROWS and qm.lowbit_tc_takes(bits, in_f, nsub, nd, ndm)
    return [[qm.NAME_2BIT, qm.NAME_4BIT], [qm.NAME_2BIT_TC, qm.NAME_4BIT_TC]][tc][bits == 4]


def _8bit_name(qm, B, in_f, sub, has_min):
    """The launch name of the 8-bit kernel the dispatching wrapper runs."""
    tc = B >= qm.TC_MIN_ROWS and qm.tc_takes(in_f, sub)
    return [[qm.NAME_8BIT, qm.NAME_8BIT_MIN], [qm.NAME_8BIT_TC, qm.NAME_8BIT_MIN_TC]][tc][has_min]


# weight geometry of each format the kernel rows draw: (bits, sub-block size,
# code bias, has a min side, sub-block scale signed)
FORMATS = {"q2_k": (2, 16, 0, True, False), "q3_k": (4, 16, 4, False, True),
           "q4_k": (4, 32, 0, True, False), "q4_0": (4, 32, 8, False, False),
           "q4_1": (4, 32, 0, True, False), "iq2_xs": (4, 32, 0, False, False),
           "iq3_s": (4, 32, 0, False, False), "q5_k": (8, 32, 0, True, False),
           "q5_1": (8, 32, 0, True, False), "q8_0": (8, 32, 0, False, False)}


def _weight(torch, g, fmt, out_f, in_f, layout):
    """A random QuantLinear of ``fmt``'s geometry in one scale layout: flat
    (f32 per sub-block), compact (f32 per 256 times an 8-bit factor per
    sub-block) or mixed (the scale flat, the min side compact)."""
    from llama_gguf_inference_tpu_torch.ops.linear import QuantLinear
    bits, sub, bias, has_min, signed_sc = FORMATS[fmt]
    nsub, nd = in_f // sub, in_f // 256

    def f32(n, scale):
        return torch.rand(out_f, n, generator=g, device="cuda") * scale + scale / 10

    def u8(lo):
        t = torch.randint(lo, lo + 16, (out_f, nsub), generator=g, device="cuda",
                          dtype=torch.int32)
        return t.to(torch.int8 if lo < 0 else torch.uint8)

    if bits == 8:   # 5-bit codes widened to int8, as Q5_K and Q5_1 repack; Q8_0's int8
        lo, hi = (-128, 128) if fmt == "q8_0" else (0, 32)
        codes = torch.randint(lo, hi, (out_f, in_f), generator=g, device="cuda",
                              dtype=torch.int8)
    else:
        codes = torch.randint(0, 256, (out_f, in_f * bits // 8), generator=g, device="cuda",
                              dtype=torch.uint8)
    d = f32(nsub, 1e-2) if layout != "compact" else f32(nd, 1e-3)
    sc = u8(-8 if signed_sc else 0) if layout == "compact" else None
    dmin = mn = None
    if has_min:
        dmin = f32(nsub, 5e-2) if layout == "flat" else f32(nd, 5e-3)
        mn = None if layout == "flat" else u8(0)
    return QuantLinear(codes=codes, d=d, sc=sc, dmin=dmin, mn=mn, fmt=fmt,
                       bits=bits, sub_size=sub, d_size=256 if layout == "compact" else sub,
                       code_bias=bias, out_features=out_f, in_features=in_f,
                       min_size=256 if layout == "mixed" else 0)


def _wbytes(w) -> int:
    return sum(a.numel() * a.element_size() for a in (w.codes, w.d, w.sc, w.dmin, w.mn)
               if a is not None)


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
            cases.append(("q2_k", f"{layout} {name}", out_f, in_f, layout, bs))
    for name in ("o", "down"):
        out_f, in_f = SHAPES_4BIT[name]
        cases.append(("q3_k", f"q3_k {name}", out_f, in_f, "flat", (1, 4)))
    for layout in ("compact", "mixed"):
        out_f, in_f = SHAPES_4BIT["gate_up"]
        cases.append(("q4_k", f"q4_k {layout} gate_up", out_f, in_f, layout, (4,)))
    rows = []
    for fmt, label, out_f, in_f, layout, bs in cases:
        w = _weight(torch, g, fmt, out_f, in_f, layout)
        bits, sub, bias = w.bits, w.sub_size, w.code_bias
        kernel, plain = ((qm.quant_matmul_2bit, qm.quant_matmul_2bit_plain) if bits == 2 else
                         (qm.quant_matmul_4bit, qm.quant_matmul_4bit_plain))
        w_lib = w.dequantize_bm()
        arrays = [w.codes, w.d, w.sc, w.dmin, w.mn]
        wbytes = _wbytes(w)
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
            rows.append({"kernel": _lowbit_name(qm, bits, B, in_f, nsub, w.d.shape[1],
                                                (w.d if w.dmin is None else w.dmin).shape[1]),
                         "shape": f"{label} {out_f}x{in_f} B={B}",
                         "B": B, "max_abs_err": err, "max_rel_err": rel,
                         "bits_per_weight": 8 * wbytes / (out_f * in_f),
                         "ms": timer(lambda: kernel(*args)),
                         "plain_ms": timer(lambda: plain(*args), 5),
                         "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                         "bound_ms": b_ms, "bound_by": b_by})
            emit({"phase": "kernels", **rows[-1]})
        del w, w_lib, arrays
    return rows


def _host_us(torch, fn, n: int = 50) -> float:
    """Mean host microseconds of one call of ``fn`` (a wrapper that
    enqueues its kernel and returns), over ``n`` calls in a row."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def _lowbit_tc_rows(torch, qm, g, timer):
    """The 2- and 4-bit tensor-core kernels through their own wrappers, each
    beside the decode kernel on the same inputs (``decode_ms``): Q4_K flat,
    compact and mixed and Q2_K flat, mixed and compact at the four
    projections, Q3_K at o and down, the IQ2/IQ3 maps at o, for 16, 64, 300
    and 512 rows; the served layouts (Q4_K flat, Q2_K mixed) also at 8, 24,
    32 and 48, where the two kernels cross, and at 16 and 512 rows with
    the host's time for one call of the wrapper (``host_us``). Bound and
    library call as in :func:`_lowbit_rows`."""
    cases = []
    for fmt, layouts in (("q4_k", ("flat", "compact", "mixed")),
                         ("q2_k", ("mixed", "flat", "compact"))):
        for layout in layouts:
            for name in SHAPES_4BIT:
                served = layout == ("flat" if fmt == "q4_k" else "mixed")
                cases.append((fmt, layout, name, (8, 16, 24, 32, 48, 64, 300, 512) if served
                              else (16, 64, 300, 512)))
    cases += [("q3_k", "flat", name, (16, 64, 300, 512)) for name in ("o", "down")]
    cases += [(fmt, "flat", "o", (16, 64, 300, 512)) for fmt in ("iq2_xs", "iq3_s")]
    rows = []
    for fmt, layout, name, bs in cases:
        out_f, in_f = SHAPES_4BIT[name]
        w = _weight(torch, g, fmt, out_f, in_f, layout)
        bits, sub = w.bits, w.sub_size
        kname = qm.NAME_4BIT_TC if bits == 4 else qm.NAME_2BIT_TC
        kernel = getattr(qm, f"quant_matmul_{bits}bit_tc")
        decode = getattr(qm, f"quant_matmul_{bits}bit_decode")
        plain = getattr(qm, f"quant_matmul_{bits}bit_plain")
        w_lib = w.dequantize_bm()
        wbytes = _wbytes(w)
        nsub = in_f // sub
        for B in bs:
            x = torch.randn(B, in_f, generator=g, device="cuda").bfloat16()
            xsum = qm._block_sums(x, sub)
            if layout == "mixed":
                xsum = qm._mixed_xsum(xsum, w)
            args = (x, xsum, w.codes, w.d, w.sc, w.dmin, w.mn, w.code_bias, w.fmt)
            err, rel = _err(kernel(*args), plain(*args), MATMUL_TOL)
            b_ms, b_by = bound(wbytes + B * in_f * 2 + B * nsub * 4 + B * out_f * 4,
                               2.0 * B * in_f * out_f)
            ms = timer(lambda: kernel(*args))
            host = {"host_us": _host_us(torch, lambda: kernel(*args))} \
                if (fmt, layout) in (("q4_k", "flat"), ("q2_k", "mixed")) and B in (16, 512) \
                else {}
            rows.append({"kernel": kname, "shape": f"{fmt} {layout} tc {name} {out_f}x{in_f} B={B}",
                         "B": B, "max_abs_err": err, "max_rel_err": rel,
                         "bits_per_weight": 8 * wbytes / (out_f * in_f), "ms": ms,
                         "decode_ms": timer(lambda: decode(*args), 5 if B > 64 else 20),
                         "plain_ms": timer(lambda: plain(*args), 5),
                         "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                         "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms, **host})
            emit({"phase": "kernels", **rows[-1]})
        del w, w_lib
    return rows


VARIANTS = ("base", "xsum", "split", "int8")


def _variant_call(qm, w, variant, x):
    """(kernel name, kernel, its args, plain version, its args, activation
    bytes read, int8 operations) of one body on weight ``w`` and bf16
    activations ``x`` (B, in), the arguments built as the dispatcher builds
    them."""
    arrs = (w.codes, w.d, w.sc, w.dmin, w.mn)
    B, in_f = x.shape
    nsub = in_f // w.sub_size
    xsum = qm._block_sums(x, w.sub_size)
    x_bytes = B * in_f * 2 + B * nsub * 4
    if variant.startswith("8bit"):
        # 8bit: the dispatching wrapper; 8bit_decode, 8bit_tc: one kernel
        args = (x, w.codes, w.d, w.sc, w.sub_size, w.code_bias, w.dmin, w.mn)
        nrows = {"8bit": B, "8bit_decode": 0, "8bit_tc": qm.TC_MIN_ROWS}[variant]
        fn = {"8bit": qm.quant_matmul_8bit, "8bit_decode": qm.quant_matmul_8bit_decode,
              "8bit_tc": qm.quant_matmul_8bit_tc}[variant]
        return _8bit_name(qm, nrows, in_f, w.sub_size, w.dmin is not None), fn, args, \
            qm.quant_matmul_8bit_plain, args, B * in_f * 2, False
    nd = w.d.shape[1]
    # int8, base: the dispatching wrapper; int8_decode, base_decode: the
    # decode kernel; int8_tc, base_tc: the tensor-core kernel
    kind = variant.split("_")[1] if "_" in variant else ""
    if variant.startswith("int8"):
        xq, xs = qm.quantize_acts(x, w.sub_size)
        args = (xq, xs, xsum, *arrs, w.code_bias)
        tc = kind == "tc" or (not kind and B >= qm.INT8_TC_MIN_ROWS
                              and qm.int8_tc_takes(in_f, nsub, nd, w.sub_size))
        fn = getattr(qm, "quant_matmul_4bit_int8" + (f"_{kind}" if kind else ""))
        return qm.NAME_4BIT_INT8_TC if tc else qm.NAME_4BIT_INT8, fn, args, \
            qm.quant_matmul_4bit_int8_plain, args, B * in_f + 2 * B * nsub * 4, True
    tc = kind == "tc" or (not kind and B >= qm.LOWBIT_TC_MIN_ROWS
                          and qm.lowbit_tc_takes(w.bits, in_f, nsub, nd, nd))
    if variant.startswith("base") and w.bits == 4 and w.fmt not in qm.MAPPED_FMTS:
        args = (x, *arrs, w.code_bias)
        fn = getattr(qm, "quant_matmul_4bit_base" + (f"_{kind}" if kind else ""))
        return qm.NAME_4BIT_BASE_TC if tc else qm.NAME_4BIT_BASE, fn, args, \
            qm.quant_matmul_4bit_base_plain, args, B * in_f * 2, False
    if variant.startswith("base"):
        args = (x, *arrs, w.code_bias, w.bits, w.fmt)
        fn = getattr(qm, "quant_matmul_lowbit_base" + (f"_{kind}" if kind else ""))
        return qm.NAME_LOWBIT_BASE_TC if tc else qm.NAME_LOWBIT_BASE, fn, args, \
            qm.quant_matmul_lowbit_base_plain, args, B * in_f * 2, False
    # fsplit, xsum, split: the dispatching wrapper; xsum_decode, xsum_tc,
    # split_decode, split_tc: one kernel
    body = variant.split("_")[0]
    name = {"fsplit": (qm.NAME_4BIT, qm.NAME_4BIT_TC),
            "xsum": (qm.NAME_4BIT_XSUM, qm.NAME_4BIT_XSUM_TC),
            "split": (qm.NAME_4BIT_SPLIT, qm.NAME_4BIT_SPLIT_TC)}[body][tc]
    kernel = getattr(qm, "quant_matmul_4bit" + ("" if body == "fsplit" else f"_{body}")
                     + (f"_{kind}" if kind else ""))
    plain = getattr(qm, "quant_matmul_4bit" + ("" if body == "fsplit" else f"_{body}")
                    + "_plain")
    args = (x, xsum, *arrs, w.code_bias, w.fmt)
    return name, kernel, args, plain, args, x_bytes, False


def _variant_rows(torch, qm, g, timer):
    """The 8-bit kernel's min term and the LGT_MM_VARIANT bodies, each at
    the shapes of its path: the 8-bit kernel with its min term at the Q5_K
    projections (compact, the ``auto`` layout, and flat; B = 1, 4, 512, the
    512 rows through the tensor-core kernel; compact gate_up and qkv at 16,
    64 and 300 too), the decode and tensor-core kernels side by side at the
    compact projections and at Q8_0's flat o for B = 8, 16, 32, 64, Q8_0's flat o through the tensor-core kernel (B = 16, 64, 300,
    512) and Q5_1's flat min at o; the
    4-bit base, xsum, split and int8 kernels at Q4_K flat gate+up and down
    (B = 1, 4, 512) and at Q4_0 (bias 8), Q4_1 (flat min) and Q3_K (sub 16,
    bias 4) at o; the int8 kernel also at Q4_K flat qkv and o (B = 1, 4);
    the base body's f32 branch at Q2_K flat and compact gate+up; the IQ2/IQ3
    value maps through fsplit and base at o (codes drawn at random, no IQ
    repack). The int8 kernel's operations bound is taken at the int8 rate."""
    cases = [("q5_k", layout, name, (1, 4, 512), ("8bit",))
             for layout in ("compact", "flat") for name in SHAPES_4BIT]
    cases += [("q5_k", "compact", name, (16, 64, 300), ("8bit",)) for name in ("gate_up", "qkv")]
    cases += [("q5_k", "compact", name, (8, 16, 32, 64), ("8bit_decode", "8bit_tc"))
              for name in SHAPES_4BIT]
    cases.append(("q8_0", "flat", "o", (16, 64, 300, 512), ("8bit",)))
    cases.append(("q8_0", "flat", "o", (8, 16, 32, 64), ("8bit_decode", "8bit_tc")))
    cases.append(("q5_1", "flat", "o", (4,), ("8bit",)))
    cases += [("q4_k", "flat", name, (1, 4, 512), VARIANTS) for name in ("gate_up", "down")]
    cases += [("q4_k", "flat", name, (1, 4), ("int8",)) for name in ("qkv", "o")]
    cases += [(fmt, "flat", "o", (4,), VARIANTS) for fmt in ("q4_0", "q4_1", "q3_k")]
    cases += [("q2_k", layout, "gate_up", (4,), ("base",)) for layout in ("flat", "compact")]
    cases += [(fmt, "flat", "o", (4,), ("fsplit", "base")) for fmt in ("iq2_xs", "iq3_s")]
    rows = []
    for fmt, layout, name, bs, variants in cases:
        out_f, in_f = SHAPES_4BIT[name]
        w = _weight(torch, g, fmt, out_f, in_f, layout)
        w_lib = w.dequantize_bm()
        wbytes = _wbytes(w)
        for B in bs:
            x = torch.randn(B, in_f, generator=g, device="cuda").bfloat16()
            for var in variants:
                kname, kernel, args, plain, pargs, x_bytes, int8 = _variant_call(qm, w, var, x)
                err, rel = _err(kernel(*args), plain(*pargs), MATMUL_TOL)
                b_ms, b_by = bound(wbytes + x_bytes + B * out_f * 4, 2.0 * B * in_f * out_f,
                                   INT8_OPS if int8 else BF16_FLOPS)
                ms = timer(lambda: kernel(*args))
                rows.append({"kernel": kname,
                             "shape": f"{fmt} {layout} {var} {name} {out_f}x{in_f} B={B}",
                             "B": B, "max_abs_err": err, "max_rel_err": rel,
                             "bits_per_weight": 8 * wbytes / (out_f * in_f), "ms": ms,
                             "plain_ms": timer(lambda: plain(*pargs), 5),
                             "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                             "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms})
                emit({"phase": "kernels", **rows[-1]})
        del w, w_lib
    return rows


def _variant_tc_rows(torch, qm, g, timer):
    """The tensor-core kernels of the int8 body, of the base rules and of
    the xsum and split bodies through their own wrappers, each beside its
    decode kernel on the same inputs (``decode_ms``): Q4_K flat at the four
    projections for 8, 16, 32, 64, 300 and 512 rows (int8 also 24 and 48; 8 to 64
    rows are where the two kernels cross) and for 16, 64, 300 and 512 (xsum
    and split; at gate+up also 8 and 32, their crossover), Q4_0, Q4_1 and
    Q3_K at o for 16, 64, 300 and 512, and the base_f32 rule at Q2_K flat
    and compact gate+up for 512 rows. Bound as in :func:`_variant_rows`
    (the int8 kernel's operations at the int8 rate)."""
    cases = [("q4_k", "flat", name, (8, 16, 24, 32, 48, 64, 300, 512), ("int8",))
             for name in SHAPES_4BIT]
    cases += [("q4_k", "flat", name, (8, 16, 32, 64, 300, 512), ("base",))
              for name in SHAPES_4BIT]
    cases += [("q4_k", "flat", name, (8, 16, 32, 64, 300, 512) if name == "gate_up"
               else (16, 64, 300, 512), ("xsum", "split")) for name in SHAPES_4BIT]
    cases += [(fmt, "flat", "o", (16, 64, 300, 512), ("int8", "base"))
              for fmt in ("q4_0", "q4_1", "q3_k")]
    cases += [("q2_k", layout, "gate_up", (512,), ("base",)) for layout in ("flat", "compact")]
    rows = []
    for fmt, layout, name, bs, variants in cases:
        out_f, in_f = SHAPES_4BIT[name]
        w = _weight(torch, g, fmt, out_f, in_f, layout)
        w_lib = w.dequantize_bm()
        wbytes = _wbytes(w)
        for B in bs:
            x = torch.randn(B, in_f, generator=g, device="cuda").bfloat16()
            for var in variants:
                kname, kernel, args, plain, _, x_bytes, int8 = _variant_call(qm, w, var + "_tc", x)
                decode = _variant_call(qm, w, var + "_decode", x)[1]
                err, rel = _err(kernel(*args), plain(*args), MATMUL_TOL)
                b_ms, b_by = bound(wbytes + x_bytes + B * out_f * 4, 2.0 * B * in_f * out_f,
                                   INT8_OPS if int8 else BF16_FLOPS)
                ms = timer(lambda: kernel(*args))
                rows.append({"kernel": kname,
                             "shape": f"{fmt} {layout} {var} tc {name} {out_f}x{in_f} B={B}",
                             "B": B, "max_abs_err": err, "max_rel_err": rel,
                             "bits_per_weight": 8 * wbytes / (out_f * in_f), "ms": ms,
                             "decode_ms": timer(lambda: decode(*args), 5 if B > 64 else 20),
                             "plain_ms": timer(lambda: plain(*args), 5),
                             "library_ms": timer(lambda: torch.matmul(x, w_lib.t())),
                             "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms})
                emit({"phase": "kernels", **rows[-1]})
        del w, w_lib
    return rows


# the unsplit decode kernel at the B=4 decode row (PERF.md §6, measured on an
# NVIDIA H100 80GB HBM3 at 700.00 W before the kernel was split), shown
# beside the split kernel's time; that kernel is no longer in the tree
UNSPLIT_DECODE_MS = {"flash_attention": 0.1199, "flash_attention_q8": 0.0970,
                 "flash_attention_q4": 0.0714, "flash_attention_q41": 0.0759,
                 "flash_attention_paged": 0.1282, "flash_attention_paged_q8": 0.1058}


def _attention_rows(torch, F, fa, rand, g, timer):
    """Every flash kernel at decode (T=1: B=4, offsets up to 1000; B=1 at
    offset 1000 over 1024 slots and at 8191 over 8192), at prefill (T=512,
    B=1, offsets 0 and 1024; bf16 and q8_0 also at 7680 over 8192 slots, an
    8K prompt's last chunk) and at T=16, 32 and 64 (B=1, offset 1000: the
    crossover that sets FLASH_TC_MIN_ROWS): H 32 over KVH 8, D 128, 1024
    slots a sequence (more where its keys reach past 1024), contiguous or in
    pages of 256. Above T=1 every entry point runs its tensor-core kernel,
    each row beside the CUDA-core kernel on the same inputs
    (``cuda_core_ms``, its error ``cuda_core_max_abs_err``); the B=4 decode
    rows carry the unsplit kernel's time (``unsplit_ms``)."""
    from llama_gguf_inference_tpu_torch.runtime.kv_cache import QuantKV, QuantKV4, QuantKV41
    H, KVH, D = 32, 8, 128
    rows = []

    def measure(name, label, args, lib_k, lib_v, key_bytes, off, table=None):
        """One row: args[0] is q; lib_k/lib_v the (B, KVH, S, D) bf16 view
        SDPA reads; key_bytes what the kernel's function reads per live key
        and kv head (K and V codes, scales, minimums)."""
        q = args[0]
        B, T = q.shape[:2]
        tc = T > 1
        kernel = getattr(fa, name + "_tc" if tc else name)
        plain = getattr(fa, name + "_plain")
        want = plain(*args)
        err, rel = _err(kernel(*args), want, FLASH_TOL)
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
        ms = timer(lambda: kernel(*args))
        row = {"kernel": name + "_tc" if tc else name,
               "shape": f"{label} B={B} T={T} H={H} KVH={KVH} D={D} S={Sl} offsets={offs}",
               "B": B, "max_abs_err": err, "max_rel_err": rel, "ms": ms,
               "plain_ms": timer(lambda: plain(*args), 5), "library_ms": timer(lib),
               "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms}
        if tc:
            dec = getattr(fa, name + "_decode")
            row["cuda_core_max_abs_err"] = _err(dec(*args), want, FLASH_TOL)[0]
            row["cuda_core_ms"] = timer(lambda: dec(*args))
        elif len(offs) >= 4:   # the B=4 decode row (paged: with its idle fifth)
            row["unsplit_ms"] = UNSPLIT_DECODE_MS[name]
        rows.append(row)
        emit({"phase": "kernels", **row})

    for label, B, T, offs in (("decode", 4, 1, [1000, 700, 300, 37]),
                              ("decode", 1, 1, [1000]), ("decode", 1, 1, [8191]),
                              ("prefill", 1, 512, [0]), ("prefill", 1, 512, [1024]),
                              ("prefill", 1, 512, [7680]),
                              ("crossover", 1, 16, [1000]), ("crossover", 1, 32, [1000]),
                              ("crossover", 1, 64, [1000])):
        S = max(1024, -(-(max(offs) + T) // 1024) * 1024)
        NP = S // PAGE_S
        q = rand(B, T, H, D).bfloat16()
        k = rand(B, KVH, S, D).bfloat16()
        v = rand(B, KVH, S, D).bfloat16()
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        long_chunk = offs == [7680]   # bf16 and q8_0 only
        measure(fa.NAME, label, (q, k, v, off), k, v, 2 * D * 2, off)
        for name, codec, key_bytes in ((fa.NAME_Q8, QuantKV, 2 * (D + 4)),
                                       (fa.NAME_Q4, QuantKV4, 2 * (D // 2 + 4)),
                                       (fa.NAME_Q41, QuantKV41, 2 * (D // 2 + 8)))[
                                           :1 if long_chunk else 3]:
            kc, vc = codec.quantize(k), codec.quantize(v)
            measure(name, label, (q, *kc, *vc, off), codec.dequantize(*kc),
                    codec.dequantize(*vc), key_bytes, off)
        del k, v
        if long_chunk:
            continue

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


MATMUL_WRAPPERS = ("quant_matmul_2bit", "quant_matmul_4bit", "quant_matmul_4bit_xsum",
                   "quant_matmul_4bit_split", "quant_matmul_4bit_int8",
                   "quant_matmul_4bit_base", "quant_matmul_lowbit_base", "quant_matmul_8bit")


@contextlib.contextmanager
def plain_versions():
    """Route the model through the plain PyTorch versions (on the card)."""
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    saved = {n: getattr(qm, n) for n in MATMUL_WRAPPERS}
    saved_fa = fa.flash_attention
    for n in MATMUL_WRAPPERS:
        setattr(qm, n, getattr(qm, n + "_plain"))
    fa.flash_attention = fa.flash_attention_plain
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(qm, n, fn)
        fa.flash_attention = saved_fa


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


def _compare(k_logits, p_logits, tol=LOGITS_TOL):
    """The plain run was fed the kernel run's tokens, so the logits of every
    step compare: each within ``tol`` of its scale. Returns the errors
    (prefill first) and the steps whose argmax agree."""
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(k_logits, p_logits)]
    if not max(errs) <= tol:
        raise AssertionError(f"logits rel errs {errs} exceed {tol}")
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


# prompts of three lengths: two pad to the engine's bucket of 16 rows, the
# third to 32; every bucket reaches FLASH_TC_MIN_ROWS (16)
ENGINE_PROMPTS = (PROMPT, "hello world, the quick brown fox",
                  "request 2: " + PROMPT + ", and then " + PROMPT)


def _engine_run(torch, engine, kind, steps):
    """Three greedy requests through the engine's scheduler (``step()``),
    over four slots of ``kind``'s cache with one slot idle; launches counted
    over this run only. Each request is then replayed, fed the engine's
    tokens, through a one-sequence cache of the same kind: every token the
    engine chose must lie within LOGITS_TOL (of the logits' scale) of the
    replay's largest logit. The prompts' prefill, padded to the engine's
    buckets (all from FLASH_TC_MIN_ROWS), runs the kind's tensor-core flash
    kernel, their decode steps its decode kernel."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.runtime.sampler import SamplingParams
    name = KV_KINDS[kind][2]
    want = (name, name + "_tc")
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
    _check_launches(f"{kind} engine", launches, want)
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


def _check_launches(what, launches, want, absent=()):
    """Every kernel of ``want`` launched, none of ``absent``, no plain
    version."""
    bad = [n for n in want if launches.get(n, 0) <= 0] + \
        [n for n in absent if launches.get(n, 0)] + \
        [n for n in launches if n.endswith(".plain")]
    if bad:
        raise AssertionError(f"{what}: launches {launches}")


@contextlib.contextmanager
def mm_variant(name):
    os.environ["LGT_MM_VARIANT"] = name
    try:
        yield
    finally:
        os.environ.pop("LGT_MM_VARIANT", None)


@contextlib.contextmanager
def shadowed(torch, wrapper, errs):
    """Each call of the matmul wrapper ``wrapper`` also runs its plain
    version on the same arguments, and ``errs`` gets the error of the
    kernel's output relative to the plain output's scale."""
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    real, plain = getattr(qm, wrapper), getattr(qm, wrapper + "_plain")

    def both(*args):
        y = real(*args)
        want = plain(*args)
        errs.append(((y - want).abs().max() / (want.abs().max() + 1e-12)).item())
        return y
    setattr(qm, wrapper, both)
    try:
        yield
    finally:
        setattr(qm, wrapper, real)


def _variant_forward(torch, engine, label, want, absent=(), shadow=None, tol=LOGITS_TOL,
                     prompt=PROMPT):
    """A prefill of ``prompt`` and 16 greedy steps through the kernels
    (launches counted) held against the plain versions fed the same tokens;
    with ``shadow`` (a matmul wrapper's name) the same 17 steps again, every
    call of that wrapper held to MATMUL_TOL of its plain version on the same
    inputs."""
    from llama_gguf_inference_tpu_torch.ops import _build
    ids = engine.tokenizer.encode(prompt)
    _build.reset_launches()
    t0 = time.time()
    k_logits, k_toks = _greedy_run(torch, engine, ids, 16)
    t1 = time.time()
    launches = dict(_build.LAUNCHES)
    _check_launches(label, launches, want, absent)
    out = {}
    if shadow:
        errs: list[float] = []
        with shadowed(torch, shadow, errs):
            _greedy_run(torch, engine, ids, 16, feed=k_toks)
        if not errs or max(errs) > MATMUL_TOL:
            raise AssertionError(f"{label}: {shadow} against its plain version: {errs}")
        out = {"shadow_calls": len(errs), "shadow_rel_err_max": max(errs)}
    with plain_versions():
        p_logits, _ = _greedy_run(torch, engine, ids, 16, feed=k_toks)
    _check_logits(torch, engine, k_logits)
    errs, agree = _compare(k_logits, p_logits, tol)
    return launches, {"steps_compared": len(errs), "argmax_agree": agree,
                      "logits_rel_err_prefill": errs[0], "logits_rel_err_max": max(errs),
                      "logits_tol": tol, **out, "kernel_path_s": round(t1 - t0, 3)}


def _prompt_of(engine, rows: int) -> str:
    """PROMPT repeated until it is at least ``rows`` tokens long."""
    prompt = PROMPT
    while len(engine.tokenizer.encode(prompt)) < rows:
        prompt += " " + PROMPT
    return prompt


def phase_variants(torch, engine):
    """The Q4_K_M engine under each LGT_MM_VARIANT: its Q4_K projections
    through that variant's decode kernel (never fsplit's, decode or
    tensor-core; the body's own tensor-core kernel only for a prompt of at
    least its threshold's rows: int8's prompt is PROMPT repeated to
    INT8_TC_MIN_ROWS tokens, so its prefill takes the tensor-core kernel),
    the Q6_K head through the 8-bit kernel, held against the plain versions
    over 17 steps; then three greedy requests through the server. Under
    each, then one 512-token chunk through that body's tensor-core kernel
    (int8: its logits held to INT8_LOGITS_TOL and every call shadowed by its
    plain version). Each run is one launch window."""
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    kernel = {"base": qm.NAME_4BIT_BASE, "xsum": qm.NAME_4BIT_XSUM,
              "split": qm.NAME_4BIT_SPLIT, "int8": qm.NAME_4BIT_INT8}
    chunk_kernel = {"base": qm.NAME_4BIT_BASE_TC, "int8": qm.NAME_4BIT_INT8_TC,
                    "xsum": qm.NAME_4BIT_XSUM_TC, "split": qm.NAME_4BIT_SPLIT_TC}
    tc_rows = {var: qm.INT8_TC_MIN_ROWS if var == "int8" else qm.LOWBIT_TC_MIN_ROWS
               for var in chunk_kernel}
    paths = []
    for var in VARIANTS:
        # the prompt's prefill takes the body's tensor-core kernel from its
        # threshold (the decode steps never do); the served prompts' prefill,
        # padded to the engine's 16-row bucket, may take it too (int8: must,
        # where that bucket reaches its threshold)
        prompt = _prompt_of(engine, qm.INT8_TC_MIN_ROWS) if var == "int8" else PROMPT
        n_prompt = len(engine.tokenizer.encode(prompt))
        tc = [chunk_kernel[var]] if var in chunk_kernel and n_prompt >= tc_rows[var] else []
        want = (kernel[var], qm.NAME_8BIT, *tc)
        served_want = want
        if var == "int8":
            served_rows = engine._bucket(len(engine.tokenizer.encode("request 0: the lazy dog")))
            served_want = (kernel[var], qm.NAME_8BIT,
                           *(tc if served_rows >= qm.INT8_TC_MIN_ROWS else ()))
        served_absent = (qm.NAME_4BIT, qm.NAME_4BIT_TC, qm.NAME_DEQUANT)
        absent = (*served_absent, *(k for k in chunk_kernel.values() if k not in tc))
        with mm_variant(var):
            launches, out = _variant_forward(
                torch, engine, f"variant {var}", want, absent, shadow=kernel[var],
                tol=INT8_LOGITS_TOL if var == "int8" else LOGITS_TOL, prompt=prompt)
            served: dict[str, int] = {}
            with serving(torch, engine, served) as (port, key):
                t0 = time.time()
                results = _completions(port, key, [
                    {"prompt": f"request {i}: the lazy dog", "max_tokens": 16,
                     "temperature": 0} for i in range(3)])
                wall = time.time() - t0
        _check_launches(f"variant {var} serve", served, served_want, served_absent)
        ntok = sum(r[1]["usage"]["completion_tokens"] for r in results)
        emit({"phase": "variants", "ok": True, "variant": var, "kernel": kernel[var],
              "prompt_tokens": n_prompt, **out,
              "launches": launches, "served_tokens": ntok,
              "served_tok_s": round(ntok / wall, 2), "served_launches": served})
        paths += [launches, served]
        if var in chunk_kernel:
            with mm_variant(var):
                paths.append(_prefill_chunk(
                    torch, engine, f"variant {var} chunk", chunk_kernel[var],
                    tol=INT8_LOGITS_TOL if var == "int8" else LOGITS_TOL,
                    shadow=kernel[var] if var == "int8" else None))
    return paths


def phase_serve_paged(torch, path):
    """A q8_0 paged engine from the environment: 4 slots over 4 pages of
    1024 (a contiguous slot's share is 1024). One streamed request of about
    1,500 prompt tokens and three short ones at once need 5 pages, so one
    of them waits at the head of the line until pages come back. The
    prompts' chunks run the paged q8_0 tensor-core flash kernel, the decode
    steps its CUDA-core kernel."""
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
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    name = KV_KINDS["paged_q8_0"][2]
    _check_launches("serve-paged", launches, (name, fa.NAME_PAGED_Q8_TC))
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
    same tokens (launches counted over the kernel run), then served, then
    one 512-token prefill chunk through the 2-bit tensor-core kernel."""
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
        if served.get(qm.NAME_2BIT, 0) <= 0 or any(n.endswith(".plain") for n in served):
            raise AssertionError(f"q2k serve: launches {served}")
        chunk = _prefill_chunk(torch, engine, "q2k-chunk", qm.NAME_2BIT_TC)
        base = _q2k_base(torch, engine)
    finally:
        engine.stop()
        os.environ.pop("LGT_SCALE_LAYOUT", None)
    return [launches, served, chunk, *base]


def _as_flat(w):
    """A mixed-layout QuantLinear relaid flat on the card: the same codes and
    scale, the min side expanded per sub-block in the scale's order (the
    decode's own ``_min_sub_mixed``, the f32 products ``flatten_repacked``
    forms)."""
    import dataclasses
    return dataclasses.replace(w, dmin=w._min_sub_mixed().contiguous(), mn=None,
                               min_size=0)


def _q2k_base(torch, engine):
    """``LGT_MM_VARIANT=base`` on the Q2_K engine: the mixed layout takes the
    dequantize path there (as ``matmul_xla`` in the JAX package), so two
    greedy steps show that; then its 2-bit weights are relaid flat and the
    17-step forward runs through the base body's 2-bit decode kernel against
    the plain versions, and one 512-token chunk through its tensor-core
    kernel."""
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    with mm_variant("base"):
        ids = engine.tokenizer.encode(PROMPT)
        _build.reset_launches()
        _greedy_run(torch, engine, ids, 2)
        mixed = dict(_build.LAUNCHES)
        _check_launches("q2k base, mixed", mixed, (qm.NAME_DEQUANT, qm.NAME_8BIT),
                        (qm.NAME_2BIT, qm.NAME_2BIT_TC, qm.NAME_LOWBIT_BASE))
        for layer in engine.params["layers"]:
            for n, w in layer.items():
                if getattr(w, "min_size", 0):
                    layer[n] = _as_flat(w)
        launches, out = _variant_forward(torch, engine, "q2k base, flat",
                                         (qm.NAME_LOWBIT_BASE, qm.NAME_8BIT),
                                         (qm.NAME_2BIT, qm.NAME_2BIT_TC, qm.NAME_DEQUANT,
                                          qm.NAME_LOWBIT_BASE_TC),
                                         shadow=qm.NAME_LOWBIT_BASE)
        emit({"phase": "q2k-base", "ok": True, "mixed_launches": mixed, **out,
              "launches": launches})
        chunk = _prefill_chunk(torch, engine, "q2k-base-chunk", qm.NAME_LOWBIT_BASE_TC)
    return [launches, chunk]


def phase_q5k(torch):
    """The 8B Q5_K model under the default layout (compact: u8 sc and mn per
    32): load, resident bytes, a prefill and 16 greedy steps through the
    kernels (the 8-bit one with its min term) against the plain versions fed
    the same tokens, then served."""
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    from llama_gguf_inference_tpu_torch.runtime.engine import EngineConfig, InferenceEngine
    from llama_gguf_inference_tpu_torch.tools.synth import cached_model
    t0 = time.time()
    path = cached_model("8b", seed=0, quant="q5_k")
    t1 = time.time()
    engine = InferenceEngine(path, EngineConfig(max_slots=4, ctx=1024), device="cuda")
    torch.cuda.synchronize()
    t2 = time.time()
    try:
        p = engine.params
        w = p["layers"][0]["ffn_gateup"]
        if (w.fmt, w.bits, w.sc is None, w.dmin is None) != ("q5_k", 8, False, False):
            raise AssertionError(f"gate+up loaded as {w.fmt}, {w.bits} bits")
        emit({"phase": "q5k-load", "ok": True, "synth_s": round(t1 - t0, 3),
              "load_s": round(t2 - t1, 3), "gguf_gb": os.path.getsize(path) / 1e9,
              "scale_layout": "auto (compact)",
              "resident_weights_gb": _resident_bytes(torch, p) / 1e9,
              "resident_block_weights_gb": _resident_bytes(torch, p["layers"]) / 1e9,
              "resident_head_gb": _resident_bytes(torch, p["output"]) / 1e9,
              "resident_embedding_gb": _resident_bytes(torch, p["tok_embd"]) / 1e9,
              "device_gb": torch.cuda.memory_allocated() / 1e9})
        # a prompt of three times the others' length, so that its prefill rows
        # reach TC_MIN_ROWS and run the tensor-core kernel, and the decode
        # steps the decode kernel
        want = (qm.NAME_8BIT_MIN, qm.NAME_8BIT, qm.NAME_8BIT_MIN_TC)
        prompt = " ".join([PROMPT] * 3)
        if len(engine.tokenizer.encode(prompt)) < qm.TC_MIN_ROWS:
            raise AssertionError("the q5k prompt is shorter than TC_MIN_ROWS")
        launches, out = _variant_forward(torch, engine, "q5k", want, (qm.NAME_DEQUANT,),
                                         shadow=qm.NAME_8BIT, prompt=prompt)
        emit({"phase": "q5k-forward", "ok": True, **out, "launches": launches})
        served = phase_serve(torch, engine, "q5k-serve")
        _check_launches("q5k serve", served, want)
        chunk = _prefill_chunk(torch, engine, "q5k-chunk", qm.NAME_8BIT_MIN_TC)
        long_served = _long_prompt(torch, engine, "q5k-long-prompt",
                                   (qm.NAME_8BIT_MIN_TC, qm.NAME_DEQUANT, qm.NAME_8BIT_MIN),
                                   1152.69)
    finally:
        engine.stop()
    return [launches, served, chunk, long_served]


def _words(engine, n_max):
    """A prompt of the most repeated words whose encoding has at most
    ``n_max`` tokens, and that encoding."""
    words = "the quick brown fox jumps over the lazy dog and".split()
    lo, hi = 1, 4 * n_max
    while lo < hi:                      # the most words that fit
        mid = (lo + hi + 1) // 2
        text = " ".join(words[i % len(words)] for i in range(mid))
        if len(engine.tokenizer.encode(text)) <= n_max:
            lo = mid
        else:
            hi = mid - 1
    text = " ".join(words[i % len(words)] for i in range(lo))
    return text, engine.tokenizer.encode(text)


def _prefill_chunk(torch, engine, label, tc_name, tol=LOGITS_TOL, shadow=None):
    """One 512-token prefill chunk, launches counted over it: per layer, qkv,
    o and gate_up through the tensor-core kernel ``tc_name``, and ffn_down,
    whose 512 x 14336 activations pass the JAX package's gate
    (``LGT_MM_MAX_B``, ``LGT_MM_X_VMEM``), through the dequantize path, and
    the attention through the tensor-core flash kernel; the head's one row
    through the 8-bit decode kernel; no other matmul or flash body and no
    plain version. With ``shadow`` (a matmul wrapper's name) the chunk
    runs again, every call of that wrapper held to MATMUL_TOL of its plain
    version on the same inputs. Its logits are then held to ``tol`` of the
    plain versions' fed the same tokens."""
    from llama_gguf_inference_tpu_torch.models.llama import KVCache, forward
    from llama_gguf_inference_tpu_torch.ops import _build
    from llama_gguf_inference_tpu_torch.ops import flash_attention as fa
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    dev = engine.device
    _, ids = _words(engine, 600)
    ids = ids[:512]
    if len(ids) != 512:
        raise AssertionError(f"the chunk's prompt has {len(ids)} tokens")

    def chunk():
        with torch.inference_mode():
            lg = forward(engine.params, engine.cfg, torch.tensor([ids], dtype=torch.int32,
                                                                 device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev),
                         KVCache.zeros(engine.cfg, 1, 1024, dev),
                         logits_at=torch.tensor([511], device=dev))[0, 0]
        torch.cuda.synchronize()
        return lg

    _build.reset_launches()
    t0 = time.time()
    k_logits = chunk()
    wall = time.time() - t0
    launches = dict(_build.LAUNCHES)
    layers = engine.cfg.n_layers
    matmuls = {n: c for n, c in launches.items() if n.startswith("quant_matmul")}
    flash = {n: c for n, c in launches.items() if n.startswith("flash")}
    want = {tc_name: 3 * layers, qm.NAME_DEQUANT: layers, qm.NAME_8BIT: 1}
    want_flash = {fa.NAME_TC: layers}
    if matmuls != want or flash != want_flash or any(n.endswith(".plain") for n in launches):
        raise AssertionError(f"{label} 512-token chunk: launches {launches}, want {want} "
                             f"and {want_flash}")
    out = {}
    if shadow:
        shadow_errs: list[float] = []
        with shadowed(torch, shadow, shadow_errs):
            chunk()
        if len(shadow_errs) != 3 * layers or max(shadow_errs) > MATMUL_TOL:
            raise AssertionError(f"{label}: {shadow} against its plain version: {shadow_errs}")
        out = {"shadow_calls": len(shadow_errs), "shadow_rel_err_max": max(shadow_errs)}
    with plain_versions():
        p_logits = chunk()
    _check_logits(torch, engine, [k_logits])
    errs, agree = _compare([k_logits], [p_logits], tol)
    emit({"phase": label, "ok": True, "rows": 512, "logits_rel_err": errs[0],
          "logits_tol": tol, "argmax_agree": agree, **out,
          "first_chunk_wall_s": round(wall, 4), "launches": launches})
    return launches


def _long_prompt(torch, engine, label, want, chunk_ms_before):
    """Three streamed completions of a prompt of at most 512 tokens (one
    prefill chunk) through the server, one after another: the time to the
    first token of each, beside ``chunk_ms_before``, what ``tools/profile.py``
    measured for one 512-token chunk of this model before its prefill ran a
    tensor-core kernel (PERF.md §5, NVIDIA H100 80GB HBM3, 700 W). Launches
    counted over the three; every kernel of ``want`` must run."""
    text, ids = _words(engine, 512)
    launches: dict[str, int] = {}
    ttft = []
    with serving(torch, engine, launches) as (port, key):
        for _ in range(3):
            t0 = time.time()
            t_first, _, usage, _ = _stream(port, "/v1/completions",
                                           {"prompt": text, "max_tokens": 4,
                                            "temperature": 0}, key)
            ttft.append(round(t_first - t0, 4))
            if usage["prompt_tokens"] != len(ids):
                raise AssertionError(f"long prompt: {usage['prompt_tokens']} != {len(ids)}")
    _check_launches(label, launches, want)
    emit({"phase": label, "ok": True, "prompt_tokens": len(ids), "ttft_s": ttft,
          "prefill_chunk_ms_before": chunk_ms_before, "launches": launches})
    return launches


def phase_q4k_prefill(torch, engine):
    """The Q4_K_M engine's 512-token chunk through the 4-bit tensor-core
    kernel, and the served time to the first token of a 512-token prompt
    (beside the 521.71 ms that ``tools/profile.py`` measured for one chunk
    of this model when its prefill ran the decode kernel, PERF.md §5)."""
    from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
    chunk = _prefill_chunk(torch, engine, "q4k-chunk", qm.NAME_4BIT_TC)
    served = _long_prompt(torch, engine, "q4k-long-prompt",
                          (qm.NAME_4BIT_TC, qm.NAME_DEQUANT, qm.NAME_4BIT), 521.71)
    return [chunk, served]


_FA_CU = "llama_gguf_inference_tpu_torch/csrc/flash_attention.cu"
_FA_TC_CU = "llama_gguf_inference_tpu_torch/csrc/flash_attention_tc.cu"
_FA_JAX = "llama_gguf_inference_tpu/ops/flash_attention.py"
_QM_CU = "llama_gguf_inference_tpu_torch/csrc/quant_matmul.cu"
_QM_TC_CU = "llama_gguf_inference_tpu_torch/csrc/quant_matmul_tc.cu"
_QM_LTC_CU = "llama_gguf_inference_tpu_torch/csrc/quant_matmul_lowbit_tc.cu"
_QM_ITC_CU = "llama_gguf_inference_tpu_torch/csrc/quant_matmul_int8_tc.cu"
_QM_JAX = "llama_gguf_inference_tpu/ops/pallas_matmul.py"
SOURCES = {
    # name: (source, TPU kernel it replaces); pallas_call sites are
    # pallas_matmul.py:641 (qsplit, fsplit, xsum, split), :247 (_make_kernel's
    # branches), :698 (int8) and flash_attention.py:176, :289 (q8/q4/q4_1),
    # :369 (paged) and :452 (paged q8_0)
    "quant_matmul_2bit": (_QM_CU, _QM_JAX + ":481"),
    "quant_matmul_4bit": (_QM_CU, _QM_JAX + ":421"),
    # the same two bodies at prefill rows, on tensor cores
    "quant_matmul_2bit_tc": (_QM_LTC_CU, _QM_JAX + ":481"),
    "quant_matmul_4bit_tc": (_QM_LTC_CU, _QM_JAX + ":421"),
    "quant_matmul_4bit_xsum": (_QM_CU, _QM_JAX + ":309"),
    "quant_matmul_4bit_split": (_QM_CU, _QM_JAX + ":362"),
    "quant_matmul_4bit_int8": (_QM_CU, _QM_JAX + ":536"),
    "quant_matmul_4bit_base": (_QM_CU, _QM_JAX + ":157"),      # _make_kernel, bf16-magic branch
    "quant_matmul_lowbit_base": (_QM_CU, _QM_JAX + ":172"),    # _make_kernel, f32 low-bit branch
    # the same five at prefill rows, on tensor cores (split through the xsum
    # rule's instances)
    "quant_matmul_4bit_xsum_tc": (_QM_LTC_CU, _QM_JAX + ":309"),
    "quant_matmul_4bit_split_tc": (_QM_LTC_CU, _QM_JAX + ":362"),
    "quant_matmul_4bit_int8_tc": (_QM_ITC_CU, _QM_JAX + ":536"),
    "quant_matmul_4bit_base_tc": (_QM_LTC_CU, _QM_JAX + ":157"),
    "quant_matmul_lowbit_base_tc": (_QM_LTC_CU, _QM_JAX + ":172"),
    "quant_matmul_8bit": (_QM_CU, _QM_JAX + ":123"),           # _make_kernel, 8-bit branch
    "quant_matmul_8bit_min": (_QM_CU, _QM_JAX + ":185"),       # the same, with its min term
    # the same with its min term, prefill rows, tensor cores (the instance
    # without a min side runs on no main path here: no model of the smoke
    # has such a weight at prefill; its rows are in the kernels phase)
    "quant_matmul_8bit_min_tc": (_QM_TC_CU, _QM_JAX + ":185"),
    "flash_attention": (_FA_CU, _FA_JAX + ":129"),
    "flash_attention_q8": (_FA_CU, _FA_JAX + ":189"),
    "flash_attention_q4": (_FA_CU, _FA_JAX + ":189"),
    "flash_attention_q41": (_FA_CU, _FA_JAX + ":189"),
    "flash_attention_paged": (_FA_CU, _FA_JAX + ":302"),
    "flash_attention_paged_q8": (_FA_CU, _FA_JAX + ":383"),
    # the same six at prefill, on tensor cores
    "flash_attention_tc": (_FA_TC_CU, _FA_JAX + ":129"),
    "flash_attention_q8_tc": (_FA_TC_CU, _FA_JAX + ":189"),
    "flash_attention_q4_tc": (_FA_TC_CU, _FA_JAX + ":189"),
    "flash_attention_q41_tc": (_FA_TC_CU, _FA_JAX + ":189"),
    "flash_attention_paged_tc": (_FA_TC_CU, _FA_JAX + ":302"),
    "flash_attention_paged_q8_tc": (_FA_TC_CU, _FA_JAX + ":383"),
}
# the kernels line reports each kernel at its decode shape (4 slots; the
# paged ones with their idle fifth, B=5; the 2-bit one in the layout the q2k
# phase serves), the tensor-core matmuls at a 512-row prefill chunk's
# gate_up, the tensor-core flash kernels at a 512-token chunk at offset 0
LINE_SHAPE = {"quant_matmul_2bit": "mixed gate_up 28672x4096 B=4",
              "quant_matmul_4bit": "gate_up 28672x4096 B=4",
              "quant_matmul_2bit_tc": "q2_k mixed tc gate_up 28672x4096 B=512",
              "quant_matmul_4bit_tc": "q4_k flat tc gate_up 28672x4096 B=512",
              **{f"quant_matmul_4bit_{v}": f"q4_k flat {v} gate_up 28672x4096 B=4"
                 for v in VARIANTS},
              "quant_matmul_lowbit_base": "q2_k flat base gate_up 28672x4096 B=4",
              **{f"quant_matmul_4bit_{v}_tc": f"q4_k flat {v} tc gate_up 28672x4096 B=512"
                 for v in ("xsum", "split")},
              "quant_matmul_4bit_int8_tc": "q4_k flat int8 tc gate_up 28672x4096 B=512",
              "quant_matmul_4bit_base_tc": "q4_k flat base tc gate_up 28672x4096 B=512",
              "quant_matmul_lowbit_base_tc": "q2_k flat base tc gate_up 28672x4096 B=512",
              "quant_matmul_8bit": "head 128256x4096 B=4",
              "quant_matmul_8bit_min": "q5_k compact 8bit gate_up 28672x4096 B=4",
              "quant_matmul_8bit_min_tc": "q5_k compact 8bit gate_up 28672x4096 B=512",
              **{name: "prefill" if name.endswith("_tc") else
                 "decode B=5" if "paged" in name else "decode B=4"
                 for name in SOURCES if name.startswith("flash")}}


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
        reports = phase_build()
        phase = "plans"
        phase_plans(torch, reports)
        phase = "kernels"
        with torch.inference_mode():
            rows = phase_kernels(torch, Timer(torch))
        torch.cuda.empty_cache()
        phase = "load"
        engine, path = phase_engine(torch)
        phase = "forward"
        bf16_prefill = phase_forward(torch, engine)
        phase = "q4k-prefill"
        paths = phase_q4k_prefill(torch, engine)
        torch.cuda.empty_cache()
        phase = "kv-forward"
        paths.append(phase_kv_forward(torch, engine, bf16_prefill))
        torch.cuda.empty_cache()
        phase = "serve"
        paths.append(phase_serve(torch, engine))
        phase = "variants"
        paths += phase_variants(torch, engine)
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
        gc.collect()
        torch.cuda.empty_cache()
        phase = "q5k"
        paths += phase_q5k(torch)
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
