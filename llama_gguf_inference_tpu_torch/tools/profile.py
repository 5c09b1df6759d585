"""Where the time goes in the engine on one card.

    python -m llama_gguf_inference_tpu_torch.tools.profile [--shape 8b] [--seed 0] [--quant q2_k|q5_k]
        [--offsets 0,1024] [--kv-dtype bf16|q8_0|q4_0|q4_1]

Loads the synthesized model of the shape (``tools.synth``: Q4_K_M, Q2_K
with ``--quant q2_k`` or Q5_K with ``--quant q5_k``; written under the temp
dir on first use) into an engine with 4 slots of 1024 tokens (more where an
offset needs them) over a contiguous cache of ``--kv-dtype``, and prints the
card's name and power limit (``nvidia-smi``), the scale layout
(``LGT_SCALE_LAYOUT``, read by the repack at load) and the matmul variant
(``LGT_MM_VARIANT``, read per call), then one JSON line per measurement:

1. the engine's decode rate for one greedy request of 64 tokens, without
   the HTTP server in front;
2. a decode step over all 4 slots at 512 live tokens each (forward, argmax,
   read back to the host, as the engine's decode does) and one 512-token
   prefill chunk at each of ``--offsets`` (default 0: a prompt's first
   chunk; 1024: its third, whose queries see 1024 cached keys more): wall
   ms per step without the profiler, then, under
   ``torch.profiler``, device ms per step by kernel (the port's matmul and
   attention kernels and all other PyTorch kernels) and the device's idle
   share. The breakdown names each matmul kernel that ran (2-bit, 4-bit
   fsplit/xsum/split/base/int8, the base body's f32 branch, 8-bit with and
   without the min term, decode and tensor-core kernels, the 2- and 4-bit
   tensor-core kernels of the fsplit, base and base_f32 rules, the int8
   body's tensor-core kernel, the xsum rule's, which the split body runs
   too) and each flash kernel (the CUDA-core split kernel, its merge in
   the same launch, and the tensor-core one, every cache kind's instances
   under one name each); the dequantize path's cuBLAS product and its
   elementwise decode are among the other kernels.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import torch

from ..ops import flash_attention as fa
from ..ops import quant_matmul as qm
from ..quant.repack import scale_layout
from .synth import QUANTS, SHAPES, cached_model

# the CUDA kernels' names, told apart by their template arguments: the 2/4-bit
# template by (bits, element rule), the 8-bit one by its min side
LOWBIT = {(2, 0): qm.NAME_2BIT, (4, 0): qm.NAME_4BIT, (4, 1): qm.NAME_4BIT_XSUM,
          (4, 2): qm.NAME_4BIT_SPLIT, (4, 3): qm.NAME_4BIT_BASE,
          (2, 4): qm.NAME_LOWBIT_BASE, (4, 4): qm.NAME_LOWBIT_BASE}
# the 2/4-bit tensor-core template by (bits, element rule)
# (the xsum rule's instances, 1, serve the split body too: named by the variant)
LOWBIT_TC = {(2, 0): qm.NAME_2BIT_TC, (4, 0): qm.NAME_4BIT_TC, (4, 1): qm.NAME_4BIT_XSUM_TC,
             (4, 3): qm.NAME_4BIT_BASE_TC, (2, 4): qm.NAME_LOWBIT_BASE_TC,
             (4, 4): qm.NAME_LOWBIT_BASE_TC}
KERNELS = (*dict.fromkeys(LOWBIT.values()), *dict.fromkeys(LOWBIT_TC.values()),
           qm.NAME_4BIT_SPLIT_TC, qm.NAME_4BIT_INT8, qm.NAME_4BIT_INT8_TC, qm.NAME_8BIT,
           qm.NAME_8BIT_MIN, qm.NAME_8BIT_TC, qm.NAME_8BIT_MIN_TC, fa.NAME, fa.NAME_TC)
LIVE = 512


def _kernel_group(name: str) -> str:
    m = re.search(r"quant_matmul_lowbit_tc_kernel<(\d+), (\d+)", name)
    if m:
        group = LOWBIT_TC[int(m[1]), int(m[2])]
        return qm.NAME_4BIT_SPLIT_TC if group == qm.NAME_4BIT_XSUM_TC and \
            qm.variant() == "split" else group
    m = re.search(r"quant_matmul_lowbit_(?:kernel|generic)<(\d+), (\d+)", name)
    if m:
        return LOWBIT[int(m[1]), int(m[2])]
    m = re.search(r"quant_matmul_8bit_kernel<\d+, (\d+)", name)
    if m:
        return qm.NAME_8BIT if m[1] == "0" else qm.NAME_8BIT_MIN
    m = re.search(r"quant_matmul_8bit_tc_kernel<\d+, (\d+)", name)
    if m:
        return qm.NAME_8BIT_TC if m[1] == "0" else qm.NAME_8BIT_MIN_TC
    if "quant_matmul_int8_tc_kernel" in name:
        return qm.NAME_4BIT_INT8_TC
    if "quant_matmul_int8_kernel" in name:
        return qm.NAME_4BIT_INT8
    if "flash_attention_tc_kernel" in name:     # prefill, every cache kind
        return fa.NAME_TC
    if "flash_attention_kernel" in name:        # decode (the split kernel and its merge)
        return fa.NAME
    return "other"


def profile(engine, steps: int = 8, offsets=(0,)) -> list[dict]:
    """The measurements above, for an engine on the card; one prefill chunk
    at each of ``offsets``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from ..models.llama import forward
    from ..runtime.sampler import SamplingParams
    dev, B = engine.device, engine.ecfg.max_slots
    rows = []

    def decode():
        forward(engine.params, engine.cfg, torch.zeros((B, 1), dtype=torch.int32, device=dev),
                torch.full((B,), LIVE, dtype=torch.int32, device=dev),
                engine.cache)[:, 0].argmax(-1).tolist()

    def prefill(offset):
        forward(engine.params, engine.cfg, torch.ones((1, LIVE), dtype=torch.int32, device=dev),
                torch.full((1,), offset, dtype=torch.int32, device=dev), engine.cache.slot(0),
                logits_at=torch.tensor([LIVE - 1], device=dev))[:, 0].argmax(-1).tolist()

    engine.start()
    try:
        stamps = [time.perf_counter() for _ in engine.generate(
            "hello world, the quick brown fox", SamplingParams(temperature=0.0, max_tokens=64))]
    finally:
        engine.stop()
    rows.append({"step": "engine decode, 1 request, no server", "tokens": len(stamps),
                 "ms_per_token": (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)})

    runs = [(f"decode B={B}, {LIVE} live tokens each", decode, steps)]
    for off in offsets:
        runs.append((f"prefill B=1, T={LIVE}" + (f", offset {off}" if off else ""),
                     lambda off=off: prefill(off), max(1, steps // 4)))
    for label, fn, n in runs:
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
            with torch.profiler.profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
        by_group = {k: 0.0 for k in (*KERNELS, "other")}
        other = []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            ms = ev.self_device_time_total / 1e3 / n
            group = _kernel_group(ev.key)
            by_group[group] += ms
            if group == "other":
                other.append((ms, ev.key[:80], ev.count // n))
        busy = sum(by_group.values())
        rows.append({"step": label, "wall_ms": wall,
                     "device_busy_ms": busy if busy else "not measured",
                     "device_idle_share": 1.0 - busy / wall if busy else "not measured",
                     "device_ms_by_kernel": by_group,
                     "top_other_kernels": [{"name": k, "ms": ms, "launches": c}
                                           for ms, k, c in sorted(other, reverse=True)[:6]]})
    return rows


def main() -> None:
    from ..runtime.engine import EngineConfig, InferenceEngine
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="8b", choices=sorted(SHAPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", default="q4_k", choices=QUANTS)
    ap.add_argument("--offsets", default="0",
                    help="comma-separated cache offsets of the prefill chunks profiled")
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "q8_0", "q4_0", "q4_1"))
    a = ap.parse_args()
    offsets = tuple(int(o) for o in a.offsets.split(","))
    ctx = max(1024, -(-(max(offsets) + LIVE) // 1024) * 1024)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps({"shape": a.shape, "quant": a.quant, "scale_layout": scale_layout(),
                      "mm_variant": qm.variant(), "kv_dtype": a.kv_dtype}), flush=True)
    engine = InferenceEngine(cached_model(a.shape, a.seed, quant=a.quant),
                             EngineConfig(max_slots=4, ctx=ctx, kv_dtype=a.kv_dtype),
                             device="cuda")
    for row in profile(engine, offsets=offsets):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
