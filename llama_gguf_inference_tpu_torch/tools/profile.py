"""Where the time goes in the engine on one card.

    python -m llama_gguf_inference_tpu_torch.tools.profile [--shape 8b] [--seed 0] [--quant q2_k]

Loads the synthesized model of the shape (``tools.synth``: Q4_K_M, or Q2_K
with ``--quant q2_k``; written under the temp dir on first use) into an
engine with 4 slots of 1024 tokens, and prints the card's name and power
limit (``nvidia-smi``) and the scale layout (``LGT_SCALE_LAYOUT``, read by
the repack at load), then one JSON line per measurement:

1. the engine's decode rate for one greedy request of 64 tokens, without
   the HTTP server in front;
2. a decode step over all 4 slots at 512 live tokens each (forward, argmax,
   read back to the host, as the engine's decode does) and one 512-token
   prefill chunk: wall ms per step without the profiler, then, under
   ``torch.profiler``, device ms per step by kernel (the port's matmul and
   attention kernels and all other PyTorch kernels) and the device's idle
   share.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..ops import flash_attention as fa
from ..ops import quant_matmul as qm
from ..quant.repack import scale_layout
from .synth import QUANTS, SHAPES, cached_model

# matched against the CUDA kernels' names by substring: the 2- and 4-bit
# kernels share one template, told apart by its first argument
KERNELS = {qm.NAME_2BIT: "quant_matmul_lowbit_kernel<2",
           qm.NAME_4BIT: "quant_matmul_lowbit_kernel<4",
           qm.NAME_8BIT: "quant_matmul_8bit", fa.NAME: "flash_attention"}
LIVE = 512


def _kernel_group(name: str) -> str:
    return next((k for k, pat in KERNELS.items() if pat in name), "other")


def profile(engine, steps: int = 8) -> list[dict]:
    """The measurements above, for an engine on the card."""
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

    def prefill():
        forward(engine.params, engine.cfg, torch.ones((1, LIVE), dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), engine.cache.slot(0),
                logits_at=torch.tensor([LIVE - 1], device=dev))[:, 0].argmax(-1).tolist()

    engine.start()
    try:
        stamps = [time.perf_counter() for _ in engine.generate(
            "hello world, the quick brown fox", SamplingParams(temperature=0.0, max_tokens=64))]
    finally:
        engine.stop()
    rows.append({"step": "engine decode, 1 request, no server", "tokens": len(stamps),
                 "ms_per_token": (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)})

    for label, fn, n in ((f"decode B={B}, {LIVE} live tokens each", decode, steps),
                         (f"prefill B=1, T={LIVE}", prefill, max(1, steps // 4))):
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
    a = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps({"shape": a.shape, "quant": a.quant, "scale_layout": scale_layout()}),
          flush=True)
    engine = InferenceEngine(cached_model(a.shape, a.seed, quant=a.quant),
                             EngineConfig(max_slots=4, ctx=1024), device="cuda")
    for row in profile(engine):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
