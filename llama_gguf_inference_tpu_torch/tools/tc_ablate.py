"""Where the tensor-core 8-bit kernel's time goes, on one card.

    python -m llama_gguf_inference_tpu_torch.tools.tc_ablate [--seed 0]

Builds ``csrc/quant_matmul_tc.cu`` three ways into the build directory: as
it is, without its decode stage (each step's weight tile left as an earlier
step wrote it), and without its products (``ldmatrix`` and ``mma.sync``).
Times each, and the decode kernel and ``torch.matmul`` on a bf16 copy, at
the 8B's Q5_K compact projections (codes and scales drawn from ``--seed``)
for 16, 64 and 512 activation rows: CUDA events, the L2 flushed before each
launch, the median of 20. Prints the card's name and power limit first, then
one JSON line per shape. The two cut builds compute wrong outputs and are
only timed; the full build is held to the plain version first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess

import torch

from ..ops import _build
from ..ops import quant_matmul as qm

SHAPES = {"qkv": (6144, 4096), "o": (4096, 4096), "gate_up": (28672, 4096),
          "down": (4096, 14336)}
ROWS = (16, 64, 512)
# the source text each cut build replaces
CUTS = {"no_decode": ("      decode_run<kM, kPer>(", "      if (false) decode_run<kM, kPer>("),
        "no_products": ("    if (i >= 0 && warp_live) {", "    if (false) {")}


def _builds() -> dict[str, ctypes.CDLL]:
    with open(os.path.join(_build._CSRC, "quant_matmul_tc.cu")) as f:
        src = f.read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, (old, new) in CUTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer holds {old!r} once")
        cu = os.path.join(_build.BUILD_DIR, f"tc_ablate_{name}.cu")
        with open(cu, "w") as f:
            f.write(src.replace(old, new))
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, cu, "-o",
                                        cu[:-3] + ".so"], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {"full": _build.library("quant_matmul_tc")}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        path = os.path.join(_build.BUILD_DIR, f"tc_ablate_{name}.so")
        libs[name] = _build._bind("quant_matmul_tc", ctypes.CDLL(path))
    return libs


def _timer(flush: torch.Tensor, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _q5k(out_f: int, in_f: int, g: torch.Generator):
    """Random Q5_K compact arrays: 5-bit codes, f32 d and dmin per 256, u8
    sc and mn per 32."""
    def u8(n):
        return torch.randint(0, 16, (out_f, n), generator=g, device="cuda").to(torch.uint8)

    def f32(n, scale):
        return torch.rand(out_f, n, generator=g, device="cuda") * scale + scale / 10
    codes = torch.randint(0, 32, (out_f, in_f), generator=g, device="cuda").to(torch.int8)
    nsub, nd = in_f // 32, in_f // 256
    return codes, f32(nd, 1e-3), u8(nsub), f32(nd, 5e-3), u8(nsub)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _builds()
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(a.seed)
    for name, (out_f, in_f) in SHAPES.items():
        codes, d, sc, dmin, mn = _q5k(out_f, in_f, g)
        nsub = in_f // 32
        w_lib = (codes.float() * qm._sub_side(d, sc, nsub).repeat(1, 32)
                 - qm._sub_side(dmin, mn, nsub).repeat(1, 32)).bfloat16()
        for B in ROWS:
            x = torch.randn(B, in_f, generator=g, device="cuda").bfloat16()
            args = (x, codes, d, sc, 32, 0, dmin, mn)
            row = {"shape": f"q5_k compact {name} {out_f}x{in_f}", "B": B}
            for build, lib in libs.items():
                _build._LIBS["quant_matmul_tc"] = lib
                if build == "full":
                    want = qm.quant_matmul_8bit_plain(*args)
                    err = (qm.quant_matmul_8bit_tc(*args) - want).abs().max() / want.abs().max()
                    row["rel_err"] = err.item()
                row[f"{build}_ms"] = _timer(flush, lambda: qm.quant_matmul_8bit_tc(*args))
            _build._LIBS["quant_matmul_tc"] = libs["full"]
            row["decode_kernel_ms"] = _timer(flush, lambda: qm.quant_matmul_8bit_decode(*args),
                                             5 if B > 64 else 20)
            row["torch_matmul_ms"] = _timer(flush, lambda: torch.matmul(x, w_lib.t()))
            row["bound_ms"] = max(2.0 * B * in_f * out_f / 989e12,
                                  (codes.numel() + 2 * sc.numel() + 8 * d.numel()
                                   + B * in_f * 2 + B * out_f * 4) / 3.35e12) * 1e3
            print(json.dumps(row), flush=True)
        del codes, d, sc, dmin, mn, w_lib


if __name__ == "__main__":
    main()
