"""How the decode flash kernel's split length moves its time, on one card.

    python -m llama_gguf_inference_tpu_torch.tools.flash_split [--splits 128,256,512] [--seed 0]

Builds ``csrc/flash_attention.cu`` with each split length (its ``kChunk``,
keys a block) into the build directory, holds each build to the plain
version, and times every decode entry point through its own wrapper (the
wrapper's ``FLASH_SPLIT_KEYS`` set to the build's length) at the smoke's
decode shapes: H 32 over KVH 8, D 128, T 1; B 4 at offsets 1000/700/300/37
over 1024 slots, B 1 at offset 1000 over 1024 and at 8191 over 8192; the
paged kinds beside an idle slot, in shuffled pages of 256. CUDA events, the
L2 flushed before each launch, the median of 20. Prints the card's name and
power limit first, then one JSON line per (shape, kind): each length's ms
and max relative error.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from ..ops import _build
from ..ops import flash_attention as fa
from ..runtime.kv_cache import QuantKV, QuantKV4, QuantKV41
from .tc_ablate import _timer

KINDS = ("bf16", "q8", "q4", "q41", "paged", "paged_q8")
SHAPES = (("B=4 S=1024", [1000, 700, 300, 37], 1024), ("B=1 S=1024", [1000], 1024),
          ("B=1 S=8192", [8191], 8192))
H, KVH, D, PAGE_S = 32, 8, 128, 256
_CHUNK = "constexpr int kChunk = 256;"


def _builds(splits: list[int]) -> dict[int, ctypes.CDLL]:
    """One library a split length, compiled in parallel."""
    with open(os.path.join(_build._CSRC, "flash_attention.cu")) as f:
        src = f.read()
    if src.count(_CHUNK) != 1:
        raise RuntimeError(f"flash_attention.cu no longer holds {_CHUNK!r} once")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for n in splits:
        cu = os.path.join(_build.BUILD_DIR, f"flash_split_{n}.cu")
        with open(cu, "w") as f:
            f.write(src.replace(_CHUNK, f"constexpr int kChunk = {n};"))
        procs[n] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build._CSRC, cu,
                                     "-o", cu[:-3] + ".so"], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for split {n}:\n{log}")
        path = os.path.join(_build.BUILD_DIR, f"flash_split_{n}.so")
        libs[n] = _build._bind("flash_attention", ctypes.CDLL(path))
    return libs


def _args(kind: str, offs: list[int], S: int, g: torch.Generator) -> list:
    """The decode wrapper's inputs of ``kind`` at these offsets."""
    paged = kind.startswith("paged")
    B = len(offs) + paged
    q = torch.randn(B, 1, H, D, generator=g, device="cuda").bfloat16()
    if paged:
        NP = S // PAGE_S
        table = torch.randperm(B * NP, generator=g, device="cuda").int().reshape(B, NP)
        for b, o in enumerate(offs):
            table[b, -(-(o + 1) // PAGE_S):] = -1
        table[-1] = -1
        rows = (B * NP, KVH, PAGE_S)
        off = torch.tensor(offs + [0], dtype=torch.int32, device="cuda")
    else:
        rows = (B, KVH, S)
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    k = torch.randn(*rows, D, generator=g, device="cuda").bfloat16()
    v = torch.randn(*rows, D, generator=g, device="cuda").bfloat16()
    codec = {"q8": QuantKV, "paged_q8": QuantKV, "q4": QuantKV4, "q41": QuantKV41}.get(kind)
    kv = [k, v] if codec is None else [*codec.quantize(k), *codec.quantize(v)]
    return [q, *kv, off] + ([table] if paged else [])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", default="128,256,512",
                    help="comma-separated split lengths (keys a block) to build and time")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    splits = [int(n) for n in a.splits.split(",")]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = _builds(splits)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(a.seed)
    saved_split, saved_lib = fa.FLASH_SPLIT_KEYS, _build._LIBS.get("flash_attention")
    try:
        with torch.inference_mode():
            for label, offs, S in SHAPES:
                for kind in KINDS:
                    args = _args(kind, offs, S, g)
                    name = fa.NAME if kind == "bf16" else f"flash_attention_{kind}"
                    kernel, plain = getattr(fa, name + "_decode"), getattr(fa, name + "_plain")
                    want = plain(*args).float()
                    row = {"shape": label, "kind": kind}
                    for n, lib in libs.items():
                        fa.FLASH_SPLIT_KEYS, _build._LIBS["flash_attention"] = n, lib
                        err = (kernel(*args).float() - want).abs().max() / want.abs().max()
                        row[f"split_{n}_ms"] = _timer(flush, lambda: kernel(*args))
                        row[f"split_{n}_max_rel_err"] = err.item()
                    print(json.dumps(row), flush=True)
    finally:
        fa.FLASH_SPLIT_KEYS = saved_split
        if saved_lib is None:
            _build._LIBS.pop("flash_attention", None)
        else:
            _build._LIBS["flash_attention"] = saved_lib


if __name__ == "__main__":
    main()
