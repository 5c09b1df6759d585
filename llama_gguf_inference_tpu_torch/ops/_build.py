"""Build the CUDA kernels under ``csrc/`` with nvcc and bind them by ctypes.

Each source compiles to its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). The first use of any kernel
builds every source at once, one ``nvcc`` process per source, all started
together. Libraries land in ``_build/`` beside the package, named by a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one is reused. A failed build raises; nothing falls back to the plain
PyTorch versions.

Every kernel wrapper counts its launches in :data:`LAUNCHES` (and each plain
version under ``"<name>.plain"``), so a caller can show which path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("quant_matmul", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

LAUNCHES: dict[str, int] = {}


def count(name: str) -> None:
    """Add one launch of ``name`` to :data:`LAUNCHES`."""
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, name + ".cu"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every missing library in parallel; returns name -> ptxas
    report (empty for a library that was already built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, os.path.join(_CSRC, name + ".cu"), "-o", tmp]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {name: "" for name in SOURCES}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate(timeout=600)
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all()
            _LIBS[name] = _bind(name, ctypes.CDLL(path))
        return _LIBS[name]


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "quant_matmul":
        # pointers: x, xsum, codes, d, sc, dmin, mn, y; then B, in, out,
        # nsub, nd, ndm, the code bias, the two sides' storage and the stream
        for fn in ("lgt_quant_matmul_2bit", "lgt_quant_matmul_4bit"):
            getattr(lib, fn).argtypes = [p] * 8 + [i] * 9 + [p]
            getattr(lib, fn).restype = i
        lib.lgt_quant_matmul_8bit.argtypes = [p, p, p, p, p,
                                              i, i, i, i, i, i, p]
        lib.lgt_quant_matmul_8bit.restype = i
    elif name == "flash_attention":
        # pointers: q, the cache tensors, offsets (and the page table), out;
        # then B, T, H, KVH, S (or NP, page_s), D, the scale and the stream
        contig = [i, i, i, i, i, i, f, p]
        paged = [i, i, i, i, i, i, i, f, p]
        for fn, n_ptr, ints in (("lgt_flash_attention", 5, contig),
                                ("lgt_flash_attention_q8", 7, contig),
                                ("lgt_flash_attention_q4", 7, contig),
                                ("lgt_flash_attention_q41", 9, contig),
                                ("lgt_flash_attention_paged", 6, paged),
                                ("lgt_flash_attention_paged_q8", 8, paged)):
            getattr(lib, fn).argtypes = [p] * n_ptr + ints
            getattr(lib, fn).restype = i
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")
