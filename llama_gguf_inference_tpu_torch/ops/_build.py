"""Build the CUDA kernels under ``csrc/`` with nvcc and bind them by ctypes.

Each source compiles to its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds); the ``*.cuh`` headers
beside them are shared, and hashed into every library's name. The first use of any kernel
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
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("quant_matmul", "quant_matmul_tc", "quant_matmul_lowbit_tc", "quant_matmul_int8_tc",
           "flash_attention", "flash_attention_tc")
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [name + ".cu", *sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))]:
        with open(os.path.join(_CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _nvcc_cmd(name: str, out: str) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-I", _CSRC, os.path.join(_CSRC, name + ".cu"), "-o", out]


def ptxas_report(name: str) -> str:
    """ptxas's report of ``csrc/<name>.cu``, compiled again into a
    temporary file under :data:`BUILD_DIR` (a library already built keeps no
    report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        proc = subprocess.run(_nvcc_cmd(name, os.path.join(d, name + ".so")),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{name}.cu:\n{proc.stdout}")
    return proc.stdout


def build_all() -> dict[str, str]:
    """Compile every missing library in parallel; returns name -> ptxas
    report (empty for a library that was already built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(_nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
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
        # lowbit: pointers x, xsum, codes, d, sc, dmin, mn, y; then B, in,
        # out, nsub, nd, ndm, the code bias, the two sides' storage, the
        # bits, the element rule, the code map and the stream. int8: xq, xs,
        # xsum, codes, d, sc, dmin, mn, y; B, in, out, nsub, nd, bias, the
        # sides, the stream. 8-bit: x, codes, d, sc, dmin, mn, y; B, in, out,
        # nd, nsub, bias, the sides, the stream. The 8-bit and int8
        # launches' plans: B, in, out, nsub, the sides, an int[7] (int8:
        # int[8]) to fill; the lowbit one's: B, in, out, nsub, the sides,
        # the bits, the element rule, the code map, an int[8].
        for fn, n_ptr, n_int in (("lgt_quant_matmul_lowbit", 8, 12),
                                 ("lgt_quant_matmul_int8", 9, 8),
                                 ("lgt_quant_matmul_8bit", 7, 8)):
            getattr(lib, fn).argtypes = [p] * n_ptr + [i] * n_int + [p]
            getattr(lib, fn).restype = i
        for fn in ("lgt_quant_matmul_8bit_plan", "lgt_quant_matmul_int8_plan"):
            getattr(lib, fn).argtypes = [i] * 6 + [p]
            getattr(lib, fn).restype = i
        lib.lgt_quant_matmul_lowbit_plan.argtypes = [i] * 9 + [p]
        lib.lgt_quant_matmul_lowbit_plan.restype = i
    elif name == "quant_matmul_tc":
        # the 8-bit entry point's arguments: x, codes, d, sc, dmin, mn, y;
        # B, in, out, nd, nsub, bias, the sides, the stream
        lib.lgt_quant_matmul_8bit_tc.argtypes = [p] * 7 + [i] * 8 + [p]
        lib.lgt_quant_matmul_8bit_tc.restype = i
        # its launch plan: B, in, out, nsub, the sides, an int[9] to fill
        lib.lgt_quant_matmul_8bit_tc_plan.argtypes = [i] * 6 + [p]
        lib.lgt_quant_matmul_8bit_tc_plan.restype = i
    elif name == "quant_matmul_lowbit_tc":
        # the lowbit entry point's arguments without the bits: x, xsum, codes,
        # d, sc, dmin, mn, y; B, in, out, nsub, nd, ndm, bias, the sides, the
        # element rule, the code map; the stream
        for fn in ("lgt_quant_matmul_4bit_tc", "lgt_quant_matmul_2bit_tc"):
            getattr(lib, fn).argtypes = [p] * 8 + [i] * 11 + [p]
            getattr(lib, fn).restype = i
        # its launch plan: B, in, out, nsub, the sides, the bits, the rule,
        # the code map, an int[9] to fill
        lib.lgt_quant_matmul_lowbit_tc_plan.argtypes = [i] * 9 + [p]
        lib.lgt_quant_matmul_lowbit_tc_plan.restype = i
    elif name == "quant_matmul_int8_tc":
        # xq (sub-block-major), xs and xsum interleaved, codes, d, sc, dmin,
        # mn, y; B, in, out, nsub, nd, bias, the sides; the stream
        lib.lgt_quant_matmul_int8_tc.argtypes = [p] * 8 + [i] * 8 + [p]
        lib.lgt_quant_matmul_int8_tc.restype = i
        # its launch plan: B, in, out, nsub, the sides, an int[9] to fill
        lib.lgt_quant_matmul_int8_tc_plan.argtypes = [i] * 6 + [p]
        lib.lgt_quant_matmul_int8_tc_plan.restype = i
    elif name in ("flash_attention", "flash_attention_tc"):
        # pointers: q, the cache tensors, offsets (and the page table), out
        # (the decode kernel then its partials' scratch and arrival counters);
        # then B, T, H, KVH, S (or NP, page_s), D (the decode kernel then its
        # split length), the scale and the stream
        dec = int(name == "flash_attention")
        contig = [i] * (6 + dec) + [f, p]
        paged = [i] * (7 + dec) + [f, p]
        for fn, n_ptr, ints in (("lgt_flash_attention", 5, contig),
                                ("lgt_flash_attention_q8", 7, contig),
                                ("lgt_flash_attention_q4", 7, contig),
                                ("lgt_flash_attention_q41", 9, contig),
                                ("lgt_flash_attention_paged", 6, paged),
                                ("lgt_flash_attention_paged_q8", 8, paged)):
            fn += "" if dec else "_tc"
            getattr(lib, fn).argtypes = [p] * (n_ptr + 2 * dec) + ints
            getattr(lib, fn).restype = i
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")
