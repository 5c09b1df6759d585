"""Native (C++) repack of the hot formats, with a numpy fallback that shows.

``repack.cpp`` (a copy of the JAX package's) is compiled with the machine's
``g++`` on first use into ``LGT_NATIVE_BUILD_DIR`` (default ``_build/``
beside the package), named by a hash of the source and the flags, and bound
by ctypes. :func:`native_repack` returns None when the format has no native
path (only Q8_0, Q4_K and Q6_K have one) or the library is unavailable;
``quant.repack.repack`` then runs its numpy path. A library that cannot be
built prints one line naming the failure, and :data:`REPACKS` counts every
repack the library did, so a caller can tell which path ran.
``LGT_NO_NATIVE`` set to anything turns the library off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "repack.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False

FORMATS = ("q8_0", "q4_k", "q6_k")
REPACKS: dict[str, int] = {}


def count(fmt: str) -> None:
    """Add one native repack of ``fmt`` to :data:`REPACKS`."""
    REPACKS[fmt] = REPACKS.get(fmt, 0) + 1


def reset_repacks() -> None:
    REPACKS.clear()


def _build_dir() -> str:
    d = os.environ.get("LGT_NATIVE_BUILD_DIR",
                       os.path.join(os.path.dirname(_HERE), "_build"))
    os.makedirs(d, exist_ok=True)
    return d


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_build_dir(), f"librepack-{h.hexdigest()[:16]}.so")


def load_library() -> ctypes.CDLL | None:
    """Build (once) and load the native library; None when it cannot be
    built or loaded (one line says why) or ``LGT_NO_NATIVE`` is set."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        if os.environ.get("LGT_NO_NATIVE"):
            print("[native] LGT_NO_NATIVE is set: repacking with numpy", flush=True)
            _LIB_FAILED = True
            return None
        try:
            so_path = _lib_path()
            if not os.path.exists(so_path):
                tmp = f"{so_path}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                               capture_output=True, timeout=300)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(so_path)
        except (OSError, subprocess.SubprocessError) as e:   # no toolchain etc.
            # one line: the exception and the compiler's first error
            err = [ln.strip() for ln in (getattr(e, "stderr", b"") or b"")
                   .decode(errors="replace").splitlines() if "error" in ln]
            print(f"[native] repack library unavailable ({e}"
                  f"{': ' + err[0] if err else ''}); repacking with numpy", flush=True)
            _LIB_FAILED = True
            return None
        i64, u8p, i8p, f32p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                               ctypes.POINTER(ctypes.c_int8),
                               ctypes.POINTER(ctypes.c_float))
        lib.repack_q8_0.argtypes = [u8p, i64, i64, i8p, f32p, ctypes.c_int]
        lib.repack_q4_k.argtypes = [u8p, i64, i64, u8p, f32p, u8p, f32p, u8p,
                                    ctypes.c_int, ctypes.c_int]
        lib.repack_q6_k.argtypes = [u8p, i64, i64, i8p, f32p, i8p,
                                    ctypes.c_int, ctypes.c_int]
        _LIB = lib
        return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_repack(raw: np.ndarray, fmt: str, out_f: int, in_f: int,
                  n_threads: int | None = None):
    """A ``quant.repack.RepackedWeight``, or None (the numpy path then runs).

    Hierarchical formats come out compact, as the numpy path emits them:
    Q4_K's codes in the block-minor order of (sub 32, d_size 256) and its
    ``sc``/``mn`` in (s, σ) order."""
    if fmt not in FORMATS:
        return None
    lib = load_library()
    if lib is None:
        return None
    if n_threads is None:   # the cores this process may run on
        n_threads = max(1, len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
                        else os.cpu_count() or 1)
    nbytes = _wire_bytes(fmt, out_f, in_f)
    if raw.dtype != np.uint8 or raw.ndim != 1 or raw.size < nbytes:
        return None                  # not wire bytes, or short: the numpy path raises
    raw = np.ascontiguousarray(raw[:nbytes])

    from ..quant.repack import RepackedWeight

    if fmt == "q8_0":
        codes = np.empty((out_f, in_f), np.int8)
        d = np.empty((out_f, in_f // 32), np.float32)
        lib.repack_q8_0(_ptr(raw, ctypes.c_uint8), out_f, in_f,
                        _ptr(codes, ctypes.c_int8), _ptr(d, ctypes.c_float), n_threads)
        rp = RepackedWeight(codes=codes, d=d, sc=None, dmin=None, mn=None,
                            fmt="q8_0", bits=8, sub_size=32, d_size=32,
                            code_bias=0, out_features=out_f, in_features=in_f)
    elif fmt == "q4_k":
        nd = in_f // 256
        codes = np.empty((out_f, in_f // 2), np.uint8)
        d = np.empty((out_f, nd), np.float32)
        dmin = np.empty((out_f, nd), np.float32)
        sc = np.empty((out_f, nd * 8), np.uint8)
        mn = np.empty((out_f, nd * 8), np.uint8)
        lib.repack_q4_k(_ptr(raw, ctypes.c_uint8), out_f, in_f,
                        _ptr(codes, ctypes.c_uint8), _ptr(d, ctypes.c_float),
                        _ptr(sc, ctypes.c_uint8), _ptr(dmin, ctypes.c_float),
                        _ptr(mn, ctypes.c_uint8), n_threads, 1)
        rp = RepackedWeight(codes=codes, d=d, sc=sc, dmin=dmin, mn=mn,
                            fmt="q4_k", bits=4, sub_size=32, d_size=256,
                            code_bias=0, out_features=out_f, in_features=in_f)
    else:
        nd = in_f // 256
        codes = np.empty((out_f, in_f), np.int8)
        d = np.empty((out_f, nd), np.float32)
        sc = np.empty((out_f, nd * 16), np.int8)
        lib.repack_q6_k(_ptr(raw, ctypes.c_uint8), out_f, in_f,
                        _ptr(codes, ctypes.c_int8), _ptr(d, ctypes.c_float),
                        _ptr(sc, ctypes.c_int8), n_threads, 1)
        rp = RepackedWeight(codes=codes, d=d, sc=sc, dmin=None, mn=None,
                            fmt="q6_k", bits=8, sub_size=16, d_size=256,
                            code_bias=0, out_features=out_f, in_features=in_f)
    count(fmt)
    return rp


def _wire_bytes(fmt: str, out_f: int, in_f: int) -> int:
    per = {"q8_0": (32, 34), "q4_k": (256, 144), "q6_k": (256, 210)}[fmt]
    return out_f * (in_f // per[0]) * per[1]
