"""Codebook grids + sign tables for the GGML importance-matrix (IQ) formats.

The IQ wire formats (IQ2_XXS/XS/S, IQ3_XXS/S, IQ1_S/M) quantize groups of
elements to entries of a small trained codebook ("grid") plus per-group sign
bits and per-sub-block scales.  Everything about the formats is fixed public ABI and implemented
exactly here (block layouts, scale packing, sign encoding) — EXCEPT the grid
tables themselves, which are trained k-means/E8-lattice codebooks shipped as
static data inside llama.cpp's ``ggml-quants.c``.  They are data, not
algorithm, and cannot be derived.

This module resolves grids in priority order:

1. ``LGT_IQ_GRID_FILE`` — path to an ``.npz`` with arrays named
   ``iq2xxs/iq2xs/iq2s/iq3xxs/iq3s/iq1s`` holding the REAL llama.cpp tables
   (int8, shape (entries, group)).  ``scripts/dev/extract_iq_grids.py``
   produces this file from any llama.cpp checkout in one command.  With it,
   decoding is bit-identical to llama.cpp for real-world GGUF files.
2. A deterministic synthesized codebook with the correct entry count, group
   size and value alphabet.  Self-consistent: files produced by this repo's
   encoder decode exactly, all structural/round-trip tests hold, and
   end-to-end serving of IQ-quantized models works — but a file quantized by
   llama.cpp itself would dequantize to wrong values.  ``grids_are_synthetic``
   tells callers.

A copy of the JAX package's ``quant/iq_grids.py``: the same resolution order
and the same stand-ins, so both packages decode a file to the same values.

Sign tables ARE formulaic and exact: ``ksigns`` entry ``i`` carries sign bits
``i`` for elements 0..6 and odd-parity(i) for element 7 (the codebook of all
even-parity 8-bit sign masks, indexed by the low 7 bits).
"""

from __future__ import annotations

import os

import numpy as np

# (entries, elements-per-entry, value alphabet) per grid.  The alphabets are
# the dequant-ABI byte values stored in llama.cpp's static tables:
# IQ2 magnitudes {8, 25, 43, 59} (2-bit code c -> byte ~ 17c+8), IQ3
# magnitudes {4, 12, 20, 28, 36, 44, 52, 62} (3-bit code), IQ1 trits
# {-1, 0, 1}.
GRID_SPECS: dict[str, tuple[int, int, tuple[int, ...]]] = {
    "iq2xxs": (256, 8, (8, 25, 43, 59)),
    "iq2xs": (512, 8, (8, 25, 43, 59)),
    "iq2s": (1024, 8, (8, 25, 43, 59)),
    "iq3xxs": (256, 4, (4, 12, 20, 28, 36, 44, 52, 62)),
    "iq3s": (512, 4, (4, 12, 20, 28, 36, 44, 52, 62)),
    "iq1s": (2048, 8, (-1, 0, 1)),
}

IQ1S_DELTA = 0.125
IQ1M_DELTA = 0.0625

_cache: dict[str, np.ndarray] = {}
_loaded_file: str | None = None
_synthetic: set[str] = set()


def ksigns() -> np.ndarray:
    """The 128-entry sign codebook (uint8): all even-parity 8-bit masks.

    Entry ``i``: bits 0..6 = ``i``; bit 7 = popcount(i) & 1, so every entry
    has an even number of set bits.  Matches llama.cpp's ``ksigns_iq2xs``.
    """
    i = np.arange(128, dtype=np.uint8)
    parity = i.copy()
    parity ^= parity >> 4
    parity ^= parity >> 2
    parity ^= parity >> 1
    return (i | ((parity & 1) << 7)).astype(np.uint8)


KSIGNS = ksigns()


def _synthesize(name: str) -> np.ndarray:
    """Deterministic stand-in codebook: unique random code vectors over the
    format's alphabet (seeded per format name; stable across processes)."""
    entries, group, alphabet = GRID_SPECS[name]
    rng = np.random.default_rng(sum(ord(c) for c in name))
    seen: set[bytes] = set()
    rows: list[np.ndarray] = []
    alph = np.asarray(alphabet, dtype=np.int16)
    while len(rows) < entries:
        cand = alph[rng.integers(0, len(alph), size=group)]
        key = cand.tobytes()
        if key in seen:
            continue
        seen.add(key)
        rows.append(cand)
    return np.stack(rows).astype(np.int8)


def _load_file(path: str) -> None:
    global _loaded_file
    with np.load(path) as z:
        for name, (entries, group, _alph) in GRID_SPECS.items():
            if name not in z.files:
                continue
            arr = np.asarray(z[name], dtype=np.int8)
            if arr.shape != (entries, group):
                raise ValueError(
                    f"grid {name!r} in {path} has shape {arr.shape}, "
                    f"expected {(entries, group)}")
            _cache[name] = arr
    _loaded_file = path


def get_grid(name: str) -> np.ndarray:
    """Grid table for ``name`` -> int8 (entries, group).  See module doc."""
    if name not in GRID_SPECS:
        raise KeyError(f"unknown IQ grid {name!r}")
    if name not in _cache:
        path = os.environ.get("LGT_IQ_GRID_FILE", "")
        if path and _loaded_file != path:
            _load_file(path)
        if name not in _cache:
            _cache[name] = _synthesize(name)
            _synthetic.add(name)
    return _cache[name]


def grids_are_synthetic() -> bool:
    """True if any grid served so far was a synthesized stand-in."""
    return bool(_synthetic)


def grid_index_map(name: str) -> dict[bytes, int]:
    """code-vector bytes -> entry index, for the encoders."""
    g = get_grid(name)
    return {g[k].tobytes(): k for k in range(g.shape[0])}


def nearest_entries(name: str, vals: np.ndarray) -> np.ndarray:
    """Nearest grid entry (L2) for each row of ``vals`` (N, group) -> (N,).

    Vectorized via the |g|^2 - 2 g.x expansion in chunks; used by the
    encoders (llama.cpp's quantizers search the same codebooks).
    """
    g = get_grid(name).astype(np.float32)          # (E, group)
    g_sq = (g * g).sum(axis=1)                     # (E,)
    out = np.empty(vals.shape[0], dtype=np.int64)
    step = 1 << 16
    for i in range(0, vals.shape[0], step):
        chunk = vals[i:i + step].astype(np.float32)
        scores = chunk @ g.T * -2.0 + g_sq[None, :]
        out[i:i + step] = np.argmin(scores, axis=1)
    return out
