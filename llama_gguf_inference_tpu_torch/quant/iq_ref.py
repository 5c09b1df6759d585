"""Golden numpy codecs for the GGML importance-matrix (IQ) block formats.

Wire layouts (public GGML ABI, QK_K = 256 elements per super-block; byte
counts in gguf.constants.GGML_BLOCK_INFO):

- IQ2_XXS: [d f16][qs u16 x32] — per 32 elements, 4 u16: the first pair packs
  four 8-bit grid indices (one per 8-element group), the second pair packs
  four 7-bit sign-codebook indices plus a 4-bit sub-scale in the top bits;
  value = d*(0.5+scale)*0.25 * grid[idx][j] * sign_j.
- IQ2_XS: [d f16][qs u16 x32][scales u8 x8] — per group one u16 = 9-bit grid
  index | 7-bit sign index; two 4-bit sub-scales per 32 (one per 16).
- IQ2_S: [d f16][qs u8 x32 idx-lo + u8 x32 sign bytes][qh u8 x8][scales u8 x8]
  — 10-bit grid indices (high pair per group in qh), explicit sign bytes.
- IQ3_XXS: [d f16][qs u8 x64 grid idx][sas u32 x8] — 4-element grid entries;
  per 32 elements one u32 = four 7-bit sign indices + 4-bit scale (×0.5).
- IQ3_S: [d f16][qs u8 x64 idx-lo][qh u8 x8][signs u8 x32][scales u8 x4] —
  9-bit indices, explicit signs, 4-bit scale per 32 with value d*(1+2s).
- IQ1_S: [d f16][qs u8 x32 idx-lo][qh u16 x8] — 11-bit indices into the
  2048-entry ternary grid; per 32: 3-bit scale + delta sign in qh;
  value = d*(2s+1) * (grid ± 0.125).
- IQ1_M: [qs u8 x32][qh u8 x16][scales u8 x8] — d is an f16 hidden in the
  top nibbles of the scale words; per-16 3-bit scales; per-8 delta sign in
  the qh nibbles; value = d*(2s+1) * (grid ± 0.0625).

Grid *tables* come from quant.iq_grids (real llama.cpp tables when
LGT_IQ_GRID_FILE is set, synthesized stand-ins otherwise — see that module's
docstring).  Everything structural here is exact.

The encoders are spec-conformant quantizers (not llama.cpp's importance-
weighted optimizers): per-sub-block scale fit + nearest-codebook-entry
search.  Round-trips decode exactly; used by the GGUF writer for synthesis
and tests.

A copy of the JAX package's ``quant/iq_ref.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType
from .iq_grids import IQ1M_DELTA, IQ1S_DELTA, KSIGNS, get_grid, nearest_entries

__all__ = ["IQ_DEQUANT", "IQ_QUANT", "IQ_PLANES"]


def _f16(b: np.ndarray) -> np.ndarray:
    return b.view("<f2").astype(np.float32)


def _to_f16_bytes(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype("<f2")).view(np.uint8)


def _sign_pm1(sbytes: np.ndarray) -> np.ndarray:
    """uint8 sign bytes (...,) -> (..., 8) float32 of ±1 (bit set = negative)."""
    j = np.arange(8, dtype=np.uint8)
    return np.where((sbytes[..., None] >> j) & 1, -1.0, 1.0).astype(np.float32)


_L4 = np.arange(4)


# --------------------------------------------------------------------- decode
#
# Each format decodes via "planes": signed int8 element values (grid entry ×
# sign), a per-sub-block f32 scale, and (IQ1 only) a per-sub-block f32 min
# term.  The golden dequant is then uniformly
#
#     y = codes * repeat(s, sub) - repeat(m, sub)
#
# and quant.repack hands the SAME planes to QuantLinear, whose decode rule is
# identical — repack bit-exactness holds by construction (CLAUDE.md
# invariant: repacked dequant == numpy_ref.dequantize bit-for-bit).

def _planes_iq2_xxs(blocks: np.ndarray):
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2])                                     # (nb, 1)
    q16 = blocks[:, 2:66].copy().view("<u2").reshape(nb, 8, 4).astype(np.uint32)
    a0 = q16[..., 0] | (q16[..., 1] << 16)                       # (nb, 8)
    a1 = q16[..., 2] | (q16[..., 3] << 16)
    idx = (a0[..., None] >> (8 * _L4)) & 0xFF                    # (nb, 8, 4)
    sidx = (a1[..., None] >> (7 * _L4)) & 127
    s = d * (0.5 + (a1 >> 28).astype(np.float32)) * 0.25         # (nb, 8)
    grid = get_grid("iq2xxs").astype(np.float32)
    codes = (grid[idx] * _sign_pm1(KSIGNS[sidx])).astype(np.int8)
    return codes.reshape(nb, 256), s, None, 32


def _planes_iq2_xs(blocks: np.ndarray):
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2])
    q16 = blocks[:, 2:66].copy().view("<u2").reshape(nb, 8, 4)
    sc = blocks[:, 66:74]                                        # (nb, 8)
    idx = (q16 & 511).astype(np.int64)
    sidx = q16 >> 9
    s16 = np.stack([sc & 0xF, sc >> 4], axis=-1)                 # (nb, 8, 2)
    s = d[..., None] * (0.5 + s16.astype(np.float32)) * 0.25     # (nb, 8, 2)
    grid = get_grid("iq2xs").astype(np.float32)
    codes = (grid[idx] * _sign_pm1(KSIGNS[sidx])).astype(np.int8)
    return codes.reshape(nb, 256), s.reshape(nb, 16), None, 16


def _planes_iq2_s(blocks: np.ndarray):
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2])
    qlo = blocks[:, 2:34].reshape(nb, 8, 4).astype(np.int64)
    sbytes = blocks[:, 34:66].reshape(nb, 8, 4)
    qh = blocks[:, 66:74].astype(np.int64)                       # (nb, 8)
    sc = blocks[:, 74:82]
    idx = qlo | ((qh[..., None] << (8 - 2 * _L4)) & 0x300)
    s16 = np.stack([sc & 0xF, sc >> 4], axis=-1)
    s = d[..., None] * (0.5 + s16.astype(np.float32)) * 0.25
    grid = get_grid("iq2s").astype(np.float32)
    codes = (grid[idx] * _sign_pm1(sbytes)).astype(np.int8)
    return codes.reshape(nb, 256), s.reshape(nb, 16), None, 16


def _planes_iq3_xxs(blocks: np.ndarray):
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2])
    qi = blocks[:, 2:66].reshape(nb, 8, 8).astype(np.int64)      # 8 groups of 4
    aux = blocks[:, 66:98].copy().view("<u4")                    # (nb, 8)
    s = d * (0.5 + (aux >> 28).astype(np.float32)) * 0.5         # (nb, 8)
    sidx = (aux[..., None] >> (7 * _L4)) & 127                   # (nb, 8, 4)
    signs = _sign_pm1(KSIGNS[sidx])                              # (nb, 8, 4, 8)
    grid = get_grid("iq3xxs").astype(np.float32)                 # (256, 4)
    g1 = grid[qi[..., 0::2]]                                     # (nb, 8, 4, 4)
    g2 = grid[qi[..., 1::2]]
    codes = (np.concatenate([g1, g2], axis=-1) * signs).astype(np.int8)
    return codes.reshape(nb, 256), s, None, 32


def _planes_iq3_s(blocks: np.ndarray):
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2])
    qlo = blocks[:, 2:66].reshape(nb, 8, 8).astype(np.int64)
    qh = blocks[:, 66:74].astype(np.int64)                       # (nb, 8)
    sbytes = blocks[:, 74:106].reshape(nb, 8, 4)
    sc4 = blocks[:, 106:110]
    m8 = np.arange(8)
    idx = qlo | (((qh[..., None] >> m8) & 1) << 8)               # (nb, 8, 8)
    s_ib = (sc4[:, m8 // 2] >> (4 * (m8 % 2))) & 0xF             # (nb, 8)
    s = d * (1.0 + 2.0 * s_ib.astype(np.float32))                # (nb, 8)
    grid = get_grid("iq3s").astype(np.float32)                   # (512, 4)
    codes = (grid[idx].reshape(nb, 8, 32)
             * _sign_pm1(sbytes).reshape(nb, 8, 32)).astype(np.int8)
    return codes.reshape(nb, 256), s, None, 32


def _planes_iq1_s(blocks: np.ndarray):
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2])
    qs = blocks[:, 2:34].reshape(nb, 8, 4).astype(np.int64)
    qh = blocks[:, 34:50].copy().view("<u2").astype(np.int64)    # (nb, 8)
    s = d * (2.0 * ((qh >> 12) & 7).astype(np.float32) + 1.0)    # (nb, 8)
    delta = np.where(qh & 0x8000, -IQ1S_DELTA, IQ1S_DELTA).astype(np.float32)
    idx = qs | (((qh[..., None] >> (3 * _L4)) & 7) << 8)         # (nb, 8, 4)
    grid = get_grid("iq1s")                                      # int8 trits
    codes = grid[idx]                                            # (nb, 8, 4, 8)
    m = -(s * delta)                                             # (nb, 8)
    return codes.reshape(nb, 256), s, m, 32


def _planes_iq1_m(blocks: np.ndarray):
    nb = blocks.shape[0]
    qs = blocks[:, 0:32].reshape(nb, 8, 4).astype(np.int64)
    qh = blocks[:, 32:48].reshape(nb, 8, 2)
    sc = blocks[:, 48:56]
    sc16 = sc.copy().view("<u2").astype(np.uint16)               # (nb, 4)
    du16 = ((sc16[:, 0] >> 12) | ((sc16[:, 1] >> 8) & 0x00F0)
            | ((sc16[:, 2] >> 4) & 0x0F00) | (sc16[:, 3] & 0xF000))
    d = np.ascontiguousarray(du16.astype("<u2")).view("<f2").astype(np.float32)
    nib = np.stack([qh[..., 0] & 0xF, qh[..., 0] >> 4,
                    qh[..., 1] & 0xF, qh[..., 1] >> 4], axis=-1)  # (nb, 8, 4)
    idx = qs | ((nib.astype(np.int64) & 7) << 8)
    delta = np.where(nib & 8, -IQ1M_DELTA, IQ1M_DELTA).astype(np.float32)
    m8 = np.arange(8)
    # per u16 word: four 3-bit half-scales at bit offsets 0/3/6/9, d nibble
    # at 12-15 (assembled above)
    scw = sc16[:, m8 // 2]                                       # (nb, 8)
    base = 6 * (m8 % 2)
    s1 = (scw >> base) & 7                                       # elems 0..15
    s2 = (scw >> (base + 3)) & 7                                 # elems 16..31
    sl = np.stack([s1, s1, s2, s2], axis=-1).astype(np.float32)  # (nb, 8, 4)
    s = d[:, None, None] * (2.0 * sl + 1.0)                      # (nb, 8, 4) per 8
    grid = get_grid("iq1s")
    codes = grid[idx]
    m = -(s * delta)                                             # (nb, 8, 4)
    return codes.reshape(nb, 256), s.reshape(nb, 32), m.reshape(nb, 32), 8


IQ_PLANES = {
    GGMLType.IQ2_XXS: _planes_iq2_xxs,
    GGMLType.IQ2_XS: _planes_iq2_xs,
    GGMLType.IQ2_S: _planes_iq2_s,
    GGMLType.IQ3_XXS: _planes_iq3_xxs,
    GGMLType.IQ3_S: _planes_iq3_s,
    GGMLType.IQ1_S: _planes_iq1_s,
    GGMLType.IQ1_M: _planes_iq1_m,
}


# ------------------------------------------------------- native-width packing
#
# The int8 element planes above stream at ~8 bpw on device — 3x the nominal
# width of a 2.5-bpw format.  The packed forms below store
# each element as a small CODE instead:
#
# - IQ2/IQ3: 4-bit code = sign bit (bit 3) | magnitude index.  The dequant
#   alphabets are fixed ABI ({8, 25, 43, 59} and {4, 12, .., 52, 62} — see
#   GRID_SPECS), so the value map is pure arithmetic (ops.linear.code_values):
#       iq2: |v| = 17c + 8 + (c == 2)        c in [0, 4)
#       iq3: |v| = 8c + 4 + 2*(c == 7)       c in [0, 8)
# - IQ1: 2-bit trit code c in {0, 1, 2}, value c - 1 (plain code_bias=1).
#
# Scales keep the wire hierarchy at wire density: per-super-block f32 d' and
# per-sub-block u8/i8 multipliers chosen so the kernels' single f32 product
# d' * sc reproduces the reference scale BIT-EXACTLY — every d' differs from
# the wire d by a power of two only, so fl(d'*(2s+1)) == fl(d*(0.5+s)*2^k):
#       iq2_*:   s = d*(0.5+s4)*0.25  ==  (d/8)  * (2*s4+1)
#       iq3_xxs: s = d*(0.5+s4)*0.5   ==  (d/4)  * (2*s4+1)
#       iq3_s:   s = d*(1+2*s4)       ==   d     * (2*s4+1)
#       iq1_*:   s = d*(2*s3+1); m = -(s*delta)  ==  (d*delta) * (-sign*(2*s3+1))
#
# Each function returns (values (nb, 256) int8 — the decoded elements,
# for the int8-codes fast layout — codes (nb, 256) uint8 packed-code
# logical order, d (nb, nd'), sc (nb, nsub'), dmin | None, mn | None,
# sub) for quant.repack.rw.

_IQ2_CODE_OF = {-59: 0, -43: 3, -25: 4, -8: 6, 8: 9, 25: 11, 43: 12, 59: 15}
# Signed-alphabet code assignment solving 2v == 17*(c & 14) - 2*(c & 1) - 118
# EXACTLY for all 16 values — 7 integer ops in ops.linear.code_values versus
# the 12 of a sign|magnitude map (the doubling folds into the stored
# d as an exact power of two: repack stores d/16 instead of d/8).


def _codes4_from_values(vals: np.ndarray, fmt: str) -> np.ndarray:
    """int8 element values -> 4-bit codes, verified exact.

    iq2: the arithmetic-affine signed assignment above (c chosen so the
    kernels' decode is shift/add only).  iq3: sign|mag (bit 3 = sign)."""
    v = vals.astype(np.int32)
    if fmt == "iq2":
        lut = np.full(256, -1, np.int32)
        for val, code in _IQ2_CODE_OF.items():
            lut[val + 128] = code
        c = lut[v + 128]
        if (c < 0).any():
            raise ValueError("iq2 value outside the fixed signed alphabet")
        back = (17 * (c & 14) - 2 * (c & 1) - 118)
        if not np.array_equal(back, 2 * v):
            raise ValueError("iq2 fast-map round-trip failed")
        return c.astype(np.uint8)
    a = np.abs(v)
    c = (a - 4) // 8
    back = 8 * c + 4 + ((((c + 1) >> 3) & 1) << 1)
    if not np.array_equal(back, a):
        raise ValueError(f"{fmt} grid magnitude outside the fixed alphabet")
    return (c | ((v < 0) << 3)).astype(np.uint8)


def _packed_iq2_xxs(blocks: np.ndarray, with_packed: bool = True):
    nb = blocks.shape[0]
    codes, _s, _m, sub = _planes_iq2_xxs(blocks)
    d = _f16(blocks[:, 0:2])                                     # (nb, 1)
    q16 = blocks[:, 2:66].copy().view("<u2").reshape(nb, 8, 4).astype(np.uint32)
    a1 = q16[..., 2] | (q16[..., 3] << 16)
    s4 = (a1 >> 28).astype(np.uint8)                             # (nb, 8)
    return (codes,
            _codes4_from_values(codes, "iq2") if with_packed else None, d * 0.125,
            (2 * s4 + 1).astype(np.uint8), None, None, sub)


def _packed_iq2_xs(blocks: np.ndarray, with_packed: bool = True):
    nb = blocks.shape[0]
    codes, _s, _m, sub = _planes_iq2_xs(blocks)
    d = _f16(blocks[:, 0:2])
    sc = blocks[:, 66:74]
    s4 = np.stack([sc & 0xF, sc >> 4], axis=-1).reshape(nb, 16)
    return (codes,
            _codes4_from_values(codes, "iq2") if with_packed else None, d * 0.125,
            (2 * s4 + 1).astype(np.uint8), None, None, sub)


def _packed_iq2_s(blocks: np.ndarray, with_packed: bool = True):
    nb = blocks.shape[0]
    codes, _s, _m, sub = _planes_iq2_s(blocks)
    d = _f16(blocks[:, 0:2])
    sc = blocks[:, 74:82]
    s4 = np.stack([sc & 0xF, sc >> 4], axis=-1).reshape(nb, 16)
    return (codes,
            _codes4_from_values(codes, "iq2") if with_packed else None, d * 0.125,
            (2 * s4 + 1).astype(np.uint8), None, None, sub)


def _packed_iq3_xxs(blocks: np.ndarray, with_packed: bool = True):
    codes, _s, _m, sub = _planes_iq3_xxs(blocks)
    d = _f16(blocks[:, 0:2])
    aux = blocks[:, 66:98].copy().view("<u4")
    s4 = (aux >> 28).astype(np.uint8)                            # (nb, 8)
    return (codes,
            _codes4_from_values(codes, "iq3") if with_packed else None, d * 0.25,
            (2 * s4 + 1).astype(np.uint8), None, None, sub)


def _packed_iq3_s(blocks: np.ndarray, with_packed: bool = True):
    codes, _s, _m, sub = _planes_iq3_s(blocks)
    d = _f16(blocks[:, 0:2])
    sc4 = blocks[:, 106:110]
    m8 = np.arange(8)
    s4 = (sc4[:, m8 // 2] >> (4 * (m8 % 2))) & 0xF               # (nb, 8)
    return (codes,
            _codes4_from_values(codes, "iq3") if with_packed else None, d,
            (2 * s4 + 1).astype(np.uint8), None, None, sub)


def _packed_iq1_s(blocks: np.ndarray, with_packed: bool = True):
    codes, _s, _m, sub = _planes_iq1_s(blocks)
    d = _f16(blocks[:, 0:2])
    qh = blocks[:, 34:50].copy().view("<u2").astype(np.int64)    # (nb, 8)
    s3 = ((qh >> 12) & 7).astype(np.int32)
    odd = (2 * s3 + 1).astype(np.uint8)
    # m = -(s*delta): delta sign in qh bit 15 -> mn = -sign * (2s+1)
    mn = np.where(qh & 0x8000, odd.astype(np.int32),
                  -odd.astype(np.int32)).astype(np.int8)
    return (codes, (codes.astype(np.int32) + 1).astype(np.uint8), d,
            odd, d * IQ1S_DELTA, mn, sub)   # iq1 packed codes are trivial


def _packed_iq1_m(blocks: np.ndarray, with_packed: bool = True):
    nb = blocks.shape[0]
    codes, _s, _m, sub = _planes_iq1_m(blocks)
    qh = blocks[:, 32:48].reshape(nb, 8, 2)
    sc16 = blocks[:, 48:56].copy().view("<u2").astype(np.uint16)
    du16 = ((sc16[:, 0] >> 12) | ((sc16[:, 1] >> 8) & 0x00F0)
            | ((sc16[:, 2] >> 4) & 0x0F00) | (sc16[:, 3] & 0xF000))
    d = np.ascontiguousarray(du16.astype("<u2")).view("<f2").astype(
        np.float32)[:, None]                                     # (nb, 1)
    m8 = np.arange(8)
    scw = sc16[:, m8 // 2]
    base = 6 * (m8 % 2)
    s1 = (scw >> base) & 7
    s2 = (scw >> (base + 3)) & 7
    sl = np.stack([s1, s1, s2, s2], axis=-1).astype(np.int32)    # (nb, 8, 4)
    odd = (2 * sl + 1).reshape(nb, 32)
    nib = np.stack([qh[..., 0] & 0xF, qh[..., 0] >> 4,
                    qh[..., 1] & 0xF, qh[..., 1] >> 4], axis=-1)  # (nb, 8, 4)
    neg_delta = (nib & 8).astype(bool).reshape(nb, 32)
    mn = np.where(neg_delta, odd, -odd).astype(np.int8)
    return (codes, (codes.astype(np.int32) + 1).astype(np.uint8), d,
            odd.astype(np.uint8), d * IQ1M_DELTA, mn, sub)


IQ_PACKED = {
    GGMLType.IQ2_XXS: _packed_iq2_xxs,
    GGMLType.IQ2_XS: _packed_iq2_xs,
    GGMLType.IQ2_S: _packed_iq2_s,
    GGMLType.IQ3_XXS: _packed_iq3_xxs,
    GGMLType.IQ3_S: _packed_iq3_s,
    GGMLType.IQ1_S: _packed_iq1_s,
    GGMLType.IQ1_M: _packed_iq1_m,
}


def _dequant_from_planes(planes_fn):
    def deq(blocks: np.ndarray) -> np.ndarray:
        codes, s, m, sub = planes_fn(blocks)
        y = codes.astype(np.float32) * np.repeat(s, sub, axis=1)
        if m is not None:
            y = y - np.repeat(m, sub, axis=1)
        return y
    return deq


# --------------------------------------------------------------------- encode

def _fix_parity_signs(x8: np.ndarray) -> np.ndarray:
    """Per 8-element row: sign bits (bit set = negative) projected onto the
    even-parity codebook by flipping the sign of the smallest-|x| element
    when parity is odd.  Returns uint8 sign bytes; index into KSIGNS is the
    low 7 bits."""
    neg = (x8 < 0)
    parity = neg.sum(axis=-1) & 1                                # (...,)
    flip_at = np.abs(x8).argmin(axis=-1)
    flip_mask = (np.arange(8) == flip_at[..., None]) & parity[..., None].astype(bool)
    neg = neg ^ flip_mask
    return (neg << np.arange(8)).sum(axis=-1).astype(np.uint8)


def _fit_scales(amax_u: np.ndarray, vmax: float, f: float, smax: int):
    """Two-level scale fit: per-unit 4(or 3)-bit scale s and global f16 d so
    that d*f*(0.5+s) ≈ amax_u/vmax.  Returns (d (nb,1) f32-of-f16, s, db)."""
    ideal = amax_u / vmax                                        # (nb, U)
    d = ideal.max(axis=-1, keepdims=True) / ((0.5 + smax) * f)
    d = d.astype("<f2").astype(np.float32)                       # round-trip f16
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(d > 0, np.round(ideal / np.where(d == 0, 1.0, d) / f - 0.5),
                     0.0)
    s = np.clip(s, 0, smax).astype(np.uint32)
    db = d * f * (0.5 + s)
    return d, s, db


def _grid_match(name: str, mags: np.ndarray, db: np.ndarray) -> np.ndarray:
    """Nearest grid entries for |x| groups (..., G) given per-group scale db
    broadcastable over the leading dims.  Returns int64 indices (...)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        scaled = np.where(db[..., None] > 0, mags / np.where(
            db[..., None] == 0, 1.0, db[..., None]), 0.0)
    flat = scaled.reshape(-1, scaled.shape[-1])
    return nearest_entries(name, flat).reshape(scaled.shape[:-1])


def _quant_iq2_xxs(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    g8 = xb.reshape(nb, 8, 4, 8)                                 # ib32, group, 8
    sbytes = _fix_parity_signs(g8)                               # (nb, 8, 4)
    sidx = (sbytes & 127).astype(np.uint32)
    amax = np.abs(g8).reshape(nb, 8, 32).max(axis=-1)            # per ib32
    d, s, db = _fit_scales(amax, 59.0, 0.25, 15)                 # db (nb, 8)
    idx = _grid_match("iq2xxs", np.abs(g8), db[..., None]).astype(np.uint32)
    a0 = (idx << (8 * _L4)).sum(axis=-1, dtype=np.uint64).astype(np.uint32)
    a1 = ((sidx << (7 * _L4)).sum(axis=-1, dtype=np.uint64).astype(np.uint32)
          | (s << 28))
    out = np.zeros((nb, 66), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    q16 = np.empty((nb, 8, 4), dtype="<u2")
    q16[..., 0] = a0 & 0xFFFF
    q16[..., 1] = a0 >> 16
    q16[..., 2] = a1 & 0xFFFF
    q16[..., 3] = a1 >> 16
    out[:, 2:66] = q16.reshape(nb, -1).view(np.uint8)
    return out


def _quant_iq2_xs(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    g8 = xb.reshape(nb, 8, 4, 8)
    sbytes = _fix_parity_signs(g8)
    sidx = (sbytes & 127).astype(np.uint32)
    amax = np.abs(g8).reshape(nb, 16, 16).max(axis=-1)           # per 16 elems
    d, s, db16 = _fit_scales(amax, 59.0, 0.25, 15)               # (nb, 16)
    db = db16.reshape(nb, 8, 2)[:, :, [0, 0, 1, 1]]              # (nb, 8, 4)
    idx = _grid_match("iq2xs", np.abs(g8), db).astype(np.uint32)
    q16 = (idx | (sidx << 9)).astype("<u2")                      # (nb, 8, 4)
    s2 = s.reshape(nb, 8, 2)
    out = np.zeros((nb, 74), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:66] = q16.reshape(nb, -1).view(np.uint8)
    out[:, 66:74] = (s2[..., 0] | (s2[..., 1] << 4)).astype(np.uint8)
    return out


def _quant_iq2_s(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    g8 = xb.reshape(nb, 8, 4, 8)
    sbytes = (( (g8 < 0) << np.arange(8)).sum(axis=-1)).astype(np.uint8)
    amax = np.abs(g8).reshape(nb, 16, 16).max(axis=-1)
    d, s, db16 = _fit_scales(amax, 59.0, 0.25, 15)
    db = db16.reshape(nb, 8, 2)[:, :, [0, 0, 1, 1]]
    idx = _grid_match("iq2s", np.abs(g8), db).astype(np.uint32)  # < 1024
    s2 = s.reshape(nb, 8, 2)
    out = np.zeros((nb, 82), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:34] = (idx & 0xFF).astype(np.uint8).reshape(nb, -1)
    out[:, 34:66] = sbytes.reshape(nb, -1)
    qh = ((idx >> 8) << (2 * _L4)).sum(axis=-1).astype(np.uint8)  # (nb, 8)
    out[:, 66:74] = qh
    out[:, 74:82] = (s2[..., 0] | (s2[..., 1] << 4)).astype(np.uint8)
    return out


def _quant_iq3_xxs(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    g8 = xb.reshape(nb, 8, 4, 8)                                 # sign spans of 8
    g4 = xb.reshape(nb, 8, 8, 4)                                 # grid groups of 4
    sbytes = _fix_parity_signs(g8)
    sidx = (sbytes & 127).astype(np.uint32)
    amax = np.abs(g8).reshape(nb, 8, 32).max(axis=-1)
    d, s, db = _fit_scales(amax, 62.0, 0.5, 15)                  # (nb, 8)
    idx = _grid_match("iq3xxs", np.abs(g4), db[..., None]).astype(np.uint8)
    aux = ((sidx << (7 * _L4)).sum(axis=-1, dtype=np.uint64).astype(np.uint32)
           | (s << 28))
    out = np.zeros((nb, 98), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:66] = idx.reshape(nb, -1)
    out[:, 66:98] = np.ascontiguousarray(aux.astype("<u4")).view(np.uint8).reshape(nb, -1)
    return out


def _quant_iq3_s(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    g8 = xb.reshape(nb, 8, 4, 8)
    g4 = xb.reshape(nb, 8, 8, 4)
    sbytes = (((g8 < 0) << np.arange(8)).sum(axis=-1)).astype(np.uint8)
    amax = np.abs(g8).reshape(nb, 8, 32).max(axis=-1)            # per ib32
    ideal = amax / 62.0
    d = (ideal.max(axis=-1, keepdims=True) / 31.0).astype("<f2").astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(d > 0,
                     np.round((ideal / np.where(d == 0, 1.0, d) - 1.0) / 2.0), 0.0)
    s = np.clip(s, 0, 15).astype(np.uint32)                      # (nb, 8)
    dl = d * (1.0 + 2.0 * s)
    idx = _grid_match("iq3s", np.abs(g4), dl[..., None]).astype(np.uint32)
    out = np.zeros((nb, 110), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:66] = (idx & 0xFF).astype(np.uint8).reshape(nb, -1)
    m8 = np.arange(8)
    out[:, 66:74] = ((idx >> 8) << m8).sum(axis=-1).astype(np.uint8)
    out[:, 74:106] = sbytes.reshape(nb, -1)
    s_pairs = s.reshape(nb, 4, 2)
    out[:, 106:110] = (s_pairs[..., 0] | (s_pairs[..., 1] << 4)).astype(np.uint8)
    return out


def _quant_iq1_s(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    gib = xb.reshape(nb, 8, 32)
    g8 = xb.reshape(nb, 8, 4, 8)
    amax = np.abs(gib).max(axis=-1)                              # (nb, 8)
    ideal = amax / (1.0 + IQ1S_DELTA)
    d = (ideal.max(axis=-1, keepdims=True) / 15.0).astype("<f2").astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(d > 0,
                     np.round((ideal / np.where(d == 0, 1.0, d) - 1.0) / 2.0), 0.0)
    s = np.clip(s, 0, 7).astype(np.uint32)                       # (nb, 8)
    dl = d * (2.0 * s + 1.0)
    neg = gib.sum(axis=-1) < 0                                   # delta sign per ib
    delta = np.where(neg, -IQ1S_DELTA, IQ1S_DELTA)
    with np.errstate(divide="ignore", invalid="ignore"):
        target = np.where(dl[..., None, None] > 0,
                          g8 / np.where(dl[..., None, None] == 0, 1.0,
                                        dl[..., None, None]), 0.0)
    target = target - delta[..., None, None]
    idx = nearest_entries("iq1s", target.reshape(-1, 8)).reshape(nb, 8, 4)
    idx = idx.astype(np.uint32)
    out = np.zeros((nb, 50), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:34] = (idx & 0xFF).astype(np.uint8).reshape(nb, -1)
    qh = ((idx >> 8) << (3 * _L4)).sum(axis=-1, dtype=np.uint64).astype(np.uint32)
    qh |= (s << 12) | (neg.astype(np.uint32) << 15)
    out[:, 34:50] = np.ascontiguousarray(qh.astype("<u2")).view(np.uint8).reshape(nb, -1)
    return out


def _quant_iq1_m(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    g16 = xb.reshape(nb, 16, 16)
    g8 = xb.reshape(nb, 8, 4, 8)
    amax = np.abs(g16).max(axis=-1)                              # (nb, 16)
    ideal = amax / (1.0 + IQ1M_DELTA)
    d = (ideal.max(axis=-1, keepdims=True) / 15.0).astype("<f2").astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(d > 0,
                     np.round((ideal / np.where(d == 0, 1.0, d) - 1.0) / 2.0), 0.0)
    s = np.clip(s, 0, 7).astype(np.uint32)                       # (nb, 16) per-16
    dl16 = d * (2.0 * s + 1.0)                                   # (nb, 16)
    dl = dl16.reshape(nb, 8, 2)[:, :, [0, 0, 1, 1]]              # (nb, 8, 4)
    neg = g8.sum(axis=-1) < 0                                    # (nb, 8, 4)
    delta = np.where(neg, -IQ1M_DELTA, IQ1M_DELTA)
    with np.errstate(divide="ignore", invalid="ignore"):
        target = np.where(dl[..., None] > 0,
                          g8 / np.where(dl[..., None] == 0, 1.0, dl[..., None]),
                          0.0)
    target = target - delta[..., None]
    idx = nearest_entries("iq1s", target.reshape(-1, 8)).reshape(nb, 8, 4)
    idx = idx.astype(np.uint32)
    out = np.zeros((nb, 56), dtype=np.uint8)
    out[:, 0:32] = (idx & 0xFF).astype(np.uint8).reshape(nb, -1)
    nib = ((idx >> 8) | (neg.astype(np.uint32) << 3)).astype(np.uint8)  # (nb,8,4)
    out[:, 32:48] = (nib[..., 0::2] | (nib[..., 1::2] << 4)).reshape(nb, -1)
    # scale words: four 3-bit half-scales per u16 at bit offsets 0/3/6/9;
    # the top nibble of each of the 4 words carries the f16 d, nibble-by-nibble
    s4w = s.reshape(nb, 4, 4).astype(np.uint16)
    words = (s4w[..., 0] | (s4w[..., 1] << 3) | (s4w[..., 2] << 6)
             | (s4w[..., 3] << 9))                               # (nb, 4)
    du16 = np.ascontiguousarray(d[:, 0].astype("<f2")).view("<u2").astype(np.uint16)
    words[:, 0] |= ((du16 >> 0) & 0xF) << 12
    words[:, 1] |= ((du16 >> 4) & 0xF) << 12
    words[:, 2] |= ((du16 >> 8) & 0xF) << 12
    words[:, 3] |= ((du16 >> 12) & 0xF) << 12
    out[:, 48:56] = np.ascontiguousarray(words.astype("<u2")).view(np.uint8).reshape(nb, -1)
    return out


IQ_DEQUANT = {t: _dequant_from_planes(fn) for t, fn in IQ_PLANES.items()}

IQ_QUANT = {
    GGMLType.IQ2_XXS: _quant_iq2_xxs,
    GGMLType.IQ2_XS: _quant_iq2_xs,
    GGMLType.IQ2_S: _quant_iq2_s,
    GGMLType.IQ3_XXS: _quant_iq3_xxs,
    GGMLType.IQ3_S: _quant_iq3_s,
    GGMLType.IQ1_S: _quant_iq1_s,
    GGMLType.IQ1_M: _quant_iq1_m,
}
