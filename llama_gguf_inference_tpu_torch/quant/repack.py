"""Repack native GGML wire blocks into the device layout.

GGUF block formats scatter bits across interleaved nibble/``qh`` arrays and
pack sub-block scales into 6-bit fields. At load time each weight is
repacked into the uniform layout that :class:`ops.linear.QuantLinear` and the
quantized-matmul kernels read:

- codes: 2-bit planar quarters, 4-bit planar nibbles or int8, in block-minor
  element order
- scales: f32 super-block ``d``(/``dmin``) + int8/uint8 sub-block ``sc``(/``mn``)

Repacking is *value-exact*: ``QuantLinear.dequantize()`` over the repacked
arrays equals ``quant.numpy_ref.dequantize()`` over the wire bytes
bit-for-bit. 5- and 6-bit codes (Q5_0, Q5_1, Q5_K, Q6_K) are widened to
int8, and the IQ4 codebook is applied here (IQ4_NL, IQ4_XS store int8
values); Q3_K's 3-bit codes ride the 4-bit planes with code bias 4, Q4_0's
with bias 8; the grid-codebook formats are laid out by :func:`_repack_iq`.
Formats: Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q8_1, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K,
Q8_K, IQ4_NL, IQ4_XS, IQ1_S, IQ1_M, IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S.

Q8_0, Q4_K and Q6_K are repacked by the C++ library of ``native`` where it
builds (the same bytes), the others by numpy.

Which device scale layout a hierarchical weight gets (``flat``, ``compact``
or ``mixed``) is chosen per weight by :func:`device_scale_layout` from
``LGT_SCALE_LAYOUT``; all three decode to the same values.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.constants import GGMLType, type_block_info
from .iq_ref import IQ_PACKED
from .numpy_ref import KVALUES_IQ4NL, _f16, _k4_scale_min, _q3k_q6k_scales, _q5_high_bits


def scale_layout() -> str:
    """Scale-storage policy: ``auto`` (default) | ``compact`` | ``flat`` |
    ``mixed``, from ``LGT_SCALE_LAYOUT`` (or the older ``LGT_FLAT_SCALES=1``,
    which means ``flat``).

    - ``flat``: one f32 effective scale (and min) per sub-block;
    - ``compact``: f32 ``d`` (and ``dmin``) per super-block times an 8-bit
      ``sc`` (and ``mn``) per sub-block, expanded in the kernel;
    - ``mixed``: the scale flat, the min side compact (see
      :func:`mixed_repacked`);
    - ``auto``: compact for 8-bit codes, flat below.
    """
    mode = os.environ.get("LGT_SCALE_LAYOUT", "").lower()
    if mode in ("auto", "compact", "flat", "mixed"):
        return mode
    if os.environ.get("LGT_FLAT_SCALES", "").lower() in ("1", "true", "yes"):
        return "flat"
    return "auto"


def device_scale_layout(bits: int = 8, fmt: str = "",
                        has_min: bool = False, bias: int = 0) -> str:
    """Per-weight device layout: ``flat`` | ``compact`` | ``mixed``.

    ``mixed`` applies only to formats below 8 bits that carry a min
    hierarchy and no code bias (Q2_K, Q4_K): the bias fold ``bias·s + m``
    would need the min term in the scale's order. Other formats take
    ``compact`` for 8-bit codes and ``flat`` below, as under ``auto``.
    Q2_K: 6.0 bits per weight flat, 4.625 mixed, 3.25 compact.
    """
    mode = scale_layout()
    if mode == "mixed":
        if has_min and bias == 0 and bits < 8:
            return "mixed"
        return "compact" if bits == 8 else "flat"
    if mode == "auto":
        return "compact" if bits == 8 else "flat"
    return mode


@dataclasses.dataclass
class RepackedWeight:
    """Host-side (numpy) repacked arrays + static metadata for QuantLinear."""

    codes: np.ndarray
    d: np.ndarray
    sc: np.ndarray | None
    dmin: np.ndarray | None
    mn: np.ndarray | None
    fmt: str
    bits: int
    sub_size: int
    d_size: int
    code_bias: int
    out_features: int
    in_features: int
    # mixed layout: granularity of dmin (elements per min super-block);
    # 0 = min arrays share d_size (flat/compact layouts)
    min_size: int = 0


def _pack4(q: np.ndarray) -> np.ndarray:
    """(out, in) uint8 codes < 16 -> (out, in//2).

    Planar split layout: byte j holds element j (low nibble) and element
    j + in/2 (high nibble).
    """
    h = q.shape[1] // 2
    return (q[:, :h] | (q[:, h:] << 4)).astype(np.uint8)


def _pack2(q: np.ndarray) -> np.ndarray:
    """(out, in) uint8 codes < 4 -> (out, in//4), planar quarters: byte j
    holds elements j, j+in/4, j+in/2, j+3in/4 in bit pairs."""
    qt = q.shape[1] // 4
    return (q[:, :qt] | (q[:, qt:2 * qt] << 2) | (q[:, 2 * qt:3 * qt] << 4)
            | (q[:, 3 * qt:] << 6)).astype(np.uint8)


def block_minor_perm(in_features: int, sub: int, dsz: int) -> np.ndarray:
    """Permutation mapping stored position -> logical element index.

    Stored ("block-minor") order enumerates: position-within-sub-block t
    (major), sub-block-within-super s, super-block σ (minor):

        stored[t * (g * nd) + s * nd + σ] = logical[σ * dsz + s * sub + t]

    with g = dsz // sub, nd = in / dsz. Every per-block scale expansion is
    then a tile (``full[j] = arr[j mod n]``), and consecutive stored
    positions walk consecutive sub-blocks.
    """
    nd = in_features // dsz
    g = dsz // sub
    idx = np.arange(in_features).reshape(nd, g, sub)   # [σ, s, t] -> logical
    return idx.transpose(2, 1, 0).reshape(-1)           # stored j -> logical


def _to_block_minor(q: np.ndarray, sub: int, dsz: int) -> np.ndarray:
    """(out, in) logical-order codes -> block-minor order."""
    out, in_f = q.shape
    nd = in_f // dsz
    g = dsz // sub
    return (q.reshape(out, nd, g, sub).transpose(0, 3, 2, 1)
            .reshape(out, in_f))


def _sc_transpose(sc: np.ndarray, nd: int, g: int) -> np.ndarray:
    """Per-sub-block arrays (out, nd*g) from (σ, s) order to (s, σ) order,
    matching the block-minor element order."""
    out = sc.shape[0]
    return sc.reshape(out, nd, g).transpose(0, 2, 1).reshape(out, nd * g)


def repack(raw: bytes | np.ndarray, ggml_type: GGMLType,
           out_features: int, in_features: int) -> RepackedWeight:
    """Repack a (out, in) weight whose rows are contiguous wire blocks."""
    t = GGMLType(ggml_type)
    if t not in _REPACKED:
        raise NotImplementedError(f"repack for {t!r}")
    buf = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    blk, nbytes = type_block_info(t)
    if in_features % blk != 0:
        raise ValueError(f"in_features {in_features} not divisible by block {blk}")
    if t in (GGMLType.Q8_0, GGMLType.Q4_K, GGMLType.Q6_K):
        # the hot formats go through the multi-threaded C++ repacker when it
        # builds (``native``), with the same output bytes
        from ..native import native_repack
        rp = native_repack(buf.reshape(-1), t.name.lower(), out_features, in_features)
        if rp is not None:
            return rp
    bpr = in_features // blk                       # blocks per row
    blocks = buf[: out_features * bpr * nbytes].reshape(out_features * bpr, nbytes)
    O, I = out_features, in_features

    def rw(q_logical, d, sc=None, dmin=None, mn=None, *, bits, sub, dsz, bias=0):
        """Assemble a RepackedWeight from LOGICAL-order integer codes.

        Hierarchical formats (dsz > sub) are assembled compact; the device
        layout is chosen downstream by :func:`to_quant_linear`. Flat ones
        (dsz == sub) fold any per-sub-block sc/mn into f32 effective scales
        and keep their min (Q4_1, Q5_1).
        """
        g = dsz // sub
        nd = I // dsz
        compact = g > 1
        qbm = _to_block_minor(np.asarray(q_logical), sub, dsz if compact else sub)
        if bits == 4:
            codes = _pack4(qbm.astype(np.uint8))
        elif bits == 2:
            codes = _pack2(qbm.astype(np.uint8))
        else:
            codes = qbm.astype(np.int8)
        d32 = np.ascontiguousarray(d.reshape(O, nd).astype(np.float32))
        if not compact:
            s_eff = d32
            if sc is not None:
                s_eff = s_eff * sc.reshape(O, nd).astype(np.float32)
            m_eff = None
            if dmin is not None:
                m_eff = dmin.reshape(O, nd).astype(np.float32)
                if mn is not None:
                    m_eff = m_eff * mn.reshape(O, nd).astype(np.float32)
            return RepackedWeight(
                codes=codes, d=np.ascontiguousarray(s_eff), sc=None,
                dmin=None if m_eff is None else np.ascontiguousarray(m_eff), mn=None,
                fmt=t.name.lower(), bits=bits, sub_size=sub, d_size=sub,
                code_bias=bias, out_features=O, in_features=I)
        sc_bm = np.ascontiguousarray(
            _sc_transpose(np.asarray(sc).reshape(O, nd * g), nd, g))
        dmin32 = mn_bm = None
        if dmin is not None:
            dmin32 = np.ascontiguousarray(dmin.reshape(O, nd).astype(np.float32))
            mn_bm = np.ascontiguousarray(
                _sc_transpose(np.asarray(mn).reshape(O, nd * g), nd, g))
        return RepackedWeight(
            codes=codes, d=d32, sc=sc_bm, dmin=dmin32, mn=mn_bm,
            fmt=t.name.lower(), bits=bits, sub_size=sub, d_size=dsz,
            code_bias=bias, out_features=O, in_features=I)

    if t == GGMLType.Q8_0:
        d = _f16(blocks[:, 0:2])
        q = blocks[:, 2:34].view(np.int8)
        return rw(q.reshape(O, I).copy(), d, bits=8, sub=32, dsz=32)

    if t == GGMLType.Q4_0:
        d = _f16(blocks[:, 0:2])
        qs = blocks[:, 2:18]
        q = np.concatenate([qs & 0x0F, qs >> 4], axis=1).reshape(O, I)
        return rw(q, d, bits=4, sub=32, dsz=32, bias=8)

    if t == GGMLType.Q4_1:
        d = _f16(blocks[:, 0:2])
        m = _f16(blocks[:, 2:4])
        qs = blocks[:, 4:20]
        q = np.concatenate([qs & 0x0F, qs >> 4], axis=1).reshape(O, I)
        return rw(q, d, dmin=-m, bits=4, sub=32, dsz=32)

    if t == GGMLType.Q5_0:
        d = _f16(blocks[:, 0:2])
        hb = _q5_high_bits(blocks[:, 2:6])
        qs = blocks[:, 6:22]
        q = np.concatenate([(qs & 0x0F) | (hb[:, :16] << 4),
                            (qs >> 4) | (hb[:, 16:] << 4)], axis=1)
        codes = (q.astype(np.int16) - 16).astype(np.int8).reshape(O, I)
        return rw(codes, d, bits=8, sub=32, dsz=32)

    if t == GGMLType.Q5_1:
        d = _f16(blocks[:, 0:2])
        m = _f16(blocks[:, 2:4])
        hb = _q5_high_bits(blocks[:, 4:8])
        qs = blocks[:, 8:24]
        q = np.concatenate([(qs & 0x0F) | (hb[:, :16] << 4),
                            (qs >> 4) | (hb[:, 16:] << 4)], axis=1)
        return rw(q.astype(np.int8).reshape(O, I), d, dmin=-m, bits=8, sub=32, dsz=32)

    if t == GGMLType.Q8_1:
        d = _f16(blocks[:, 0:2])
        q = blocks[:, 4:36].view(np.int8)
        return rw(q.reshape(O, I).copy(), d, bits=8, sub=32, dsz=32)

    if t == GGMLType.Q2_K:
        scb = blocks[:, 0:16]
        qs = blocks[:, 16:80]
        d = _f16(blocks[:, 80:82])
        dmin = _f16(blocks[:, 82:84])
        nb = blocks.shape[0]
        q = np.empty((nb, 256), dtype=np.uint8)
        for half in range(2):
            src = qs[:, 32 * half:32 * (half + 1)]
            for j in range(4):
                q[:, 128 * half + 32 * j:128 * half + 32 * (j + 1)] = (src >> (2 * j)) & 3
        return rw(q.reshape(O, I), d, sc=(scb & 0x0F), dmin=dmin,
                  mn=(scb >> 4), bits=2, sub=16, dsz=256)

    if t == GGMLType.Q3_K:
        hmask = blocks[:, 0:32]
        qs = blocks[:, 32:96]
        scales = _q3k_q6k_scales(blocks[:, 96:108]).astype(np.int8)
        d = _f16(blocks[:, 108:110])
        nb = blocks.shape[0]
        q = np.empty((nb, 256), dtype=np.uint8)
        m = 1
        for half in range(2):
            src = qs[:, 32 * half:32 * (half + 1)]
            for j in range(4):
                lowq = (src >> (2 * j)) & 3
                hbit = ((hmask & m) != 0).astype(np.uint8)
                # biased code in [0,7]: q = low2 + 4*hbit  (value = q - 4)
                q[:, 128 * half + 32 * j:128 * half + 32 * (j + 1)] = lowq + 4 * hbit
                m <<= 1
        return rw(q.reshape(O, I), d, sc=scales, bits=4, sub=16, dsz=256, bias=4)

    if t == GGMLType.Q4_K:
        d = _f16(blocks[:, 0:2])
        dmin = _f16(blocks[:, 2:4])
        sc, mn = _k4_scale_min(blocks[:, 4:16])
        qs = blocks[:, 16:144]
        nb = blocks.shape[0]
        q = np.empty((nb, 256), dtype=np.uint8)
        for c in range(4):
            src = qs[:, 32 * c:32 * (c + 1)]
            q[:, 64 * c:64 * c + 32] = src & 0x0F
            q[:, 64 * c + 32:64 * c + 64] = src >> 4
        return rw(q.reshape(O, I), d, sc=sc, dmin=dmin, mn=mn,
                  bits=4, sub=32, dsz=256)

    if t == GGMLType.Q5_K:
        d = _f16(blocks[:, 0:2])
        dmin = _f16(blocks[:, 2:4])
        sc, mn = _k4_scale_min(blocks[:, 4:16])
        qh = blocks[:, 16:48]
        qs = blocks[:, 48:176]
        nb = blocks.shape[0]
        q = np.empty((nb, 256), dtype=np.uint8)
        for c in range(4):
            src = qs[:, 32 * c:32 * (c + 1)]
            q[:, 64 * c:64 * c + 32] = (src & 0x0F) | (((qh >> (2 * c)) & 1) << 4)
            q[:, 64 * c + 32:64 * c + 64] = (src >> 4) | (((qh >> (2 * c + 1)) & 1) << 4)
        return rw(q.astype(np.int8).reshape(O, I), d, sc=sc, dmin=dmin, mn=mn,
                  bits=8, sub=32, dsz=256)

    if t == GGMLType.Q6_K:
        ql = blocks[:, 0:128]
        qh = blocks[:, 128:192]
        sc = blocks[:, 192:208].view(np.int8)
        d = _f16(blocks[:, 208:210])
        nb = blocks.shape[0]
        q = np.empty((nb, 256), dtype=np.int16)
        for half in range(2):
            l_ = ql[:, 64 * half:64 * half + 32]
            l32 = ql[:, 64 * half + 32:64 * half + 64]
            h = qh[:, 32 * half:32 * (half + 1)]
            base = 128 * half
            q[:, base + 0:base + 32] = ((l_ & 0x0F) | (((h >> 0) & 3) << 4)).astype(np.int16) - 32
            q[:, base + 32:base + 64] = ((l32 & 0x0F) | (((h >> 2) & 3) << 4)).astype(np.int16) - 32
            q[:, base + 64:base + 96] = ((l_ >> 4) | (((h >> 4) & 3) << 4)).astype(np.int16) - 32
            q[:, base + 96:base + 128] = ((l32 >> 4) | (((h >> 6) & 3) << 4)).astype(np.int16) - 32
        return rw(q.astype(np.int8).reshape(O, I), d, sc=sc.copy(),
                  bits=8, sub=16, dsz=256)

    if t == GGMLType.Q8_K:
        d = blocks[:, 0:4].copy().view("<f4")
        q = blocks[:, 4:260].view(np.int8)
        return rw(q.reshape(O, I).copy(), d, bits=8, sub=256, dsz=256)

    if t == GGMLType.IQ4_NL:
        d = _f16(blocks[:, 0:2])
        qs = blocks[:, 2:18]
        idx = np.concatenate([qs & 0x0F, qs >> 4], axis=1)
        codes = KVALUES_IQ4NL[idx].astype(np.int8).reshape(O, I)
        return rw(codes, d, bits=8, sub=32, dsz=32)

    if t in _IQ_GRID:
        return _repack_iq(t, blocks, O, I, rw)

    # IQ4_XS
    d = _f16(blocks[:, 0:2])
    scales_h = blocks[:, 2:4].copy().view("<u2").astype(np.uint32)
    scales_l = blocks[:, 4:8]
    qs = blocks[:, 8:136]
    nb = blocks.shape[0]
    ls = np.empty((nb, 8), dtype=np.int8)
    for ib in range(8):
        lo = (scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F
        hi = (scales_h[:, 0] >> (2 * ib)) & 0x03
        ls[:, ib] = ((lo.astype(np.int32) | (hi.astype(np.int32) << 4)) - 32).astype(np.int8)
    idx = np.empty((nb, 256), dtype=np.uint8)
    for ib in range(8):
        src = qs[:, 16 * ib:16 * (ib + 1)]
        idx[:, 32 * ib:32 * ib + 16] = src & 0x0F
        idx[:, 32 * ib + 16:32 * (ib + 1)] = src >> 4
    codes = KVALUES_IQ4NL[idx].astype(np.int8).reshape(O, I)
    return rw(codes, d, sc=ls, bits=8, sub=32, dsz=256)


_IQ_GRID = frozenset((GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S,
                      GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.IQ1_M))
_REPACKED = frozenset((
    GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
    GGMLType.Q8_1, GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K,
    GGMLType.Q6_K, GGMLType.Q8_K, GGMLType.IQ4_NL, GGMLType.IQ4_XS)) | _IQ_GRID


def _repack_iq(t: GGMLType, blocks: np.ndarray, O: int, I: int, rw) -> RepackedWeight:
    """The grid-codebook formats, as the JAX package lays them out:

    - IQ1_S and IQ1_M: 2-bit trit codes with code bias 1, the scale ``d``
      per 256 times a sub-block multiplier and the min side ``d·delta``
      times its signed multiplier (the 2/4-bit kernels read them);
    - IQ2 and IQ3: int8 element values with the compact ``d`` × sub-scale
      hierarchy (sub-blocks of 32, or 16 for IQ2_XS and IQ2_S), which the
      8-bit kernels read; ``LGT_IQ_CODES=packed4`` stores the 4-bit mapped
      codes of ``ops.linear.code_values`` instead, with IQ2's ``d`` halved
      (its map decodes doubled values; exact, a power of two).

    Every split of the wire scale is a power-of-two factorization, so the
    dequantized values equal ``quant.iq_ref``'s in every mode."""
    iq1 = t in (GGMLType.IQ1_S, GGMLType.IQ1_M)
    packed4 = os.environ.get("LGT_IQ_CODES", "int8").lower() == "packed4"
    values, codes, d, sc, dmin, mn, sub = IQ_PACKED[t](blocks, with_packed=iq1 or packed4)
    if not (iq1 or packed4):
        return rw(values.reshape(O, I), d.reshape(O, I // 256), sc=sc.reshape(O, I // sub),
                  bits=8, sub=sub, dsz=256)
    if t in (GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S):
        d = d * 0.5
    return rw(codes.reshape(O, I), d.reshape(O, I // 256), sc=sc.reshape(O, I // sub),
              dmin=None if dmin is None else dmin.reshape(O, I // 256),
              mn=None if mn is None else mn.reshape(O, I // sub),
              bits=2 if iq1 else 4, sub=sub, dsz=256, bias=1 if iq1 else 0)


def flatten_repacked(rp: RepackedWeight) -> RepackedWeight:
    """Relayout a compact (hierarchical) RepackedWeight to the FLAT layout.

    Bit-exact vs assembling flat directly from the wire: the element
    permutation between the two block-minor orders is a pure transpose even
    on the planar-packed code bytes (packing pairs elements by their
    position-within-sub-block t, which the permutation preserves), and the
    effective scale is the single IEEE f32 product ``d * sc`` per sub-block.
    """
    if rp.d_size == rp.sub_size:
        return rp
    O, I = rp.out_features, rp.in_features
    g = rp.d_size // rp.sub_size
    nd = I // rp.d_size
    # packed code bytes: (t_p, s, σ) -> (t_p, σ, s); t_p indexes the
    # sub_size*bits//8 byte-rows of a sub-block (== sub_size when bits == 8)
    groups = rp.sub_size * rp.bits // 8
    codes = np.ascontiguousarray(
        rp.codes.reshape(O, groups, g, nd).transpose(0, 1, 3, 2)
        .reshape(O, groups * nd * g))

    def expand(d_arr, sc_arr):
        # d: (O, nd) f32; sc: (O, g*nd) in (s, σ) order -> flat (O, nd*g)
        # effective f32 scale indexed by sub-block σ' = σ*g + s
        if sc_arr is None:
            return np.ascontiguousarray(np.repeat(d_arr, g, axis=1))
        prod = d_arr[:, None, :] * np.asarray(sc_arr).reshape(
            O, g, nd).astype(np.float32)
        return np.ascontiguousarray(
            prod.transpose(0, 2, 1).reshape(O, nd * g))

    d_flat = expand(rp.d, rp.sc)
    m_flat = None if rp.dmin is None else expand(rp.dmin, rp.mn)
    return RepackedWeight(
        codes=codes, d=d_flat, sc=None, dmin=m_flat, mn=None,
        fmt=rp.fmt, bits=rp.bits, sub_size=rp.sub_size, d_size=rp.sub_size,
        code_bias=rp.code_bias, out_features=O, in_features=I,
    )


def mixed_repacked(rp: RepackedWeight) -> RepackedWeight:
    """Relayout a compact RepackedWeight to the MIXED layout.

    Codes + effective scale go to the flat order/density (same permutation
    and f32 products as :func:`flatten_repacked`); dmin stays per
    super-block and mn per sub-block in the compact (s, σ) order —
    ``min_size`` records the min hierarchy's granularity. The min term only
    feeds the kernels' xsum dot, whose activation-side block sums are
    permuted to match (``ops.quant_matmul``). Q2_K: 4.625 bits per weight
    stored against flat's 6.0, with the dequant chain identical to flat.
    """
    if rp.d_size == rp.sub_size:
        return rp
    if rp.dmin is None or rp.code_bias != 0:
        return flatten_repacked(rp)
    flat = flatten_repacked(dataclasses.replace(rp, dmin=None, mn=None))
    return dataclasses.replace(flat, dmin=rp.dmin, mn=rp.mn, min_size=rp.d_size)


def to_quant_linear(rp: RepackedWeight, device: str | torch.device = "cuda"):
    """Move repacked host arrays onto ``device`` as a QuantLinear, after the
    device layout policy (:func:`device_scale_layout`) is applied."""
    from ..ops.linear import QuantLinear

    dev = resolve_device(device)
    if rp.d_size > rp.sub_size:
        layout = device_scale_layout(rp.bits, rp.fmt, has_min=rp.dmin is not None,
                                     bias=rp.code_bias)
        if layout == "flat":
            rp = flatten_repacked(rp)
        elif layout == "mixed":
            rp = mixed_repacked(rp)

    def put(a, dtype=None):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return QuantLinear(
        codes=put(rp.codes), d=put(rp.d, torch.float32), sc=put(rp.sc),
        dmin=put(rp.dmin, torch.float32), mn=put(rp.mn),
        fmt=rp.fmt, bits=rp.bits, sub_size=rp.sub_size, d_size=rp.d_size,
        code_bias=rp.code_bias, out_features=rp.out_features,
        in_features=rp.in_features, min_size=rp.min_size,
    )
