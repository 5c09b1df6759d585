"""Golden numpy codecs for the GGML block formats this package loads.

Bit-exact decoders for F32, F16, the 32-element formats Q4_0, Q4_1, Q5_0,
Q5_1, Q8_0 and Q8_1, the K-quants Q2_K, Q3_K, Q4_K, Q5_K, Q6_K and Q8_K, and
the non-linear IQ4_NL and IQ4_XS, and the grid-codebook formats IQ1_S, IQ1_M,
IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS and IQ3_S (``quant.iq_ref``);
spec-conformant encoders for all of them but Q8_1 (an activation format:
nothing stores weights in it). These cover the Q4_K_M, Q5_K_M and Q2_K
GGUFs (llama.cpp's mixes of K-quant projections and embedding, Q6_K heads,
F32 norms) and the legacy and IQ files.

All functions are vectorized over blocks: ``dequantize(raw_bytes, ggml_type,
n_elements) -> float32[n_elements]``.

Layout notes (public GGML ABI):
- all multi-byte fields little-endian; scales are IEEE f16 unless noted
- "nibble" packing: byte j of a 32-element block holds element j in the low
  nibble and element j+16 in the high nibble
- K-quants use 256-element super-blocks with 6-bit sub-block scales
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType, type_block_info
from .iq_ref import IQ_DEQUANT, IQ_QUANT

__all__ = ["dequantize", "quantize", "SUPPORTED_TYPES"]


def _f16(b: np.ndarray) -> np.ndarray:
    """View little-endian byte pairs as float16 -> float32."""
    return b.view("<f2").astype(np.float32)


def _dequant_q8_0(blocks: np.ndarray) -> np.ndarray:
    # block: [d f16][qs int8 x32]
    d = _f16(blocks[:, 0:2])                      # (nb, 1)
    q = blocks[:, 2:34].view(np.int8).astype(np.float32)
    return q * d


def _dequant_q4_0(blocks: np.ndarray) -> np.ndarray:
    # block: [d f16][qs u8 x16] ; v = (q - 8) * d
    d = _f16(blocks[:, 0:2])
    qs = blocks[:, 2:18]
    lo = (qs & 0x0F).astype(np.float32) - 8.0
    hi = (qs >> 4).astype(np.float32) - 8.0
    return np.concatenate([lo, hi], axis=1) * d


def _dequant_q4_1(blocks: np.ndarray) -> np.ndarray:
    # block: [d f16][m f16][qs u8 x16] ; v = q * d + m
    d = _f16(blocks[:, 0:2])
    m = _f16(blocks[:, 2:4])
    qs = blocks[:, 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    return np.concatenate([lo, hi], axis=1) * d + m


def _q5_high_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """Expand the packed u32 of 5th bits into (nb, 32) {0,1}."""
    qh = qh_bytes.copy().view("<u4")              # (nb, 1)
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh >> shifts) & 1).astype(np.uint8)  # (nb, 32), bit j -> element j


def _dequant_q5_0(blocks: np.ndarray) -> np.ndarray:
    # block: [d f16][qh u32][qs u8 x16] ; q = low4 | (bit<<4); v = (q - 16) * d
    d = _f16(blocks[:, 0:2])
    hb = _q5_high_bits(blocks[:, 2:6])
    qs = blocks[:, 6:22]
    lo = (qs & 0x0F) | (hb[:, :16] << 4)
    hi = (qs >> 4) | (hb[:, 16:] << 4)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32) - 16.0
    return q * d


def _dequant_q5_1(blocks: np.ndarray) -> np.ndarray:
    # block: [d f16][m f16][qh u32][qs u8 x16] ; v = q * d + m
    d = _f16(blocks[:, 0:2])
    m = _f16(blocks[:, 2:4])
    hb = _q5_high_bits(blocks[:, 4:8])
    qs = blocks[:, 8:24]
    lo = (qs & 0x0F) | (hb[:, :16] << 4)
    hi = (qs >> 4) | (hb[:, 16:] << 4)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return q * d + m


def _dequant_q8_1(blocks: np.ndarray) -> np.ndarray:
    # block: [d f16][s f16][qs int8 x32] ; v = q * d (s = sum*d, redundant)
    d = _f16(blocks[:, 0:2])
    q = blocks[:, 4:36].view(np.int8).astype(np.float32)
    return q * d


def _dequant_q2_k(blocks: np.ndarray) -> np.ndarray:
    # block: [scales u8 x16][qs u8 x64][d f16][dmin f16]
    # 16 sub-blocks of 16; scales[i]: low4 = scale, high4 = min.
    # Elements 0..127 come from qs[0..31] at shifts 0/2/4/6; 128..255 from qs[32..63].
    nb = blocks.shape[0]
    sc = blocks[:, 0:16]
    qs = blocks[:, 16:80]
    d = _f16(blocks[:, 80:82])
    dmin = _f16(blocks[:, 82:84])

    q = np.empty((nb, 256), dtype=np.uint8)
    for half in range(2):                      # element halves 0..127 / 128..255
        src = qs[:, 32 * half:32 * (half + 1)]
        for j in range(4):                     # shift index
            grp = src >> (2 * j) & 3           # (nb, 32)
            q[:, 128 * half + 32 * j: 128 * half + 32 * (j + 1)] = grp
    sub_scale = (sc & 0x0F).astype(np.float32)     # (nb, 16)
    sub_min = (sc >> 4).astype(np.float32)
    dl = (d * sub_scale).repeat(16, axis=1)        # (nb, 256)
    ml = (dmin * sub_min).repeat(16, axis=1)
    return dl * q.astype(np.float32) - ml


def _q3k_q6k_scales(scales12: np.ndarray) -> np.ndarray:
    """Unpack Q3_K's 12-byte 16x6-bit scale field -> (nb, 16) int8 in [-32, 31]."""
    nb = scales12.shape[0]
    out = np.empty((nb, 16), dtype=np.int32)
    for j in range(16):
        # low 4 bits: scales12[j % 8], nibble chosen by j // 8
        lo = (scales12[:, j % 8] >> (4 * (j // 8))) & 0x0F
        hi = (scales12[:, 8 + j % 4] >> (2 * (j // 4))) & 0x03
        out[:, j] = (lo | (hi << 4)).astype(np.int32) - 32
    return out


def _dequant_q3_k(blocks: np.ndarray) -> np.ndarray:
    # block: [hmask u8 x32][qs u8 x64][scales u8 x12][d f16]
    # q = 2-bit - (hmask bit set ? 0 : 4); v = d * sc[j] * q
    nb = blocks.shape[0]
    hmask = blocks[:, 0:32]
    qs = blocks[:, 32:96]
    scales = _q3k_q6k_scales(blocks[:, 96:108])     # (nb, 16)
    d = _f16(blocks[:, 108:110])                    # (nb, 1)

    q = np.empty((nb, 256), dtype=np.int32)
    m = 1
    for half in range(2):
        src = qs[:, 32 * half:32 * (half + 1)]
        for j in range(4):
            lowq = (src >> (2 * j) & 3).astype(np.int32)
            hbit = ((hmask & m) != 0).astype(np.int32)
            q[:, 128 * half + 32 * j: 128 * half + 32 * (j + 1)] = lowq - 4 * (1 - hbit)
            m <<= 1
    dl = (d * scales.astype(np.float32)).repeat(16, axis=1)
    return dl * q.astype(np.float32)


def _k4_scale_min(scales12: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack Q4_K/Q5_K 12-byte field -> (sc, m) each (nb, 8) of 6-bit values."""
    q = scales12.astype(np.uint8)
    sc = np.empty(q.shape[:1] + (8,), dtype=np.uint8)
    mn = np.empty_like(sc)
    for j in range(8):
        if j < 4:
            sc[:, j] = q[:, j] & 63
            mn[:, j] = q[:, j + 4] & 63
        else:
            sc[:, j] = (q[:, j + 4] & 0x0F) | ((q[:, j - 4] >> 6) << 4)
            mn[:, j] = (q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)
    return sc, mn


def _dequant_q4_k(blocks: np.ndarray) -> np.ndarray:
    # block: [d f16][dmin f16][scales u8 x12][qs u8 x128]
    # 8 sub-blocks of 32; per 64-element chunk: 32 low nibbles then 32 high.
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2])
    dmin = _f16(blocks[:, 2:4])
    sc, mn = _k4_scale_min(blocks[:, 4:16])
    qs = blocks[:, 16:144]

    q = np.empty((nb, 256), dtype=np.uint8)
    for c in range(4):                    # 4 chunks of 64 elements / 32 bytes
        src = qs[:, 32 * c:32 * (c + 1)]
        q[:, 64 * c:64 * c + 32] = src & 0x0F
        q[:, 64 * c + 32:64 * c + 64] = src >> 4
    dl = (d * sc.astype(np.float32)).repeat(32, axis=1)
    ml = (dmin * mn.astype(np.float32)).repeat(32, axis=1)
    return dl * q.astype(np.float32) - ml


def _dequant_q5_k(blocks: np.ndarray) -> np.ndarray:
    # block: [d f16][dmin f16][scales u8 x12][qh u8 x32][qs u8 x128]
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2])
    dmin = _f16(blocks[:, 2:4])
    sc, mn = _k4_scale_min(blocks[:, 4:16])
    qh = blocks[:, 16:48]
    qs = blocks[:, 48:176]

    q = np.empty((nb, 256), dtype=np.uint8)
    for c in range(4):
        src = qs[:, 32 * c:32 * (c + 1)]
        b1 = ((qh >> (2 * c)) & 1) << 4       # u1 bit for first 32 of chunk
        b2 = ((qh >> (2 * c + 1)) & 1) << 4   # u2 bit for second 32
        q[:, 64 * c:64 * c + 32] = (src & 0x0F) | b1
        q[:, 64 * c + 32:64 * c + 64] = (src >> 4) | b2
    dl = (d * sc.astype(np.float32)).repeat(32, axis=1)
    ml = (dmin * mn.astype(np.float32)).repeat(32, axis=1)
    return dl * q.astype(np.float32) - ml


def _dequant_q6_k(blocks: np.ndarray) -> np.ndarray:
    # block: [ql u8 x128][qh u8 x64][scales i8 x16][d f16]
    # per 128-element half (ql 64B, qh 32B):
    #   y[l+ 0] = d*sc[l//16+0] * ((ql[l   ]&0xF | ((qh[l]>>0&3)<<4)) - 32)
    #   y[l+32] = d*sc[l//16+2] * ((ql[l+32]&0xF | ((qh[l]>>2&3)<<4)) - 32)
    #   y[l+64] = d*sc[l//16+4] * ((ql[l   ]>>4  | ((qh[l]>>4&3)<<4)) - 32)
    #   y[l+96] = d*sc[l//16+6] * ((ql[l+32]>>4  | ((qh[l]>>6&3)<<4)) - 32)
    nb = blocks.shape[0]
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)   # (nb, 16)
    d = _f16(blocks[:, 208:210])

    q = np.empty((nb, 256), dtype=np.int32)
    for half in range(2):
        l_ = ql[:, 64 * half:64 * half + 32]
        l32 = ql[:, 64 * half + 32:64 * half + 64]
        h = qh[:, 32 * half:32 * (half + 1)]
        base = 128 * half
        q[:, base + 0:base + 32] = ((l_ & 0x0F) | (((h >> 0) & 3) << 4)).astype(np.int32) - 32
        q[:, base + 32:base + 64] = ((l32 & 0x0F) | (((h >> 2) & 3) << 4)).astype(np.int32) - 32
        q[:, base + 64:base + 96] = ((l_ >> 4) | (((h >> 4) & 3) << 4)).astype(np.int32) - 32
        q[:, base + 96:base + 128] = ((l32 >> 4) | (((h >> 6) & 3) << 4)).astype(np.int32) - 32
    dl = (d * sc).repeat(16, axis=1)   # sc order matches q layout: sub-block l//16
    return dl * q.astype(np.float32)


def _dequant_q8_k(blocks: np.ndarray) -> np.ndarray:
    # block: [d f32][qs i8 x256][bsums i16 x16]
    d = blocks[:, 0:4].copy().view("<f4").astype(np.float32)
    q = blocks[:, 4:260].view(np.int8).astype(np.float32)
    return q * d


# public non-linear codebook for IQ4 formats (ggml kvalues_iq4nl)
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.float32,
)


def _dequant_iq4_nl(blocks: np.ndarray) -> np.ndarray:
    # block (32 elems): [d f16][qs u8 x16]; v = d * kvalues[nibble]
    d = _f16(blocks[:, 0:2])
    qs = blocks[:, 2:18]
    lo = KVALUES_IQ4NL[qs & 0x0F]
    hi = KVALUES_IQ4NL[qs >> 4]
    return np.concatenate([lo, hi], axis=1) * d


def _dequant_iq4_xs(blocks: np.ndarray) -> np.ndarray:
    # block (256): [d f16][scales_h u16][scales_l u8 x4][qs u8 x128]
    # 8 sub-blocks of 32; ls = (low 4-bit | high 2-bit << 4) - 32
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2])
    scales_h = blocks[:, 2:4].copy().view("<u2").astype(np.uint32)   # (nb,1)
    scales_l = blocks[:, 4:8]
    qs = blocks[:, 8:136]
    ls = np.empty((nb, 8), dtype=np.float32)
    for ib in range(8):
        lo = (scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F
        hi = (scales_h[:, 0] >> (2 * ib)) & 0x03
        ls[:, ib] = (lo.astype(np.int32) | (hi.astype(np.int32) << 4)) - 32
    q = np.empty((nb, 256), dtype=np.float32)
    for ib in range(8):
        src = qs[:, 16 * ib:16 * (ib + 1)]
        q[:, 32 * ib:32 * ib + 16] = KVALUES_IQ4NL[src & 0x0F]
        q[:, 32 * ib + 16:32 * ib + 32] = KVALUES_IQ4NL[src >> 4]
        q[:, 32 * ib:32 * (ib + 1)] *= ls[:, ib:ib + 1]
    return q * d


_DEQUANT = {
    GGMLType.Q4_0: _dequant_q4_0,
    GGMLType.Q4_1: _dequant_q4_1,
    GGMLType.Q5_0: _dequant_q5_0,
    GGMLType.Q5_1: _dequant_q5_1,
    GGMLType.Q8_0: _dequant_q8_0,
    GGMLType.Q8_1: _dequant_q8_1,
    GGMLType.Q2_K: _dequant_q2_k,
    GGMLType.Q3_K: _dequant_q3_k,
    GGMLType.Q4_K: _dequant_q4_k,
    GGMLType.Q5_K: _dequant_q5_k,
    GGMLType.Q6_K: _dequant_q6_k,
    GGMLType.Q8_K: _dequant_q8_k,
    GGMLType.IQ4_NL: _dequant_iq4_nl,
    GGMLType.IQ4_XS: _dequant_iq4_xs,
    **IQ_DEQUANT,
}

SUPPORTED_TYPES = frozenset(_DEQUANT) | {GGMLType.F32, GGMLType.F16}


def dequantize(raw: bytes | np.ndarray, ggml_type: GGMLType, n_elements: int) -> np.ndarray:
    """Decode ``raw`` bytes of ``ggml_type`` into float32[n_elements]."""
    ggml_type = GGMLType(ggml_type)
    buf = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    buf = buf.reshape(-1).view(np.uint8)

    if ggml_type == GGMLType.F32:
        return buf.view("<f4")[:n_elements].astype(np.float32)
    if ggml_type == GGMLType.F16:
        return buf.view("<f2")[:n_elements].astype(np.float32)
    if ggml_type not in _DEQUANT:
        raise NotImplementedError(f"no decoder for {ggml_type!r}")
    blk, nbytes = type_block_info(ggml_type)
    if n_elements % blk != 0:
        raise ValueError(f"{n_elements} not a multiple of block size {blk}")
    nb = n_elements // blk
    blocks = buf[: nb * nbytes].reshape(nb, nbytes)
    return _DEQUANT[ggml_type](blocks).reshape(-1)[:n_elements].astype(np.float32)


def _to_f16_bytes(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype("<f2")).view(np.uint8)


def _quant_q8_0(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 32)
    amax = np.abs(xb).max(axis=1, keepdims=True)
    d = amax / 127.0
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round(xb * inv), -127, 127).astype(np.int8)
    out = np.empty((xb.shape[0], 34), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:34] = q.view(np.uint8)
    return out


def _signed_max(xb: np.ndarray) -> np.ndarray:
    """Per-row value with the largest magnitude (keeping its sign)."""
    idx = np.abs(xb).argmax(axis=1)
    return xb[np.arange(xb.shape[0]), idx][:, None]


def _quant_q4_0(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 32)
    d = _signed_max(xb) / -8.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round(xb * inv) + 8, 0, 15).astype(np.uint8)
    out = np.empty((xb.shape[0], 18), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out


def _quant_q4_1(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 32)
    mn = xb.min(axis=1, keepdims=True)
    mx = xb.max(axis=1, keepdims=True)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round((xb - mn) * inv), 0, 15).astype(np.uint8)
    out = np.empty((xb.shape[0], 20), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(mn)
    out[:, 4:20] = q[:, :16] | (q[:, 16:] << 4)
    return out


def _pack_q5_high(q: np.ndarray) -> np.ndarray:
    """Pack bit4 of 32 5-bit quants into a little-endian u32 -> 4 bytes."""
    bits = (q >> 4) & 1                                   # (nb, 32)
    word = (bits.astype(np.uint32) << np.arange(32, dtype=np.uint32)).sum(axis=1)
    return np.ascontiguousarray(word.astype("<u4"))[:, None].view(np.uint8)


def _quant_q5_0(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 32)
    d = _signed_max(xb) / -16.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round(xb * inv) + 16, 0, 31).astype(np.uint8)
    out = np.empty((xb.shape[0], 22), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:6] = _pack_q5_high(q)
    out[:, 6:22] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out


def _quant_q5_1(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 32)
    mn = xb.min(axis=1, keepdims=True)
    mx = xb.max(axis=1, keepdims=True)
    d = (mx - mn) / 31.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round((xb - mn) * inv), 0, 31).astype(np.uint8)
    out = np.empty((xb.shape[0], 24), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(mn)
    out[:, 4:8] = _pack_q5_high(q)
    out[:, 8:24] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out


def _quant_q2_k(x: np.ndarray) -> np.ndarray:
    # simple spec-conformant encoder: per sub-block affine [min, min + 3*step]
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    sub = xb.reshape(nb, 16, 16)
    smin = np.minimum(sub.min(axis=2), 0.0)            # min <= 0 so -dmin*m works
    srange = sub.max(axis=2) - smin
    sstep = srange / 3.0                               # per-sub scale
    dmax = sstep.max(axis=1, keepdims=True)            # (nb,1)
    mmax = (-smin).max(axis=1, keepdims=True)
    d = dmax / 15.0
    dmin = mmax / 15.0
    with np.errstate(divide="ignore", invalid="ignore"):
        ls = np.where(d > 0, np.clip(np.round(sstep / d), 0, 15), 0).astype(np.uint8)
        lm = np.where(dmin > 0, np.clip(np.round(-smin / dmin), 0, 15), 0).astype(np.uint8)
        eff_d = d * ls                                  # (nb, 16)
        eff_m = dmin * lm
        q = np.where(eff_d[..., None] > 0,
                     np.round((sub + eff_m[..., None]) / np.where(eff_d[..., None] == 0, 1.0,
                                                                  eff_d[..., None])), 0)
    q = np.clip(q, 0, 3).astype(np.uint8).reshape(nb, 256)
    out = np.zeros((nb, 84), dtype=np.uint8)
    out[:, 0:16] = ls | (lm << 4)
    qs = np.zeros((nb, 64), dtype=np.uint8)
    for half in range(2):
        for j in range(4):
            qs[:, 32 * half:32 * (half + 1)] |= (
                q[:, 128 * half + 32 * j: 128 * half + 32 * (j + 1)] << (2 * j))
    out[:, 16:80] = qs
    out[:, 80:82] = _to_f16_bytes(d)
    out[:, 82:84] = _to_f16_bytes(dmin)
    return out


def _quant_q3_k(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    sub = xb.reshape(nb, 16, 16)
    amax = np.abs(sub).max(axis=2)                     # (nb,16)
    smax = amax.max(axis=1, keepdims=True)
    d = smax / (31.0 * 4.0)                            # scale range [-32,31]; q in [-4,3]
    with np.errstate(divide="ignore", invalid="ignore"):
        ls = np.where(d > 0, np.clip(np.round(amax / (4.0 * np.where(d == 0, 1.0, d))),
                                     -32, 31), 0).astype(np.int32)
        eff = d * ls
        q = np.where(eff[..., None] != 0,
                     np.round(sub / np.where(eff[..., None] == 0, 1.0, eff[..., None])), 0)
    q = np.clip(q, -4, 3).astype(np.int32).reshape(nb, 256) + 4   # store biased [0,7]
    out = np.zeros((nb, 110), dtype=np.uint8)
    hmask = np.zeros((nb, 32), dtype=np.uint8)
    qs = np.zeros((nb, 64), dtype=np.uint8)
    m = 1
    for half in range(2):
        for j in range(4):
            grp = q[:, 128 * half + 32 * j: 128 * half + 32 * (j + 1)]
            qs[:, 32 * half:32 * (half + 1)] |= (grp & 3).astype(np.uint8) << (2 * j)
            hmask |= np.where(grp >= 4, m, 0).astype(np.uint8)
            m <<= 1
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    # pack 16 6-bit scales (biased by 32) into 12 bytes
    s6 = (ls + 32).astype(np.uint8)                     # (nb,16) in [0,63]
    sc12 = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(16):
        sc12[:, j % 8] |= (s6[:, j] & 0x0F) << (4 * (j // 8))
        sc12[:, 8 + j % 4] |= (s6[:, j] >> 4) << (2 * (j // 4))
    out[:, 96:108] = sc12
    out[:, 108:110] = _to_f16_bytes(d)
    return out


def _pack_k4_scales(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Pack 8 6-bit (sc, mn) pairs into the 12-byte Q4_K/Q5_K field."""
    nb = sc.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(4):
        out[:, j] = sc[:, j] & 63
        out[:, j + 4] = mn[:, j] & 63
    for j in range(4, 8):
        out[:, j + 4] = (sc[:, j] & 0x0F) | ((mn[:, j] & 0x0F) << 4)
        out[:, j - 4] |= (sc[:, j] >> 4) << 6
        out[:, j] |= (mn[:, j] >> 4) << 6
    return out


def _k4_affine(x: np.ndarray, nsub: int, qmax: int):
    """Shared sub-block affine-quantization setup for Q4_K/Q5_K."""
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    sub = xb.reshape(nb, nsub, 256 // nsub)
    smin = np.minimum(sub.min(axis=2), 0.0)
    sstep = (sub.max(axis=2) - smin) / qmax
    d = sstep.max(axis=1, keepdims=True) / 63.0
    dmin = (-smin).max(axis=1, keepdims=True) / 63.0
    with np.errstate(divide="ignore", invalid="ignore"):
        ls = np.where(d > 0, np.clip(np.round(sstep / np.where(d == 0, 1, d)), 0, 63),
                      0).astype(np.uint8)
        lm = np.where(dmin > 0, np.clip(np.round(-smin / np.where(dmin == 0, 1, dmin)), 0, 63),
                      0).astype(np.uint8)
        eff_d = d * ls
        eff_m = dmin * lm
        q = np.where(eff_d[..., None] > 0,
                     np.round((sub + eff_m[..., None]) /
                              np.where(eff_d[..., None] == 0, 1.0, eff_d[..., None])), 0)
    q = np.clip(q, 0, qmax).astype(np.uint8).reshape(nb, 256)
    return nb, d, dmin, ls, lm, q


def _quant_q4_k(x: np.ndarray) -> np.ndarray:
    nb, d, dmin, ls, lm, q = _k4_affine(x, 8, 15)
    out = np.zeros((nb, 144), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(dmin)
    out[:, 4:16] = _pack_k4_scales(ls, lm)
    for c in range(4):
        out[:, 16 + 32 * c:16 + 32 * (c + 1)] = (
            q[:, 64 * c:64 * c + 32] | (q[:, 64 * c + 32:64 * c + 64] << 4))
    return out


def _quant_q5_k(x: np.ndarray) -> np.ndarray:
    nb, d, dmin, ls, lm, q = _k4_affine(x, 8, 31)
    out = np.zeros((nb, 176), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(dmin)
    out[:, 4:16] = _pack_k4_scales(ls, lm)
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for c in range(4):
        q1 = q[:, 64 * c:64 * c + 32]
        q2 = q[:, 64 * c + 32:64 * c + 64]
        out[:, 48 + 32 * c:48 + 32 * (c + 1)] = (q1 & 0x0F) | ((q2 & 0x0F) << 4)
        qh |= ((q1 >> 4) << (2 * c)) | ((q2 >> 4) << (2 * c + 1))
    out[:, 16:48] = qh
    return out


def _quant_q6_k(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    sub = xb.reshape(nb, 16, 16)
    amax = np.abs(sub).max(axis=2)
    smax = amax.max(axis=1, keepdims=True)
    d = smax / (127.0 * 31.0)                         # sc in [-128,127] (use [0,127]); q-32 in [-32,31]
    with np.errstate(divide="ignore", invalid="ignore"):
        ls = np.where(d > 0, np.clip(np.round(amax / (31.0 * np.where(d == 0, 1, d))),
                                     -128, 127), 0).astype(np.int32)
        eff = d * ls
        q = np.where(eff[..., None] != 0,
                     np.round(sub / np.where(eff[..., None] == 0, 1.0, eff[..., None])), 0)
    q = (np.clip(q, -32, 31).astype(np.int32) + 32).astype(np.uint8).reshape(nb, 256)
    out = np.zeros((nb, 210), dtype=np.uint8)
    for half in range(2):
        base = 128 * half
        q1 = q[:, base:base + 32]
        q2 = q[:, base + 32:base + 64]
        q3 = q[:, base + 64:base + 96]
        q4 = q[:, base + 96:base + 128]
        out[:, 64 * half:64 * half + 32] = (q1 & 0x0F) | ((q3 & 0x0F) << 4)
        out[:, 64 * half + 32:64 * half + 64] = (q2 & 0x0F) | ((q4 & 0x0F) << 4)
        out[:, 128 + 32 * half:128 + 32 * (half + 1)] = (
            (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6))
    out[:, 192:208] = ls.astype(np.int8).view(np.uint8)
    out[:, 208:210] = _to_f16_bytes(d)
    return out


def _quant_q8_k(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 256)
    amax = np.abs(xb).max(axis=1, keepdims=True)
    d = amax / 127.0
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round(xb * inv), -127, 127).astype(np.int8)
    bsums = q.reshape(-1, 16, 16).sum(axis=2).astype("<i2")
    out = np.empty((xb.shape[0], 292), dtype=np.uint8)
    out[:, 0:4] = np.ascontiguousarray(d.astype("<f4")).view(np.uint8)
    out[:, 4:260] = q.view(np.uint8)
    out[:, 260:292] = np.ascontiguousarray(bsums).view(np.uint8).reshape(-1, 32)
    return out


def _quant_iq4_nl(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 32)
    sm = _signed_max(xb)
    d = sm / -127.0                                   # map signed max near kvalue -127
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    scaled = xb * inv                                  # in ~[-127, 127]
    idx = np.abs(scaled[..., None] - KVALUES_IQ4NL[None, None, :]).argmin(axis=2).astype(np.uint8)
    out = np.empty((xb.shape[0], 18), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:18] = idx[:, :16] | (idx[:, 16:] << 4)
    return out


def _quant_iq4_xs(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 256)
    nb = xb.shape[0]
    sub = xb.reshape(nb, 8, 32)
    sm = np.take_along_axis(sub, np.abs(sub).argmax(axis=2)[..., None], axis=2)[..., 0]
    sub_d = sm / -127.0                                # per-sub-block ideal scale
    dmax = np.abs(sub_d).max(axis=1, keepdims=True)
    d = np.where(dmax > 0, dmax / 31.0, 0.0)           # ls in [-32,31]; use magnitude <=31
    with np.errstate(divide="ignore", invalid="ignore"):
        ls = np.where(d > 0, np.clip(np.round(sub_d / np.where(d == 0, 1, d)), -32, 31),
                      0).astype(np.int32)
        eff = d * ls
        scaled = np.where(eff[..., None] != 0,
                          sub / np.where(eff[..., None] == 0, 1.0, eff[..., None]), 0.0)
    idx = np.abs(scaled[..., None] - KVALUES_IQ4NL[None, None, None, :]).argmin(axis=3)
    idx = idx.astype(np.uint8)                          # (nb, 8, 32)
    out = np.zeros((nb, 136), dtype=np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    l6 = (ls + 32).astype(np.uint32)
    sh = np.zeros(nb, dtype=np.uint32)
    for ib in range(8):
        out[:, 4 + ib // 2] |= ((l6[:, ib] & 0x0F) << (4 * (ib % 2))).astype(np.uint8)
        sh |= (l6[:, ib] >> 4) << (2 * ib)
    out[:, 2:4] = np.ascontiguousarray(sh.astype("<u2"))[:, None].view(np.uint8)
    for ib in range(8):
        out[:, 8 + 16 * ib:8 + 16 * (ib + 1)] = idx[:, ib, :16] | (idx[:, ib, 16:] << 4)
    return out


_QUANT = {
    GGMLType.Q4_0: _quant_q4_0,
    GGMLType.Q4_1: _quant_q4_1,
    GGMLType.Q5_0: _quant_q5_0,
    GGMLType.Q5_1: _quant_q5_1,
    GGMLType.Q8_0: _quant_q8_0,
    GGMLType.Q2_K: _quant_q2_k,
    GGMLType.Q3_K: _quant_q3_k,
    GGMLType.Q4_K: _quant_q4_k,
    GGMLType.Q5_K: _quant_q5_k,
    GGMLType.Q6_K: _quant_q6_k,
    GGMLType.Q8_K: _quant_q8_k,
    GGMLType.IQ4_NL: _quant_iq4_nl,
    GGMLType.IQ4_XS: _quant_iq4_xs,
    **IQ_QUANT,
}


def quantize(x: np.ndarray, ggml_type: GGMLType) -> bytes:
    """Encode float array ``x`` into ``ggml_type`` blocks (spec-conformant)."""
    ggml_type = GGMLType(ggml_type)
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    if ggml_type == GGMLType.F32:
        return np.ascontiguousarray(x.astype("<f4")).tobytes()
    if ggml_type == GGMLType.F16:
        return np.ascontiguousarray(x.astype("<f2")).tobytes()
    try:
        fn = _QUANT[ggml_type]
    except KeyError:
        raise NotImplementedError(f"no encoder for {ggml_type!r}") from None
    blk, _ = type_block_info(ggml_type)
    if x.size % blk != 0:
        raise ValueError(f"{x.size} not a multiple of block size {blk}")
    return fn(x).tobytes()
