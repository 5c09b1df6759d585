"""Golden numpy codecs for the GGML block formats this package loads.

Bit-exact decoders and spec-conformant encoders for F32, F16, Q8_0, Q2_K,
Q3_K, Q4_K and Q6_K: the formats of a Q4_K_M Llama GGUF (Q4_K projections
and embedding, a Q6_K output head, F32 norms) and of a Q2_K one (Q2_K
projections and embedding, Q3_K ``attn_output``/``ffn_down`` and Q4_K
``attn_v`` in llama.cpp's mix, a Q6_K head). Every other format raises
``NotImplementedError`` naming it.

All functions are vectorized over blocks: ``dequantize(raw_bytes, ggml_type,
n_elements) -> float32[n_elements]``.

Layout notes (public GGML ABI):
- all multi-byte fields little-endian; scales are IEEE f16 unless noted
- K-quants use 256-element super-blocks with 6-bit sub-block scales
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType, type_block_info

__all__ = ["dequantize", "quantize", "SUPPORTED_TYPES"]


def _f16(b: np.ndarray) -> np.ndarray:
    """View little-endian byte pairs as float16 -> float32."""
    return b.view("<f2").astype(np.float32)


def _dequant_q8_0(blocks: np.ndarray) -> np.ndarray:
    # block: [d f16][qs int8 x32]
    d = _f16(blocks[:, 0:2])                      # (nb, 1)
    q = blocks[:, 2:34].view(np.int8).astype(np.float32)
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


_DEQUANT = {
    GGMLType.Q8_0: _dequant_q8_0,
    GGMLType.Q2_K: _dequant_q2_k,
    GGMLType.Q3_K: _dequant_q3_k,
    GGMLType.Q4_K: _dequant_q4_k,
    GGMLType.Q6_K: _dequant_q6_k,
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


_QUANT = {
    GGMLType.Q8_0: _quant_q8_0,
    GGMLType.Q2_K: _quant_q2_k,
    GGMLType.Q3_K: _quant_q3_k,
    GGMLType.Q4_K: _quant_q4_k,
    GGMLType.Q6_K: _quant_q6_k,
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
