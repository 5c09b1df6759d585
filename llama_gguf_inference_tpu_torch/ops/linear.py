"""Linear-layer weight containers: dense bf16 or quantized-resident.

Weights live on the device in the repacked layout of ``quant.repack``:
power-of-two bitfield codes plus a (super-block scale, sub-block int8
scale/min) hierarchy, in block-minor element order. ``QuantLinear.matmul``
goes through ``ops.quant_matmul``, whose kernels dequantize in registers so
the weights never exist at bf16 width in device memory; ``dequantize_bm``
and ``dequantize`` are the plain decode rule the kernels are held against.

``matmul(w, x)`` computes ``x @ W.T`` for x: (..., in) -> (..., out).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

MAPPED_FMTS = frozenset(("iq2_xxs", "iq2_xs", "iq2_s", "iq3_xxs", "iq3_s"))


def code_values(fmt: str, q: torch.Tensor) -> torch.Tensor:
    """Unpacked integer codes -> integer element values: the identity for
    every format this package repacks and for the IQ1 trit codes.

    The 4-bit IQ2/IQ3 codes (the JAX package's ``LGT_IQ_CODES=packed4``
    layout) are sign|magnitude: IQ2 decodes ``17·(c & 14) − 2·(c & 1) −
    118``, which for the codes its repack writes is twice a value of the
    alphabet ±{8, 25, 43, 59} (the repack halves ``d``), IQ3 the magnitude ``8c + 4 + 2·(c == 7)`` of the low three
    bits, negated when bit 3 is set. Shifts and adds only, as in the JAX
    package, so every backend computes the same integers.
    """
    if fmt in ("iq2_xxs", "iq2_xs", "iq2_s"):
        e = q & 14
        return ((e << 4) + e) - ((q & 1) << 1) - 118
    if fmt not in ("iq3_xxs", "iq3_s"):
        return q
    c = q & 7
    m = (c << 3) + 4 + ((((c + 1) >> 3) & 1) << 1)
    neg = -(q >> 3)
    return (m ^ neg) - neg


@dataclasses.dataclass
class DenseLinear:
    """Plain bf16/f32 weight, shape (out, in)."""

    w: torch.Tensor
    out_features: int = 0
    in_features: int = 0

    @staticmethod
    def from_f32(w: np.ndarray, device: str | torch.device = "cuda",
                 dtype=torch.bfloat16) -> "DenseLinear":
        o, i = w.shape
        t = torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32))
        return DenseLinear(w=t.to(device=resolve_device(device), dtype=dtype),
                           out_features=o, in_features=i)

    def matmul(self, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
        y = torch.matmul(x.float(), self.w.float().t())
        return y.to(out_dtype or x.dtype)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return self.w.to(dtype)


@dataclasses.dataclass
class QuantLinear:
    """Quantized-resident weight in the repacked layout.

    Decode rule, in block-minor element order (``quant.repack``):

        w[o, j] = (q[o, j] - code_bias) * s_full[o, j] - m_full[o, j]

    with ``s_sub = tile(d, g) * sc`` per sub-block and ``s_full =
    tile(s_sub, sub_size)``; symmetric formats have ``dmin``/``mn`` None,
    flat layouts have ``sc``/``mn`` None and ``d_size == sub_size``.

    ==========  ====  ========  ==========  ======================================
    fmt         bits  sub_size  code_bias   device scale layout (``auto``)
    ==========  ====  ========  ==========  ======================================
    q4_0        4     32        8           flat: d f32 per 32
    q4_1        4     32        0           flat: d, dmin f32 per 32 (dmin = -m)
    q5_0        8     32        0           flat: d f32 per 32 (codes q - 16)
    q5_1        8     32        0           flat: d, dmin f32 per 32 (dmin = -m)
    q8_0, q8_1  8     32        0           flat: d f32 per 32
    q2_k        2     16        0           flat: d, dmin f32 per 16 (d*sc, dmin*mn)
    q3_k        4     16        4           flat: d f32 per 16 (d*sc), no min
    q4_k        4     32        0           flat: d, dmin f32 per 32 (d*sc, dmin*mn)
    q5_k        8     32        0           compact: d, dmin f32 per 256; sc, mn
                                            uint8 per 32
    q6_k        8     16        0           compact: d f32 per 256; sc int8 per 16
    q8_k        8     256       0           flat: d f32 per 256
    iq4_nl      8     32        0           flat: d f32 per 32 (codebook values)
    iq4_xs      8     32        0           compact: d f32 per 256; sc int8 per
                                            32 (codebook values)
    ==========  ====  ========  ==========  ======================================

    ``LGT_SCALE_LAYOUT`` (``quant.repack.scale_layout``) picks the layout of
    the hierarchical formats: ``compact`` keeps d/dmin f32 per 256 and sc/mn
    8-bit per sub-block (sc int8 for q3_k/q6_k, uint8 otherwise); ``flat``
    folds them into f32 per sub-block; ``mixed`` keeps the scale flat and
    the min side compact, ``dmin`` per ``min_size`` elements and ``mn`` in
    the compact (s, σ) order (q2_k and q4_k; the other formats as under
    ``auto``).
    """

    codes: torch.Tensor               # (out, in*bits//8) uint8 or (out, in) int8
    d: torch.Tensor                   # (out, in // d_size) f32
    sc: torch.Tensor | None           # (out, in // sub_size) int8/uint8
    dmin: torch.Tensor | None         # (out, in // d_size) f32
    mn: torch.Tensor | None           # (out, in // sub_size) uint8
    fmt: str = "q8_0"
    bits: int = 8
    sub_size: int = 32
    d_size: int = 32
    code_bias: int = 0
    out_features: int = 0
    in_features: int = 0
    min_size: int = 0                 # mixed layout: elements per dmin entry

    @property
    def _geom(self) -> tuple[int, int, int]:
        """(nd, g, sub): super-blocks per row, subs per super, sub size."""
        nd = self.in_features // self.d_size
        g = self.d_size // self.sub_size
        return nd, g, self.sub_size

    def permute_activations(self, x: torch.Tensor) -> torch.Tensor:
        """Reorder x's feature axis into the weight's block-minor order."""
        nd, g, sub = self._geom
        lead = x.shape[:-1]
        x4 = x.reshape(*lead, nd, g, sub)
        n = len(lead)
        return x4.permute(*range(n), n + 2, n + 1, n).reshape(
            *lead, self.in_features)

    def _unpack_codes_bm(self) -> torch.Tensor:
        """Integer codes (out, in) in block-minor order, int32 minus bias."""
        b = self.codes.to(torch.int32)
        if self.bits == 8:
            q = b
        elif self.bits == 4:
            # planar split: low nibbles = stored [0, in/2), high = [in/2, in)
            q = code_values(self.fmt, torch.cat([b & 0x0F, b >> 4], dim=1))
        elif self.bits == 2:
            # planar quarters: bit pair i of stored byte j = element j + i*in/4
            q = torch.cat([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3], dim=1)
        else:
            raise NotImplementedError(f"bits={self.bits}")
        return q - self.code_bias if self.code_bias else q

    def _scale_sub_bm(self, arr_d: torch.Tensor,
                      arr_sc: torch.Tensor | None) -> torch.Tensor:
        """(out, nsub) per-sub-block scale in block-minor order: the tile of
        ``arr_d`` times ``arr_sc``; stored position j takes column j mod nsub."""
        nd, g, sub = self._geom
        s = arr_d.repeat(1, g)                        # (out, g*nd): d[σ]
        if arr_sc is not None:
            s = s * arr_sc.to(torch.int32).float()
        return s

    def _min_sub_mixed(self) -> torch.Tensor:
        """Mixed layout: per-sub-block min term (out, nsub) in the FLAT
        σ' = σ*g + s column order (matching d and the stored codes)."""
        o = self.out_features
        g = self.min_size // self.sub_size
        ndm = self.in_features // self.min_size
        m = self.dmin.repeat_interleave(g, dim=1)         # σ-major expand
        mn_p = (self.mn.reshape(o, g, ndm).transpose(1, 2)
                .reshape(o, ndm * g))                     # (s,σ) -> σ' order
        return m * mn_p.to(torch.int32).float()

    def dequantize_bm(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Dequant to (out, in) in block-minor column order: the f32 codes
        times their sub-block's scale, minus its min, each broadcast over the
        sub_size stored positions j = t·nsub + k of sub-block k (the JAX
        package's tiles, without materializing them)."""
        o = self.out_features
        w = self._unpack_codes_bm().float().view(o, self.sub_size, -1)
        w.mul_(self._scale_sub_bm(self.d, self.sc)[:, None])
        if self.dmin is not None:
            m = self._min_sub_mixed() if self.min_size else self._scale_sub_bm(self.dmin, self.mn)
            w.sub_(m[:, None])
        return w.view(o, self.in_features).to(dtype)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Full dequant to (out, in) in LOGICAL column order."""
        nd, g, sub = self._geom
        w = self.dequantize_bm(dtype)
        # invert the block-minor permutation: stored (t, s, σ) -> logical (σ, s, t)
        return (w.reshape(self.out_features, sub, g, nd)
                .permute(0, 3, 2, 1).reshape(self.out_features, self.in_features))

    def matmul(self, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
        from . import quant_matmul
        return quant_matmul.quant_matmul(self, x, out_dtype)


@dataclasses.dataclass
class QuantEmbedding:
    """Quantized-resident token embedding table.

    The table keeps the repacked QuantLinear arrays (rows = vocab entries)
    and gathers + dequantizes only the requested rows, at exact wire values
    and the packed footprint (llama.cpp's ggml_get_rows on quantized
    tensors is the same design).
    """

    table: QuantLinear

    @property
    def shape(self) -> tuple[int, int]:
        return (self.table.out_features, self.table.in_features)

    def take(self, token_ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        """token_ids (...,) int -> (..., dim) embeddings."""
        flat = token_ids.reshape(-1).long()

        def g(a):
            return None if a is None else a.index_select(0, flat)

        sub = dataclasses.replace(
            self.table, codes=g(self.table.codes), d=g(self.table.d),
            sc=g(self.table.sc), dmin=g(self.table.dmin), mn=g(self.table.mn),
            out_features=int(flat.shape[0]))
        w = sub.dequantize(dtype)
        return w.reshape(*token_ids.shape, self.table.in_features)

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return self.table.dequantize(dtype)


def embed_lookup(tok_embd, token_ids: torch.Tensor) -> torch.Tensor:
    """Gather token embeddings from a dense table or a QuantEmbedding."""
    if isinstance(tok_embd, QuantEmbedding):
        return tok_embd.take(token_ids)
    return tok_embd.index_select(0, token_ids.reshape(-1).long()).reshape(
        *token_ids.shape, tok_embd.shape[-1])


LinearWeight = DenseLinear | QuantLinear


def matmul(w: LinearWeight, x: torch.Tensor) -> torch.Tensor:
    return w.matmul(x)


def fuse_linears(ws: list[LinearWeight]) -> LinearWeight | None:
    """Row-concatenate weights sharing in_features into one linear.

    Quantized rows are independent (blocks run along in_features), so
    concatenating codes/scales along the out axis is exact. Returns None when
    the weights aren't compatible (mixed formats or geometry).
    """
    if all(isinstance(w, DenseLinear) for w in ws):
        if len({w.in_features for w in ws}) != 1:
            return None
        return DenseLinear(w=torch.cat([w.w for w in ws], dim=0),
                           out_features=sum(w.out_features for w in ws),
                           in_features=ws[0].in_features)
    if not all(isinstance(w, QuantLinear) for w in ws):
        return None

    def key(w):
        return (w.fmt, w.bits, w.sub_size, w.d_size, w.code_bias, w.min_size,
                w.in_features, w.sc is None, w.dmin is None, w.mn is None)

    if len({key(w) for w in ws}) != 1:
        return None

    def cat(field):
        vals = [getattr(w, field) for w in ws]
        return None if vals[0] is None else torch.cat(vals, dim=0)

    w0 = ws[0]
    return QuantLinear(
        codes=cat("codes"), d=cat("d"), sc=cat("sc"), dmin=cat("dmin"),
        mn=cat("mn"), fmt=w0.fmt, bits=w0.bits, sub_size=w0.sub_size,
        d_size=w0.d_size, code_bias=w0.code_bias, min_size=w0.min_size,
        out_features=sum(w.out_features for w in ws),
        in_features=w0.in_features,
    )
