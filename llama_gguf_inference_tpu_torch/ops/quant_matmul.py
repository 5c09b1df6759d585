"""Fused dequant+matmul dispatch and its three kernels.

``quant_matmul(w, x)`` computes ``x @ dequant(w).T`` for a QuantLinear:

- 2-bit codes (Q2_K) go to :func:`quant_matmul_2bit`, the counterpart of
  the TPU kernel ``_make_kernel_qsplit``: ``y = Σ_i x_i·bf16(q_i·s)ᵀ −
  xsum·m′ᵀ`` over the four quarter planes;
- 4-bit codes (Q4_K, Q3_K) go to :func:`quant_matmul_4bit`, the
  counterpart of ``_make_kernel_fsplit``: ``y = x_lo·bf16(q_lo·s)ᵀ +
  x_hi·bf16(q_hi·s)ᵀ − xsum·m′ᵀ``;
- 8-bit codes (Q6_K compact, Q8_0 flat) go to :func:`quant_matmul_8bit`,
  the counterpart of ``_make_kernel``: ``y = x·bf16((q − bias)·s_full)ᵀ``
  (the JAX kernel's min term serves asymmetric 8-bit formats, which this
  package does not load).

For 2 and 4 bits, ``s`` and ``m′ = bias·s + m`` per sub-block follow the JAX
package's ``_hier_scales``: the kernels read the scale side flat (``d`` per
sub-block) or compact (``d`` per super-block times ``sc``), and the min
side absent, flat, compact or mixed (``dmin`` per ``min_size`` times
``mn``), and fold the code bias in themselves.

The activation permute into block-minor order, the per-sub-block sums
``_block_sums`` and, for the mixed layout, their permutation into the
``mn`` order stay plain tensor ops outside the kernels, as in the JAX
package. Each kernel wrapper launches its CUDA kernel (``csrc/
quant_matmul.cu``) for tensors on the card, or raises; it takes the plain
PyTorch version beside it only for tensors on the CPU. Outputs are f32; the
dispatcher casts to the activation dtype.
"""

from __future__ import annotations

import torch

from . import _build
from .linear import QuantLinear

NAME_2BIT = "quant_matmul_2bit"
NAME_4BIT = "quant_matmul_4bit"
NAME_8BIT = "quant_matmul_8bit"

# how one side (scale or min) of a 2/4-bit weight is stored; the values
# are the kernel's Side enum
SIDE_NONE, SIDE_FLAT, SIDE_HIER_U8, SIDE_HIER_I8 = 0, 1, 2, 3


def _block_sums(x2: torch.Tensor, sub: int) -> torch.Tensor:
    """(B, in) block-minor activations -> (B, nsub) per-sub-block sums, f32."""
    B, in_f = x2.shape
    return x2.float().reshape(B, sub, in_f // sub).sum(dim=1)


def _mixed_xsum(xsum: torch.Tensor, w: QuantLinear) -> torch.Tensor:
    """Mixed layout: the block sums from the flat σ' = σ*g + s order into
    the compact (s, σ) order of ``mn`` (``pallas_quant_matmul``)."""
    B = xsum.shape[0]
    gm = w.min_size // w.sub_size
    ndm = w.in_features // w.min_size
    return xsum.reshape(B, ndm, gm).transpose(1, 2).reshape(B, ndm * gm).contiguous()


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _side(base: torch.Tensor | None, sub: torch.Tensor | None) -> int:
    if base is None:
        return SIDE_NONE
    if sub is None:
        return SIDE_FLAT
    return SIDE_HIER_I8 if sub.dtype == torch.int8 else SIDE_HIER_U8


def _lowbit(bits: int, name: str, x, xsum, codes, d, sc, dmin, mn,
            code_bias: int) -> torch.Tensor:
    """Checks and launch shared by the 2- and 4-bit wrappers."""
    B, in_f = x.shape
    nsub = xsum.shape[1]
    out_f, nd = d.shape
    dev = x.device
    _check(x, "x", torch.bfloat16, (B, in_f), dev)
    _check(xsum, "xsum", torch.float32, (B, nsub), dev)
    _check(codes, "codes", torch.uint8, (out_f, in_f * bits // 8), dev)
    _check(d, "d", torch.float32, (out_f, nd), dev)
    ndm = nd if dmin is None else dmin.shape[1]
    if sc is not None:
        _check(sc, "sc", (torch.int8, torch.uint8), (out_f, nsub), dev)
    if dmin is not None:
        _check(dmin, "dmin", torch.float32, (out_f, ndm), dev)
    if mn is not None:
        if dmin is None:
            raise ValueError("mn without dmin")
        _check(mn, "mn", (torch.int8, torch.uint8), (out_f, nsub), dev)
    planes = 8 // bits
    if in_f % (16 * planes) or (in_f // planes) % nsub:
        raise ValueError(f"{bits}-bit matmul needs in % {16 * planes} == 0 and "
                         f"in/{planes} a multiple of nsub (in={in_f}, nsub={nsub})")
    if nsub % nd or nsub % ndm or (sc is None and nd != nsub) \
            or (dmin is not None and mn is None and ndm != nsub):
        raise ValueError(f"{bits}-bit matmul scale geometry: nsub={nsub}, nd={nd}, "
                         f"ndm={ndm}, sc={sc is not None}, mn={mn is not None}")
    if code_bias and dmin is not None and ndm != nd:
        raise ValueError("the mixed layout takes no code bias")
    if dev.type != "cuda":
        plain = quant_matmul_2bit_plain if bits == 2 else quant_matmul_4bit_plain
        return plain(x, xsum, codes, d, sc, dmin, mn, code_bias)
    y = torch.empty(B, out_f, dtype=torch.float32, device=dev)
    lib = _build.library("quant_matmul")
    fn = lib.lgt_quant_matmul_2bit if bits == 2 else lib.lgt_quant_matmul_4bit

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.check(fn(
        x.data_ptr(), xsum.data_ptr(), codes.data_ptr(), d.data_ptr(), ptr(sc),
        ptr(dmin), ptr(mn), y.data_ptr(), B, in_f, out_f, nsub, nd, ndm,
        code_bias, _side(d, sc), _side(dmin, mn),
        torch.cuda.current_stream(dev).cuda_stream), name)
    _build.count(name)
    return y


def quant_matmul_2bit(x: torch.Tensor, xsum: torch.Tensor, codes: torch.Tensor,
                      d: torch.Tensor, sc: torch.Tensor | None,
                      dmin: torch.Tensor | None, mn: torch.Tensor | None,
                      code_bias: int = 0) -> torch.Tensor:
    """x (B, in) bf16 block-minor, xsum (B, nsub) f32, codes (out, in/4)
    uint8 planar quarters, d (out, nd) f32 with sc (out, nsub) 8-bit or
    None, dmin (out, ndm) f32 or None with mn (out, nsub) 8-bit or None
    -> (B, out) f32."""
    return _lowbit(2, NAME_2BIT, x, xsum, codes, d, sc, dmin, mn, code_bias)


def quant_matmul_4bit(x: torch.Tensor, xsum: torch.Tensor, codes: torch.Tensor,
                      d: torch.Tensor, sc: torch.Tensor | None,
                      dmin: torch.Tensor | None, mn: torch.Tensor | None,
                      code_bias: int = 0) -> torch.Tensor:
    """As :func:`quant_matmul_2bit`, with codes (out, in/2) uint8 planar
    nibbles."""
    return _lowbit(4, NAME_4BIT, x, xsum, codes, d, sc, dmin, mn, code_bias)


def _sub_side(base: torch.Tensor, sub: torch.Tensor | None, nsub: int) -> torch.Tensor:
    """One side per sub-block, (out, nsub) f32: tile(base) times sub."""
    s = base.repeat(1, nsub // base.shape[1])
    if sub is not None:
        s = s * sub.to(torch.int32).float()
    return s


def _scales(d, sc, dmin, mn, nsub: int, code_bias: int):
    """Effective scale s and min term m′ = bias·s + m, each (out, nsub) f32,
    as ``_hier_scales`` forms them."""
    s = _sub_side(d, sc, nsub)
    m = None if dmin is None else _sub_side(dmin, mn, nsub)
    if code_bias:
        b = float(code_bias) * s
        m = b if m is None else b + m
    return s, (torch.zeros_like(s) if m is None else m)


def _plain_lowbit(bits, x, xsum, codes, d, sc, dmin, mn, code_bias):
    planes = 8 // bits
    qn = x.shape[1] // planes
    s, m = _scales(d, sc, dmin, mn, xsum.shape[1], code_bias)
    sq = s.repeat(1, qn // s.shape[1])                 # tile: scale of stored byte j
    c = codes.to(torch.int32)
    xf = x.float()
    y = None
    for i in range(planes):
        w = (((c >> (bits * i)) & ((1 << bits) - 1)).float() * sq).to(torch.bfloat16)
        part = xf[:, i * qn:(i + 1) * qn] @ w.float().t()
        y = part if y is None else y + part
    return y - xsum @ m.t()


def quant_matmul_2bit_plain(x, xsum, codes, d, sc, dmin, mn, code_bias=0) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_2bit`, step by step in
    the kernel's dtypes: four quarter-plane dots, then the min term."""
    _build.count(NAME_2BIT + ".plain")
    return _plain_lowbit(2, x, xsum, codes, d, sc, dmin, mn, code_bias)


def quant_matmul_4bit_plain(x, xsum, codes, d, sc, dmin, mn, code_bias=0) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_4bit`, step by step in
    the kernel's dtypes: two half-plane dots, then the min term."""
    _build.count(NAME_4BIT + ".plain")
    return _plain_lowbit(4, x, xsum, codes, d, sc, dmin, mn, code_bias)


def quant_matmul_8bit(x: torch.Tensor, codes: torch.Tensor, d: torch.Tensor,
                      sc: torch.Tensor | None, sub_size: int,
                      code_bias: int) -> torch.Tensor:
    """x (B, in) bf16 block-minor, codes (out, in) int8, d (out, nd) f32,
    sc (out, nsub) int8 or None -> (B, out) f32."""
    B, in_f = x.shape
    out_f, nd = d.shape
    nsub = in_f // sub_size
    dev = x.device
    _check(x, "x", torch.bfloat16, (B, in_f), dev)
    _check(codes, "codes", torch.int8, (out_f, in_f), dev)
    _check(d, "d", torch.float32, (out_f, nd), dev)
    if sc is not None:
        _check(sc, "sc", torch.int8, (out_f, nsub), dev)
    if in_f % 16 or in_f % sub_size or nsub % nd:
        raise ValueError(f"8-bit matmul geometry: in={in_f}, sub={sub_size}, "
                         f"nd={nd}")
    if dev.type != "cuda":
        return quant_matmul_8bit_plain(x, codes, d, sc, sub_size, code_bias)
    y = torch.empty(B, out_f, dtype=torch.float32, device=dev)
    lib = _build.library("quant_matmul")
    _build.check(lib.lgt_quant_matmul_8bit(
        x.data_ptr(), codes.data_ptr(), d.data_ptr(),
        None if sc is None else sc.data_ptr(), y.data_ptr(), B, in_f, out_f,
        nd, nsub, code_bias, torch.cuda.current_stream(dev).cuda_stream),
        NAME_8BIT)
    _build.count(NAME_8BIT)
    return y


def quant_matmul_8bit_plain(x, codes, d, sc, sub_size, code_bias) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_8bit`: the tile scale
    expansion of ``QuantLinear.dequantize_bm``, bf16 weights, f32 matmul."""
    _build.count(NAME_8BIT + ".plain")
    nd = d.shape[1]
    g = codes.shape[1] // sub_size // nd
    s = d.repeat(1, g)
    if sc is not None:
        s = s * sc.to(torch.int32).float()
    w = (codes.to(torch.int32) - code_bias).float() * s.repeat(1, sub_size)
    return x.float() @ w.to(torch.bfloat16).float().t()


def quant_matmul(w: QuantLinear, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x (..., in) -> (..., out) against a QuantLinear weight."""
    lead = x.shape[:-1]
    x2 = w.permute_activations(x).reshape(-1, w.in_features).contiguous()
    if w.bits in (2, 4):
        in_f, sub = w.in_features, w.sub_size
        if w.bits == 2 and (sub % 4 or in_f % 512 or (in_f // sub) % 8):
            raise NotImplementedError(
                f"2-bit {w.fmt} at sub_size {sub}, in_features {in_f}: the kernel "
                "takes sub_size % 4 == 0, in % 512 == 0 and (in / sub) % 8 == 0")
        xsum = _block_sums(x2, sub)
        if w.min_size:
            xsum = _mixed_xsum(xsum, w)
        fn = quant_matmul_2bit if w.bits == 2 else quant_matmul_4bit
        out = fn(x2.to(torch.bfloat16), xsum, w.codes, w.d, w.sc, w.dmin, w.mn,
                 w.code_bias)
    elif w.bits == 8:
        if w.dmin is not None:
            raise NotImplementedError(f"8-bit {w.fmt} with a min term")
        out = quant_matmul_8bit(x2.to(torch.bfloat16), w.codes, w.d, w.sc,
                                w.sub_size, w.code_bias)
    else:
        raise NotImplementedError(f"{w.bits}-bit codes ({w.fmt})")
    return out.reshape(*lead, w.out_features).to(out_dtype or x.dtype)
