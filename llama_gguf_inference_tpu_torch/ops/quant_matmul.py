"""Fused dequant+matmul dispatch and its two kernels.

``quant_matmul(w, x)`` computes ``x @ dequant(w).T`` for a QuantLinear:

- 4-bit codes in the flat scale layout (Q4_K) go to
  :func:`quant_matmul_4bit`, the counterpart of the TPU kernel
  ``_make_kernel_fsplit``: ``y = x_lo·bf16(q_lo·s)ᵀ + x_hi·bf16(q_hi·s)ᵀ −
  xsum·m′ᵀ`` with ``m′ = m + bias·s`` (``_hier_scales``);
- 8-bit codes (Q6_K compact, Q8_0 flat) go to :func:`quant_matmul_8bit`,
  the counterpart of ``_make_kernel``: ``y = x·bf16((q − bias)·s_full)ᵀ``
  (the JAX kernel's min term serves asymmetric 8-bit formats, which this
  package does not load).

The activation permute into block-minor order and the per-sub-block sums
``_block_sums`` stay plain tensor ops outside the kernels, as in the JAX
package. Each kernel wrapper launches its CUDA kernel (``csrc/
quant_matmul.cu``) for tensors on the card, or raises; it takes the plain
PyTorch version beside it only for tensors on the CPU. Outputs are f32; the
dispatcher casts to the activation dtype.
"""

from __future__ import annotations

import torch

from . import _build
from .linear import QuantLinear

NAME_4BIT = "quant_matmul_4bit"
NAME_8BIT = "quant_matmul_8bit"


def _block_sums(x2: torch.Tensor, sub: int) -> torch.Tensor:
    """(B, in) block-minor activations -> (B, nsub) per-sub-block sums, f32."""
    B, in_f = x2.shape
    return x2.float().reshape(B, sub, in_f // sub).sum(dim=1)


def _hier_scales(w: QuantLinear) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sub-block effective scale and min term m′ = m + bias·s, each
    (out, nsub) f32, for a 4-bit weight in the flat layout."""
    s = w.d
    m = w.dmin if w.dmin is not None else torch.zeros_like(s)
    if w.code_bias:
        m = m + float(w.code_bias) * s
    return s, m


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def quant_matmul_4bit(x: torch.Tensor, xsum: torch.Tensor,
                      codes: torch.Tensor, d: torch.Tensor,
                      m: torch.Tensor) -> torch.Tensor:
    """x (B, in) bf16 block-minor, xsum (B, nsub) f32, codes (out, in/2)
    uint8 planar nibbles, d and m (out, nsub) f32 -> (B, out) f32."""
    B, in_f = x.shape
    out_f, nsub = d.shape
    dev = x.device
    _check(x, "x", torch.bfloat16, (B, in_f), dev)
    _check(xsum, "xsum", torch.float32, (B, nsub), dev)
    _check(codes, "codes", torch.uint8, (out_f, in_f // 2), dev)
    _check(d, "d", torch.float32, (out_f, nsub), dev)
    _check(m, "m", torch.float32, (out_f, nsub), dev)
    if in_f % 32 or (in_f // 2) % nsub:
        raise ValueError(f"4-bit matmul needs in % 32 == 0 and in/2 a "
                         f"multiple of nsub (in={in_f}, nsub={nsub})")
    if dev.type != "cuda":
        return quant_matmul_4bit_plain(x, xsum, codes, d, m)
    y = torch.empty(B, out_f, dtype=torch.float32, device=dev)
    lib = _build.library("quant_matmul")
    _build.check(lib.lgt_quant_matmul_4bit(
        x.data_ptr(), xsum.data_ptr(), codes.data_ptr(), d.data_ptr(),
        m.data_ptr(), y.data_ptr(), B, in_f, out_f, nsub,
        torch.cuda.current_stream(dev).cuda_stream), NAME_4BIT)
    _build.count(NAME_4BIT)
    return y


def quant_matmul_4bit_plain(x, xsum, codes, d, m) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_4bit`, step by step in
    the kernel's dtypes."""
    _build.count(NAME_4BIT + ".plain")
    h = x.shape[1] // 2
    c = codes.to(torch.int32)
    sh = d.repeat(1, h // d.shape[1])                 # tile: scale of column j
    wlo = ((c & 0x0F).float() * sh).to(torch.bfloat16).float()
    whi = ((c >> 4).float() * sh).to(torch.bfloat16).float()
    xf = x.float()
    y = xf[:, :h] @ wlo.t() + xf[:, h:] @ whi.t()
    return y - xsum @ m.t()


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
    if w.bits == 4:
        if w.d_size != w.sub_size or w.sc is not None or w.min_size:
            raise NotImplementedError(
                f"4-bit {w.fmt} needs the flat scale layout")
        s, m = _hier_scales(w)
        out = quant_matmul_4bit(x2.to(torch.bfloat16),
                                _block_sums(x2, w.sub_size), w.codes, s, m)
    elif w.bits == 8:
        if w.dmin is not None:
            raise NotImplementedError(f"8-bit {w.fmt} with a min term")
        out = quant_matmul_8bit(x2.to(torch.bfloat16), w.codes, w.d, w.sc,
                                w.sub_size, w.code_bias)
    else:
        raise NotImplementedError(f"{w.bits}-bit codes ({w.fmt})")
    return out.reshape(*lead, w.out_features).to(out_dtype or x.dtype)
