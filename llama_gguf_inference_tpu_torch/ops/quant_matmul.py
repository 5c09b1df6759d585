"""Fused dequant+matmul dispatch and its kernels.

``quant_matmul(w, x)`` computes ``x @ dequant(w).T`` for a QuantLinear,
choosing the kernel as the JAX package's ``pallas_quant_matmul`` chooses its
Pallas body (:func:`select_kernel`). First its gate: no out-tile fits
(:func:`pick_tile`), ``in % 128 != 0``, or more than ``LGT_MM_MAX_B`` (64)
activation rows whose ``B·in·2`` bytes pass ``LGT_MM_X_VMEM`` (6 MiB) take
:func:`dequant_matmul`, the counterpart of its ``matmul_xla`` (on the 8B,
ffn_down from 220 prefill rows up). Then ``LGT_MM_VARIANT`` (read per call,
default ``fsplit``) picks among the 4-bit bodies, value-mapped formats force
fsplit, 2-bit codes take qsplit unless the variant is ``base``, and a
geometry with ``(in/sub) % 8 != 0`` takes the base body. The knobs are read
on every call, as the JAX package reads them. The wrappers, each the
counterpart of one TPU body and branch:

- :func:`quant_matmul_2bit` (``_make_kernel_qsplit``): ``y = Σ_i
  x_i·bf16(q_i·s)ᵀ − xsum·m′ᵀ`` over the four quarter planes;
- :func:`quant_matmul_4bit` (``_make_kernel_fsplit``): ``y =
  x_lo·bf16(v(q_lo)·s)ᵀ + x_hi·bf16(v(q_hi)·s)ᵀ − xsum·m′ᵀ``, ``v`` the
  IQ2/IQ3 code→value map or the identity. Both dispatch by rows: from
  :data:`LOWBIT_TC_MIN_ROWS` activation rows up, where
  :func:`lowbit_tc_takes` the geometry, the tensor-core kernel of
  ``csrc/quant_matmul_lowbit_tc.cu`` (:func:`quant_matmul_2bit_tc`,
  :func:`quant_matmul_4bit_tc`, launches counted as :data:`NAME_2BIT_TC` and
  :data:`NAME_4BIT_TC`); else the decode kernel
  (:func:`quant_matmul_2bit_decode`, :func:`quant_matmul_4bit_decode`);
- :func:`quant_matmul_4bit_xsum` and :func:`quant_matmul_4bit_split`
  (``_make_kernel_xsum``/``_split``): the weight ``bf16(q·bf16(s))``, one dot
  over the row or one per nibble plane, then the same min term. Both
  dispatch as :func:`quant_matmul_4bit` does, to the xsum rule of the 2/4-bit
  tensor-core kernel (:func:`quant_matmul_4bit_xsum_tc`,
  :func:`quant_matmul_4bit_split_tc`, launches :data:`NAME_4BIT_XSUM_TC` and
  :data:`NAME_4BIT_SPLIT_TC`; split's planes summed apart are only an order
  of f32 sums there) or to the decode kernel
  (:func:`quant_matmul_4bit_xsum_decode`, :func:`quant_matmul_4bit_split_decode`);
- :func:`quant_matmul_4bit_int8` (``_make_kernel_int8``): activations
  quantized per sub-block (:func:`quantize_acts`), exact integer dots per
  sub-block, ``y = Σ_k (p_k·xs_k)·s_k − xsum·m′ᵀ``; from
  :data:`INT8_TC_MIN_ROWS` rows, where :func:`int8_tc_takes` the geometry,
  the s8 tensor-core kernel of ``csrc/quant_matmul_int8_tc.cu``
  (:func:`quant_matmul_4bit_int8_tc`, launches :data:`NAME_4BIT_INT8_TC`),
  else the decode kernel (:func:`quant_matmul_4bit_int8_decode`);
- :func:`quant_matmul_4bit_base` (``_make_kernel``'s bf16-magic branch):
  ``w = bf16(bf16(q·bf16 s) − bf16 m′)``, no xsum term;
- :func:`quant_matmul_lowbit_base` (``_make_kernel``'s f32 branch, 2-bit
  codes and value-mapped 4-bit codes): ``w = bf16((v(q) − bias)·s − m)``.
  Both dispatch as :func:`quant_matmul_4bit` does, to the base rules of the
  2/4-bit tensor-core kernel (:func:`quant_matmul_4bit_base_tc`,
  :func:`quant_matmul_lowbit_base_tc`, launches :data:`NAME_4BIT_BASE_TC`
  and :data:`NAME_LOWBIT_BASE_TC`) or to the decode kernel
  (:func:`quant_matmul_4bit_base_decode`,
  :func:`quant_matmul_lowbit_base_decode`);
- :func:`quant_matmul_8bit` (``_make_kernel``'s 8-bit branch): ``y =
  x·bf16((q − bias)·s_full − m_full)ᵀ``, the min term for the asymmetric
  formats (Q5_K, Q5_1) counted under its own launch name. From
  :data:`TC_MIN_ROWS` activation rows up it takes the tensor-core kernel of
  ``csrc/quant_matmul_tc.cu`` (:func:`quant_matmul_8bit_tc`, launches
  counted as :data:`NAME_8BIT_TC` and :data:`NAME_8BIT_MIN_TC`) wherever
  that kernel takes the geometry; fewer rows take the decode kernel.

A mixed-layout weight under ``base`` or ``int8`` takes :func:`dequant_matmul`
too, as the JAX package sends it to ``matmul_xla`` outside any Pallas
kernel. That path dequantizes to bf16 and multiplies in PyTorch (a bf16
product accumulated in f32 on the card); it is no kernel of this package and
is counted under :data:`NAME_DEQUANT`.

For 2 and 4 bits, ``s`` and ``m′ = bias·s + m`` per sub-block follow the JAX
package's ``_hier_scales``: the kernels read the scale side flat (``d`` per
sub-block) or compact (``d`` per super-block times ``sc``), and the min
side absent, flat, compact or mixed (``dmin`` per ``min_size`` times
``mn``), and fold the code bias in themselves.

The activation permute into block-minor order, the per-sub-block sums
``_block_sums``, the activation quantization and, for the mixed layout, the
sums' permutation into the ``mn`` order stay plain tensor ops outside the
kernels, as in the JAX package. Each kernel wrapper launches its CUDA kernel
(``csrc/quant_matmul.cu``, ``csrc/quant_matmul_tc.cu``,
``csrc/quant_matmul_lowbit_tc.cu``, ``csrc/quant_matmul_int8_tc.cu``) for
tensors on the card, or raises; it takes the plain PyTorch version beside it
only for tensors on the CPU. Outputs are f32; the dispatcher casts to the
activation dtype.
"""

from __future__ import annotations

import os

import torch

from . import _build
from .linear import MAPPED_FMTS, QuantLinear, code_values

NAME_2BIT = "quant_matmul_2bit"
NAME_4BIT = "quant_matmul_4bit"
NAME_2BIT_TC = "quant_matmul_2bit_tc"
NAME_4BIT_TC = "quant_matmul_4bit_tc"
NAME_4BIT_XSUM = "quant_matmul_4bit_xsum"
NAME_4BIT_SPLIT = "quant_matmul_4bit_split"
NAME_4BIT_XSUM_TC = "quant_matmul_4bit_xsum_tc"
NAME_4BIT_SPLIT_TC = "quant_matmul_4bit_split_tc"
NAME_4BIT_INT8 = "quant_matmul_4bit_int8"
NAME_4BIT_INT8_TC = "quant_matmul_4bit_int8_tc"
NAME_4BIT_BASE = "quant_matmul_4bit_base"
NAME_4BIT_BASE_TC = "quant_matmul_4bit_base_tc"
NAME_LOWBIT_BASE = "quant_matmul_lowbit_base"
NAME_LOWBIT_BASE_TC = "quant_matmul_lowbit_base_tc"
NAME_8BIT = "quant_matmul_8bit"
NAME_8BIT_MIN = "quant_matmul_8bit_min"
NAME_8BIT_TC = "quant_matmul_8bit_tc"
NAME_8BIT_MIN_TC = "quant_matmul_8bit_min_tc"
NAME_DEQUANT = "quant_matmul_dequant"

# activation rows from which quant_matmul_8bit takes the tensor-core (wgmma)
# kernel: on an H100 the decode kernel wins a layer's four Q5_K 8B
# projections at 8 rows (0.202 against 0.312 ms), the tensor-core kernel at
# 16 (0.312 against 0.336; at o and down the decode kernel still wins there,
# at qkv and gate+up the tensor-core one), and every projection from 32;
# Q8_0's o crosses between 16 and 24 (PERF.md §6, tools/tc_ablate.py
# --full-only --kinds q5_k,q8_0)
TC_MIN_ROWS = 16
TC_STEP = 64      # the tensor-core kernels' step: they need in and nsub multiples of it
# activation rows from which quant_matmul_2bit and quant_matmul_4bit (and the
# base, xsum and split wrappers) take the tensor-core (wgmma) kernel: on an
# H100 the decode kernel, which reads the codes again for each 8 activation
# rows, wins a layer's four 8B projections at 8 rows (Q4_K flat 0.256
# against 0.272 ms, Q2_K mixed 0.313 against 0.417, the base rule 0.216
# against 0.256), the tensor-core kernel at 16 (0.272 against 0.425, 0.415
# against 0.549, 0.255 against 0.352; PERF.md §6, tools/tc_ablate.py
# --full-only --kinds q4_k,q2_k,q4_k_base)
LOWBIT_TC_MIN_ROWS = 16
# activation rows from which quant_matmul_4bit_int8 takes the tensor-core
# kernel of csrc/quant_matmul_int8_tc.cu: on an H100 the decode kernel wins
# a layer's four 8B projections at 16 rows (0.289 against 0.360 ms), the
# tensor-core (wgmma) one at 24 (0.361 against 0.395); alone, gate+up
# crosses near 16 rows, down near 20, qkv near 24 and o near 32 (PERF.md §6,
# tools/tc_ablate.py --full-only --kinds q4_k_int8)
INT8_TC_MIN_ROWS = 24
INT8_TC_GROUP = 16   # the int8 tensor-core kernel walks groups of 16 sub-blocks

# how one side (scale or min) of a weight is stored; the values are the
# kernel's Side enum
SIDE_NONE, SIDE_FLAT, SIDE_HIER_U8, SIDE_HIER_I8 = 0, 1, 2, 3
# the element rule of the 2/4-bit kernel (its Var enum) and the code->value
# map (its Map enum)
VAR_FSPLIT, VAR_XSUM, VAR_SPLIT, VAR_BASE, VAR_BASE_F32 = 0, 1, 2, 3, 4
_MAP = {"iq2_xxs": 1, "iq2_xs": 1, "iq2_s": 1, "iq3_xxs": 2, "iq3_s": 2}


def variant() -> str:
    """The 4-bit kernel variant, ``LGT_MM_VARIANT`` (default ``fsplit``),
    read on every call as the JAX package reads it."""
    return os.environ.get("LGT_MM_VARIANT", "fsplit")


def pick_tile(out_features: int, in_features: int, code_bytes_per_row: int) -> int:
    """The JAX package's ``_pick_tile``: the largest out-tile (512, 256,
    128) that divides ``out_features`` and fits the ``LGT_MM_VMEM_BUDGET``
    (48 MiB) estimate, ``LGT_MM_TO`` when it divides; the whole axis when it
    is under 128 or a multiple of 128 of at most 512; else 0 (no tile)."""
    forced = int(os.environ.get("LGT_MM_TO", 0))
    if forced and out_features % forced == 0:
        return forced
    budget = int(os.environ.get("LGT_MM_VMEM_BUDGET", 48 * 1024 * 1024))
    for to in (512, 256, 128):
        if out_features % to:
            continue
        if to * in_features * 10 + to * code_bytes_per_row * 2 <= budget:
            return to
    if out_features < 128 or out_features % 128 == 0:
        return out_features if out_features <= 512 else 0
    return 0


def select_kernel(w: QuantLinear, B: int = 1) -> str:
    """The body the JAX package's ``pallas_quant_matmul`` runs for ``w`` on
    ``B`` activation rows under the current variant: ``fsplit``, ``xsum``,
    ``split``, ``int8``, ``qsplit``, ``base``, or ``dequant`` (its
    ``matmul_xla``)."""
    in_f, sub = w.in_features, w.sub_size
    tile = pick_tile(w.out_features, in_f, in_f * w.bits // 8)
    max_b = int(os.environ.get("LGT_MM_MAX_B", 64))
    x_vmem = int(os.environ.get("LGT_MM_X_VMEM", 6 * 1024 * 1024))
    if tile == 0 or in_f % 128 or (B > max_b and B * in_f * 2 > x_vmem):
        return "dequant"
    var = variant()
    kern = None
    if in_f % sub == 0 and w.d_size % sub == 0 and (in_f // sub) % 8 == 0:
        if w.bits == 4 and var in ("xsum", "split", "fsplit", "int8"):
            kern = "fsplit" if w.fmt in MAPPED_FMTS else var
        elif w.bits == 2 and sub % 4 == 0 and in_f % 512 == 0 and var != "base":
            kern = "qsplit"
    if w.min_size and (kern is None or kern == "int8"):
        return "dequant"
    return kern or "base"


def _block_sums(x2: torch.Tensor, sub: int) -> torch.Tensor:
    """(B, in) block-minor activations -> (B, nsub) per-sub-block sums, f32."""
    B, in_f = x2.shape
    return x2.float().reshape(B, sub, in_f // sub).sum(dim=1)


def quantize_acts(x2: torch.Tensor, sub: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sub-block symmetric int8 activation quantization (Q8_1 style),
    the JAX package's ``_quantize_acts`` operation for operation: (B, in)
    block-minor -> (codes int8 (B, in), scales f32 (B, nsub)). Sub-block k's
    elements sit at positions t·nsub + k."""
    B, in_f = x2.shape
    nd = in_f // sub
    xb = x2.float().reshape(B, sub, nd)
    amax = xb.abs().amax(dim=1)
    # tensor by tensor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which rounds differently from the IEEE division JAX does
    one = torch.ones_like(amax)
    s = amax / (one * 127.0)
    inv = torch.where(s > 0, one / torch.where(s == 0, one, s), torch.zeros_like(s))
    q = torch.clamp(torch.round(xb * inv[:, None, :]), -127, 127).to(torch.int8)
    return q.reshape(B, in_f), s


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


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_sides(x, codes, d, sc, dmin, mn, bits: int, code_bias: int, with_mixed: bool):
    """Checks shared by the 2/4-bit and int8 wrappers; returns (out, nsub, nd,
    ndm)."""
    B, in_f = x.shape
    out_f, nd = d.shape
    nsub = sc.shape[1] if sc is not None else nd
    dev = x.device
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
    if ndm != nd and not with_mixed:
        raise ValueError("this kernel takes no mixed layout")
    if code_bias and ndm != nd:
        raise ValueError("the mixed layout takes no code bias")
    return out_f, nsub, nd, ndm


def _lowbit(bits: int, var: int, name: str, plain, x, xsum, codes, d, sc, dmin, mn,
            code_bias: int, fmt: str = "", tc: bool = False) -> torch.Tensor:
    """Checks and launch shared by the 2- and 4-bit wrappers; ``plain`` runs
    the wrapper's plain version on its own arguments. ``tc`` launches the
    tensor-core kernel (every rule), which raises on a geometry it does not
    take."""
    B, in_f = x.shape
    base = var in (VAR_BASE, VAR_BASE_F32)
    out_f, nsub, nd, ndm = _check_sides(x, codes, d, sc, dmin, mn, bits, code_bias,
                                        with_mixed=not base)
    dev = x.device
    _check(x, "x", torch.bfloat16, (B, in_f), dev)
    if not base:
        _check(xsum, "xsum", torch.float32, (B, nsub), dev)
    vmap = _MAP.get(fmt, 0)
    if vmap and (dmin is not None or var not in (VAR_FSPLIT, VAR_BASE_F32) or bits != 4):
        raise ValueError(f"the {fmt} code map takes 4-bit fsplit or base codes and no min")
    if tc and not lowbit_tc_takes(bits, in_f, nsub, nd, ndm):
        raise ValueError(f"the tensor-core {bits}-bit kernel does not take in={in_f}, "
                         f"nsub={nsub}, nd={nd}, ndm={ndm}")
    if dev.type != "cuda":
        return plain()
    y = torch.empty(B, out_f, dtype=torch.float32, device=dev)
    args = [x.data_ptr(), _ptr(xsum), codes.data_ptr(), d.data_ptr(), _ptr(sc), _ptr(dmin),
            _ptr(mn), y.data_ptr(), B, in_f, out_f, nsub, nd, ndm, code_bias, _side(d, sc),
            _side(dmin, mn)]
    if tc:
        fn = getattr(_build.library("quant_matmul_lowbit_tc"), f"lgt_quant_matmul_{bits}bit_tc")
        rc = fn(*args, var, vmap, torch.cuda.current_stream(dev).cuda_stream)
    else:
        rc = _build.library("quant_matmul").lgt_quant_matmul_lowbit(
            *args, bits, var, vmap, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    _build.count(name)
    return y


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def lowbit_tc_takes(bits: int, in_f: int, nsub: int, nd: int, ndm: int) -> bool:
    """Whether the tensor-core 2/4-bit kernel takes rows of ``in_f``
    positions in ``nsub`` sub-blocks, the scale side ``nd`` wide and the min
    side ``ndm``: it walks 64 consecutive sub-blocks a step, a chunk's steps
    are whole groups of the ``8 // bits`` planes, and its scale loads take
    ``nd`` a multiple of 4 dividing ``nsub``."""
    planes = 8 // bits
    return (nsub > 0 and in_f % TC_STEP == 0 and nsub % TC_STEP == 0 and in_f % nsub == 0
            and (in_f // planes) % nsub == 0 and (in_f // nsub) % planes == 0
            and nd > 0 and nd % 4 == 0 and nsub % nd == 0 and ndm > 0 and nsub % ndm == 0)


def _takes_tc(bits: int, x, d, sc, dmin) -> bool:
    """Whether a 2/4-bit call goes to the tensor-core kernel: on the card,
    from :data:`LOWBIT_TC_MIN_ROWS` rows, where :func:`lowbit_tc_takes` its
    geometry (read from its arrays)."""
    if not _on_card(x) or x.shape[0] < LOWBIT_TC_MIN_ROWS:
        return False
    nd = d.shape[1]
    nsub = sc.shape[1] if sc is not None else nd
    return lowbit_tc_takes(bits, x.shape[1], nsub, nd, nd if dmin is None else dmin.shape[1])


def quant_matmul_2bit(x: torch.Tensor, xsum: torch.Tensor, codes: torch.Tensor,
                      d: torch.Tensor, sc: torch.Tensor | None,
                      dmin: torch.Tensor | None, mn: torch.Tensor | None,
                      code_bias: int = 0, fmt: str = "") -> torch.Tensor:
    """x (B, in) bf16 block-minor, xsum (B, nsub) f32, codes (out, in/4)
    uint8 planar quarters, d (out, nd) f32 with sc (out, nsub) 8-bit or
    None, dmin (out, ndm) f32 or None with mn (out, nsub) 8-bit or None
    -> (B, out) f32: on the card from :data:`LOWBIT_TC_MIN_ROWS` rows,
    where :func:`lowbit_tc_takes` the geometry, :func:`quant_matmul_2bit_tc`;
    else :func:`quant_matmul_2bit_decode`."""
    fn = quant_matmul_2bit_decode
    if _takes_tc(2, x, d, sc, dmin):
        fn = quant_matmul_2bit_tc
    return fn(x, xsum, codes, d, sc, dmin, mn, code_bias, fmt)


def quant_matmul_4bit(x: torch.Tensor, xsum: torch.Tensor, codes: torch.Tensor,
                      d: torch.Tensor, sc: torch.Tensor | None,
                      dmin: torch.Tensor | None, mn: torch.Tensor | None,
                      code_bias: int = 0, fmt: str = "") -> torch.Tensor:
    """As :func:`quant_matmul_2bit`, with codes (out, in/2) uint8 planar
    nibbles, decoded through ``fmt``'s code->value map (IQ2/IQ3):
    :func:`quant_matmul_4bit_tc` or :func:`quant_matmul_4bit_decode`."""
    fn = quant_matmul_4bit_decode
    if _takes_tc(4, x, d, sc, dmin):
        fn = quant_matmul_4bit_tc
    return fn(x, xsum, codes, d, sc, dmin, mn, code_bias, fmt)


def quant_matmul_2bit_decode(x, xsum, codes, d, sc, dmin, mn, code_bias=0,
                             fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_2bit`, through the decode kernel (bf16
    tensor-core products of 8 output rows by up to 8 activation rows, a
    second grid axis beyond) at any row count; launches count under
    :data:`NAME_2BIT`."""
    return _lowbit(2, VAR_FSPLIT, NAME_2BIT, lambda: quant_matmul_2bit_plain(
        x, xsum, codes, d, sc, dmin, mn, code_bias, fmt), x, xsum, codes, d, sc, dmin, mn,
        code_bias, fmt)


def quant_matmul_4bit_decode(x, xsum, codes, d, sc, dmin, mn, code_bias=0,
                             fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_4bit`, through the decode kernel at any row
    count; launches count under :data:`NAME_4BIT`."""
    return _lowbit(4, VAR_FSPLIT, NAME_4BIT, lambda: quant_matmul_4bit_plain(
        x, xsum, codes, d, sc, dmin, mn, code_bias, fmt), x, xsum, codes, d, sc, dmin, mn,
        code_bias, fmt)


def quant_matmul_2bit_tc(x, xsum, codes, d, sc, dmin, mn, code_bias=0, fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_2bit`, through the tensor-core kernel for
    prefill-sized row counts (any B); raises on a geometry it does not take.
    Launches count under :data:`NAME_2BIT_TC`; the plain version is
    :func:`quant_matmul_2bit_plain`."""
    return _lowbit(2, VAR_FSPLIT, NAME_2BIT_TC, lambda: quant_matmul_2bit_plain(
        x, xsum, codes, d, sc, dmin, mn, code_bias, fmt), x, xsum, codes, d, sc, dmin, mn,
        code_bias, fmt, tc=True)


def quant_matmul_4bit_tc(x, xsum, codes, d, sc, dmin, mn, code_bias=0, fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_2bit_tc` for 4-bit planar nibbles (with
    ``fmt``'s code map); launches count under :data:`NAME_4BIT_TC`."""
    return _lowbit(4, VAR_FSPLIT, NAME_4BIT_TC, lambda: quant_matmul_4bit_plain(
        x, xsum, codes, d, sc, dmin, mn, code_bias, fmt), x, xsum, codes, d, sc, dmin, mn,
        code_bias, fmt, tc=True)


def quant_matmul_4bit_xsum(x, xsum, codes, d, sc, dmin, mn, code_bias=0,
                           fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_4bit` with the weight bf16(q·bf16(s)) and one
    dot over the whole row (``LGT_MM_VARIANT=xsum``):
    :func:`quant_matmul_4bit_xsum_tc` from :data:`LOWBIT_TC_MIN_ROWS` rows
    where the tensor-core kernel takes the geometry, else
    :func:`quant_matmul_4bit_xsum_decode`."""
    fn = quant_matmul_4bit_xsum_decode
    if _takes_tc(4, x, d, sc, dmin):
        fn = quant_matmul_4bit_xsum_tc
    return fn(x, xsum, codes, d, sc, dmin, mn, code_bias, fmt)


def quant_matmul_4bit_xsum_decode(x, xsum, codes, d, sc, dmin, mn, code_bias=0,
                                  fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_4bit_xsum`, through the decode kernel at any
    row count; launches count under :data:`NAME_4BIT_XSUM`."""
    return _lowbit(4, VAR_XSUM, NAME_4BIT_XSUM, lambda: quant_matmul_4bit_xsum_plain(
        x, xsum, codes, d, sc, dmin, mn, code_bias, fmt), x, xsum, codes, d, sc, dmin, mn,
        code_bias, fmt)


def quant_matmul_4bit_xsum_tc(x, xsum, codes, d, sc, dmin, mn, code_bias=0,
                              fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_4bit_xsum`, through the tensor-core kernel
    (any B); raises on a geometry it does not take. Launches count under
    :data:`NAME_4BIT_XSUM_TC`; the plain version is
    :func:`quant_matmul_4bit_xsum_plain`."""
    return _lowbit(4, VAR_XSUM, NAME_4BIT_XSUM_TC, lambda: quant_matmul_4bit_xsum_plain(
        x, xsum, codes, d, sc, dmin, mn, code_bias, fmt), x, xsum, codes, d, sc, dmin, mn,
        code_bias, fmt, tc=True)


def quant_matmul_4bit_split(x, xsum, codes, d, sc, dmin, mn, code_bias=0,
                            fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_4bit_xsum`, the two nibble planes summed apart
    and added at the end (``LGT_MM_VARIANT=split``):
    :func:`quant_matmul_4bit_split_tc` or
    :func:`quant_matmul_4bit_split_decode`."""
    fn = quant_matmul_4bit_split_decode
    if _takes_tc(4, x, d, sc, dmin):
        fn = quant_matmul_4bit_split_tc
    return fn(x, xsum, codes, d, sc, dmin, mn, code_bias, fmt)


def quant_matmul_4bit_split_decode(x, xsum, codes, d, sc, dmin, mn, code_bias=0,
                                   fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_4bit_split`, through the decode kernel at any
    row count; launches count under :data:`NAME_4BIT_SPLIT`."""
    return _lowbit(4, VAR_SPLIT, NAME_4BIT_SPLIT, lambda: quant_matmul_4bit_split_plain(
        x, xsum, codes, d, sc, dmin, mn, code_bias, fmt), x, xsum, codes, d, sc, dmin, mn,
        code_bias, fmt)


def quant_matmul_4bit_split_tc(x, xsum, codes, d, sc, dmin, mn, code_bias=0,
                               fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_4bit_split`, through the tensor-core kernel
    (any B; the xsum rule's instances, whose plane steps share one
    accumulator); raises on a geometry it does not take. Launches count
    under :data:`NAME_4BIT_SPLIT_TC`; the plain version is
    :func:`quant_matmul_4bit_split_plain`."""
    return _lowbit(4, VAR_SPLIT, NAME_4BIT_SPLIT_TC, lambda: quant_matmul_4bit_split_plain(
        x, xsum, codes, d, sc, dmin, mn, code_bias, fmt), x, xsum, codes, d, sc, dmin, mn,
        code_bias, fmt, tc=True)


def quant_matmul_4bit_base(x, codes, d, sc, dmin, mn, code_bias=0) -> torch.Tensor:
    """x (B, in) bf16 block-minor, 4-bit planar codes and the scale/min
    sides of :func:`quant_matmul_4bit` (no mixed layout) -> (B, out) f32,
    the weight bf16(bf16(q·bf16 s) − bf16 m′) and no xsum term: on the card
    from :data:`LOWBIT_TC_MIN_ROWS` rows, where :func:`lowbit_tc_takes` the
    geometry, :func:`quant_matmul_4bit_base_tc`; else
    :func:`quant_matmul_4bit_base_decode`."""
    fn = quant_matmul_4bit_base_decode
    if _takes_tc(4, x, d, sc, dmin):
        fn = quant_matmul_4bit_base_tc
    return fn(x, codes, d, sc, dmin, mn, code_bias)


def quant_matmul_4bit_base_decode(x, codes, d, sc, dmin, mn, code_bias=0) -> torch.Tensor:
    """As :func:`quant_matmul_4bit_base`, through the decode kernel at any
    row count; launches count under :data:`NAME_4BIT_BASE`."""
    return _lowbit(4, VAR_BASE, NAME_4BIT_BASE, lambda: quant_matmul_4bit_base_plain(
        x, codes, d, sc, dmin, mn, code_bias), x, None, codes, d, sc, dmin, mn, code_bias)


def quant_matmul_4bit_base_tc(x, codes, d, sc, dmin, mn, code_bias=0) -> torch.Tensor:
    """As :func:`quant_matmul_4bit_base`, through the tensor-core kernel for
    prefill-sized row counts (any B); raises on a geometry it does not take.
    Launches count under :data:`NAME_4BIT_BASE_TC`; the plain version is
    :func:`quant_matmul_4bit_base_plain`."""
    return _lowbit(4, VAR_BASE, NAME_4BIT_BASE_TC, lambda: quant_matmul_4bit_base_plain(
        x, codes, d, sc, dmin, mn, code_bias), x, None, codes, d, sc, dmin, mn, code_bias,
        tc=True)


def quant_matmul_lowbit_base(x, codes, d, sc, dmin, mn, code_bias=0, bits=2,
                             fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_4bit_base` for 2-bit planar quarters (or
    value-mapped 4-bit nibbles), the weight bf16((v(q) − bias)·s − m)
    formed in f32: :func:`quant_matmul_lowbit_base_tc` from
    :data:`LOWBIT_TC_MIN_ROWS` rows where the tensor-core kernel takes the
    geometry, else :func:`quant_matmul_lowbit_base_decode`."""
    fn = quant_matmul_lowbit_base_decode
    if _takes_tc(bits, x, d, sc, dmin):
        fn = quant_matmul_lowbit_base_tc
    return fn(x, codes, d, sc, dmin, mn, code_bias, bits, fmt)


def quant_matmul_lowbit_base_decode(x, codes, d, sc, dmin, mn, code_bias=0, bits=2,
                                    fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_lowbit_base`, through the decode kernel at any
    row count; launches count under :data:`NAME_LOWBIT_BASE`."""
    return _lowbit(bits, VAR_BASE_F32, NAME_LOWBIT_BASE, lambda: quant_matmul_lowbit_base_plain(
        x, codes, d, sc, dmin, mn, code_bias, bits, fmt), x, None, codes, d, sc, dmin, mn,
        code_bias, fmt)


def quant_matmul_lowbit_base_tc(x, codes, d, sc, dmin, mn, code_bias=0, bits=2,
                                fmt="") -> torch.Tensor:
    """As :func:`quant_matmul_lowbit_base`, through the tensor-core kernel
    (any B); raises on a geometry it does not take. Launches count under
    :data:`NAME_LOWBIT_BASE_TC`; the plain version is
    :func:`quant_matmul_lowbit_base_plain`."""
    return _lowbit(bits, VAR_BASE_F32, NAME_LOWBIT_BASE_TC, lambda: quant_matmul_lowbit_base_plain(
        x, codes, d, sc, dmin, mn, code_bias, bits, fmt), x, None, codes, d, sc, dmin, mn,
        code_bias, fmt, tc=True)


def int8_tc_takes(in_f: int, nsub: int, nd: int, sub: int) -> bool:
    """Whether the tensor-core int8 kernel takes rows of ``in_f`` positions
    in ``nsub`` sub-blocks of ``sub`` (16 or 32: one s8 ``mma`` k-step), the
    scale side ``nd`` wide: it walks groups of :data:`INT8_TC_GROUP`
    sub-blocks, and its scale loads take ``nd`` a multiple of 4 dividing
    ``nsub``."""
    return (sub in (16, 32) and nsub * sub == in_f and nsub % INT8_TC_GROUP == 0
            and nd > 0 and nd % 4 == 0 and nsub % nd == 0)


def _check_int8(xq, xs, xsum, codes, d, sc, dmin, mn, code_bias):
    """Checks shared by the int8 wrappers; returns (B, in, out, nsub, nd)."""
    B, in_f = xq.shape
    out_f, nsub, nd, _ = _check_sides(xq, codes, d, sc, dmin, mn, 4, code_bias,
                                      with_mixed=False)
    dev = xq.device
    _check(xq, "xq", torch.int8, (B, in_f), dev)
    _check(xs, "xs", torch.float32, (B, nsub), dev)
    _check(xsum, "xsum", torch.float32, (B, nsub), dev)
    if nsub % 4 or in_f % 8:
        raise ValueError(f"int8 matmul needs nsub % 4 == 0 (nsub={nsub})")
    return B, in_f, out_f, nsub, nd


def quant_matmul_4bit_int8(xq: torch.Tensor, xs: torch.Tensor, xsum: torch.Tensor,
                           codes: torch.Tensor, d: torch.Tensor, sc, dmin, mn,
                           code_bias: int = 0) -> torch.Tensor:
    """xq (B, in) int8 and xs (B, nsub) f32 from :func:`quantize_acts`, xsum
    (B, nsub) f32, 4-bit planar codes and the scale/min sides of
    :func:`quant_matmul_4bit` (no mixed layout) -> (B, out) f32: on the card
    from :data:`INT8_TC_MIN_ROWS` rows, where :func:`int8_tc_takes` the
    geometry, :func:`quant_matmul_4bit_int8_tc`; else
    :func:`quant_matmul_4bit_int8_decode`."""
    B, in_f = xq.shape
    nsub = _nsub(d, sc)
    fn = quant_matmul_4bit_int8_decode
    if _on_card(xq) and B >= INT8_TC_MIN_ROWS and int8_tc_takes(in_f, nsub, d.shape[1],
                                                                in_f // nsub):
        fn = quant_matmul_4bit_int8_tc
    return fn(xq, xs, xsum, codes, d, sc, dmin, mn, code_bias)


def quant_matmul_4bit_int8_decode(xq, xs, xsum, codes, d, sc, dmin, mn,
                                  code_bias=0) -> torch.Tensor:
    """As :func:`quant_matmul_4bit_int8`, through the decode kernel (s8
    tensor-core products, 8 output rows a warp, up to 8 activation rows a
    block, a second grid axis beyond) at any row count; launches count
    under :data:`NAME_4BIT_INT8`."""
    B, in_f, out_f, nsub, nd = _check_int8(xq, xs, xsum, codes, d, sc, dmin, mn, code_bias)
    dev = xq.device
    if dev.type != "cuda":
        return quant_matmul_4bit_int8_plain(xq, xs, xsum, codes, d, sc, dmin, mn, code_bias)
    y = torch.empty(B, out_f, dtype=torch.float32, device=dev)
    lib = _build.library("quant_matmul")
    _build.check(lib.lgt_quant_matmul_int8(
        xq.data_ptr(), xs.data_ptr(), xsum.data_ptr(), codes.data_ptr(), d.data_ptr(),
        _ptr(sc), _ptr(dmin), _ptr(mn), y.data_ptr(), B, in_f, out_f, nsub, nd,
        code_bias, _side(d, sc), _side(dmin, mn),
        torch.cuda.current_stream(dev).cuda_stream), NAME_4BIT_INT8)
    _build.count(NAME_4BIT_INT8)
    return y


def quant_matmul_4bit_int8_tc(xq, xs, xsum, codes, d, sc, dmin, mn,
                              code_bias=0) -> torch.Tensor:
    """As :func:`quant_matmul_4bit_int8`, through the tensor-core kernel for
    prefill-sized row counts (any B); raises on a geometry it does not take
    (:func:`int8_tc_takes`). The kernel reads the activation codes
    sub-block-major, (B, nsub, sub), and each sub-block's scale beside its
    block sum, (B, nsub, 2): both are formed here, one PyTorch op each.
    Launches count under :data:`NAME_4BIT_INT8_TC`; the plain version is
    :func:`quant_matmul_4bit_int8_plain`."""
    B, in_f, out_f, nsub, nd = _check_int8(xq, xs, xsum, codes, d, sc, dmin, mn, code_bias)
    if not int8_tc_takes(in_f, nsub, nd, in_f // nsub):
        raise ValueError(f"the tensor-core int8 kernel does not take in={in_f}, nsub={nsub}, "
                         f"nd={nd}")
    dev = xq.device
    if dev.type != "cuda":
        return quant_matmul_4bit_int8_plain(xq, xs, xsum, codes, d, sc, dmin, mn, code_bias)
    xp = xq.reshape(B, in_f // nsub, nsub).transpose(1, 2).contiguous()
    xsx = torch.stack((xs, xsum), dim=-1)
    y = torch.empty(B, out_f, dtype=torch.float32, device=dev)
    lib = _build.library("quant_matmul_int8_tc")
    _build.check(lib.lgt_quant_matmul_int8_tc(
        xp.data_ptr(), xsx.data_ptr(), codes.data_ptr(), d.data_ptr(), _ptr(sc), _ptr(dmin),
        _ptr(mn), y.data_ptr(), B, in_f, out_f, nsub, nd, code_bias, _side(d, sc),
        _side(dmin, mn), torch.cuda.current_stream(dev).cuda_stream), NAME_4BIT_INT8_TC)
    _build.count(NAME_4BIT_INT8_TC)
    return y


def _sub_side(base: torch.Tensor, sub: torch.Tensor | None, nsub: int) -> torch.Tensor:
    """One side per sub-block, (out, nsub) f32: tile(base) times sub."""
    s = base.repeat(1, nsub // base.shape[1])
    if sub is not None:
        s = s * sub.to(torch.int32).float()
    return s


def _nsub(d, sc) -> int:
    return sc.shape[1] if sc is not None else d.shape[1]


def _scales(d, sc, dmin, mn, nsub: int, code_bias: int):
    """Effective scale s and min term m′ = bias·s + m, each (out, nsub) f32,
    as ``_hier_scales`` forms them."""
    s = _sub_side(d, sc, nsub)
    m = None if dmin is None else _sub_side(dmin, mn, nsub)
    if code_bias:
        b = float(code_bias) * s
        m = b if m is None else b + m
    return s, (torch.zeros_like(s) if m is None else m)


def _planes(bits: int, codes: torch.Tensor) -> list[torch.Tensor]:
    """The unpacked code planes, int32 (out, in/planes) each."""
    c = codes.to(torch.int32)
    return [(c >> (bits * i)) & ((1 << bits) - 1) for i in range(8 // bits)]


def _plain_lowbit(bits, x, xsum, codes, d, sc, dmin, mn, code_bias, fmt="", rule="fsplit"):
    """The 2/4-bit plain versions: per-plane bf16 weights and dots, then the
    min term. ``rule`` picks the weight: ``fsplit`` bf16(v(q)·s), ``xsum``
    bf16(q·bf16(s)) in one dot, ``split`` the same in one dot per plane."""
    planes = _planes(bits, codes)
    qn = x.shape[1] // len(planes)
    s, m = _scales(d, sc, dmin, mn, xsum.shape[1], code_bias)
    if rule != "fsplit":
        s = s.to(torch.bfloat16).float()
    sq = s.repeat(1, qn // s.shape[1])                 # tile: scale of stored byte j
    ws = [(code_values(fmt, p).float() * sq).to(torch.bfloat16).float() for p in planes]
    xf = x.float()
    if rule == "xsum":
        y = xf @ torch.cat(ws, dim=1).t()
    else:
        y = None
        for i, w in enumerate(ws):
            part = xf[:, i * qn:(i + 1) * qn] @ w.t()
            y = part if y is None else y + part
    return y - xsum @ m.t()


def quant_matmul_2bit_plain(x, xsum, codes, d, sc, dmin, mn, code_bias=0, fmt="") -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_2bit` (both its
    kernels), step by step in the kernel's dtypes: four quarter-plane dots,
    then the min term."""
    _build.count(NAME_2BIT + ".plain")
    return _plain_lowbit(2, x, xsum, codes, d, sc, dmin, mn, code_bias, fmt)


def quant_matmul_4bit_plain(x, xsum, codes, d, sc, dmin, mn, code_bias=0, fmt="") -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_4bit` (both its
    kernels), step by step in the kernel's dtypes: two half-plane dots,
    then the min term."""
    _build.count(NAME_4BIT + ".plain")
    return _plain_lowbit(4, x, xsum, codes, d, sc, dmin, mn, code_bias, fmt)


def quant_matmul_4bit_xsum_plain(x, xsum, codes, d, sc, dmin, mn, code_bias=0,
                                 fmt="") -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_4bit_xsum`."""
    _build.count(NAME_4BIT_XSUM + ".plain")
    return _plain_lowbit(4, x, xsum, codes, d, sc, dmin, mn, code_bias, rule="xsum")


def quant_matmul_4bit_split_plain(x, xsum, codes, d, sc, dmin, mn, code_bias=0,
                                  fmt="") -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_4bit_split`."""
    _build.count(NAME_4BIT_SPLIT + ".plain")
    return _plain_lowbit(4, x, xsum, codes, d, sc, dmin, mn, code_bias, rule="split")


def quant_matmul_4bit_base_plain(x, codes, d, sc, dmin, mn, code_bias=0) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_4bit_base`: the bf16
    weight of the magic-number branch, one dot."""
    _build.count(NAME_4BIT_BASE + ".plain")
    s, m = _scales(d, sc, dmin, mn, _nsub(d, sc), code_bias)
    q = torch.cat(_planes(4, codes), dim=1).float()
    reps = q.shape[1] // s.shape[1]
    sb = s.to(torch.bfloat16).float().repeat(1, reps)
    mb = m.to(torch.bfloat16).float().repeat(1, reps)
    w = ((q * sb).to(torch.bfloat16).float() - mb).to(torch.bfloat16)
    return x.float() @ w.float().t()


def quant_matmul_lowbit_base_plain(x, codes, d, sc, dmin, mn, code_bias=0, bits=2,
                                   fmt="") -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_lowbit_base`: the f32
    decode of ``QuantLinear.dequantize_bm`` rounded once to bf16, one dot."""
    _build.count(NAME_LOWBIT_BASE + ".plain")
    nsub = _nsub(d, sc)
    q = code_values(fmt, torch.cat(_planes(bits, codes), dim=1)) - code_bias
    reps = q.shape[1] // nsub
    w = q.float() * _sub_side(d, sc, nsub).repeat(1, reps)
    if dmin is not None:
        w = w - _sub_side(dmin, mn, nsub).repeat(1, reps)
    return x.float() @ w.to(torch.bfloat16).float().t()


def quant_matmul_4bit_int8_plain(xq, xs, xsum, codes, d, sc, dmin, mn,
                                 code_bias=0) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_4bit_int8`: per
    sub-block dots of the int8 activations with the unbiased codes (f32
    products of integers whose partial sums stay below 2^24, so exact in
    any order), then (p·xs)·s summed over sub-blocks, minus the min term."""
    _build.count(NAME_4BIT_INT8 + ".plain")
    B, in_f = xq.shape
    nsub = xs.shape[1]
    sub = in_f // nsub
    s, m = _scales(d, sc, dmin, mn, nsub, code_bias)
    q = torch.cat(_planes(4, codes), dim=1).float()          # (out, in) unbiased
    x3 = xq.float().reshape(B, sub, nsub).permute(2, 0, 1)   # (nsub, B, sub)
    w3 = q.reshape(-1, sub, nsub).permute(2, 1, 0)           # (nsub, sub, out)
    y = torch.zeros(B, q.shape[0], dtype=torch.float32, device=xq.device)
    for k0 in range(0, nsub, 32):                             # bounds the (k, B, out) partials
        p = torch.bmm(x3[k0:k0 + 32], w3[k0:k0 + 32])
        y += (p * xs.t()[k0:k0 + 32, :, None] * s.t()[k0:k0 + 32, None, :]).sum(0)
    return y - xsum @ m.t()


def _check_8bit(x, codes, d, sc, sub_size, dmin, mn) -> tuple[int, int, int, int, int]:
    """Checks shared by the 8-bit wrappers; returns (B, in, out, nd, nsub)."""
    B, in_f = x.shape
    out_f, nd = d.shape
    nsub = in_f // sub_size
    dev = x.device
    _check(x, "x", torch.bfloat16, (B, in_f), dev)
    _check(codes, "codes", torch.int8, (out_f, in_f), dev)
    _check(d, "d", torch.float32, (out_f, nd), dev)
    if sc is not None:
        _check(sc, "sc", (torch.int8, torch.uint8), (out_f, nsub), dev)
    if dmin is not None:
        _check(dmin, "dmin", torch.float32, (out_f, nd), dev)
    if mn is not None:
        if dmin is None or sc is None:
            raise ValueError("mn needs dmin and sc")
        _check(mn, "mn", torch.uint8, (out_f, nsub), dev)
    if in_f % 16 or in_f % sub_size or nsub % nd or (sc is None and nd != nsub) \
            or (dmin is not None and (mn is None) != (sc is None)):
        raise ValueError(f"8-bit matmul geometry: in={in_f}, sub={sub_size}, "
                         f"nd={nd}, sc={sc is not None}, mn={mn is not None}")
    return B, in_f, out_f, nd, nsub


def tc_takes(in_f: int, sub_size: int) -> bool:
    """Whether the tensor-core 8-bit kernel takes rows of ``in_f`` stored
    positions in sub-blocks of ``sub_size``: it walks 64 consecutive
    sub-blocks a step."""
    return in_f % TC_STEP == 0 and in_f % sub_size == 0 and (in_f // sub_size) % TC_STEP == 0


def quant_matmul_8bit(x: torch.Tensor, codes: torch.Tensor, d: torch.Tensor,
                      sc: torch.Tensor | None, sub_size: int, code_bias: int,
                      dmin: torch.Tensor | None = None,
                      mn: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, in) bf16 block-minor, codes (out, in) int8, d (out, nd) f32,
    sc (out, nsub) int8/uint8 or None, dmin (out, nd) f32 or None with mn
    (out, nsub) uint8 or None -> (B, out) f32: from :data:`TC_MIN_ROWS` rows
    up, where :func:`tc_takes` the geometry, :func:`quant_matmul_8bit_tc`;
    else :func:`quant_matmul_8bit_decode`."""
    B, in_f = x.shape
    if _on_card(x) and B >= TC_MIN_ROWS and tc_takes(in_f, sub_size):
        return quant_matmul_8bit_tc(x, codes, d, sc, sub_size, code_bias, dmin, mn)
    return quant_matmul_8bit_decode(x, codes, d, sc, sub_size, code_bias, dmin, mn)


def quant_matmul_8bit_decode(x: torch.Tensor, codes: torch.Tensor, d: torch.Tensor,
                             sc: torch.Tensor | None, sub_size: int, code_bias: int,
                             dmin: torch.Tensor | None = None,
                             mn: torch.Tensor | None = None) -> torch.Tensor:
    """As :func:`quant_matmul_8bit`, through the decode kernel (8 output
    rows and 8 activation rows a block, the row split across its warps) at
    any row count. Launches count under :data:`NAME_8BIT`, or
    :data:`NAME_8BIT_MIN` with a min side."""
    B, in_f, out_f, nd, nsub = _check_8bit(x, codes, d, sc, sub_size, dmin, mn)
    dev = x.device
    if dev.type != "cuda":
        return quant_matmul_8bit_plain(x, codes, d, sc, sub_size, code_bias, dmin, mn)
    name = NAME_8BIT if dmin is None else NAME_8BIT_MIN
    y = torch.empty(B, out_f, dtype=torch.float32, device=dev)
    lib = _build.library("quant_matmul")
    _build.check(lib.lgt_quant_matmul_8bit(
        x.data_ptr(), codes.data_ptr(), d.data_ptr(), _ptr(sc), _ptr(dmin), _ptr(mn),
        y.data_ptr(), B, in_f, out_f, nd, nsub, code_bias, _side(d, sc), _side(dmin, mn),
        torch.cuda.current_stream(dev).cuda_stream), name)
    _build.count(name)
    return y


def quant_matmul_8bit_tc(x: torch.Tensor, codes: torch.Tensor, d: torch.Tensor,
                         sc: torch.Tensor | None, sub_size: int, code_bias: int,
                         dmin: torch.Tensor | None = None,
                         mn: torch.Tensor | None = None) -> torch.Tensor:
    """As :func:`quant_matmul_8bit`, through the tensor-core kernel for
    prefill-sized row counts (any B); raises on a geometry it does not take
    (:func:`tc_takes`). Launches count under :data:`NAME_8BIT_TC`, or
    :data:`NAME_8BIT_MIN_TC` with a min side; the plain version is
    :func:`quant_matmul_8bit_plain`."""
    B, in_f, out_f, nd, nsub = _check_8bit(x, codes, d, sc, sub_size, dmin, mn)
    if not tc_takes(in_f, sub_size):
        raise ValueError(f"the tensor-core 8-bit kernel needs in and in/sub multiples of "
                         f"{TC_STEP} (in={in_f}, sub={sub_size})")
    dev = x.device
    if dev.type != "cuda":
        return quant_matmul_8bit_plain(x, codes, d, sc, sub_size, code_bias, dmin, mn)
    name = NAME_8BIT_TC if dmin is None else NAME_8BIT_MIN_TC
    y = torch.empty(B, out_f, dtype=torch.float32, device=dev)
    lib = _build.library("quant_matmul_tc")
    _build.check(lib.lgt_quant_matmul_8bit_tc(
        x.data_ptr(), codes.data_ptr(), d.data_ptr(), _ptr(sc), _ptr(dmin), _ptr(mn),
        y.data_ptr(), B, in_f, out_f, nd, nsub, code_bias, _side(d, sc), _side(dmin, mn),
        torch.cuda.current_stream(dev).cuda_stream), name)
    _build.count(name)
    return y


def quant_matmul_8bit_plain(x, codes, d, sc, sub_size, code_bias, dmin=None,
                            mn=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`quant_matmul_8bit`,
    :func:`quant_matmul_8bit_decode` and :func:`quant_matmul_8bit_tc`: the
    tile scale expansion of ``QuantLinear.dequantize_bm``, the f32 subtract
    of the min, bf16 weights, f32 matmul."""
    _build.count((NAME_8BIT if dmin is None else NAME_8BIT_MIN) + ".plain")
    nsub = codes.shape[1] // sub_size
    w = (codes.to(torch.int32) - code_bias).float() * _sub_side(d, sc, nsub).repeat(1, sub_size)
    if dmin is not None:
        w = w - _sub_side(dmin, mn, nsub).repeat(1, sub_size)
    return x.float() @ w.to(torch.bfloat16).float().t()


def dequant_matmul(w: QuantLinear, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The JAX package's ``matmul_xla``: the weight dequantized to x's dtype
    in block-minor order, multiplied with the permuted activations, the sums
    in f32 (its ``preferred_element_type``). On the card a bf16 product that
    accumulates and returns f32 (``torch.mm``'s ``out_dtype``); on the CPU,
    which has no such product, the f32 product of the same bf16 values,
    which is what XLA computes there. Not a kernel: counted under
    :data:`NAME_DEQUANT` so a run shows it."""
    _build.count(NAME_DEQUANT)
    wb = w.dequantize_bm(x.dtype)
    xp = w.permute_activations(x)
    if xp.device.type == "cuda":
        x2 = xp.reshape(-1, w.in_features)
        y = torch.mm(x2, wb.t(), out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        y = xp.float() @ wb.float().t()
    return y.to(out_dtype or x.dtype)


def quant_matmul(w: QuantLinear, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x (..., in) -> (..., out) against a QuantLinear weight."""
    kern = select_kernel(w, x.numel() // w.in_features)
    if kern == "dequant":
        return dequant_matmul(w, x, out_dtype)
    lead = x.shape[:-1]
    x2 = w.permute_activations(x).reshape(-1, w.in_features).contiguous()
    args = (w.codes, w.d, w.sc, w.dmin, w.mn)
    if kern == "int8":
        xq, xs = quantize_acts(x2, w.sub_size)
        out = quant_matmul_4bit_int8(xq, xs, _block_sums(x2, w.sub_size), *args, w.code_bias)
    elif kern != "base":
        xsum = _block_sums(x2, w.sub_size)
        if w.min_size:
            xsum = _mixed_xsum(xsum, w)
        fn = {"qsplit": quant_matmul_2bit, "fsplit": quant_matmul_4bit,
              "xsum": quant_matmul_4bit_xsum, "split": quant_matmul_4bit_split}[kern]
        out = fn(x2.to(torch.bfloat16), xsum, *args, w.code_bias, w.fmt)
    elif w.bits == 8:
        out = quant_matmul_8bit(x2.to(torch.bfloat16), w.codes, w.d, w.sc, w.sub_size,
                                w.code_bias, w.dmin, w.mn)
    elif w.bits == 4 and w.fmt not in MAPPED_FMTS:
        out = quant_matmul_4bit_base(x2.to(torch.bfloat16), *args, w.code_bias)
    elif w.bits in (2, 4):
        out = quant_matmul_lowbit_base(x2.to(torch.bfloat16), *args, w.code_bias,
                                       w.bits, w.fmt)
    else:
        raise NotImplementedError(f"{w.bits}-bit codes ({w.fmt})")
    return out.reshape(*lead, w.out_features).to(out_dtype or x.dtype)
