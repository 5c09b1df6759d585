"""The CUDA matmul source run on the CPU: ``csrc/quant_matmul.cu`` compiled
by g++ against the stand-in headers of ``tests/cuda_emu`` (whole blocks as
threads, shuffles through a warp barrier, and ``tc_emu.h``'s ``cp.async``
and ``mma.sync`` for the 8-bit kernel, as ``test_torch_cuda_emulated_tc.py``
builds its sources), driven through the port's own wrappers with their
device check lifted, against the plain PyTorch versions.

This holds the kernels' index arithmetic, element rules and rounding points
to the plain versions where no card is present; what nvcc makes of the
source is checked only on the card (``test_torch_cuda_kernels.py``).
Tolerance: the same bf16 weights and exact integer dots on both sides, f32
sums in another order: 1e-5 of the output's scale. Skips where there is no
g++ with C++20.
"""

import ctypes
import os
import shutil
import subprocess
import types

import pytest
import torch

from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
from test_torch_cuda_emulated_tc import _emulated_source

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "llama_gguf_inference_tpu_torch", "csrc")
TOL = 1e-5


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The wrappers of ``ops.quant_matmul`` over the g++ build of the CUDA
    source, and the launches they count."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    d = tmp_path_factory.mktemp("cuda_emu")
    cpp, lib = d / "quant_matmul.cpp", d / "quant_matmul.so"
    cpp.write_text(_emulated_source("quant_matmul").replace("fmaf(", "std::fmaf("))
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                        "-pthread", "-I", os.path.join(HERE, "cuda_emu"), "-I", CSRC,
                        str(cpp),
                        "-o", str(lib)], capture_output=True, text=True, timeout=600)
    if r.returncode != 0 and "barrier" in r.stderr and "No such file" in r.stderr:
        pytest.skip("g++ lacks C++20's <barrier>")
    assert r.returncode == 0, r.stderr[-3000:]
    so = _build._bind("quant_matmul", ctypes.CDLL(str(lib)))
    launches: dict[str, int] = {}
    fake_build = types.SimpleNamespace(
        library=lambda name: so, check=_build.check,
        count=lambda name: launches.__setitem__(name, launches.get(name, 0) + 1))
    with open(qm.__file__) as f:
        wsrc = f.read()
    wsrc = wsrc.replace('if dev.type != "cuda":', "if False:")
    wsrc = wsrc.replace("torch.cuda.current_stream(dev).cuda_stream", "0")
    wsrc = wsrc.replace("from . import _build\n", "")
    wsrc = wsrc.replace("from .linear import", "from llama_gguf_inference_tpu_torch.ops.linear import")
    mod = types.ModuleType("quant_matmul_emulated")
    mod._build = fake_build
    exec(compile(wsrc, "quant_matmul_emulated", "exec"), mod.__dict__)
    mod._build = fake_build
    return mod, launches


def _arrays(bits, out_f, in_f, sub, layout, has_min, signed, g):
    nsub, nd = in_f // sub, in_f // 256
    if bits == 8:
        codes = torch.randint(-128, 128, (out_f, in_f), generator=g, dtype=torch.int32).to(torch.int8)
    else:
        codes = torch.randint(0, 256, (out_f, in_f * bits // 8), generator=g, dtype=torch.uint8)

    def f32(n):
        return torch.rand(out_f, n, generator=g) * 0.02 + 1e-3

    def u8(s):
        if s:
            return torch.randint(-32, 32, (out_f, nsub), generator=g, dtype=torch.int32).to(torch.int8)
        return torch.randint(0, 64, (out_f, nsub), generator=g, dtype=torch.int32).to(torch.uint8)
    if layout == "flat":
        return codes, f32(nsub), None, (f32(nsub) if has_min else None), None
    if layout == "compact":
        return codes, f32(nd), u8(signed), (f32(nd) if has_min else None), \
            (u8(False) if has_min else None)
    return codes, f32(nsub), None, f32(nd), u8(False)


def _close(got, want):
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


OUT, IN, B = 10, 512, 9     # 3 blocks of 4 warps (two idle), 2 blocks of rows (8 + 1)

LOWBIT = [  # (bits, sub, bias, layout, has_min, signed sc)
    (4, 32, 0, "flat", True, False), (4, 32, 0, "compact", True, False),
    (4, 32, 0, "mixed", True, False), (4, 16, 4, "flat", False, True),
    (4, 16, 4, "compact", False, True), (4, 32, 8, "flat", False, False),
    (2, 16, 0, "flat", True, False), (2, 16, 0, "compact", True, False),
    (2, 16, 0, "mixed", True, False), (2, 8, 1, "compact", True, True)]


@pytest.mark.parametrize("bits,sub,bias,layout,has_min,signed", LOWBIT, ids=str)
def test_lowbit_kernels(emu, bits, sub, bias, layout, has_min, signed):
    """qsplit/fsplit, xsum, split and both base rules in each layout they
    take."""
    mod, launches = emu
    g = torch.Generator().manual_seed(bits * 100 + sub + bias)
    arrs = _arrays(bits, OUT, IN, sub, layout, has_min, signed, g)
    x = torch.randn(B, IN, generator=g).bfloat16()
    xsum = qm._block_sums(x, sub)
    names = ["quant_matmul_2bit"] if bits == 2 else [
        "quant_matmul_4bit", "quant_matmul_4bit_xsum", "quant_matmul_4bit_split"]
    for name in names:
        _close(getattr(mod, name)(x, xsum, *arrs, bias),
               getattr(qm, name + "_plain")(x, xsum, *arrs, bias))
    if layout != "mixed":
        if bits == 4:
            _close(mod.quant_matmul_4bit_base(x, *arrs, bias),
                   qm.quant_matmul_4bit_base_plain(x, *arrs, bias))
        else:
            _close(mod.quant_matmul_lowbit_base(x, *arrs, bias, 2),
                   qm.quant_matmul_lowbit_base_plain(x, *arrs, bias, 2))
    assert all(launches.get(n, 0) for n in names)


@pytest.mark.parametrize("fmt", ["iq2_xs", "iq3_s"])
@pytest.mark.parametrize("layout", ["flat", "compact"])
def test_mapped_code_kernels(emu, fmt, layout):
    mod, _ = emu
    g = torch.Generator().manual_seed(len(fmt) + len(layout))
    codes, d, sc, _, _ = _arrays(4, OUT, IN, 32, layout, False, False, g)
    x = torch.randn(B, IN, generator=g).bfloat16()
    xsum = qm._block_sums(x, 32)
    _close(mod.quant_matmul_4bit(x, xsum, codes, d, sc, None, None, 0, fmt),
           qm.quant_matmul_4bit_plain(x, xsum, codes, d, sc, None, None, 0, fmt))
    _close(mod.quant_matmul_lowbit_base(x, codes, d, sc, None, None, 0, 4, fmt),
           qm.quant_matmul_lowbit_base_plain(x, codes, d, sc, None, None, 0, 4, fmt))


@pytest.mark.parametrize("layout,has_min,bias,signed", [
    ("flat", True, 0, False), ("flat", False, 8, False), ("compact", True, 0, False),
    ("compact", False, 4, True)], ids=str)
def test_int8_kernel(emu, layout, has_min, bias, signed):
    mod, launches = emu
    g = torch.Generator().manual_seed(bias + len(layout))
    arrs = _arrays(4, OUT, IN, 32, layout, has_min, signed, g)
    x = torch.randn(B, IN, generator=g).bfloat16()
    xq, xs = qm.quantize_acts(x, 32)
    args = (xq, xs, qm._block_sums(x, 32), *arrs, bias)
    _close(mod.quant_matmul_4bit_int8(*args), qm.quant_matmul_4bit_int8_plain(*args))
    assert launches[qm.NAME_4BIT_INT8] > 0


@pytest.mark.parametrize("layout,has_min,signed,sub,bias", [
    ("flat", False, False, 32, 0), ("flat", True, False, 32, 0), ("compact", False, True, 16, 0),
    ("compact", True, False, 32, 0), ("compact", False, False, 32, 16)], ids=str)
def test_8bit_kernel(emu, layout, has_min, signed, sub, bias):
    """Q8_0/Q5_1-like flat sides, Q6_K/IQ4_XS-like i8 sc, Q5_K-like u8 sc and
    mn."""
    mod, launches = emu
    g = torch.Generator().manual_seed(sub + bias + has_min)
    codes, d, sc, dmin, mn = _arrays(8, OUT, IN, sub, layout, has_min, signed, g)
    x = torch.randn(B, IN, generator=g).bfloat16()
    args = (x, codes, d, sc, sub, bias, dmin, mn)
    _close(mod.quant_matmul_8bit(*args), qm.quant_matmul_8bit_plain(*args))
    assert launches[qm.NAME_8BIT_MIN if has_min else qm.NAME_8BIT] > 0


# (in, sub, layout, has_min, signed sc, bias): the decode kernel's walk over
# 64-position cells, cell q meeting sub-blocks (64q + 16t + e) mod nsub. The
# emulated card has 4 SMs, so at 13 output rows (two blocks of 8, one
# ragged) a chunk's run splits as far as 16 warps a block allow.
GEOMETRIES_8BIT = [
    # Q5_K's ffn_down in small: nsub 56 (no multiple of 16, so a lane's run
    # of 16 sub-blocks wraps it), nd 7, the scales read one at a time; 7
    # chunks each split in 2
    (1792, 32, "compact", True, False, 0),
    # Q6_K's ffn_down in small: nsub 112, nd 7, i8 sc
    (1792, 16, "compact", False, True, 0),
    (1792, 32, "flat", True, False, 0),
    # Q5_K at in 4096: 2 chunks, each run split in 8, 16 warps summed in the block
    (4096, 32, "compact", True, False, 0),
    # the Q6_K head's geometry: nsub 256, nd 16, i8 sc in 16-byte loads
    (4096, 16, "compact", False, True, 0),
    # Q5_K's ffn_down: 7 chunks of 32 cells, 14 warps of 16, so each warp's
    # ring (4 cells with a min side) refills; 16-byte scale loads whose
    # super-block index wraps (nd 56)
    (14336, 32, "compact", True, False, 0),
    # Q6_K's ffn_down: nsub 896, 14 chunks of 16 cells through rings of 8
    (14336, 16, "compact", False, True, 0),
    # the same wrap at nd 12: 3 chunks
    (3072, 32, "compact", True, False, 0),
    # nsub 33: a ragged last cell (in % 64 == 16) and 9 one-cell chunks
    (528, 16, "flat", False, False, 8),
    # nsub 136: 17 chunks of 2 cells dealt two a warp over 9 warps
    (2176, 16, "flat", True, False, 0),
]


@pytest.mark.parametrize("B", [1, 4, 7, 9])
@pytest.mark.parametrize("in_f,sub,layout,has_min,signed,bias", GEOMETRIES_8BIT, ids=str)
def test_8bit_kernel_geometry(emu, in_f, sub, layout, has_min, signed, bias, B):
    """The 8-bit decode kernel where nsub does not divide the lanes' step,
    where a row splits over several warps, where K is ragged; B = 1, 4, 7
    and 9 (a second tile of activation rows), 13 output rows (a ragged
    block of 8)."""
    mod, launches = emu
    g = torch.Generator().manual_seed(in_f + sub + B)
    codes, d, sc, dmin, mn = _arrays(8, 13, in_f, sub, layout, has_min, signed, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    args = (x, codes, d, sc, sub, bias, dmin, mn)
    name = qm.NAME_8BIT_MIN if has_min else qm.NAME_8BIT
    before = launches.get(name, 0)
    _close(mod.quant_matmul_8bit_decode(*args), qm.quant_matmul_8bit_plain(*args))
    assert launches[name] == before + 1


def _int8_arrays(out_f, in_f, sub, layout, nd, has_min, signed, mn_signed, g):
    """Planar 4-bit codes and one layout's sides, compact ones ``nd`` wide."""
    nsub = in_f // sub
    codes = torch.randint(0, 256, (out_f, in_f // 2), generator=g, dtype=torch.uint8)

    def f32(n):
        return torch.rand(out_f, n, generator=g) * 0.02 + 1e-3

    def u8(s):
        lo = -32 if s else 0
        return torch.randint(lo, lo + 64, (out_f, nsub), generator=g,
                             dtype=torch.int32).to(torch.int8 if s else torch.uint8)
    if layout == "flat":
        return codes, f32(nsub), None, (f32(nsub) if has_min else None), None
    return codes, f32(nd), u8(signed), (f32(nd) if has_min else None), \
        (u8(mn_signed) if has_min else None)


# (in, sub, layout, nd, has_min, signed sc, bias, signed mn): the int8 decode
# kernel's steps of 16 sub-blocks (nsub % 16 == 0) or of 4, on m16n8k32 (sub
# 32) or m16n8k16. The emulated card has 4 SMs; at 13 output rows (two row
# groups of 8, one ragged) a block holds both or walks them as two tiles, and
# a row group's steps split over up to 16 warps.
GEOMETRIES_INT8 = [
    # nsub 4: one step of 4 sub-blocks, sub 32 through two k16 steps
    (128, 32, "flat", 4, True, False, 0, False),
    # nsub 12, Q3_K-like (sub 16, bias 4, i8 sc), nd 3: the scales one at a time
    (192, 16, "compact", 3, False, True, 4, False),
    # nsub 12, sub 32, u8 sc and mn, nd 4
    (384, 32, "compact", 4, True, False, 0, False),
    # Q4_K flat at in 4096: nsub 128, 8 steps, one a warp
    (4096, 32, "flat", 128, True, False, 0, False),
    # Q4_K compact: nd 16, u8 sc and mn
    (4096, 32, "compact", 16, True, False, 0, False),
    # Q4_0: flat, bias 8, no min side
    (4096, 32, "flat", 128, False, False, 8, False),
    # Q3_K compact at in 4096: nsub 256 on m16n8k16, i8 sc, bias 4
    (4096, 16, "compact", 16, False, True, 4, False),
    # Q4_K's ffn_down: nsub 448, 28 steps over 14 warps, the super-block
    # index wrapping (nd 56); at B 9 activation tiles of 4 rows (8 would
    # take over half the shared memory)
    (14336, 32, "compact", 56, True, False, 0, False),
    # nsub 200 (no multiple of 16): 50 steps of 4 sub-blocks over 13 warps,
    # 4 each, so each ring refills within a tile; i8 sc and mn, nd 25
    (6400, 32, "compact", 25, True, True, 0, True),
    # nsub 896 at sub 32: 56 steps over 14 warps, 4 each, the m16n8k32 ring
    # refilling; at B 9 activation tiles of 2 rows
    (28672, 32, "flat", 896, False, False, 8, False),
    # nsub 48 on m16n8k16, nd 3: 16-sub-block steps whose compact scales
    # come one at a time
    (768, 16, "compact", 3, True, False, 4, False),
    # sub 24 (two k16 steps, the second half past the sub-block) and sub 64
    # (four)
    (768, 24, "flat", 32, True, False, 0, False),
    (1024, 64, "compact", 4, False, True, 0, False),
]


@pytest.mark.parametrize("B", [1, 4, 7, 9])
@pytest.mark.parametrize("in_f,sub,layout,nd,has_min,signed,bias,mn_signed", GEOMETRIES_INT8,
                         ids=str)
def test_int8_kernel_geometry(emu, in_f, sub, layout, nd, has_min, signed, bias, mn_signed, B):
    """The int8 decode kernel where nsub is not a multiple of 16, where a
    row splits over several warps and their rings refill, at sub-blocks of
    16, 32 and other even sizes, flat and compact sides (u8 and i8 factors,
    with and without a min side), bias 0, 4 and 8; B = 1, 4, 7 and 9 (a
    second tile of activation rows), 13 output rows (a ragged block of 8)."""
    mod, launches = emu
    g = torch.Generator().manual_seed(in_f + sub + B)
    arrs = _int8_arrays(13, in_f, sub, layout, nd, has_min, signed, mn_signed, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xq, xs = qm.quantize_acts(x, sub)
    args = (xq, xs, qm._block_sums(x, sub), *arrs, bias)
    before = launches.get(qm.NAME_4BIT_INT8, 0)
    _close(mod.quant_matmul_4bit_int8_decode(*args), qm.quant_matmul_4bit_int8_plain(*args))
    assert launches[qm.NAME_4BIT_INT8] == before + 1


@pytest.mark.parametrize("B", [8, 9])
def test_int8_kernel_persistent_tiles(emu, B):
    """Blocks walking several tiles: 200 output rows (25 row groups) at in
    11520 (nsub 360, no multiple of 16) go to fewer blocks in x than there
    are row groups, each block staging its activations once (115 KB at 8
    rows) and walking its tiles with its rings running on from one tile into
    the next; each row group's 90 steps split over 15 warps, 6 each, so the
    rings also refill within a tile; B 9 takes two activation tiles;
    compact i8 sc, u8 mn, nd 45."""
    import ctypes
    mod, launches = emu
    out_f, in_f, sub = 200, 11520, 32
    g = torch.Generator().manual_seed(B)
    arrs = _int8_arrays(out_f, in_f, sub, "compact", 45, True, True, False, g)
    info = (ctypes.c_int * 8)()
    _build.check(mod._build.library("quant_matmul").lgt_quant_matmul_int8_plan(
        B, in_f, out_f, in_f // sub, qm.SIDE_HIER_I8, qm.SIDE_HIER_U8, info), "plan")
    assert info[0] < 25 and info[7] == 2
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xq, xs = qm.quantize_acts(x, sub)
    args = (xq, xs, qm._block_sums(x, sub), *arrs, 0)
    _close(mod.quant_matmul_4bit_int8_decode(*args), qm.quant_matmul_4bit_int8_plain(*args))


def _lowbit_arrays(bits, out_f, in_f, sub, layout, nd, has_min, signed, g):
    """Planar 2/4-bit codes and one layout's sides: flat (f32 per
    sub-block), compact (f32 ``nd`` wide times an 8-bit factor per
    sub-block) or mixed (the scale flat, the min side ``nd`` wide times u8
    factors)."""
    nsub = in_f // sub
    codes = torch.randint(0, 256, (out_f, in_f * bits // 8), generator=g, dtype=torch.uint8)

    def f32(n):
        return torch.rand(out_f, n, generator=g) * 0.02 + 1e-3

    def u8(s):
        lo = -32 if s else 0
        return torch.randint(lo, lo + 64, (out_f, nsub), generator=g,
                             dtype=torch.int32).to(torch.int8 if s else torch.uint8)
    if layout == "flat":
        return codes, f32(nsub), None, (f32(nsub) if has_min else None), None
    if layout == "compact":
        return codes, f32(nd), u8(signed), (f32(nd) if has_min else None), \
            (u8(False) if has_min else None)
    return codes, f32(nsub), None, f32(nd), u8(False)


# each rule's decode wrapper, plain version and launch name
_LOWBIT_RULES = {
    "fsplit": lambda bits: (f"quant_matmul_{bits}bit_decode", f"quant_matmul_{bits}bit_plain",
                            qm.NAME_2BIT if bits == 2 else qm.NAME_4BIT),
    "xsum": lambda bits: ("quant_matmul_4bit_xsum_decode", "quant_matmul_4bit_xsum_plain",
                          qm.NAME_4BIT_XSUM),
    "split": lambda bits: ("quant_matmul_4bit_split_decode", "quant_matmul_4bit_split_plain",
                           qm.NAME_4BIT_SPLIT),
    "base": lambda bits: ("quant_matmul_4bit_base_decode", "quant_matmul_4bit_base_plain",
                          qm.NAME_4BIT_BASE),
    "base_f32": lambda bits: ("quant_matmul_lowbit_base_decode",
                              "quant_matmul_lowbit_base_plain", qm.NAME_LOWBIT_BASE)}


def _lowbit_call(mod, rule, bits, x, xsum, arrs, bias, fmt):
    """The decode kernel's and the plain version's outputs of one rule, and
    the launch name it counts under."""
    kern, plain, name = _LOWBIT_RULES[rule](bits)
    if rule == "base":
        args = (x, *arrs, bias)
    elif rule == "base_f32":
        args = (x, *arrs, bias, bits, fmt)
    else:
        args = (x, xsum, *arrs, bias, fmt)
    return getattr(mod, kern)(*args), getattr(qm, plain)(*args), name


# (bits, in, sub, layout, nd, has_min, signed sc, bias, fmt, rules): the
# decode kernel's steps of 16 sub-blocks (R = in*bits/8/nsub = 16 code rows
# a sub-block: Q4_K, Q4_0), of 32 (R <= 8: Q3_K, Q2_K, sub 8) and its
# generic instance (nsub % 16 != 0, or R > 16). The emulated card has 4
# SMs; at 13 output rows (two row groups, one ragged) a block holds both or
# walks them as two tiles, and a row group's steps split over up to 16
# warps.
GEOMETRIES_LOWBIT = [
    # Q4_K flat, compact (nd 4, u8 sc and mn) and mixed (dmin per 256)
    (4, 1024, 32, "flat", 32, True, False, 0, "", ("fsplit", "xsum", "split", "base")),
    (4, 1024, 32, "compact", 4, True, False, 0, "", ("fsplit", "xsum", "split", "base")),
    (4, 1024, 32, "mixed", 4, True, False, 0, "", ("fsplit", "xsum", "split")),
    # Q4_0: flat, bias 8, no min side
    (4, 1024, 32, "flat", 32, False, False, 8, "", ("fsplit", "xsum", "base")),
    # Q3_K: sub 16 (8 code rows, steps of 32 sub-blocks), i8 sc, bias 4
    (4, 1024, 16, "compact", 4, False, True, 4, "", ("fsplit", "split", "base")),
    # Q2_K: sub 16 (4 code rows), mixed, flat and compact (i8 sc)
    (2, 1024, 16, "mixed", 4, True, False, 0, "", ("fsplit",)),
    (2, 1024, 16, "flat", 64, True, False, 0, "", ("fsplit", "base_f32")),
    (2, 1024, 16, "compact", 4, True, True, 0, "", ("fsplit", "base_f32")),
    # IQ1's 2-bit geometry: sub 8 (2 code rows, a piece a lane a step), bias 1
    (2, 1024, 8, "compact", 4, False, True, 1, "", ("fsplit", "base_f32")),
    # nd 6 (the super-block values copied 4 bytes at a time), min side too
    (4, 1536, 32, "compact", 6, True, False, 0, "", ("fsplit", "base")),
    # Q4_K's ffn_down at a narrow out: nsub 448, 28 steps over 14 warps, 2
    # each, so each ring refills; the super-block index wrapping (nd 56)
    (4, 14336, 32, "compact", 56, True, False, 0, "", ("fsplit",)),
    # Q2_K's ffn_down: nsub 896, steps of 32 sub-blocks
    (2, 14336, 16, "mixed", 56, True, False, 0, "", ("fsplit",)),
    # nsub 12 and 24 (no multiple of 16): the generic instance
    (4, 384, 32, "flat", 12, True, False, 0, "", ("fsplit", "xsum", "split", "base")),
    (2, 384, 16, "compact", 3, True, True, 0, "", ("fsplit", "base_f32")),
    # sub 64: 32 code rows a sub-block, the generic instance
    (4, 2048, 64, "compact", 8, False, False, 4, "", ("fsplit", "base")),
    # the IQ2/IQ3 code->value maps, no min side
    (4, 1024, 32, "flat", 32, False, False, 0, "iq2_xs", ("fsplit", "base_f32")),
    (4, 1024, 32, "compact", 4, False, False, 0, "iq3_s", ("fsplit", "base_f32")),
]
_GEOM_CASES = [(geo[:-1], rule) for geo in GEOMETRIES_LOWBIT for rule in geo[-1]]


@pytest.mark.parametrize("B", [1, 4, 7, 9])
@pytest.mark.parametrize("geo,rule", _GEOM_CASES, ids=str)
def test_lowbit_kernel_geometry(emu, geo, rule, B):
    """The 2/4-bit decode kernel at every rule, flat, compact and mixed
    sides, sub-blocks of 8, 16, 32 and 64 (bias 0, 1, 4 and 8, u8 and i8
    factors), the IQ2/IQ3 maps, nsub 12 to 896; B = 1, 4, 7 and 9 (a second
    tile of activation rows), 13 output rows (a ragged row group)."""
    bits, in_f, sub, layout, nd, has_min, signed, bias, fmt = geo
    mod, launches = emu
    g = torch.Generator().manual_seed(in_f + sub + B + bits)
    arrs = _lowbit_arrays(bits, 13, in_f, sub, layout, nd, has_min, signed, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xsum = qm._block_sums(x, sub)
    if layout == "mixed":
        xsum = qm._mixed_xsum(xsum, types.SimpleNamespace(
            min_size=in_f // nd, sub_size=sub, in_features=in_f))
    name = _LOWBIT_RULES[rule](bits)[2]
    before = launches.get(name, 0)
    got, want, _ = _lowbit_call(mod, rule, bits, x, xsum, arrs, bias, fmt)
    _close(got, want)
    assert launches[name] == before + 1


@pytest.mark.parametrize("bits,rule", [(4, "fsplit"), (2, "fsplit"), (4, "base")])
def test_lowbit_kernel_persistent_tiles(emu, bits, rule):
    """Blocks walking several tiles: 811 output rows (102 row groups, the
    last ragged) at in 2048 go to fewer blocks than there are tiles, each
    warp walking several row groups a tile, the warps' rings running on
    from one tile into the next and each tile's partial sums alternating
    between two buffers; B 9 takes two activation tiles; compact u8 sc and
    mn (Q4_K-like) or mixed (Q2_K-like)."""
    import ctypes
    mod, _ = emu
    out_f, in_f, B = 811, 2048, 9
    sub = 32 if bits == 4 else 16
    layout = "mixed" if bits == 2 else "compact"
    g = torch.Generator().manual_seed(bits)
    arrs = _lowbit_arrays(bits, out_f, in_f, sub, layout, 8, True, False, g)
    info = (ctypes.c_int * 8)()
    var = qm.VAR_BASE if rule == "base" else qm.VAR_FSPLIT
    _build.check(mod._build.library("quant_matmul").lgt_quant_matmul_lowbit_plan(
        B, in_f, out_f, in_f // sub, qm._side(arrs[1], arrs[2]), qm._side(arrs[3], arrs[4]),
        bits, var, 0, info), "plan")
    assert info[0] < 102 // 8 and info[1] == 2 and info[7] == (0 if bits == 4 else 1)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xsum = qm._block_sums(x, sub)
    if layout == "mixed":
        xsum = qm._mixed_xsum(xsum, types.SimpleNamespace(min_size=256, sub_size=sub,
                                                          in_features=in_f))
    got, want, _ = _lowbit_call(mod, rule, bits, x, xsum, arrs, 0, "")
    _close(got, want)


@pytest.mark.parametrize("B", [1, 2])
def test_lowbit_kernel_long_row(emu, B):
    """A row whose one staged activation row and warp regions pass a block's
    shared memory (in 114688: 229 KB of staged bf16 a row) takes the generic
    instance, as the plan reports, and still matches the plain version."""
    import ctypes
    mod, launches = emu
    in_f, sub = 114688, 32
    g = torch.Generator().manual_seed(B)
    arrs = _lowbit_arrays(4, 9, in_f, sub, "compact", in_f // 256, True, False, g)
    info = (ctypes.c_int * 8)()
    _build.check(mod._build.library("quant_matmul").lgt_quant_matmul_lowbit_plan(
        B, in_f, 9, in_f // sub, qm.SIDE_HIER_U8, qm.SIDE_HIER_U8, 4, qm.VAR_FSPLIT, 0, info),
        "plan")
    assert info[7] == 2
    x = torch.randn(B, in_f, generator=g).bfloat16()
    got, want, _ = _lowbit_call(mod, "fsplit", 4, x, qm._block_sums(x, sub), arrs, 0, "")
    _close(got, want)
