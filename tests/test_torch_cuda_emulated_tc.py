"""The tensor-core matmul sources run on the CPU: ``csrc/quant_matmul_tc.cu``
(8-bit codes) and ``csrc/quant_matmul_lowbit_tc.cu`` (2- and 4-bit codes; the
fsplit, xsum, base and base_f32 rules; split through xsum's instances), both
on Hopper's ``wgmma``, TMA and mbarriers, and ``csrc/quant_matmul_int8_tc.cu``
(int8 activations on s8 ``wgmma``, TMA and mbarriers) compiled by g++
against the stand-in headers of ``tests/cuda_emu`` (``tc_emu.h``: whole
blocks of threads; mbarriers, 2D TMA tile loads that land when their phase
completes and ``wgmma`` (bf16, and s8 at k32) run at the wait that retires
it; ``cuda.h``: tensor maps), with the inline-PTX helpers of
``csrc/tc_common.cuh`` swapped for those stand-ins, driven through the
port's own wrappers with their device check lifted, against the plain
PyTorch versions.

This holds the kernels' tiling, their rings of stages, their chunked walk
over the sub-blocks, the 8-bit kernel's double-buffered factor stages, the
2/4-bit kernel's plane groups and min-term epilogue, and their ragged
edges to the plain versions where no card is present; what nvcc makes of the sources, and the PTX itself, are checked
only on the card (``test_torch_cuda_kernels.py``). Tolerance: the same bf16
weights and exact bf16 products on both sides (the int8 kernel: the same
exact int32 sums per sub-block), f32 sums in another order: 1e-5 of the
output's scale. Skips where there is no g++ with C++20.
"""

import ctypes
import os
import re
import shutil
import subprocess
import types

import pytest
import torch

from llama_gguf_inference_tpu_torch.ops import _build
from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "llama_gguf_inference_tpu_torch", "csrc")
SOURCES = ("quant_matmul_tc", "quant_matmul_lowbit_tc", "quant_matmul_int8_tc")
TOL = 1e-5


def _emulated_source(name: str) -> str:
    """``csrc/<name>.cu`` for g++: the shared header inlined with its PTX
    section cut (``tc_emu.h`` stands in for it), the dynamic shared memory
    and the launches routed through the stand-ins."""
    with open(os.path.join(CSRC, "tc_common.cuh")) as f:
        hdr = f.read()
    start, end = hdr.index("// PTX: "), hdr.index("// end PTX")
    with open(os.path.join(CSRC, name + ".cu")) as f:
        src = f.read()
    src = src.replace('#include "tc_common.cuh"', '#include "tc_emu.h"\n' + hdr[:start] + hdr[end:])
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_smem();")
    return re.sub(r"([A-Za-z_0-9]+<[^<>;]*>)<<<([^>]*)>>>\(([^)]*)\);",
                  r"emu_launch_block(\2, [&]() { \1(\3); });", src)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """``ops.quant_matmul``'s wrappers over the g++ builds of the CUDA
    sources (the dispatching 2/4-bit, base and int8 wrappers see every
    tensor as on the card, and each decode kernel as a stand-in that counts
    its launch and returns the plain version), and the launches they
    count."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel")
    d = tmp_path_factory.mktemp("cuda_emu_tc")
    procs = {}
    for name in SOURCES:
        cpp, lib = d / f"{name}.cpp", d / f"{name}.so"
        cpp.write_text(_emulated_source(name))
        procs[name] = (subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
             "-I", os.path.join(HERE, "cuda_emu"), "-I", CSRC, str(cpp), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0 and "barrier" in err and "No such file" in err:
            pytest.skip("g++ lacks C++20's <barrier>")
        assert proc.returncode == 0, err[-3000:]
        libs[name] = _build._bind(name, ctypes.CDLL(str(lib)))
    launches: dict[str, int] = {}
    fake_build = types.SimpleNamespace(
        library=lambda name: libs[name], check=_build.check,
        count=lambda name: launches.__setitem__(name, launches.get(name, 0) + 1))
    with open(qm.__file__) as f:
        wsrc = f.read()
    wsrc = wsrc.replace('if dev.type != "cuda":', "if False:")
    wsrc = wsrc.replace('return t.device.type == "cuda"', "return True")
    wsrc = wsrc.replace("torch.cuda.current_stream(dev).cuda_stream", "0")
    wsrc = wsrc.replace("from . import _build\n", "")
    wsrc = wsrc.replace("from .linear import", "from llama_gguf_inference_tpu_torch.ops.linear import")
    mod = types.ModuleType("quant_matmul_tc_emulated")
    exec(compile(wsrc, "quant_matmul_tc_emulated", "exec"), mod.__dict__)
    mod._build = fake_build
    for wrapper, name, plain in (
            ("quant_matmul_2bit", qm.NAME_2BIT, qm.quant_matmul_2bit_plain),
            ("quant_matmul_4bit", qm.NAME_4BIT, qm.quant_matmul_4bit_plain),
            ("quant_matmul_4bit_base", qm.NAME_4BIT_BASE, qm.quant_matmul_4bit_base_plain),
            ("quant_matmul_lowbit_base", qm.NAME_LOWBIT_BASE, qm.quant_matmul_lowbit_base_plain),
            ("quant_matmul_4bit_int8", qm.NAME_4BIT_INT8, qm.quant_matmul_4bit_int8_plain),
            ("quant_matmul_4bit_xsum", qm.NAME_4BIT_XSUM, qm.quant_matmul_4bit_xsum_plain),
            ("quant_matmul_4bit_split", qm.NAME_4BIT_SPLIT, qm.quant_matmul_4bit_split_plain)):

        def decode(*args, _name=name, _plain=plain):
            fake_build.count(_name)
            return _plain(*args)
        setattr(mod, f"{wrapper}_decode", decode)
    return mod, launches


def _rel_err(got, want):
    assert torch.isfinite(got).all()
    return (got - want).abs().max().item() / want.abs().max().item()


def _arrays(out_f, in_f, sub, layout, has_min, signed, g):
    """8-bit codes with flat sides (f32 per sub-block) or compact ones (f32
    per 256 times an 8-bit factor per sub-block)."""
    nsub, nd = in_f // sub, in_f // 256
    codes = torch.randint(-128, 128, (out_f, in_f), generator=g, dtype=torch.int32).to(torch.int8)

    def f32(n):
        return torch.rand(out_f, n, generator=g) * 0.02 + 1e-3

    def u8(s):
        if s:
            return torch.randint(-32, 32, (out_f, nsub), generator=g, dtype=torch.int32).to(torch.int8)
        return torch.randint(0, 64, (out_f, nsub), generator=g, dtype=torch.int32).to(torch.uint8)
    if layout == "flat":
        return codes, f32(nsub), None, (f32(nsub) if has_min else None), None
    return codes, f32(nd), u8(signed), (f32(nd) if has_min else None), \
        (u8(False) if has_min else None)


# (B, out, in, sub, layout, has min, signed sc, bias): every (scale side, min
# side) instance over two 128-row output tiles (out ragged) of one 64-row
# activation tile, and over 2 x 2 tiles of 128 activation rows (rows and
# out ragged); one sub-block chunk of 32 steps (in 2048, sub 32) or three of
# 16 whose runs wrap the 12 super-blocks (in 3072, sub 16)
CASES = [(20, 136, 2048, 32, "flat", False, False, 0),
         (20, 136, 2048, 32, "flat", True, False, 16),
         (20, 136, 3072, 16, "compact", False, True, 0),
         (20, 136, 2048, 32, "compact", True, False, 0),
         (20, 136, 3072, 16, "compact", False, False, 4),
         (20, 136, 2048, 32, "compact", True, True, 0),
         (130, 136, 3072, 16, "compact", True, False, 0),
         (130, 136, 2048, 32, "flat", False, False, 16)]


@pytest.mark.parametrize("B,out_f,in_f,sub,layout,has_min,signed,bias", CASES, ids=str)
def test_8bit_tc_kernel(emu, B, out_f, in_f, sub, layout, has_min, signed, bias):
    """Q8_0/Q5_0/Q5_1-like flat sides, Q6_K/IQ4_XS-like i8 sc, Q5_K-like u8 sc
    and mn, against the plain version."""
    mod, launches = emu
    g = torch.Generator().manual_seed(B + in_f + sub + bias + has_min)
    codes, d, sc, dmin, mn = _arrays(out_f, in_f, sub, layout, has_min, signed, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    args = (x, codes, d, sc, sub, bias, dmin, mn)
    name = qm.NAME_8BIT_MIN_TC if has_min else qm.NAME_8BIT_TC
    before = launches.get(name, 0)
    got = mod.quant_matmul_8bit_tc(*args)
    assert launches[name] == before + 1
    want = qm.quant_matmul_8bit_plain(*args)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


def _8bit_side_arrays(out_f, in_f, sub, s_side, m_side, g):
    """int8 codes with the 8-bit kernel's (scale side, min side): ``flat``
    (f32 per sub-block), ``u8`` or ``i8`` (f32 per 256 times an 8-bit
    factor per sub-block), or ``none`` for the min."""
    nsub, nd = in_f // sub, in_f // 256
    codes = torch.randint(-128, 128, (out_f, in_f), generator=g, dtype=torch.int32).to(torch.int8)

    def f32(n):
        return torch.rand(out_f, n, generator=g) * 0.02 + 1e-3

    def factor(side):
        if side == "i8":
            return torch.randint(-32, 32, (out_f, nsub), generator=g, dtype=torch.int32).to(torch.int8)
        return torch.randint(0, 64, (out_f, nsub), generator=g, dtype=torch.int32).to(torch.uint8)
    d, sc = (f32(nsub), None) if s_side == "flat" else (f32(nd), factor(s_side))
    if m_side == "none":
        return codes, d, sc, None, None
    if m_side == "flat":
        return codes, d, sc, f32(nsub), None
    return codes, d, sc, f32(nd), factor(m_side)


# (B, out, in, sub, bias, scale side, min side) of the wgmma 8-bit kernel:
# all six (scale side, min side) pairs it takes; sub-blocks of 32 and 16,
# biases 4 and 16; B of 8, 16, 33, 64 (64-row activation tiles, ragged at 8,
# 16 and 33), 200 and 512 (128-row tiles, ragged at 200); out 72, 136, 200
# and 264 (ragged 128-row output tiles); grids of up to the stand-in's 4 SMs
# walking up to 3 tiles each (6 and 12 tiles); in 1024 and 2048 (two or
# four chunks of 64 sub-blocks, one to four of them a tile's whole walk),
# and 14336 (ffn_down: 448 sub-blocks in 7 chunks whose 56 super-blocks
# wrap inside a chunk); sub-blocks of 3 (in 192: three steps, the last one
# alone in its buffer)
EIGHT_WGMMA_CASES = [(8, 200, 2048, 32, 0, "flat", "none"),
                     (16, 136, 1024, 16, 16, "flat", "flat"),
                     (33, 264, 2048, 32, 4, "u8", "none"),
                     (64, 136, 1024, 16, 0, "u8", "u8"),
                     (200, 264, 2048, 32, 0, "i8", "none"),
                     (512, 264, 1024, 16, 0, "i8", "u8"),
                     (33, 72, 14336, 32, 0, "u8", "u8"),
                     (20, 136, 192, 3, 0, "flat", "flat")]


@pytest.mark.parametrize("B,out_f,in_f,sub,bias,s_side,m_side", EIGHT_WGMMA_CASES, ids=str)
def test_8bit_tc_wgmma_sides(emu, B, out_f, in_f, sub, bias, s_side, m_side):
    """Every (scale side, min side) instance of the wgmma 8-bit kernel at
    prefill row counts, through its tensor-core wrapper, against the plain
    version of _make_kernel's 8-bit branch."""
    mod, launches = emu
    g = torch.Generator().manual_seed(B + out_f + in_f + sub + bias + len(s_side + m_side))
    codes, d, sc, dmin, mn = _8bit_side_arrays(out_f, in_f, sub, s_side, m_side, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    args = (x, codes, d, sc, sub, bias, dmin, mn)
    name = qm.NAME_8BIT_TC if m_side == "none" else qm.NAME_8BIT_MIN_TC
    before = launches.get(name, 0)
    got = mod.quant_matmul_8bit_tc(*args)
    assert launches[name] == before + 1
    assert _rel_err(got, qm.quant_matmul_8bit_plain(*args)) <= TOL


def _lowbit_arrays(bits, out_f, in_f, sub, layout, has_min, signed, g):
    """2/4-bit planar codes with flat sides (f32 per sub-block), compact ones
    (f32 per 256 times an 8-bit factor per sub-block) or the mixed layout
    (flat scale, compact min)."""
    nsub, nd = in_f // sub, in_f // 256
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


# (bits, B, out, in, sub, bias, layout, has min, signed sc, code map): Q4_K
# (flat, compact, mixed), Q3_K's sub-blocks of 16 with bias 4 (i8 sc), Q4_0's
# bias 8, the IQ2/IQ3 maps, Q2_K (flat, compact, mixed; bias 1 beside a
# compact min); nsub 64 and 128; B of 1, 7, 8 and 130; out 72 and 136 (64-row
# tiles where the stand-in's 4 SMs would be left without a block, 128-row
# tiles over 2 x 2 blocks at 130 rows)
LOWBIT_CASES = [(4, 130, 136, 2048, 32, 0, "flat", True, False, ""),
                (4, 7, 136, 2048, 32, 0, "compact", True, False, ""),
                (4, 8, 72, 2048, 32, 0, "mixed", True, False, ""),
                (4, 1, 136, 1024, 16, 4, "compact", False, True, ""),
                (4, 130, 72, 2048, 16, 4, "flat", False, False, ""),
                (4, 8, 72, 2048, 32, 8, "flat", False, False, ""),
                (4, 8, 72, 2048, 32, 0, "flat", False, False, "iq2_xs"),
                (4, 7, 72, 2048, 32, 0, "compact", False, False, "iq3_s"),
                (2, 130, 136, 1024, 16, 0, "mixed", True, False, ""),
                (2, 7, 136, 2048, 16, 0, "flat", True, False, ""),
                (2, 1, 72, 1024, 16, 0, "compact", True, False, ""),
                (2, 8, 72, 1024, 16, 1, "compact", True, True, "")]


@pytest.mark.parametrize("bits,B,out_f,in_f,sub,bias,layout,has_min,signed,fmt", LOWBIT_CASES,
                         ids=str)
def test_lowbit_tc_kernel(emu, bits, B, out_f, in_f, sub, bias, layout, has_min, signed, fmt):
    """The tensor-core 2/4-bit kernel against the plain version of the
    fsplit rule, through its own wrapper at any B; a compact case with a min
    side once more without it."""
    mod, launches = emu
    g = torch.Generator().manual_seed(bits * 1000 + B + in_f + sub + bias)
    codes, d, sc, dmin, mn = _lowbit_arrays(bits, out_f, in_f, sub, layout, has_min, signed, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xsum = qm._block_sums(x, sub)
    name = qm.NAME_4BIT_TC if bits == 4 else qm.NAME_2BIT_TC
    kernel, plain = getattr(mod, name), getattr(qm, f"quant_matmul_{bits}bit_plain")
    if layout == "mixed":
        w = types.SimpleNamespace(min_size=256, sub_size=sub, in_features=in_f)
        xsum = qm._mixed_xsum(xsum, w)
    mins = [(dmin, mn)] + ([(None, None)] if has_min and layout == "compact" else [])
    for dm, m in mins:
        args = (x, xsum, codes, d, sc, dm, m, bias, fmt)
        before = launches.get(name, 0)
        got = kernel(*args)
        assert launches[name] == before + 1
        want = plain(*args)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


@pytest.mark.parametrize("bits", [2, 4])
def test_lowbit_dispatch_by_rows(emu, bits):
    """The dispatching wrapper on the card: below LOWBIT_TC_MIN_ROWS rows the
    decode kernel, from it up the tensor-core kernel; a geometry the
    tensor-core kernel does not take (nsub 48) keeps the decode kernel."""
    mod, launches = emu
    g = torch.Generator().manual_seed(bits)
    sub = 32 if bits == 4 else 16
    tc, dec = (qm.NAME_4BIT_TC, qm.NAME_4BIT) if bits == 4 else (qm.NAME_2BIT_TC, qm.NAME_2BIT)
    wrapper, plain = getattr(mod, f"quant_matmul_{bits}bit"), getattr(qm, f"quant_matmul_{bits}bit_plain")
    for in_f, B, want in ((64 * sub, qm.LOWBIT_TC_MIN_ROWS - 1, dec),
                          (64 * sub, qm.LOWBIT_TC_MIN_ROWS, tc), (48 * sub, 20, dec)):
        codes, d, sc, dmin, mn = _lowbit_arrays(bits, 8, in_f, sub, "flat", True, False, g)
        x = torch.randn(B, in_f, generator=g).bfloat16()
        args = (x, qm._block_sums(x, sub), codes, d, sc, dmin, mn)
        launches.clear()
        got = wrapper(*args)
        assert launches == {want: 1}
        want_y = plain(*args)
        assert (got - want_y).abs().max().item() <= TOL * want_y.abs().max().item()


# (bits, rule, B, out, in, sub, bias, layout, has min, signed sc, code map):
# the base rule at Q4_K (flat, compact), Q4_0's bias 8 and Q3_K's
# sub-blocks of 16 with bias 4 (i8 sc); base_f32 at Q2_K (flat, compact)
# and the IQ2/IQ3 maps; nsub 64 and 128; B of 1, 7, 16 and 130; out 72 and
# 136 (64-row tiles, 2 x 2 blocks at 130 rows)
BASE_CASES = [(4, "base", 130, 136, 2048, 32, 0, "flat", True, False, ""),
              (4, "base", 7, 72, 4096, 32, 0, "compact", True, False, ""),
              (4, "base", 16, 72, 2048, 32, 8, "flat", False, False, ""),
              (4, "base", 1, 136, 1024, 16, 4, "compact", False, True, ""),
              (2, "base_f32", 130, 136, 1024, 16, 0, "flat", True, False, ""),
              (2, "base_f32", 7, 72, 2048, 16, 0, "compact", True, True, ""),
              (4, "base_f32", 16, 72, 2048, 32, 0, "flat", False, False, "iq2_xs"),
              (4, "base_f32", 7, 136, 2048, 32, 0, "compact", False, False, "iq3_s")]


@pytest.mark.parametrize("bits,rule,B,out_f,in_f,sub,bias,layout,has_min,signed,fmt", BASE_CASES,
                         ids=str)
def test_base_tc_kernel(emu, bits, rule, B, out_f, in_f, sub, bias, layout, has_min, signed, fmt):
    """The base and base_f32 rules of the tensor-core 2/4-bit kernel against
    the plain versions of _make_kernel's bf16-magic and f32 branches, through
    their own wrappers at any B; a case with a min side once more without
    it."""
    mod, launches = emu
    g = torch.Generator().manual_seed(bits * 1000 + B + in_f + sub + bias + len(fmt))
    codes, d, sc, dmin, mn = _lowbit_arrays(bits, out_f, in_f, sub, layout, has_min, signed, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    if rule == "base":
        name, kernel, plain = qm.NAME_4BIT_BASE_TC, mod.quant_matmul_4bit_base_tc, \
            qm.quant_matmul_4bit_base_plain
        tail = ()
    else:
        name, kernel, plain = qm.NAME_LOWBIT_BASE_TC, mod.quant_matmul_lowbit_base_tc, \
            qm.quant_matmul_lowbit_base_plain
        tail = (bits, fmt)
    for dm, m in [(dmin, mn)] + ([(None, None)] if has_min else []):
        args = (x, codes, d, sc, dm, m, bias, *tail)
        before = launches.get(name, 0)
        got = kernel(*args)
        assert launches[name] == before + 1
        assert _rel_err(got, plain(*args)) <= TOL


# (rule, B, out, in, sub, bias, layout, has min, signed sc): the xsum and
# split rules at Q4_K (flat, compact, mixed), Q4_0's bias 8 and Q3_K's
# sub-blocks of 16 with bias 4 (i8 sc); nsub 64 and 128; B of 1, 7, 16 and
# 130; out 72 and 136
XSUM_CASES = [("xsum", 130, 136, 2048, 32, 0, "flat", True, False),
              ("xsum", 7, 72, 4096, 32, 0, "compact", True, False),
              ("xsum", 16, 72, 2048, 32, 0, "mixed", True, False),
              ("xsum", 1, 136, 1024, 16, 4, "compact", False, True),
              ("split", 130, 72, 2048, 32, 8, "flat", False, False),
              ("split", 7, 136, 2048, 32, 0, "compact", True, True),
              ("split", 16, 136, 2048, 32, 0, "mixed", True, False),
              ("split", 1, 72, 2048, 16, 4, "flat", False, False)]


@pytest.mark.parametrize("rule,B,out_f,in_f,sub,bias,layout,has_min,signed", XSUM_CASES,
                         ids=str)
def test_xsum_split_tc_kernel(emu, rule, B, out_f, in_f, sub, bias, layout, has_min, signed):
    """The xsum rule of the tensor-core 2/4-bit kernel (the split body runs
    its instances) against the plain versions of _make_kernel_xsum and
    _make_kernel_split, through their own wrappers at any B; a compact case
    with a min side once more without it."""
    mod, launches = emu
    g = torch.Generator().manual_seed(B + in_f + sub + bias + len(rule))
    codes, d, sc, dmin, mn = _lowbit_arrays(4, out_f, in_f, sub, layout, has_min, signed, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xsum = qm._block_sums(x, sub)
    if layout == "mixed":
        w = types.SimpleNamespace(min_size=256, sub_size=sub, in_features=in_f)
        xsum = qm._mixed_xsum(xsum, w)
    name = qm.NAME_4BIT_XSUM_TC if rule == "xsum" else qm.NAME_4BIT_SPLIT_TC
    kernel, plain = getattr(mod, f"quant_matmul_4bit_{rule}_tc"), \
        getattr(qm, f"quant_matmul_4bit_{rule}_plain")
    for dm, m in [(dmin, mn)] + ([(None, None)] if has_min and layout == "compact" else []):
        args = (x, xsum, codes, d, sc, dm, m, bias)
        before = launches.get(name, 0)
        got = kernel(*args)
        assert launches[name] == before + 1
        assert _rel_err(got, plain(*args)) <= TOL


# (B, out, in, sub, bias, layout, has min, signed sc): Q4_K flat and compact
# (u8 or i8 sc beside a u8 min), Q4_1's flat min, Q4_0's bias 8, Q3_K's
# sub-blocks of 16 with bias 4 (flat and compact i8 sc; each sub-block its
# own wgmma, half of A zero); nsub 64 and 128 (4 and 8 groups of 16); B of
# 1, 7, 16 and 130; out 72 and 136 (ragged 128-row tiles)
INT8_CASES = [(130, 136, 2048, 32, 0, "flat", True, False),
              (7, 72, 4096, 32, 0, "compact", True, False),
              (16, 136, 2048, 32, 8, "flat", False, False),
              (1, 72, 2048, 32, 0, "compact", True, True),
              (16, 72, 2048, 16, 4, "compact", False, True),
              (130, 72, 1024, 16, 4, "flat", False, False)]


@pytest.mark.parametrize("B,out_f,in_f,sub,bias,layout,has_min,signed", INT8_CASES, ids=str)
def test_int8_tc_kernel(emu, B, out_f, in_f, sub, bias, layout, has_min, signed):
    """The tensor-core int8 kernel against the plain version of
    _make_kernel_int8 on quantize_acts' codes, through its own wrapper at any
    B; a case with a min side once more without it."""
    mod, launches = emu
    g = torch.Generator().manual_seed(B + in_f + sub + bias + 7 * has_min)
    codes, d, sc, dmin, mn = _lowbit_arrays(4, out_f, in_f, sub, layout, has_min, signed, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xq, xs = qm.quantize_acts(x, sub)
    xsum = qm._block_sums(x, sub)
    for dm, m in [(dmin, mn)] + ([(None, None)] if has_min else []):
        args = (xq, xs, xsum, codes, d, sc, dm, m, bias)
        before = launches.get(qm.NAME_4BIT_INT8_TC, 0)
        got = mod.quant_matmul_4bit_int8_tc(*args)
        assert launches[qm.NAME_4BIT_INT8_TC] == before + 1
        assert _rel_err(got, qm.quant_matmul_4bit_int8_plain(*args)) <= TOL


def _int8_arrays(out_f, in_f, sub, s_side, m_side, g):
    """4-bit planar codes with the int8 kernel's (scale side, min side):
    ``flat`` (f32 per sub-block), ``u8`` or ``i8`` (f32 per 256 times an
    8-bit factor per sub-block), or ``none`` for the min."""
    nsub, nd = in_f // sub, in_f // 256
    codes = torch.randint(0, 256, (out_f, in_f // 2), generator=g, dtype=torch.uint8)

    def f32(n):
        return torch.rand(out_f, n, generator=g) * 0.02 + 1e-3

    def factor(side):
        if side == "i8":
            return torch.randint(-32, 32, (out_f, nsub), generator=g, dtype=torch.int32).to(torch.int8)
        return torch.randint(0, 64, (out_f, nsub), generator=g, dtype=torch.int32).to(torch.uint8)
    d, sc = (f32(nsub), None) if s_side == "flat" else (f32(nd), factor(s_side))
    if m_side == "none":
        return codes, d, sc, None, None
    if m_side == "flat":
        return codes, d, sc, f32(nsub), None
    return codes, d, sc, f32(nd), factor(m_side)


# (B, out, in, sub, bias, scale side, min side) of the wgmma int8 kernel:
# all eight (scale side, min side) pairs it takes; sub-blocks of 32 and 16
# (Q3_K's bias 4), Q4_0's bias 8; B of 16, 33, 64 (64-row activation
# tiles), 200 and 512 (128-row tiles, ragged at 200); out 72, 136 and 200
# (ragged 128-row output tiles), grids of up to the stand-in's 4 SMs
# walking several tiles; nsub 16 (one group) to 128, and 448 (ffn_down's in
# 14336, a compact min side)
INT8_WGMMA_CASES = [(16, 136, 2048, 32, 8, "flat", "none"),
                    (33, 200, 512, 32, 0, "flat", "flat"),
                    (64, 136, 1024, 16, 4, "u8", "none"),
                    (200, 72, 1024, 32, 0, "u8", "u8"),
                    (512, 72, 1024, 32, 0, "u8", "i8"),
                    (33, 136, 2048, 16, 4, "i8", "none"),
                    (16, 200, 1024, 16, 0, "i8", "u8"),
                    (64, 72, 2048, 32, 0, "i8", "i8"),
                    (24, 72, 14336, 32, 0, "u8", "u8")]


@pytest.mark.parametrize("B,out_f,in_f,sub,bias,s_side,m_side", INT8_WGMMA_CASES, ids=str)
def test_int8_tc_wgmma_sides(emu, B, out_f, in_f, sub, bias, s_side, m_side):
    """Every (scale side, min side) instance of the wgmma int8 kernel at
    prefill row counts, through its tensor-core wrapper, against the plain
    version of _make_kernel_int8 on quantize_acts' codes."""
    mod, launches = emu
    g = torch.Generator().manual_seed(B + out_f + in_f + sub + bias + len(s_side + m_side))
    codes, d, sc, dmin, mn = _int8_arrays(out_f, in_f, sub, s_side, m_side, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xq, xs = qm.quantize_acts(x, sub)
    args = (xq, xs, qm._block_sums(x, sub), codes, d, sc, dmin, mn, bias)
    before = launches.get(qm.NAME_4BIT_INT8_TC, 0)
    got = mod.quant_matmul_4bit_int8_tc(*args)
    assert launches[qm.NAME_4BIT_INT8_TC] == before + 1
    assert _rel_err(got, qm.quant_matmul_4bit_int8_plain(*args)) <= TOL


@pytest.mark.parametrize("body", ["base", "base_f32", "int8", "xsum", "split"])
def test_base_int8_dispatch_by_rows(emu, body):
    """The dispatching base, int8, xsum and split wrappers on the card:
    below their row threshold the decode kernel, from it the tensor-core
    kernel; a geometry the tensor-core kernel does not take (nsub 48 for
    base, xsum and split, whose steps take 64 sub-blocks; nsub 40 for int8,
    whose groups take 16) keeps the decode kernel."""
    mod, launches = emu
    g = torch.Generator().manual_seed(len(body))
    bits, sub = (2, 16) if body == "base_f32" else (4, 32)
    rows = qm.INT8_TC_MIN_ROWS if body == "int8" else qm.LOWBIT_TC_MIN_ROWS
    tc, dec = {"base": (qm.NAME_4BIT_BASE_TC, qm.NAME_4BIT_BASE),
               "base_f32": (qm.NAME_LOWBIT_BASE_TC, qm.NAME_LOWBIT_BASE),
               "int8": (qm.NAME_4BIT_INT8_TC, qm.NAME_4BIT_INT8),
               "xsum": (qm.NAME_4BIT_XSUM_TC, qm.NAME_4BIT_XSUM),
               "split": (qm.NAME_4BIT_SPLIT_TC, qm.NAME_4BIT_SPLIT)}[body]
    odd = 40 if body == "int8" else 48
    for in_f, B, want in ((64 * sub, rows - 1, dec), (64 * sub, rows, tc), (odd * sub, 20, dec)):
        codes, d, sc, dmin, mn = _lowbit_arrays(bits, 8, in_f, sub, "flat", True, False, g)
        x = torch.randn(B, in_f, generator=g).bfloat16()
        if body == "int8":
            xq, xs = qm.quantize_acts(x, sub)
            args = (xq, xs, qm._block_sums(x, sub), codes, d, sc, dmin, mn)
            wrapper, plain = mod.quant_matmul_4bit_int8, qm.quant_matmul_4bit_int8_plain
        elif body == "base":
            args = (x, codes, d, sc, dmin, mn)
            wrapper, plain = mod.quant_matmul_4bit_base, qm.quant_matmul_4bit_base_plain
        elif body in ("xsum", "split"):
            args = (x, qm._block_sums(x, sub), codes, d, sc, dmin, mn)
            wrapper = getattr(mod, f"quant_matmul_4bit_{body}")
            plain = getattr(qm, f"quant_matmul_4bit_{body}_plain")
        else:
            args = (x, codes, d, sc, dmin, mn, 0, bits)
            wrapper, plain = mod.quant_matmul_lowbit_base, qm.quant_matmul_lowbit_base_plain
        launches.clear()
        got = wrapper(*args)
        assert launches == {want: 1}
        assert _rel_err(got, plain(*args)) <= TOL


# The operand address of a K-major bf16 tile with the 128-byte swizzle, as
# the PTX ISA lays it out for wgmma's descriptors (and TMA's
# CU_TENSOR_MAP_SWIZZLE_128B writes it): row r at (r // 8) * 1024 + (r % 8)
# * 128 from the start address, element k at 2 * k, then the 16-byte chunk
# index (address bits 4-6) XORed with the row within its 8-row group
# (address bits 7-9). (tile offset, start advance in 16-byte units, row, k)
# -> byte offset, worked by hand.
DESC_TABLE = [(0, 0, 0, 0, 0), (0, 0, 0, 8, 16), (0, 0, 1, 0, 144), (0, 0, 1, 8, 128),
              (0, 0, 3, 5, 442), (0, 0, 7, 15, 1006), (0, 0, 8, 0, 1024), (0, 0, 9, 0, 1168),
              (0, 2, 0, 0, 32), (0, 2, 1, 0, 176), (0, 2, 5, 3, 758), (0, 6, 7, 15, 910),
              (2048, 0, 2, 1, 2338), (2048, 4, 10, 9, 3442)]
# (offset, mode) -> where a TMA copy's byte lands: the 64-byte mode XORs
# address bits 4-5 with bits 7-8
SWIZZLE_TABLE = [(0, 3, 0), (144, 3, 128), (1006, 3, 926), (16, 2, 16), (128, 2, 144),
                 (144, 2, 128), (256, 2, 288), (400, 2, 416), (960, 2, 1008), (50, 0, 50)]


@pytest.fixture(scope="module")
def emu_addr(tmp_path_factory):
    """tc_emu.h's descriptor and swizzle address functions, built alone."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulator")
    d = tmp_path_factory.mktemp("cuda_emu_addr")
    cpp, lib = d / "addr.cpp", d / "addr.so"
    cpp.write_text('#include "tc_emu.h"\n'
                   'extern "C" int desc_addr(unsigned long long d, int r, int k) '
                   '{ return emu_desc_addr(d, r, 2 * k); }\n'
                   'extern "C" void s8_a_slot(int r, int k, int* out) '
                   '{ emu_s8_a_slot(r, k, out[0], out[1], out[2]); }\n'
                   'extern "C" void acc_at(int th, int i, int* out) '
                   '{ emu_acc_at(th, i, out[0], out[1]); }\n'
                   'extern "C" int swizzle(int off, int mode) { return emu_swizzle(off, mode); }\n')
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-I",
                           os.path.join(HERE, "cuda_emu"), str(cpp), "-o", str(lib)],
                          capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr and "No such file" in proc.stderr:
        pytest.skip("g++ lacks C++20's <barrier>")
    assert proc.returncode == 0, proc.stderr[-3000:]
    so = ctypes.CDLL(str(lib))
    so.desc_addr.argtypes = [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int]
    return so


# The PTX ISA's register fragments of wgmma at m64nNk32 with 8-bit A and B:
# (thread of the warpgroup, register, byte) -> (row, k) of A, as in its
# figure for .atype s8 (each warp's 16 rows as mma.sync's m16n8k32 A:
# register 0 row groupID, bytes 4 * threadID_in_group..; register 1 row + 8;
# registers 2 and 3 the same 16 bytes on), worked by hand
S8_A_TABLE = [(0, 0, 0, 0, 0), (1, 0, 2, 0, 6), (3, 0, 3, 0, 15), (4, 0, 0, 1, 0),
              (5, 1, 3, 9, 7), (28, 1, 1, 15, 1), (2, 2, 1, 0, 25), (37, 2, 0, 17, 20),
              (66, 3, 2, 40, 26), (127, 3, 3, 63, 31)]
# (thread, register) -> (row, col) of the m64nN accumulators (s32 as f32):
# register 4j + e at row 16 * warp + groupID (+8 for e >= 2), column 8j +
# 2 * threadID_in_group + e % 2
ACC_TABLE = [(0, 0, 0, 0), (0, 1, 0, 1), (0, 2, 8, 0), (0, 4, 0, 8), (6, 7, 9, 13),
             (33, 30, 24, 58), (127, 31, 63, 63), (64, 16, 32, 32)]


def test_wgmma_s8_fragment_table(emu_addr):
    """The emulator's s8 wgmma A-fragment and accumulator layouts against
    tables worked from the PTX ISA's m64nNk32 8-bit fragment figures: every
    (row, k) of A has one (thread, register, byte), and the table's entries
    hold."""
    out = (ctypes.c_int * 3)()
    seen = set()
    for r in range(64):
        for k in range(32):
            emu_addr.s8_a_slot(r, k, out)
            seen.add(tuple(out))
    assert len(seen) == 64 * 32
    for th, reg, byte, row, k in S8_A_TABLE:
        emu_addr.s8_a_slot(row, k, out)
        assert tuple(out) == (th, reg, byte), (row, k)
    for th, i, row, col in ACC_TABLE:
        emu_addr.acc_at(th, i, out)
        assert tuple(out[:2]) == (row, col), (th, i)


def test_wgmma_desc_swizzle_table(emu_addr):
    """The emulator's wgmma descriptor and TMA swizzle addresses against a
    table worked from the PTX ISA's 128-byte (and 64-byte) swizzle layouts;
    the descriptor as csrc/tc_common.cuh's wgmma_desc builds it (start / 16,
    leading byte offset 16, stride byte offset 1024, layout 1)."""
    for off, adv, row, k, want in DESC_TABLE:
        desc = ((off >> 4) + adv) | (1 << 16) | ((1024 >> 4) << 32) | (1 << 62)
        assert emu_addr.desc_addr(desc, row, k) == want, (off, adv, row, k)
    for off, mode, want in SWIZZLE_TABLE:
        assert emu_addr.swizzle(off, mode) == want, (off, mode)


# (bits, rule, B, out, in, sub, bias, layout, has min, signed sc, code map) of
# the wgmma kernel: every rule at each bit width it takes, flat, compact and
# mixed sides, sub-blocks of 16 and 32, Q3_K's and Q4_0's biases, Q2_K's
# bias 1 beside an i8 compact scale, the IQ2/IQ3 maps; B of 32, 33, 64 (the
# 64-row activation tile), 200 and 512 (128-row tiles, ragged at 200); out
# 72, 136, 200 and 264 (ragged 128-row tiles); grids of up to the stand-in's
# 4 SMs walking up to 12 tiles each (persistent blocks); in 1024 and 2048
# (one or two chunks of 64 sub-blocks a tile), and 14336 (ffn_down: 448 or
# 896 sub-blocks, compact and mixed min sides)
WGMMA_CASES = [(4, "fsplit", 512, 136, 1024, 16, 4, "compact", False, True, ""),
               (4, "fsplit", 33, 264, 2048, 32, 0, "flat", True, False, ""),
               (4, "fsplit", 200, 72, 2048, 32, 0, "mixed", True, False, ""),
               (4, "fsplit", 64, 200, 2048, 32, 8, "flat", False, False, ""),
               (4, "fsplit", 32, 136, 2048, 32, 0, "flat", False, False, "iq2_xs"),
               (4, "fsplit", 200, 136, 2048, 32, 0, "compact", False, False, "iq3_s"),
               (2, "fsplit", 200, 264, 1024, 16, 0, "mixed", True, False, ""),
               (2, "fsplit", 512, 72, 2048, 16, 0, "flat", True, False, ""),
               (2, "fsplit", 33, 136, 1024, 16, 1, "compact", True, True, ""),
               (4, "xsum", 200, 264, 2048, 32, 0, "compact", True, False, ""),
               (4, "xsum", 33, 136, 2048, 32, 0, "mixed", True, False, ""),
               (4, "xsum", 64, 72, 1024, 16, 4, "flat", False, False, ""),
               (4, "split", 512, 136, 1024, 16, 4, "compact", False, True, ""),
               (4, "split", 32, 200, 2048, 32, 0, "flat", True, False, ""),
               (4, "base", 200, 136, 2048, 32, 0, "flat", True, False, ""),
               (4, "base", 33, 264, 2048, 32, 0, "compact", True, True, ""),
               (4, "base", 512, 72, 1024, 16, 4, "flat", False, False, ""),
               (2, "base_f32", 64, 136, 1024, 16, 0, "compact", True, False, ""),
               (2, "base_f32", 200, 200, 2048, 16, 0, "flat", True, False, ""),
               (4, "base_f32", 33, 136, 2048, 32, 0, "flat", False, False, "iq2_xs"),
               (4, "base_f32", 512, 72, 2048, 32, 0, "compact", False, False, "iq3_s"),
               (4, "fsplit", 33, 72, 14336, 32, 0, "compact", True, False, ""),
               (2, "fsplit", 24, 72, 14336, 16, 0, "mixed", True, False, "")]


@pytest.mark.parametrize("bits,rule,B,out_f,in_f,sub,bias,layout,has_min,signed,fmt",
                         WGMMA_CASES, ids=str)
def test_lowbit_tc_wgmma_rules(emu, bits, rule, B, out_f, in_f, sub, bias, layout, has_min,
                               signed, fmt):
    """Every rule of the wgmma 2/4-bit kernel at prefill row counts, through
    its tensor-core wrapper, against the plain version."""
    mod, launches = emu
    g = torch.Generator().manual_seed(bits * 1000 + B + out_f + in_f + sub + bias + len(rule))
    codes, d, sc, dmin, mn = _lowbit_arrays(bits, out_f, in_f, sub, layout, has_min, signed, g)
    x = torch.randn(B, in_f, generator=g).bfloat16()
    xsum = qm._block_sums(x, sub)
    if layout == "mixed":
        w = types.SimpleNamespace(min_size=256, sub_size=sub, in_features=in_f)
        xsum = qm._mixed_xsum(xsum, w)
    if rule == "base":
        name, kernel, plain = qm.NAME_4BIT_BASE_TC, mod.quant_matmul_4bit_base_tc, \
            qm.quant_matmul_4bit_base_plain
        args = (x, codes, d, sc, dmin, mn, bias)
    elif rule == "base_f32":
        name, kernel, plain = qm.NAME_LOWBIT_BASE_TC, mod.quant_matmul_lowbit_base_tc, \
            qm.quant_matmul_lowbit_base_plain
        args = (x, codes, d, sc, dmin, mn, bias, bits, fmt)
    elif rule == "fsplit":
        name = qm.NAME_4BIT_TC if bits == 4 else qm.NAME_2BIT_TC
        kernel = getattr(mod, name)
        plain = getattr(qm, f"quant_matmul_{bits}bit_plain")
        args = (x, xsum, codes, d, sc, dmin, mn, bias, fmt)
    else:
        name = qm.NAME_4BIT_XSUM_TC if rule == "xsum" else qm.NAME_4BIT_SPLIT_TC
        kernel = getattr(mod, f"quant_matmul_4bit_{rule}_tc")
        plain = getattr(qm, f"quant_matmul_4bit_{rule}_plain")
        args = (x, xsum, codes, d, sc, dmin, mn, bias)
    before = launches.get(name, 0)
    got = kernel(*args)
    assert launches[name] == before + 1
    assert _rel_err(got, plain(*args)) <= TOL


def _tool_edits():
    """(cut set, cut name, source) of every cut that ``tools/tc_ablate.py``
    makes to a CUDA source."""
    from llama_gguf_inference_tpu_torch.tools import tc_ablate
    lib = {"quant_matmul_8bit": "quant_matmul", "quant_matmul_int8": "quant_matmul",
           "quant_matmul_lowbit": "quant_matmul"}
    return [(cuts, name, lib.get(cuts, cuts))
            for cuts, edits in tc_ablate.CUTS.items() for name in edits]


@pytest.mark.parametrize("cuts,name,source", _tool_edits(), ids=str)
def test_tool_edits_apply(cuts, name, source):
    """Every cut of tools/tc_ablate.py finds the text it replaces exactly
    once in the source it builds, as the tool requires on the card."""
    from llama_gguf_inference_tpu_torch.tools import tc_ablate
    with open(os.path.join(CSRC, source + ".cu")) as f:
        src = f.read()
    edits = tc_ablate.CUTS[cuts][name]
    for old, _ in edits if isinstance(edits, list) else [edits]:
        assert src.count(old) == 1, old[:80]
