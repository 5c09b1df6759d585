"""The tensor-core flash attention source runs on the CPU:
``csrc/flash_attention_tc.cu`` compiled by g++ against the stand-in headers
of ``tests/cuda_emu`` (``tc_emu.h``: whole blocks of threads; mbarriers,
TMA tile loads that land with the 128-byte swizzle when their phase
completes, 4-byte ``cp.async`` copies whose arrival lands them; bf16
``wgmma`` run at the wait that retires it, S = Q.K^T with Q from registers
and K K-major, P.V with V MN-major (the transpose flag); named barriers for
the consumers' ping-pong; quad shuffles through a warp barrier), with the
inline-PTX helpers of ``csrc/tc_common.cuh`` swapped for those stand-ins,
driven through the port's own ``*_tc`` wrappers with their device check
lifted, against the plain PyTorch versions.

This holds the kernel's row tiles in the (g, t) order (a 128-row tile
spanning two heads where T % 64 != 0), its rings of K/V and code stages
(walks of several tiles that wrap them), the q8_0, q4_0 and q4_1 codes'
conversion and their scales (q4_1 centred, its minimums folded in after the
dots), the page lookups in boxes of a page's power-of-two part (pages of
7 to 64 keys), the masks, the online softmax and its early exits to the
plain versions where no card is present; what nvcc makes of the source, and
the PTX itself, are checked only on the card (``test_torch_cuda_kernels.py``
and ``chip_smoke.py``). Tolerance: two bf16 ulps of the output's scale
(2 * 2^-8), as for the CUDA-core kernel: both round once to bf16 at the end,
and this kernel also rounds P (times the V scale) to bf16 for the second
product. Skips where there is no g++ with C++20.
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
from llama_gguf_inference_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "llama_gguf_inference_tpu_torch", "csrc")
FLASH_TOL = 2 * 2 ** -8


def _emulated_source() -> str:
    """``csrc/flash_attention_tc.cu`` for g++: the shared header inlined
    with its PTX section cut (``tc_emu.h`` stands in for it), the dynamic
    shared memory and the launch routed through the stand-ins."""
    with open(os.path.join(CSRC, "tc_common.cuh")) as f:
        hdr = f.read()
    start, end = hdr.index("// PTX: "), hdr.index("// end PTX")
    with open(os.path.join(CSRC, "flash_attention_tc.cu")) as f:
        src = f.read()
    src = src.replace('#include "tc_common.cuh"', '#include "tc_emu.h"\n' + hdr[:start] + hdr[end:])
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_smem();")
    return re.sub(r"([A-Za-z_0-9]+<[^<>;]*>)<<<([^>]*)>>>\(([^)]*)\);",
                  r"emu_launch_block(\2, [&]() { \1(\3); });", src)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """``ops.flash_attention``'s wrappers over the g++ build (every tensor
    seen as on the card), and the launches they count."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel")
    d = tmp_path_factory.mktemp("cuda_emu_flash")
    cpp, lib = d / "flash_attention_tc.cpp", d / "flash_attention_tc.so"
    cpp.write_text(_emulated_source())
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                        "-pthread", "-I", os.path.join(HERE, "cuda_emu"), "-I", CSRC, str(cpp),
                        "-o", str(lib)], capture_output=True, text=True, timeout=600)
    if r.returncode != 0 and "barrier" in r.stderr and "No such file" in r.stderr:
        pytest.skip("g++ lacks C++20's <barrier>")
    assert r.returncode == 0, r.stderr[-3000:]
    so = _build._bind("flash_attention_tc", ctypes.CDLL(str(lib)))
    launches: dict[str, int] = {}
    fake_build = types.SimpleNamespace(
        library=lambda name: so, check=_build.check,
        count=lambda name: launches.__setitem__(name, launches.get(name, 0) + 1))
    with open(fa.__file__) as f:
        wsrc = f.read()
    wsrc = wsrc.replace('if dev.type != "cuda":', "if False:")
    wsrc = wsrc.replace("torch.cuda.current_stream(q.device).cuda_stream", "0")
    wsrc = wsrc.replace("from . import _build\n", "")
    mod = types.ModuleType("flash_attention_tc_emulated")
    exec(compile(wsrc, "flash_attention_tc_emulated", "exec"), mod.__dict__)
    mod._build = fake_build
    return mod, launches


def _close(got, want):
    assert torch.isfinite(got.float()).all()
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= FLASH_TOL * scale, f"max abs err {err} > {FLASH_TOL} * {scale}"


def _codes(shape, g):
    return (torch.randint(-127, 128, shape, generator=g, dtype=torch.int8),
            torch.rand(shape[:3], generator=g) * 0.05 + 1e-3)


# (D, T, offsets): H 8 over KVH 2; T 16 to 128 (ragged against the 64-row
# tiles at 20 and 40); offsets 0 and past a 64-key tile, S 256
CONTIG = [(64, 16, (0, 100)), (128, 20, (70, 3)), (64, 40, (0, 200)), (128, 64, (130, 0)),
          (64, 128, (65, 128))]


def _nibbles(shape, g, asym):
    """q4_0 / q4_1 codes of a (B, KVH, S, D) cache: planar nibble bytes
    (B, KVH, S, D/2), scales, and for q4_1 minimums."""
    c = torch.randint(0, 256, (*shape[:3], shape[3] // 2), generator=g, dtype=torch.uint8)
    s = torch.rand(shape[:3], generator=g) * 0.05 + 1e-3
    return (c, s, -torch.rand(shape[:3], generator=g) * 0.4) if asym else (c, s)


QUANT_SEED = {"bf16": 0, "q8": 1, "q4": 2, "q41": 3}


@pytest.mark.parametrize("quant", ["bf16", "q8", "q4", "q41"])
@pytest.mark.parametrize("D,T,offsets", CONTIG, ids=str)
def test_flash_tc_contiguous(emu, quant, D, T, offsets):
    """``lgt_flash_attention_tc``, ``_q8_tc``, ``_q4_tc`` and ``_q41_tc``
    against the plain versions over contiguous caches."""
    mod, launches = emu
    g = torch.Generator().manual_seed(D + T + sum(offsets) + QUANT_SEED[quant])
    B, KVH, H, S = 2, 2, 8, 256
    q = torch.randn(B, T, H, D, generator=g).bfloat16()
    off = torch.tensor(offsets, dtype=torch.int32)
    if quant == "q8":
        kc, ks = _codes((B, KVH, S, D), g)
        vc, vs = _codes((B, KVH, S, D), g)
        args, name = (q, kc, ks, vc, vs, off), fa.NAME_Q8_TC
        kernel, plain = mod.flash_attention_q8_tc, fa.flash_attention_q8_plain
    elif quant == "q4":
        args, name = (q, *_nibbles((B, KVH, S, D), g, False),
                      *_nibbles((B, KVH, S, D), g, False), off), fa.NAME_Q4_TC
        kernel, plain = mod.flash_attention_q4_tc, fa.flash_attention_q4_plain
    elif quant == "q41":
        args, name = (q, *_nibbles((B, KVH, S, D), g, True),
                      *_nibbles((B, KVH, S, D), g, True), off), fa.NAME_Q41_TC
        kernel, plain = mod.flash_attention_q41_tc, fa.flash_attention_q41_plain
    else:
        k = torch.randn(B, KVH, S, D, generator=g).bfloat16()
        v = torch.randn(B, KVH, S, D, generator=g).bfloat16()
        args, name = (q, k, v, off), fa.NAME_TC
        kernel, plain = mod.flash_attention_tc, fa.flash_attention_plain
    before = launches.get(name, 0)
    got = kernel(*args)
    assert launches[name] == before + 1
    _close(got, plain(*args))


# (D, T, page_s): pools of shuffled pages; slot 0 at its last position,
# slot 1 over 3 mapped pages (the rest -1), slot 2 idle (its row all -1,
# offset 0); page sizes that a 64-key tile straddles (48) or spans (16)
PAGED = [(64, 16, 48), (128, 33, 48), (64, 64, 16), (128, 100, 64)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("D,T,page_s", PAGED, ids=str)
def test_flash_tc_paged(emu, quant, D, T, page_s):
    """``lgt_flash_attention_paged_tc`` and ``lgt_flash_attention_paged_q8_tc``
    against the plain versions: shuffled pages, an idle slot whose table row
    is all -1 (it reads page 0, never out of bounds)."""
    mod, launches = emu
    g = torch.Generator().manual_seed(D + T + page_s + quant)
    B, KVH, H = 3, 2, 8
    NP = -(-(T + 130) // page_s)
    P = B * NP
    q = torch.randn(B, T, H, D, generator=g).bfloat16()
    table = torch.randperm(P, generator=g).reshape(B, NP).int()
    used = -(-(T + 40) // page_s)
    table[1, used:] = -1
    table[2] = -1
    off = torch.tensor([NP * page_s - T, used * page_s - T - 3, 0], dtype=torch.int32)
    if quant:
        kc, ks = _codes((P, KVH, page_s, D), g)
        vc, vs = _codes((P, KVH, page_s, D), g)
        args, name = (q, kc, ks, vc, vs, off, table), fa.NAME_PAGED_Q8_TC
        kernel, plain = mod.flash_attention_paged_q8_tc, fa.flash_attention_paged_q8_plain
    else:
        k = torch.randn(P, KVH, page_s, D, generator=g).bfloat16()
        v = torch.randn(P, KVH, page_s, D, generator=g).bfloat16()
        args, name = (q, k, v, off, table), fa.NAME_PAGED_TC
        kernel, plain = mod.flash_attention_paged_tc, fa.flash_attention_paged_plain
    before = launches.get(name, 0)
    got = kernel(*args)
    assert launches[name] == before + 1
    _close(got, plain(*args))


def _contig_args(mod, quant, B, T, KVH, H, D, S, offsets, g):
    """One contiguous call of ``quant``: (kernel, plain version, args, launch name)."""
    q = torch.randn(B, T, H, D, generator=g).bfloat16()
    off = torch.tensor(offsets, dtype=torch.int32)
    if quant == "q8":
        kc, ks = _codes((B, KVH, S, D), g)
        vc, vs = _codes((B, KVH, S, D), g)
        return (mod.flash_attention_q8_tc, fa.flash_attention_q8_plain,
                (q, kc, ks, vc, vs, off), fa.NAME_Q8_TC)
    if quant in ("q4", "q41"):
        asym = quant == "q41"
        args = (q, *_nibbles((B, KVH, S, D), g, asym), *_nibbles((B, KVH, S, D), g, asym), off)
        return ((mod.flash_attention_q41_tc, fa.flash_attention_q41_plain, args, fa.NAME_Q41_TC)
                if asym else
                (mod.flash_attention_q4_tc, fa.flash_attention_q4_plain, args, fa.NAME_Q4_TC))
    k = torch.randn(B, KVH, S, D, generator=g).bfloat16()
    v = torch.randn(B, KVH, S, D, generator=g).bfloat16()
    return mod.flash_attention_tc, fa.flash_attention_plain, (q, k, v, off), fa.NAME_TC


@pytest.mark.parametrize("quant", ["bf16", "q8", "q4", "q41"])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_tc_long_walk(emu, quant, D):
    """T = 100 (each 128-row tile spans two heads' t's) at offsets 600 and
    17 over 768 slots: a block walks up to six 128-key tiles, so every ring
    (two to four bf16 stages, two to four code stages) wraps, and its two
    consumers stop at different tiles."""
    mod, launches = emu
    g = torch.Generator().manual_seed(D + QUANT_SEED[quant] + 600)
    kernel, plain, args, name = _contig_args(mod, quant, 2, 100, 2, 8, D, 768, (600, 17), g)
    before = launches.get(name, 0)
    got = kernel(*args)
    assert launches[name] == before + 1
    _close(got, plain(*args))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("page_s", [24, 12, 7])
def test_flash_tc_odd_pages(emu, quant, page_s):
    """Pages of 24, 12 and 7 keys: TMA boxes of 8, 4 and 1 key (the largest
    power of two dividing the page), so a 128-key tile takes 16 to 128
    boxes, each looked up in the table; shuffled pages, an idle all -1 row."""
    mod, launches = emu
    g = torch.Generator().manual_seed(page_s + quant + 77)
    B, KVH, H, D, T = 3, 2, 8, 128, 40
    NP = -(-(T + 150) // page_s)
    P = B * NP
    q = torch.randn(B, T, H, D, generator=g).bfloat16()
    table = torch.randperm(P, generator=g).reshape(B, NP).int()
    used = -(-(T + 60) // page_s)
    table[1, used:] = -1
    table[2] = -1
    off = torch.tensor([NP * page_s - T, used * page_s - T - 2, 0], dtype=torch.int32)
    if quant:
        kc, ks = _codes((P, KVH, page_s, D), g)
        vc, vs = _codes((P, KVH, page_s, D), g)
        args, name = (q, kc, ks, vc, vs, off, table), fa.NAME_PAGED_Q8_TC
        kernel, plain = mod.flash_attention_paged_q8_tc, fa.flash_attention_paged_q8_plain
    else:
        k = torch.randn(P, KVH, page_s, D, generator=g).bfloat16()
        v = torch.randn(P, KVH, page_s, D, generator=g).bfloat16()
        args, name = (q, k, v, off, table), fa.NAME_PAGED_TC
        kernel, plain = mod.flash_attention_paged_tc, fa.flash_attention_paged_plain
    before = launches.get(name, 0)
    got = kernel(*args)
    assert launches[name] == before + 1
    _close(got, plain(*args))


# The operand address of an MN-major bf16 tile with the 128-byte swizzle,
# as the PTX ISA's canonical layout places it for wgmma's descriptors (and
# TMA's CU_TENSOR_MAP_SWIZZLE_128B writes a (rows = k, 64 columns = n) box):
# row k of n's 64-column atom at (k // 8) * SBO + (k % 8) * 128, atoms along
# n LBO apart, element n % 64 at 2 * (n % 64), then the 16-byte chunk
# (address bits 4-6) XORed with address bits 7-9. (start, LBO, k, n) -> byte
# offset, worked by hand; SBO 1024, as csrc/tc_common.cuh's wgmma_desc_mn
# builds it. The card holds it through the flash kernel's P.V (D 64 and
# 128, the smoke's flash rows against their plain versions).
MN_TABLE = [(0, 16384, 0, 0, 0), (0, 16384, 0, 1, 2), (0, 16384, 0, 8, 16),
            (0, 16384, 1, 0, 144), (0, 16384, 1, 8, 128), (0, 16384, 7, 63, 910),
            (0, 16384, 8, 0, 1024), (0, 16384, 9, 5, 1178), (0, 16384, 0, 64, 16384),
            (0, 16384, 3, 70, 16828), (2048, 16384, 0, 0, 2048), (2048, 16384, 2, 17, 2306),
            (8192, 8192, 15, 127, 18318), (32768, 16384, 12, 100, 50696)]


@pytest.fixture(scope="module")
def emu_mn(tmp_path_factory):
    """tc_emu.h's MN-major descriptor and address functions, built alone."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulator")
    d = tmp_path_factory.mktemp("cuda_emu_mn")
    cpp, lib = d / "mn.cpp", d / "mn.so"
    cpp.write_text('#include "tc_emu.h"\n'
                   'extern "C" int mn_addr(int start, int lbo, int k, int n) {\n'
                   '  emu_block blk;\n'
                   '  blk.smem_buf.assign(65536 + 1024, 0);\n'
                   '  blk.smem = blk.smem_buf.data();\n'
                   '  emu_blk = &blk;\n'
                   '  const int r = emu_desc_addr_mn(wgmma_desc_mn(blk.smem + start, lbo), k, n);\n'
                   '  emu_blk = nullptr;\n'
                   '  return r;\n'
                   '}\n')
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-I",
                           os.path.join(HERE, "cuda_emu"), str(cpp), "-o", str(lib)],
                          capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr and "No such file" in proc.stderr:
        pytest.skip("g++ lacks C++20's <barrier>")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ctypes.CDLL(str(lib))


def test_wgmma_mn_desc_table(emu_mn):
    """The emulator's MN-major descriptor (wgmma_desc_mn, the transpose
    flag's B) against the hand-worked table."""
    for start, lbo, k, n, want in MN_TABLE:
        assert emu_mn.mn_addr(start, lbo, k, n) == want, (start, lbo, k, n)


def test_flash_tc_group_of_one(emu):
    """No GQA (H = KVH): a row tile spans 64 positions of one head."""
    mod, _ = emu
    g = torch.Generator().manual_seed(11)
    q = torch.randn(1, 80, 2, 64, generator=g).bfloat16()
    k = torch.randn(1, 2, 200, 64, generator=g).bfloat16()
    v = torch.randn(1, 2, 200, 64, generator=g).bfloat16()
    off = torch.tensor([90], dtype=torch.int32)
    _close(mod.flash_attention_tc(q, k, v, off), fa.flash_attention_plain(q, k, v, off))
