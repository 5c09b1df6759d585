"""The tensor-core 8-bit matmul source run on the CPU:
``csrc/quant_matmul_tc.cu`` compiled by g++ against the stand-in headers of
``tests/cuda_emu`` (``tc_emu.h``: whole blocks of threads, ``cp.async``
copies that land at their wait, ``ldmatrix`` and ``mma.sync`` through a warp
barrier in the PTX ISA's fragment layout), with its inline-PTX helpers
swapped for those stand-ins, driven through the port's own wrapper with its
device check lifted, against the plain PyTorch version.

This holds the kernel's tiling, its ring of stages, its chunked walk over
the sub-blocks and its ragged edges to the plain version where no card is
present; what nvcc makes of the source, and the PTX itself, are checked only
on the card (``test_torch_cuda_kernels.py``). Tolerance: the same bf16
weights and exact bf16 products on both sides, f32 sums in another order:
1e-5 of the output's scale. Skips where there is no g++ with C++20.
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
SRC = os.path.join(os.path.dirname(HERE), "llama_gguf_inference_tpu_torch", "csrc",
                   "quant_matmul_tc.cu")
TOL = 1e-5


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """``ops.quant_matmul.quant_matmul_8bit_tc`` over the g++ build of the
    CUDA source, and the launches it counts."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel")
    d = tmp_path_factory.mktemp("cuda_emu_tc")
    with open(SRC) as f:
        src = f.read()
    start, end = src.index("// PTX: "), src.index("// end PTX")
    src = '#include "tc_emu.h"\n' + src[:start] + src[end:]
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_smem();")
    src = re.sub(r"([A-Za-z_0-9]+<[^<>;]*>)<<<([^>]*)>>>\(([^)]*)\);",
                 r"emu_launch_block(\2, [&]() { \1(\3); });", src)
    cpp, lib = d / "quant_matmul_tc.cpp", d / "quant_matmul_tc.so"
    cpp.write_text(src)
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                        "-pthread", "-I", os.path.join(HERE, "cuda_emu"), str(cpp),
                        "-o", str(lib)], capture_output=True, text=True, timeout=600)
    if r.returncode != 0 and "barrier" in r.stderr and "No such file" in r.stderr:
        pytest.skip("g++ lacks C++20's <barrier>")
    assert r.returncode == 0, r.stderr[-3000:]
    so = _build._bind("quant_matmul_tc", ctypes.CDLL(str(lib)))
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
    mod = types.ModuleType("quant_matmul_tc_emulated")
    exec(compile(wsrc, "quant_matmul_tc_emulated", "exec"), mod.__dict__)
    mod._build = fake_build
    return mod, launches


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
# side) instance in 64-row output tiles (3 blocks, fewer than the stand-in's
# 4 SMs, out ragged), and in 128-row tiles over 2 x 2 blocks (rows and out
# ragged); one sub-block chunk of 32 steps (in 2048, sub 32) or three of 16
# whose runs wrap the 12 super-blocks (in 3072, sub 16)
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
