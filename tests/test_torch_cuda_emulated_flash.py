"""The decode flash attention source runs on the CPU:
``csrc/flash_attention.cu`` compiled by g++ against the stand-in headers of
``tests/cuda_emu`` (``tc_emu.h``: whole blocks of threads, ``cp.async``
copies of 16 and 4 bytes that land at their wait, shuffles and
``__syncwarp`` through a warp barrier; ``atomicAdd``, ``__threadfence`` and
``__ldcg`` as a plain add, nothing and a plain load), with the inline-PTX
helpers of ``csrc/tc_common.cuh`` swapped for those stand-ins, driven through
the port's own ``*_decode`` wrappers with their device check lifted, against
the plain PyTorch versions.

This holds the split of each sequence's keys across blocks of
``FLASH_SPLIT_KEYS``, the early exit of the splits past a sequence's live
keys, the 2-slot ring of K/V tiles, the loaders (bf16, int8, nibbles biased
by 8 or not, the page lookups with -1 read as page 0), the masks, the
partials, their merge and the arrival counters' reset. The emulation runs
one block after another, so it checks the split arithmetic, the merge and
the reset, not the ordering of blocks that run at once; that, and what
nvcc makes of the source, are checked only on the card
(``test_torch_cuda_kernels.py``). Tolerance: two bf16 ulps of the output's
scale (2 * 2^-8, FLASH_TOL): the kernel and the plain version both compute
in f32 and round once to bf16, differing only in f32 rounding (the split's
merge adds one rescale of each partial). Skips where there is no g++ with
C++20.
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
KC = fa.FLASH_SPLIT_KEYS


def _emulated_source() -> str:
    """``csrc/flash_attention.cu`` for g++: the shared header inlined with
    its PTX section cut (``tc_emu.h`` stands in for it), the dynamic shared
    memory and the launch routed through the stand-ins."""
    with open(os.path.join(CSRC, "tc_common.cuh")) as f:
        hdr = f.read()
    start, end = hdr.index("// PTX: "), hdr.index("// end PTX")
    with open(os.path.join(CSRC, "flash_attention.cu")) as f:
        src = f.read()
    src = src.replace('#include "tc_common.cuh"', '#include "tc_emu.h"\n' + hdr[:start] + hdr[end:])
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_smem();")
    return re.sub(r"([A-Za-z_0-9]+<[^<>;]*>)<<<([^>]*)>>>\(([^)]*)\);",
                  r"emu_launch_block(\2, [&]() { \1(\3); });", src)


def build_emulated(tmp_dir, source: str) -> ctypes.CDLL:
    """g++ build of an emulated ``flash_attention.cu`` text; skips without
    a C++20 ``<barrier>``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel")
    cpp, lib = tmp_dir / "flash_attention.cpp", tmp_dir / "flash_attention.so"
    cpp.write_text(source)
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                        "-pthread", "-I", os.path.join(HERE, "cuda_emu"), "-I", CSRC, str(cpp),
                        "-o", str(lib)], capture_output=True, text=True, timeout=600)
    if r.returncode != 0 and "barrier" in r.stderr and "No such file" in r.stderr:
        pytest.skip("g++ lacks C++20's <barrier>")
    assert r.returncode == 0, r.stderr[-3000:]
    return _build._bind("flash_attention", ctypes.CDLL(str(lib)))


def emulated_wrappers(so: ctypes.CDLL):
    """``ops.flash_attention``'s wrappers over an emulated build (every
    tensor seen as on the card, the tensor-core kernel never taken), and the
    launches they count."""
    launches: dict[str, int] = {}
    fake_build = types.SimpleNamespace(
        library=lambda name: so, check=_build.check,
        count=lambda name: launches.__setitem__(name, launches.get(name, 0) + 1))
    with open(fa.__file__) as f:
        wsrc = f.read()
    wsrc = wsrc.replace('if dev.type != "cuda":', "if False:")
    wsrc = wsrc.replace("torch.cuda.current_stream(q.device).cuda_stream", "0")
    wsrc = wsrc.replace("from . import _build\n", "")
    mod = types.ModuleType("flash_attention_emulated")
    exec(compile(wsrc, "flash_attention_emulated", "exec"), mod.__dict__)
    mod._build = fake_build
    return mod, launches


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return emulated_wrappers(build_emulated(tmp_path_factory.mktemp("cuda_emu_flash_dec"),
                                            _emulated_source()))


def _close(got, want):
    assert torch.isfinite(got.float()).all()
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= FLASH_TOL * scale, f"max abs err {err} > {FLASH_TOL} * {scale}"


KINDS = ("bf16", "q8", "q4", "q41", "paged", "paged_q8")
S_CONTIG = KC * 4 + 76           # 5 splits, the last ragged
PAGE_S, NP = 100, 11             # paged: 1100 slots a sequence, pages a tile straddles


def offsets_of(T: int) -> list[int]:
    """One sequence's live keys in one split; the last key at KC - 1 and at
    KC (T = 5: rows t 0-3 end in split 0, row 4 in split 1); the last key at
    S - 1, across every split."""
    return [100, KC - T, KC - T + 1, S_CONTIG - T]


def case_args(kind: str, T: int, D: int, seed: int):
    """Inputs of ``kind``'s decode wrapper in its argument order: H 8 over
    KVH 2, B 4 at :func:`offsets_of`; paged: a fifth, idle sequence whose
    table row is all -1, over shuffled pages, each sequence mapping only the
    pages it uses."""
    g = torch.Generator().manual_seed(seed)
    KVH, H = 2, 8
    offs = offsets_of(T)
    paged = kind.startswith("paged")
    B = len(offs) + paged
    q = torch.randn(B, T, H, D, generator=g).bfloat16()
    if paged:
        P = B * NP
        rows = (P, KVH, PAGE_S)
        table = torch.randperm(P, generator=g).reshape(B, NP).int()
        for b, o in enumerate(offs):
            table[b, -(-(o + T) // PAGE_S):] = -1
        table[-1] = -1
        off = torch.tensor(offs + [0], dtype=torch.int32)
    else:
        rows = (B, KVH, S_CONTIG)
        off = torch.tensor(offs, dtype=torch.int32)

    def side():
        s = torch.rand(rows, generator=g) * 0.05 + 1e-3
        if kind in ("bf16", "paged"):
            return [torch.randn(*rows, D, generator=g).bfloat16()]
        if kind in ("q8", "paged_q8"):
            return [torch.randint(-127, 128, (*rows, D), generator=g, dtype=torch.int8), s]
        c = torch.randint(0, 256, (*rows, D // 2), generator=g, dtype=torch.uint8)
        return [c, s] if kind == "q4" else [c, s, -torch.rand(rows, generator=g) * 0.4]

    return [q, *side(), *side(), off] + ([table] if paged else [])


NAMES = {"bf16": fa.NAME, "q8": fa.NAME_Q8, "q4": fa.NAME_Q4, "q41": fa.NAME_Q41,
         "paged": fa.NAME_PAGED, "paged_q8": fa.NAME_PAGED_Q8}


def _wrappers(mod, kind):
    name = NAMES[kind]
    return getattr(mod, name + "_decode"), getattr(fa, name + "_plain"), name


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_flash_decode_split(emu, kind, D, T):
    """Each decode entry point against its plain version at D 64, 128 and
    256 and T 1 and 5: live keys in one split, ending at a split boundary
    (KC - 1, KC; at T = 5 the rows straddle it), and across all 5 splits to
    S - 1; paged beside an idle sequence. The counters are 0 after."""
    mod, launches = emu
    kernel, plain, name = _wrappers(mod, kind)
    args = case_args(kind, T, D, seed=D + T + len(kind))
    before = launches.get(name, 0)
    got = kernel(*args)
    assert launches[name] == before + 1
    _close(got, plain(*args))
    assert not mod._ARRIVALS[torch.device("cpu")].any()


@pytest.mark.parametrize("kind", KINDS)
def test_flash_decode_twice_and_growing(emu, kind):
    """The same call twice on the same buffers gives the same output (each
    launch leaves its counters at 0); then a call with more row groups grows
    the counter buffer, and a call with fewer reuses it."""
    mod, _ = emu
    kernel, plain, _ = _wrappers(mod, kind)
    mod._ARRIVALS.clear()
    args = case_args(kind, 1, 64, seed=7)
    first = kernel(*args)
    second = kernel(*args)
    assert torch.equal(first, second)
    _close(second, plain(*args))
    n = mod._ARRIVALS[torch.device("cpu")].numel()
    wide = case_args(kind, 5, 64, seed=8)
    _close(kernel(*wide), plain(*wide))
    assert mod._ARRIVALS[torch.device("cpu")].numel() >= 5 * n
    _close(kernel(*args), plain(*args))
    assert not mod._ARRIVALS[torch.device("cpu")].any()


@pytest.mark.parametrize("kind", KINDS)
def test_flash_decode_reads_no_offsets_on_the_host(emu, kind, monkeypatch):
    """The decode wrappers size their grid, scratch and counters from shapes
    alone: with every way of reading a tensor's values on the host made to
    raise, each wrapper still launches (a captured CUDA graph needs that)."""
    mod, launches = emu
    kernel, plain, name = _wrappers(mod, kind)
    args = case_args(kind, 1, 128, seed=9)
    before = launches.get(name, 0)

    def refuse(*_a, **_k):
        raise AssertionError("the wrapper read a tensor's values on the host")

    with monkeypatch.context() as m:
        for attr in ("item", "tolist", "nonzero", "__bool__", "__int__", "cpu", "numpy"):
            m.setattr(torch.Tensor, attr, refuse)
        got = kernel(*args)
    assert launches[name] == before + 1
    _close(got, plain(*args))



def test_split_scratch_bound_at_head_dim_256():
    """The scratch of a head_dim-256 prefill chunk (T 512 over 8192 keys, 8
    kv heads, group 2: Gemma-3-12B's global layers) would take about 270 MB
    in one launch; pieces of ``split_rows`` positions keep it under
    ``FLASH_SPLIT_SCRATCH``, in as few even pieces as fit, and a decode
    step (T = 1) stays one launch."""
    B, T, group, KVH, S, D = 1, 512, 2, 8, 8192, 256
    whole = fa.split_scratch_bytes(B, T, group, KVH, S, D)
    assert whole == B * KVH * -(-(group * T) // 4) * (S // KC) * 4 * (D + 2) * 4
    assert whole > 250e6
    rows = fa.split_rows(B, T, group, KVH, S, D)
    assert rows < T
    assert fa.split_scratch_bytes(B, rows, group, KVH, S, D) <= fa.FLASH_SPLIT_SCRATCH
    pieces = -(-T // rows)
    # one piece fewer would not fit
    fewer = -(-T // (pieces - 1))
    assert fa.split_scratch_bytes(B, fewer, group, KVH, S, D) > fa.FLASH_SPLIT_SCRATCH
    assert fa.split_rows(4, 1, group, KVH, 4096, D) == 1
    assert fa.split_rows(1, 512, 4, 8, 1024, 128) == 512    # the 8B prefill: whole


@pytest.mark.parametrize("kind", ["bf16", "q8", "paged"])
def test_flash_decode_pieces_match_plain(emu, kind):
    """With the scratch cap cut to two row groups, a head_dim-256 call of 24
    positions launches in pieces (each a counted launch, through one scratch
    of at most the cap) and matches the plain version; the counters are 0
    after."""
    mod, launches = emu
    kernel, plain, name = _wrappers(mod, kind)
    args = case_args(kind, 24, 256, seed=11)
    B, T, H, D = args[0].shape
    KVH = 2
    S = S_CONTIG if not kind.startswith("paged") else NP * PAGE_S
    saved = mod.FLASH_SPLIT_SCRATCH
    mod.FLASH_SPLIT_SCRATCH = 2 * mod.split_scratch_bytes(B, 4, 1, KVH, S, D)
    try:
        rows = mod.split_rows(B, T, H // KVH, KVH, S, D)
        assert rows == 2 and mod.split_scratch_bytes(B, rows, H // KVH, KVH, S, D) \
            <= mod.FLASH_SPLIT_SCRATCH
        before = launches.get(name, 0)
        got = kernel(*args)
    finally:
        mod.FLASH_SPLIT_SCRATCH = saved
    assert launches[name] == before + T // rows
    _close(got, plain(*args))
    assert not mod._ARRIVALS[torch.device("cpu")].any()
