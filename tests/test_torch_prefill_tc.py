"""The int8 body's, the base rules' and the xsum and split bodies'
tensor-core prefill paths, on the CPU.

- ``int8_tc_takes``: the geometries the tensor-core int8 kernel takes
  (sub-blocks of 16 or 32, whole groups of 16 sub-blocks, a scale side whose
  width is a multiple of 4 dividing nsub) and the ones it refuses, whose
  wrapper raises before any launch.
- The dispatchers as on the card (``_on_card`` answering True, spies on the
  wrappers): ``quant_matmul_4bit_int8`` takes the tensor-core kernel from
  ``INT8_TC_MIN_ROWS`` rows, ``quant_matmul_4bit_base``,
  ``quant_matmul_lowbit_base``, ``quant_matmul_4bit_xsum`` and
  ``quant_matmul_4bit_split`` from ``LOWBIT_TC_MIN_ROWS``, each where its
  kernel takes the geometry, and the decode kernel otherwise.
- The port's ``quant_matmul`` under ``LGT_MM_VARIANT=int8``, ``base``,
  ``xsum`` and ``split`` at
  and above those row counts, dispatching as on the card (on CPU tensors the
  tensor-core wrappers compute their plain versions), against the JAX
  package's ``pallas_quant_matmul`` in interpret mode, a spy showing the
  JAX body that ran. Tolerance 2e-5 of the output's scale: the same bf16
  weights (base, xsum, split) or the same exact integer dots (int8) on both
  sides, the
  f32 sums in another order (as ``test_torch_quant_matmul_variants.py``).
- A tiny model's 64-token prefill under each of the two variants against
  the JAX forward on its Pallas kernels. Under base, held to 2⁻⁷ of the
  logits' scale (one bf16 ulp near the largest logit, as
  ``test_torch_model_q5k.py``). Under int8, to 5%: its activations are
  quantized per sub-block, so an input that the two frameworks round one
  bf16 ulp apart can flip an activation code, a step its min term does not
  cancel, and the two forwards drift apart (measured on an H100: 2-12% of
  the logits' scale over 2 to 32 layers, PERF.md §6; this 2-layer prefill
  here 3.3%). Each int8 call on the same inputs is held to 2e-5 above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.gguf.constants import GGMLType as JGGMLType
from llama_gguf_inference_tpu.ops import matmul_kernels as jmk
from llama_gguf_inference_tpu.ops import pallas_matmul as jpm
from llama_gguf_inference_tpu.runtime import loader as jloader
from llama_gguf_inference_tpu_torch.gguf.constants import GGMLType
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
from llama_gguf_inference_tpu_torch.runtime import loader as tloader
from test_torch_model import _jax_logits
from test_torch_model_lowbit import write_tiny_lowbit
from test_torch_quant_matmul_variants import _pair, spy  # noqa: F401 (spy is a fixture)

torch.set_num_threads(1)

# (in, nsub, nd, sub) of the served 8B's int8 weights and the formats the
# body takes: Q4_K flat and compact at 4096 and 14336, Q4_0/Q4_1 flat, Q3_K
# flat and compact
INT8_TC_GEOMETRIES = {
    "q4_k flat 4096": (4096, 128, 128, 32), "q4_k compact 4096": (4096, 128, 16, 32),
    "q4_k flat 14336": (14336, 448, 448, 32), "q4_k compact 14336": (14336, 448, 56, 32),
    "q3_k flat 4096": (4096, 256, 256, 16), "q3_k compact 14336": (14336, 896, 56, 16),
    "tiny q4_k 512": (512, 16, 16, 32)}
INT8_TC_REFUSED = {
    "nsub 40": (1280, 40, 40, 32), "sub 64": (4096, 64, 64, 64), "sub 8": (1024, 128, 128, 8),
    "nd % 4": (2048, 64, 2, 32), "nd not dividing nsub": (4096, 128, 12, 32)}


@pytest.mark.parametrize("name", INT8_TC_GEOMETRIES)
def test_int8_tc_takes_the_served_geometries(name):
    assert qm.int8_tc_takes(*INT8_TC_GEOMETRIES[name])


@pytest.mark.parametrize("name", INT8_TC_REFUSED)
def test_int8_tc_refuses_geometry(name):
    """A refused geometry stays on the decode kernel at any row count, and
    the tensor-core wrapper raises on it before any launch."""
    in_f, nsub, nd, sub = INT8_TC_REFUSED[name]
    assert not qm.int8_tc_takes(in_f, nsub, nd, sub)
    if sub not in (16, 32) or nsub % nd:
        return                                   # not a 4-bit geometry the wrappers check
    g = torch.Generator().manual_seed(in_f + nd)
    codes = torch.randint(0, 256, (8, in_f // 2), generator=g, dtype=torch.uint8)
    d = torch.rand(8, nd, generator=g)
    sc = torch.randint(0, 64, (8, nsub), generator=g, dtype=torch.int32).to(torch.uint8) \
        if nd != nsub else None
    x = torch.randn(32, in_f, generator=g)
    xq, xs = qm.quantize_acts(x, sub)
    args = (xq, xs, qm._block_sums(x, sub), codes, d, sc, None, None)
    with pytest.raises(ValueError, match="tensor-core"):
        qm.quant_matmul_4bit_int8_tc(*args)


@pytest.fixture
def spies(monkeypatch):
    """The dispatch as on the card: ``_on_card`` answers True, and the base,
    int8, xsum and split wrappers, tensor-core and decode, record their
    calls before running (their CPU path is the plain version)."""
    calls = []
    monkeypatch.setattr(qm, "_on_card", lambda t: True)
    for body in ("4bit_base", "lowbit_base", "4bit_int8", "4bit_xsum", "4bit_split"):
        for kind in ("tc", "decode"):
            real = getattr(qm, f"quant_matmul_{body}_{kind}")

            def fn(*a, _tag=f"{body}_{kind}", _real=real):
                calls.append(_tag)
                return _real(*a)
            monkeypatch.setattr(qm, f"quant_matmul_{body}_{kind}", fn)
    return calls


def _flat_arrays(bits, in_f, sub, g):
    nsub = in_f // sub
    codes = torch.randint(0, 256, (8, in_f * bits // 8), generator=g, dtype=torch.uint8)
    return codes, torch.rand(8, nsub, generator=g), None, torch.rand(8, nsub, generator=g), None


@pytest.mark.parametrize("body", ["4bit_int8", "4bit_base", "lowbit_base", "4bit_xsum",
                                  "4bit_split"])
def test_rows_threshold(body, spies):
    """Below the body's threshold the decode kernel, from it up (512
    included) the tensor-core kernel; a geometry the tensor-core kernel does
    not take (int8: nsub 40; base, xsum, split: nsub 48) the decode kernel
    at 512 rows."""
    bits, sub = (2, 16) if body == "lowbit_base" else (4, 32)
    rows = qm.INT8_TC_MIN_ROWS if body == "4bit_int8" else qm.LOWBIT_TC_MIN_ROWS
    odd = 40 if body == "4bit_int8" else 48
    g = torch.Generator().manual_seed(len(body))
    for nsub, B, want in ((64, 1, "decode"), (64, rows - 1, "decode"), (64, rows, "tc"),
                          (64, 512, "tc"), (odd, 512, "decode")):
        arrs = _flat_arrays(bits, nsub * sub, sub, g)
        x = torch.randn(B, nsub * sub, generator=g)
        if body == "4bit_int8":
            xq, xs = qm.quantize_acts(x, sub)
            args = (xq, xs, qm._block_sums(x, sub), *arrs)
        elif body in ("4bit_xsum", "4bit_split"):
            args = (x.bfloat16(), qm._block_sums(x, sub), *arrs)
        else:
            args = (x.bfloat16(), *arrs) + ((0, bits) if body == "lowbit_base" else ())
        spies.clear()
        getattr(qm, f"quant_matmul_{body}")(*args)
        assert spies == [f"{body}_{want}"]


# (variant, format, in, layout, the port's tensor-core wrapper): each format
# the two bodies take, at an ``in`` whose geometry the tensor-core kernel
# takes (int8: whole groups of 16 sub-blocks; base: nsub a multiple of 64)
PARITY = [("int8", GGMLType.Q4_K, 512, "flat", "4bit_int8"),
          ("int8", GGMLType.Q4_K, 1024, "compact", "4bit_int8"),
          ("int8", GGMLType.Q4_0, 512, "flat", "4bit_int8"),
          ("int8", GGMLType.Q4_1, 512, "flat", "4bit_int8"),
          ("int8", GGMLType.Q3_K, 512, "flat", "4bit_int8"),
          ("base", GGMLType.Q4_K, 2048, "flat", "4bit_base"),
          ("base", GGMLType.Q4_0, 2048, "flat", "4bit_base"),
          ("base", GGMLType.Q3_K, 1024, "compact", "4bit_base"),
          ("base", GGMLType.Q2_K, 1024, "flat", "lowbit_base"),
          ("xsum", GGMLType.Q4_K, 2048, "flat", "4bit_xsum"),
          ("xsum", GGMLType.Q4_K, 2048, "mixed", "4bit_xsum"),
          ("xsum", GGMLType.Q3_K, 1024, "compact", "4bit_xsum"),
          ("split", GGMLType.Q4_K, 2048, "compact", "4bit_split"),
          ("split", GGMLType.Q4_0, 2048, "flat", "4bit_split")]


@pytest.mark.parametrize("B", [8, 16, 64])
@pytest.mark.parametrize("variant,gtype,in_f,layout,body", PARITY,
                         ids=lambda p: getattr(p, "name", str(p)))
def test_quant_matmul_matches_pallas(variant, gtype, in_f, layout, body, B, spies, spy,
                                     monkeypatch):
    """The port's dispatcher under the variant, as on the card, against
    ``pallas_quant_matmul`` (interpret mode) on the same weights and bf16
    activations: the same body in both packages, the port's tensor-core
    wrapper from its threshold, outputs within 2e-5 of their scale."""
    monkeypatch.setenv("LGT_MM_VARIANT", variant)
    jq, tq = _pair(gtype, 64, in_f, B + in_f, layout, monkeypatch)
    x = np.random.default_rng(B).normal(size=(B, in_f)).astype(np.float32)
    want = np.asarray(jpm.pallas_quant_matmul(jq, jnp.asarray(x, jnp.bfloat16),
                                              out_dtype=jnp.float32))
    got = tq.matmul(torch.from_numpy(x).bfloat16(), out_dtype=torch.float32).numpy()
    assert spy == [variant]
    rows = qm.INT8_TC_MIN_ROWS if variant == "int8" else qm.LOWBIT_TC_MIN_ROWS
    assert spies == [f"{body}_{'tc' if B >= rows else 'decode'}"]
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


@pytest.fixture(scope="module")
def tiny_models(tmp_path_factory):
    """The all-Q4_K model (flat) and the all-Q2_K model relaid flat, each
    loaded by both packages."""
    out = {}
    q4 = JGGMLType.Q4_K
    for name, kw, layout in (
            ("q4k", dict(tensor_types=dict(embd=q4, q=q4, k=q4, v=q4, o=q4, gate=q4, up=q4,
                                           down=q4)), "flat"),
            ("q2k", {}, "flat")):
        path = str(write_tiny_lowbit(tmp_path_factory.mktemp(name) / f"{name}.gguf", name, **kw))
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("LGT_SCALE_LAYOUT", layout)
            jcfg, jparams, _ = jloader.load_model(path, fuse=True)
            tcfg, tparams, _ = tloader.load_model(path, device="cpu")
        out[name] = (jcfg, jparams, tcfg, tparams)
    return out


@pytest.mark.parametrize("variant,model,tc_body", [("int8", "q4k", "4bit_int8"),
                                                    ("base", "q4k", None),
                                                    ("base", "q2k", "lowbit_base")])
def test_prefill_64_tokens_matches_jax(tiny_models, variant, model, tc_body, spies,
                                       monkeypatch):
    """A 64-token prefill of the tiny model under the variant, dispatching as
    on the card, against the JAX forward on its Pallas kernels. The int8
    body takes its tensor-core wrapper at every projection; at dim 512 only
    the Q2_K model's ffn_down (in 1024, 64 sub-blocks) fits the base rules'
    tensor-core kernel, and the 4-bit base weights (16 sub-blocks) keep
    their decode kernel."""
    jcfg, jparams, tcfg, tparams = tiny_models[model]
    monkeypatch.setenv("LGT_MM_VARIANT", variant)
    monkeypatch.setattr(jmk, "_on_tpu", lambda: True)
    monkeypatch.setenv("LGT_FORCE_FLASH", "1")
    ids = np.random.default_rng(64).integers(3, 512, 64).astype(np.int32)
    want = _jax_logits(jcfg, jparams, ids, 80)
    cache = tllama.KVCache.zeros(tcfg, 1, 80, "cpu")
    with torch.inference_mode():
        got = tllama.forward(tparams, tcfg, torch.from_numpy(ids[None]),
                             torch.zeros(1, dtype=torch.int32), cache)[0].numpy()
    if tc_body:
        assert f"{tc_body}_tc" in spies
    assert all(not c.endswith("_tc") or c.startswith(str(tc_body)) for c in spies)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= (0.05 if variant == "int8" else 2 ** -7) * scale
