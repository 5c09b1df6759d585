"""The MoE blocks of the port against the JAX package's, on the CPU (the
JAX package's ``tests/test_moe.py`` cases), and the expert-indexed launch of
the decode kernels.

- ``_moe_cond`` (the expert-indexed decode path) equals ``_moe_dense``
  exactly, and ``_moe_capacity`` at full capacity equals it within 2%;
  capacity drops the same overflow tokens as the JAX package's (both sort
  stably); the stacked experts give the same logits as the per-expert list;
- ``moe_router`` with and without renormalisation, routed scale and
  group-limited selection against the JAX package's;
- the expert-indexed function's plain version against the JAX package's
  ``_moe_cond`` over the same Q8_0 and Q4_K experts, and each of its
  matmuls against the per-expert plain matmul;
- where g++ is present, ``csrc/quant_matmul.cu``'s expert-indexed launches
  (the 2/4-bit and 8-bit decode kernels) under ``tests/cuda_emu``, as
  ``test_torch_cuda_emulated.py`` runs that source, against their plain
  versions: runs of one expert longer than a block's rows, an expert with
  no rows, ragged out, the generic 2/4-bit instance (in 1408). Tolerance
  1e-5 of the output's scale.

The routed matmuls of the port and of the JAX package read the same codes;
on the CPU the JAX package computes them on its XLA path (the weight
dequantized to bf16), the port through its kernels' plain versions, which
round the weight per rule: MoE block outputs within 2% of their scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.gguf import GGMLType as JGGMLType
from llama_gguf_inference_tpu.models import llama as jllama
from llama_gguf_inference_tpu.runtime.loader import load_model as jload
from llama_gguf_inference_tpu.utils.testing import write_tiny_llama
from llama_gguf_inference_tpu_torch.models import llama as tllama
from llama_gguf_inference_tpu_torch.ops import quant_matmul as qm
from llama_gguf_inference_tpu_torch.runtime.loader import load_model as tload
from test_torch_cuda_emulated import _arrays, emu  # noqa: F401 — the g++ build fixture

torch.set_num_threads(1)

TOL = 0.02          # MoE block outputs, port against JAX, of their scale
EMU_TOL = 1e-5      # emulated kernel against its plain version


@pytest.fixture(scope="module", params=["q8_0", "q4_k"])
def models(request, tmp_path_factory):
    """A tiny MoE model (E=4, top-2, dim 256) in both packages, fused (the
    experts stacked) and, for the port, unfused (the per-expert list)."""
    quant = {"q8_0": JGGMLType.Q8_0, "q4_k": JGGMLType.Q4_K}[request.param]
    p = tmp_path_factory.mktemp("moe") / f"moe-{request.param}.gguf"
    write_tiny_llama(p, dim=256, n_layers=2, n_heads=8, n_kv_heads=4, ffn_dim=256,
                     n_experts=4, n_experts_used=2, quant=quant)
    jcfg, jp, jr = jload(p, mode="quant", fuse=True)
    jr.close()
    tcfg, tp, tr = tload(p, device="cpu")
    tr.close()
    _, tlist, tr = tload(p, device="cpu", fuse=False)
    tr.close()
    return jcfg, jp, tcfg, tp, tlist


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def _route(tcfg, layer, x):
    return tllama.moe_route(layer, tcfg, x)


def test_cond_path_matches_dense_exactly(models):
    _, _, tcfg, tp, _ = models
    layer = tp["layers"][0]
    _, x = _both(_x((2, 2, tcfg.dim), 0))
    with torch.inference_mode():
        topv, topi = _route(tcfg, layer, x)
        w = tllama.route_weights(tcfg, topv, topi)
        views = tllama._expert_views(layer["experts_st"], tcfg.n_experts)
        dense = tllama._moe_dense(views, tcfg, x, w)
        cond = tllama._moe_cond(layer["experts_st"], tcfg, x, topv, topi)
    assert torch.equal(dense, cond)


def test_capacity_full_matches_dense(models):
    _, _, tcfg, tp, _ = models
    layer = tp["layers"][0]
    _, x = _both(_x((2, 16, tcfg.dim), 1))
    with torch.inference_mode():
        w = tllama.route_weights(tcfg, *_route(tcfg, layer, x))
        views = tllama._expert_views(layer["experts_st"], tcfg.n_experts)
        dense = tllama._moe_dense(views, tcfg, x, w)
        full = tllama._moe_capacity(views, tcfg, x, w, cf=tcfg.n_experts / tcfg.n_experts_used)
    _close(full.float(), dense.float())


def test_capacity_drops_the_jax_overflow(models):
    """All the routing weight on expert 0 with ties among the tokens: the
    capacity (32 of 64 tokens) keeps the same tokens as the JAX package's
    stable sort, and the kept ones match its outputs."""
    jcfg, jp, tcfg, tp, _ = models
    N = 64
    jx, tx = _both(_x((1, N, tcfg.dim), 2))
    wn = np.zeros((1, N, tcfg.n_experts), np.float32)
    wn[..., 0] = np.where(np.arange(N) % 3 == 0, 0.5, 1.0)   # ties: a stable sort decides
    with torch.inference_mode():
        views = tllama._expert_views(tp["layers"][0]["experts_st"], tcfg.n_experts)
        got = tllama._moe_capacity(views, tcfg, tx, torch.from_numpy(wn), cf=1.0).float().numpy()
    jlayer = dict(jp["layers"][0])
    jlayer["experts"] = jllama._expert_views(jlayer.pop("experts_st"), jcfg.n_experts)
    want = np.asarray(jllama._moe_capacity(jlayer, jcfg, jx, jnp.asarray(wn), cf=1.0),
                      np.float32)
    kept_t = np.abs(got).sum(-1) > 0
    kept_j = np.abs(want).sum(-1) > 0
    assert kept_t.sum() == N * tcfg.n_experts_used // tcfg.n_experts
    assert np.array_equal(kept_t, kept_j)
    _close(got[kept_t], want[kept_j])


@pytest.mark.parametrize("case", ["renorm", "raw-scaled", "groups", "groups-renorm"])
def test_router_matches_jax(models, case):
    """``moe_router`` (the scattered weights) against the JAX package's,
    with the config's routing knobs set per case: renormalised top-k, raw
    weights times a routed scale, and group-limited selection (2 groups of
    2, 1 kept) with and without renormalisation."""
    import dataclasses
    jcfg, jp, tcfg, tp, _ = models
    kw = {"renorm": dict(moe_renorm=True),
          "raw-scaled": dict(moe_renorm=False, routed_scale=1.5),
          "groups": dict(moe_renorm=False, n_expert_groups=2, topk_groups=1),
          "groups-renorm": dict(moe_renorm=True, n_expert_groups=2, topk_groups=1,
                                routed_scale=2.0)}[case]
    jc, tc = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    jx, tx = _both(_x((2, 5, tcfg.dim), 3))
    want = np.asarray(jllama.moe_router(jp["layers"][0], jc, jx))
    with torch.inference_mode():
        got = tllama.moe_router(tp["layers"][0], tc, tx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ((got > 0).sum(-1) == tcfg.n_experts_used).all()
    if "groups" in case:   # every token's experts lie in one group of two
        picked = (got > 0).reshape(2, 5, 2, 2).any(-1).sum(-1)
        assert (picked == 1).all()


def test_cond_matches_jax(models):
    """The expert-indexed decode path (its plain versions on the CPU)
    against the JAX package's ``_moe_cond`` on the same routing."""
    jcfg, jp, tcfg, tp, _ = models
    jx, tx = _both(_x((4, 1, tcfg.dim), 4))
    jlayer = dict(jp["layers"][1])
    w = jllama.moe_router(jlayer, jcfg, jx)
    jlayer["experts"] = jllama._expert_views(jlayer.pop("experts_st"), jcfg.n_experts)
    want = jllama._moe_cond(jlayer, jcfg, jx, w)
    layer = tp["layers"][1]
    with torch.inference_mode():
        topv, topi = _route(tcfg, layer, tx)
        assert np.allclose(tllama.route_weights(tcfg, topv, topi).numpy(), np.asarray(w),
                           atol=1e-6)
        got = tllama._moe_cond(layer["experts_st"], tcfg, tx, topv, topi)
    _close(got.float(), np.asarray(want, np.float32))


def test_expert_matmul_matches_per_expert(models):
    """Each role's expert-indexed matmul (pairs sorted by expert, runs of
    several rows, one expert with none) equals each row's own expert's
    matmul through the dispatcher."""
    _, _, tcfg, tp, _ = models
    st = tp["layers"][0]["experts_st"]
    eid = torch.tensor([0, 0, 0, 1, 3, 3, 3, 3, 3, 3, 3, 3, 3], dtype=torch.int32)
    for role in ("ffn_gate", "ffn_up", "ffn_down"):
        w = st[role]
        x = torch.from_numpy(_x((len(eid), w.in_features), 5)).bfloat16()
        with torch.inference_mode():
            got = qm.expert_matmul(w, x, eid, torch.float32)
            want = torch.stack([qm.expert_view(w, int(e)).matmul(x[i:i + 1], torch.float32)[0]
                                for i, e in enumerate(eid.tolist())])
        _close(got, want, 1e-5)


def test_stacked_experts_match_per_expert_list(models):
    """The fused load stacks each role's experts into (E, ...)-leading
    arrays; its prefill and decode logits equal the unfused per-expert
    list's (which runs every expert over every row) within the f32 sum
    order of the fused Q/K/V."""
    _, _, tcfg, tp, tlist = models
    layer = tp["layers"][0]
    assert "experts_st" in layer and "experts" not in layer
    assert layer["experts_st"]["ffn_gate"].codes.shape[0] == tcfg.n_experts
    assert "experts" in tlist["layers"][0]
    ids = torch.from_numpy(np.random.default_rng(6).integers(5, 250, (1, 20)).astype(np.int32))
    outs = []
    with torch.inference_mode():
        for params in (tp, tlist):
            cache = tllama.KVCache.zeros(tcfg, 1, 32, "cpu")
            pre = tllama.forward(params, tcfg, ids, torch.zeros(1, dtype=torch.int32), cache)
            dec = tllama.forward(params, tcfg, ids[:, :1], torch.full((1,), 20, dtype=torch.int32),
                                 cache)
            outs.append((pre, dec))
    for a, b in zip(*outs):
        _close(a, b, 0.01)


# -- the expert-indexed kernels under tests/cuda_emu --------------------------

EIDS = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2]   # 10 rows of expert 0 (8 + 2), none of 1
OUT = 10
CASES = [  # (bits, in, sub, bias, layout, has_min, signed sc)
    (4, 512, 32, 0, "flat", True, False), (4, 512, 32, 0, "compact", True, False),
    (4, 1408, 32, 0, "flat", True, False), (2, 512, 16, 0, "mixed", True, False),
    (4, 512, 16, 4, "flat", False, True)]


def _stacked(bits, in_f, sub, layout, has_min, signed, g, n_exp=3):
    per = [_arrays(bits, OUT, in_f, sub, layout, has_min, signed, g) for _ in range(n_exp)]
    return [None if a[0] is None else torch.stack(list(a)) for a in zip(*per)]


@pytest.mark.parametrize("bits,in_f,sub,bias,layout,has_min,signed", CASES, ids=str)
def test_lowbit_moe_kernel_emulated(emu, bits, in_f, sub, bias, layout, has_min, signed):  # noqa: F811
    mod, launches = emu
    g = torch.Generator().manual_seed(bits * 10 + in_f + sub)
    arrs = _stacked(bits, in_f, sub, layout, has_min, signed, g)
    eid = torch.tensor(EIDS, dtype=torch.int32)
    x = torch.randn(len(EIDS), in_f, generator=g).bfloat16()
    xsum = qm._block_sums(x, sub)
    if layout == "mixed":
        vars_ = [qm.VAR_FSPLIT]
    elif bits == 4:
        vars_ = [qm.VAR_FSPLIT, qm.VAR_XSUM, qm.VAR_SPLIT, qm.VAR_BASE]
    else:
        vars_ = [qm.VAR_FSPLIT, qm.VAR_BASE_F32]
    for var in vars_:
        xs = None if var in (qm.VAR_BASE, qm.VAR_BASE_F32) else xsum
        got = mod.quant_matmul_lowbit_moe(x, xs, eid, *arrs, bias, bits, var)
        want = qm.quant_matmul_lowbit_moe_plain(x, xs, eid, *arrs, bias, bits, var)
        assert (got - want).abs().max() <= EMU_TOL * want.abs().max(), var
    assert launches.get(qm.NAME_LOWBIT_MOE if bits == 2 else qm.NAME_4BIT_MOE, 0)


@pytest.mark.parametrize("in_f,sub,layout,signed", [(512, 32, "flat", False),
                                                    (1408, 32, "flat", False),
                                                    (512, 16, "compact", True)], ids=str)
def test_8bit_moe_kernel_emulated(emu, in_f, sub, layout, signed):  # noqa: F811
    mod, launches = emu
    g = torch.Generator().manual_seed(in_f + sub)
    codes, d, sc, _, _ = _stacked(8, in_f, sub, layout, False, signed, g)
    eid = torch.tensor(EIDS, dtype=torch.int32)
    x = torch.randn(len(EIDS), in_f, generator=g).bfloat16()
    got = mod.quant_matmul_8bit_moe(x, eid, codes, d, sc, sub, 0)
    want = qm.quant_matmul_8bit_moe_plain(x, eid, codes, d, sc, sub, 0)
    assert (got - want).abs().max() <= EMU_TOL * want.abs().max()
    assert launches.get(qm.NAME_8BIT_MOE, 0)
