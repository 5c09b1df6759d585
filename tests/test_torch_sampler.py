"""The port's batched sampler against the JAX package's, stage by stage, on
the CPU.

Both get the same numpy inputs. Masks (which logits are -inf) and integer
state (counts, step) must be equal; f32 values (penalized logits, kept
logits, mirostat's mu) agree within 1e-6 relative, the two frameworks'
elementwise rounding of the same f32 operations. The JAX package's own
sampler tests (``tests/test_sampler.py``) are cases here, each run through
both functions.

The draw is the port's own (Gumbel-max over hashed noise; the JAX package
draws with ``jax.random``), so it is held to its properties instead:
reproducible per (seed, step), different across steps, independent of the
batch around a row, and distributed as the masked softmax (a frequency
test at V = 8).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_gguf_inference_tpu.runtime import sampler as js
from llama_gguf_inference_tpu_torch.runtime import sampler as ts

RTOL = 1e-6


def _jst(**fields):
    """A JAX SampleState of the rows given as numpy arrays."""
    B, V = fields["counts"].shape
    st = js.SampleState.init(B, V)
    return st._replace(**{k: jnp.asarray(v) for k, v in fields.items()})


def _tst(**fields):
    B, V = fields["counts"].shape
    st = ts.SampleState.init(B, V)
    for k, v in fields.items():
        getattr(st, k).copy_(torch.from_numpy(np.asarray(v)))
    return st


def _same_mask(got: torch.Tensor, want) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL)


def _logits(seed, B=4, V=64, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((B, V)) * scale).astype(np.float32)


# --- penalties ----------------------------------------------------------------

PENALTY_CASES = [
    # (counts, presence, frequency, repeat, logits): the JAX test_sampler cases
    # first, then random rows
    ([[2, 0, 1, 0, 0]], [0.5], [0.25], [1.0], [[1.0] * 5]),
    ([[1, 1, 0, 0]], [0.0], [0.0], [2.0], [[2.0, -2.0, 2.0, -2.0]]),
    ("random", 0),
    ("random", 1),
]


@pytest.mark.parametrize("case", range(len(PENALTY_CASES)))
def test_penalties_match_jax(case):
    c = PENALTY_CASES[case]
    if c[0] == "random":
        rng = np.random.default_rng(c[1])
        B, V = 4, 64
        counts = rng.integers(0, 3, (B, V)).astype(np.int32)
        pres, freq = rng.uniform(-1, 1, B), rng.uniform(-1, 1, B)
        rep = rng.uniform(0.5, 2.0, B)
        logits = _logits(c[1], B, V)
    else:
        counts, pres, freq, rep, logits = (np.asarray(x) for x in c)
        counts = counts.astype(np.int32)
        logits = logits.astype(np.float32)
    f = dict(counts=counts, presence=np.float32(pres), frequency=np.float32(freq),
             repeat=np.float32(rep))
    want = js.apply_penalties(jnp.asarray(logits), _jst(**f))
    got = ts.apply_penalties(torch.from_numpy(logits), _tst(**f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


# --- truncation masks ------------------------------------------------------------

MASK_CASES = [
    # (stage, logits rows, parameter per row): JAX test_sampler's, then random
    ("top_k", [[1.0, 5.0, 3.0, 2.0, 4.0]] * 2, [2, 0]),
    ("top_k", "random", [1, 5, 0, 200]),
    ("top_k", [[1.0, 3.0, 3.0, 3.0, 0.0]], [2]),               # ties at the k-th
    ("top_p", [[5.0, 4.0, 3.0, 2.0, -1.0]] * 3, [0.8, 1.0, 1e-6]),
    ("top_p", "random", [0.1, 0.5, 0.9, 1.0]),
    ("min_p", [[5.0, 4.0, 0.0, -5.0]], [0.3]),
    ("min_p", "random", [0.0, 0.05, 0.3, 0.9]),
    ("typical", "random", [0.3, 1.0, 0.0, 0.7]),
    ("typical", [[0.0] * 64], [0.5]),
    ("typical", [[9.0, 0.0, 0.0, -3.0, 1.0]], [-1.0]),         # <= 0 keeps the most typical
]


@pytest.mark.parametrize("case", range(len(MASK_CASES)))
def test_masks_match_jax(case):
    stage, rows, par = MASK_CASES[case]
    logits = _logits(case, len(par)) if rows == "random" else np.asarray(rows, np.float32)
    jfn = {"top_k": js._mask_top_k, "top_p": js._mask_top_p, "min_p": js._mask_min_p,
           "typical": js._mask_typical}[stage]
    tfn = {"top_k": ts._mask_top_k, "top_p": ts._mask_top_p, "min_p": ts._mask_min_p,
           "typical": ts._mask_typical}[stage]
    dtype = np.int32 if stage == "top_k" else np.float32
    want = jfn(jnp.asarray(logits), jnp.asarray(np.asarray(par, dtype)))
    got = tfn(torch.from_numpy(logits),
              torch.tensor(par, dtype=torch.int64 if stage == "top_k" else torch.float32))
    _same_mask(got, want)


# --- mirostat -------------------------------------------------------------------

MIRO_CASES = [(2, 4.0), (2, 9.0), (1, 5.0), (1, 8.0), (0, 5.0)]


@pytest.mark.parametrize("mode,mu", MIRO_CASES)
def test_mirostat_mask_and_update_match_jax(mode, mu):
    B, V = 3, 300
    logits = _logits(int(mu * 10) + mode, B, V)
    f = dict(counts=np.zeros((B, V), np.int32),
             miro=np.array([mode, 0, mode], np.int32),
             miro_mu=np.array([mu, mu, mu / 2], np.float32),
             miro_tau=np.full(B, 5.0, np.float32), miro_eta=np.full(B, 0.1, np.float32))
    jst = _jst(**f)
    tst = _tst(**{k: (v.astype(np.int64) if k == "miro" else v) for k, v in f.items()})
    want = js._mirostat_mask(jnp.asarray(logits), jst)
    got = ts._mirostat_mask(torch.from_numpy(logits), tst)
    _same_mask(got, want)
    tok = np.asarray(want).argmax(-1)
    np.testing.assert_allclose(
        ts._mirostat_update(got, torch.from_numpy(tok), tst).numpy(),
        np.asarray(js._mirostat_update(want, jnp.asarray(tok.astype(np.int32)), jst)),
        rtol=RTOL)


# --- state -----------------------------------------------------------------------

def test_bias_row_and_write_slot_match_jax():
    V = 50
    p = js.SamplingParams(temperature=0.7, top_p=0.9, top_k=7, min_p=0.02, typical_p=0.8,
                          presence_penalty=0.3, frequency_penalty=0.1, repeat_penalty=1.2,
                          mirostat=2, mirostat_tau=3.3, mirostat_eta=0.2, seed=2**31 + 5,
                          logit_bias={3: 2.5, 49: -1e9, 60: 1.0, -1: 4.0})
    tp = ts.SamplingParams(**dataclasses.asdict(p))
    np.testing.assert_array_equal(ts.bias_row(tp, V), js.bias_row(p, V))
    prompt = [1, 4, 4, 9, 3, 4]
    jst = js.SampleState.init(3, V).write_slot(1, p, prompt)
    tst = ts.SampleState.init(3, V)
    tst.counts[1, 0] = 5                 # stale counts of an earlier request
    tst.write_slot(1, tp, prompt)
    for f in dataclasses.fields(tst):
        want = np.asarray(getattr(jst, f.name))
        got = getattr(tst, f.name).numpy()
        if f.name == "seed":
            want = want.astype(np.int64)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=f.name)


def test_sample_greedy_tokens_counts_and_step_match_jax():
    """The JAX test_greedy_picks_argmax_and_counts case plus a penalized,
    biased batch: greedy tokens, counts and steps equal over three steps."""
    l = np.array([[0, 9, 1, 2, 3, 4], [5, 0, 0, 0, 0, 0]], np.float32)
    for rows, pen in ((l, False), (_logits(3, 4, 64), True)):
        B, V = rows.shape
        params = [js.SamplingParams(temperature=0.0,
                                    presence_penalty=0.5 * pen, repeat_penalty=1.0 + pen,
                                    logit_bias={b: 1.5} if pen else None)
                  for b in range(B)]
        jst, tst = js.SampleState.init(B, V), ts.SampleState.init(B, V)
        for b, p in enumerate(params):
            jst = jst.write_slot(b, p, [b, b + 1])
            tst.write_slot(b, ts.SamplingParams(**dataclasses.asdict(p)), [b, b + 1])
        gates = ts.Gates.of(ts.SamplingParams(**dataclasses.asdict(p)) for p in params)
        for _ in range(3):
            jt, jst = js.sample(jnp.asarray(rows), jst)
            tt = ts.sample(torch.from_numpy(rows), tst, gates)
            assert tt.tolist() == np.asarray(jt).tolist()
        np.testing.assert_array_equal(tst.counts.numpy(), np.asarray(jst.counts))
        np.testing.assert_array_equal(tst.step.numpy(), np.asarray(jst.step))


def test_token_logprobs_match_jax():
    logits = _logits(9, 3, 100)
    want_v, want_i = js.top_logprobs(jnp.asarray(logits), 8)
    tok = torch.tensor([0, 5, 99])
    lp, got_v, got_i = ts.token_logprobs(torch.from_numpy(logits), tok, 8)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=RTOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    full = torch.log_softmax(torch.from_numpy(logits), -1)
    assert torch.equal(lp, full[torch.arange(3), tok])


# --- the draw ---------------------------------------------------------------------

def _state(params, V):
    st = ts.SampleState.init(len(params), V)
    for b, p in enumerate(params):
        st.write_slot(b, p)
    return st


def test_draw_reproducible_step_dependent_and_batch_independent():
    V = 100
    logits = torch.from_numpy(_logits(0, 1, V, scale=1.0))
    p = ts.SamplingParams(temperature=1.0, seed=123)
    st_a, st_b = _state([p], V), _state([p], V)
    a = [int(ts.sample(logits, st_a, ts.Gates.of([p]))) for _ in range(16)]
    b = [int(ts.sample(logits, st_b, ts.Gates.of([p]))) for _ in range(16)]
    assert a == b                                  # same seed and steps: same tokens
    assert len(set(a)) > 4                         # the step moves the draw
    assert st_a.step.tolist() == [16]
    # the same row inside a batch of others (other seeds, logits, settings)
    others = [ts.SamplingParams(temperature=0.5, top_k=3, seed=9),
              ts.SamplingParams(temperature=0.0),
              ts.SamplingParams(temperature=2.0, seed=123, min_p=0.1)]
    batch = torch.cat([torch.from_numpy(_logits(5, 3, V)), logits])
    st = _state([*others, p], V)
    gates = ts.Gates.of([*others, p])
    assert [int(ts.sample(batch, st, gates)[3]) for _ in range(16)] == a


def test_mixed_greedy_and_sampled_batch():
    """The JAX test case: a greedy row beside a sampled one takes the argmax."""
    l = torch.from_numpy(_logits(1, 2, 50, scale=1.0))
    params = [ts.SamplingParams(temperature=0.0, seed=7),
              ts.SamplingParams(temperature=1.0, seed=7)]
    tok = ts.sample(l, _state(params, 50), ts.Gates.of(params))
    assert int(tok[0]) == int(l[0].argmax())


FREQ_DRAWS = 4096 * 5


def test_draw_follows_masked_softmax():
    """V = 8, temperature 0.7 and top_k 6: FREQ_DRAWS draws (4096 seeds, 5
    steps each). Each token's frequency lies within 5 binomial standard
    deviations of its masked-softmax probability (a false alarm about once
    in 10^5 runs per token), and masked tokens never come."""
    V, rows = 8, 4096
    logits = torch.tensor([[1.5, 0.2, -0.4, 0.9, -2.0, 0.0, 0.6, -1.0]] * rows)
    params = [ts.SamplingParams(temperature=0.7, top_k=6, seed=s) for s in range(rows)]
    st = _state(params, V)
    gates = ts.Gates.of(params[:1])
    counts = torch.zeros(V)
    for _ in range(FREQ_DRAWS // rows):
        counts += torch.bincount(ts.sample(logits, st, gates), minlength=V)
    scaled = logits[0] / 0.7
    kept = scaled >= torch.sort(scaled, descending=True).values[5]
    p = torch.softmax(scaled.masked_fill(~kept, float("-inf")), -1)
    freq = counts / FREQ_DRAWS
    sigma = (p * (1 - p) / FREQ_DRAWS).sqrt()
    assert torch.all((freq - p).abs() <= 5 * sigma + 1e-12), (freq, p)
    assert counts[~kept].sum() == 0


# --- the JAX package's mirostat and typical cases -----------------------------------

def test_mirostat_v2_mu_converges_toward_tau():
    V = 500
    p = ts.SamplingParams(temperature=1.0, mirostat=2, mirostat_tau=2.0,
                          mirostat_eta=0.2, seed=5)
    st = _state([p], V)
    assert float(st.miro_mu[0]) == 4.0
    l = torch.from_numpy((np.random.default_rng(0).normal(size=(1, V)) * 6).astype(np.float32))
    mus = []
    for _ in range(20):
        ts.sample(l, st, ts.Gates.of([p]))
        mus.append(float(st.miro_mu[0]))
    assert mus[-1] != 4.0
    late = mus[10:]
    assert max(late) - min(late) < 3.0


def test_mirostat_v1_samples_and_updates():
    V = 300
    params = [ts.SamplingParams(temperature=1.0, mirostat=1, mirostat_tau=4.0, seed=9),
              ts.SamplingParams(temperature=0.0)]
    st = _state(params, V)
    l = torch.from_numpy((np.random.default_rng(2).normal(size=(2, V)) * 3).astype(np.float32))
    mu1 = float(st.miro_mu[1])
    tok = ts.sample(l, st, ts.Gates.of(params))
    assert float(st.miro_mu[0]) != 8.0
    assert int(tok[1]) == int(l[1].argmax())
    assert float(st.miro_mu[1]) == mu1


def test_mirostat_ignores_truncation_chain():
    V = 200
    l = torch.from_numpy((np.random.default_rng(4).normal(size=(1, V)) * 5).astype(np.float32))
    runs = []
    for top_k in (0, 3):
        p = ts.SamplingParams(temperature=1.0, mirostat=2, mirostat_tau=6.0, top_k=top_k,
                              seed=11)
        st = _state([p], V)
        runs.append([int(ts.sample(l, st, ts.Gates.of([p]))) for _ in range(6)])
    assert runs[0] == runs[1]


def test_gates_do_not_change_a_row_that_needs_no_stage():
    """A stage run for another row leaves this row's tokens as they were."""
    V = 64
    l = torch.from_numpy(_logits(7, 2, V, scale=1.0))
    plain = ts.SamplingParams(temperature=0.8, seed=3)
    busy = ts.SamplingParams(temperature=0.8, seed=4, top_k=5, typical_p=0.5, min_p=0.1,
                             presence_penalty=1.0, mirostat=0)
    alone = _state([plain], V)
    pair = _state([plain, busy], V)
    a = [int(ts.sample(l[:1], alone, ts.Gates.of([plain]))) for _ in range(8)]
    b = [int(ts.sample(l, pair, ts.Gates.of([plain, busy]))[0]) for _ in range(8)]
    assert a == b
