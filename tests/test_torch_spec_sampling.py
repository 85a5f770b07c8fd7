"""Speculative sampling in the port's ServingEngine against the JAX
package's (the engine pair and drafts of ``torch_spec_twins``): the
filtered law against the JAX package's ``_spec_filtered_probs`` (1e-6
abs, f32), ``_spec_accept_sample`` bit for bit, the race sampler's law,
the emitted law against the analytic target law (TV < 0.12 over 400
seeds), the same seed giving the same tokens (also under faults), a
sampled replay without progress failing as in JAX, and greedy rows beside
a sampled one keeping their stream. The draft's draws come from torch
uniforms, not ``jax.random``'s bits, so sampled streams are not compared
across packages.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.generation import serving as jserving
from paddle_tpu_torch.generation import sampling as tsampling
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.testing import faults as tfaults
from torch_serving_twins import solo, tokens
from torch_spec_twins import (  # noqa: F401  (fixtures)
    PAGE, _both, clock, models)


@pytest.mark.parametrize("top_k,top_p,temperature", [
    (0, 1.0, 1.0), (4, 1.0, 0.8), (50, 0.95, 0.8), (0, 0.5, 1.3),
    (1, 0.9, 0.7), (8, 0.0, 1.0)])
def test_filtered_probs_match_jax(top_k, top_p, temperature):
    rng = np.random.default_rng(top_k + int(100 * top_p))
    rows = (rng.standard_normal((5, 256)) * 3).astype(np.float32)
    rows[0, :12] = rows[0, 3]                  # ties at the threshold
    want = np.asarray(jserving._spec_filtered_probs(
        jnp.asarray(rows), jnp.float32(temperature), top_k,
        jnp.float32(top_p)))
    got = tsampling._spec_filtered_probs(
        torch.from_numpy(rows), torch.tensor([temperature]), top_k,
        torch.tensor([top_p])).numpy()
    assert np.abs(got - want).max() <= 1e-6


def _laws(rng, rows, vocab=64, keep=8):
    x = np.zeros((rows, vocab), np.float32)
    for r in range(rows):
        idx = rng.choice(vocab, keep, replace=False)
        x[r, idx] = rng.dirichlet(np.ones(keep)).astype(np.float32)
    return x


@pytest.mark.parametrize("seed", range(6))
def test_accept_sample_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    gamma = (2, 4, 8)[seed % 3]
    q, p = _laws(rng, gamma), _laws(rng, gamma + 1)
    props = np.array([rng.choice(64, p=row / row.sum()) for row in q])
    if seed % 2:
        p[:gamma] = q                          # an agreeing target
    req_j = jserving.Request(0, np.zeros(2, np.int32), 8, seed=seed)
    req_t = tserving.Request(0, np.zeros(2, np.int32), 8, seed=seed)
    for L in (3, 17):
        want = jserving.ServingEngine._spec_accept_sample(
            None, req_j, L, gamma, props, q, p)
        got = tserving.ServingEngine._spec_accept_sample(
            None, req_t, L, gamma, props, q, p)
        assert got == want


def test_race_sample_draws_the_law():
    q = torch.tensor([0.1, 0.2, 0.7, 0.0]).expand(100000, 4)
    u = torch.rand(q.shape, generator=torch.Generator().manual_seed(0))
    freq = torch.bincount(tsampling.race_sample(q, u), minlength=4) / 1e5
    assert float((freq - q[0]).abs().max()) < 0.01 and freq[3] == 0


def _sampled(models, prompt, new, seed, spec="", **law):
    with tfaults.armed(spec, serving_retry_backoff=0.001,
                       serving_max_retries=20):
        eng = tserving.ServingEngine(
            models["target"][1], max_batch=2, page_size=PAGE, max_seq_len=64,
            draft_model=models["draft"][1])
    rid = eng.submit(prompt, new, seed=seed, **law)
    out = eng.run(max_wall=300.0)[rid]
    fires = sum(s.fires for s in (eng._f_spec_draft, eng._f_spec_verify)
                if s.armed)
    return out, fires


def test_sampled_same_seed_same_tokens_also_under_faults(models):
    p = np.array([3, 5, 7, 11, 2, 9], np.int32)
    law = dict(temperature=0.8, top_k=16, top_p=0.95)
    a, _ = _sampled(models, p, 12, 5, **law)
    b, _ = _sampled(models, p, 12, 5, **law)
    c, _ = _sampled(models, p, 12, 6, **law)
    assert a == b and a != c and len(a) == 12
    faulted, fires = _sampled(
        models, p, 12, 5, spec="spec_draft:every=3;spec_verify:every=4",
        **law)
    assert fires > 0 and faulted == a


def test_sampled_replay_without_progress_fails_like_jax(models, clock):
    """A sampled replay emits nothing at its prefill (the verify samples
    that position), and once its draft needs two sync chunks an unbounded
    ``spec_draft:every=3`` fires within every replay: no progress, so the
    request ends FAILED in both engines, and a bounded spec serves it."""
    p = tokens(np.random.default_rng(0), 70)

    def script(eng):
        rid = eng.submit(p, 12, temperature=0.8, top_k=16, seed=3)
        out = eng.run(max_wall=300.0)
        return dict(status=eng.status(rid), tokens=len(out[rid]))
    for spec, status in (("spec_draft:every=3", "FAILED"),
                         ("spec_draft:every=3:times=2", "OK")):
        want, got = _both(models, clock, script, spec=spec, max_batch=1,
                          max_seq_len=128)
        assert got["status"] == want["status"] == status
        assert got["rounds"] == want["rounds"]


def test_rejection_sampling_emits_the_target_law(models):
    """The emitted token's law is the target's filtered softmax, whatever
    the (divergent) draft proposes: 400 single-token draws."""
    target = models["target"][1]
    p = np.array([3, 5, 7, 11, 2], np.int32)
    temp, top_k, n = 1.0, 4, 400
    with torch.no_grad():
        logits = target(torch.from_numpy(p[None].astype(np.int64)))
    lg = logits[0, -1].double().numpy() / temp
    lg = np.where(lg >= np.sort(lg)[-top_k], lg, -np.inf)
    expect = np.exp(lg - lg.max())
    expect /= expect.sum()
    eng = tserving.ServingEngine(target, max_batch=2, page_size=PAGE,
                                 max_seq_len=64,
                                 draft_model=models["draft"][1])
    counts = np.zeros(len(expect))
    for seed in range(n):
        rid = eng.submit(p, 1, temperature=temp, top_k=top_k, seed=seed)
        counts[eng.run()[rid][0]] += 1
    tv = 0.5 * np.abs(counts / n - expect).sum()
    assert tv < 0.12, (tv, np.nonzero(counts)[0].tolist())
    assert eng.spec_rounds == n


def test_mixed_batch_keeps_greedy_parity(models, clock):
    """A sampled row forces the step onto speculation; the greedy row
    beside it keeps the JAX spec engine's stream, and the sampled row
    parks its prefill one short (its first token is the verify's)."""
    rng = np.random.default_rng(6)
    pg, ps = tokens(rng, 6), tokens(rng, 5)

    def script(eng):
        rg = eng.submit(pg, 10)
        rs = eng.submit(ps, 10, temperature=1.0, top_k=8, seed=1)
        out = eng.run(max_wall=300.0)
        return dict(greedy=out[rg], sampled=len(out[rs]))
    want, got = _both(models, clock, script)
    assert got["greedy"] == want["greedy"] == solo(models["target"][0], pg,
                                                   10)
    assert got["sampled"] == 10
