"""Speculative decoding in the port's ServingEngine against the JAX
package's, under replay and pricing (the engine pair and drafts of
``torch_spec_twins``): a preemption that unseats a speculating request,
prefix-cache hits, injected ``spec_draft`` / ``spec_verify`` faults, a
divergent draft, the all-zero draft's γ falling and the target's own
climbing to 8, occupancy pricing speculation out, and an EOS inside a
burst. Every stream, round, counter and status equals the JAX spec
engine's, and every stream the port's plain engine's.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from torch_serving_twins import solo, tokens
from torch_spec_twins import (  # noqa: F401  (fixtures)
    PAGE, _hold, _submit_run, clock, models)


def _preempt_script(eng):
    rng = np.random.default_rng(3)
    ps = [tokens(rng, n) for n in (5, 9, 6)]
    rids = [eng.submit(ps[0], 10), eng.submit(ps[1], 10)]
    for _ in range(4):
        eng.step()
    rids.append(eng.submit(ps[2], 4, deadline=0.5))
    out = eng.run(max_wall=300.0)
    return dict(streams=[out[r] for r in rids],
                statuses=[eng.status(r) for r in rids],
                preemptions=eng.preemptions)


def test_preemption_replays_the_draft(models, clock):
    """A tight arrival unseats a speculating request: its draft span goes
    back with its slot, and its replay re-syncs the draft."""
    got = _hold(models, clock, _preempt_script,
                flags=dict(serving_spec_max_slots=16))
    assert got["preemptions"] == 1


def _prefix_script(eng):
    rng = np.random.default_rng(4)
    shared = tokens(rng, 2 * PAGE)
    ps = [np.concatenate([shared, tokens(rng, n)]) for n in (3, 5, 9)]
    rids = [eng.submit(ps[0], 8)]
    out = eng.run(max_wall=300.0)
    rids += [eng.submit(p, 8) for p in ps[1:]]
    out.update(eng.run(max_wall=300.0))
    return dict(streams=[out[r] for r in rids],
                statuses=[eng.status(r) for r in rids[1:]],
                cached_pages=len(eng._prefix._nodes))


def test_prefix_hits_keep_the_plain_stream(models, clock):
    """Hits adopt cached pages and teacher-force their suffix through the
    plain step (a pending row keeps the step plain); speculation takes
    over once the suffix is fed."""
    got = _hold(models, clock, _prefix_script, prefix_cache=True)
    assert got["cached_pages"] >= 2


@pytest.mark.parametrize("spec", ["spec_draft:every=3",
                                  "spec_verify:every=4",
                                  "spec_draft:every=5;spec_verify:every=3"])
def test_spec_faults_replay_the_same_streams(models, clock, spec):
    def script(eng):
        out = _submit_run((5, 8, 13), 10)(eng)
        if eng.draft_model is not None:
            out["fires"] = [(s.calls, s.fires) if s.armed else None
                            for s in (eng._f_spec_draft,
                                      eng._f_spec_verify)]
            out["attached"] = all(k is not None
                                  for k in eng._draft_pool.k_pages)
        return out
    got = _hold(models, clock, script, spec=spec,
                flags=dict(serving_max_retries=20))
    assert got["attached"] and any(f and f[1] for f in got["fires"])


def test_divergent_draft_rejects(models, clock):
    got = _hold(models, clock, _submit_run((7,), 16, head=1), draft="narrow")
    assert got["rejected"] > 0


def test_zero_draft_falls_and_agreeing_draft_climbs(models, clock):
    flags = dict(serving_spec_max_slots=16)
    zero = _hold(models, clock, _submit_run((6,), 32, head=1), draft="zero",
                 flags=flags, max_batch=4, max_seq_len=96)
    gammas = [g for _, g in zero["rounds"]]
    assert max(gammas) <= 4 and gammas[-1] == 2
    assert zero["rejected"] > zero["accepted"]
    same = _hold(models, clock, _submit_run((6,), 48, head=1), draft="same",
                 flags=flags, max_batch=4, max_seq_len=96)
    assert max(g for _, g in same["rounds"]) == 8
    assert same["rejected"] == 0


def test_occupancy_prices_speculation_out(models, clock):
    """4 rows at γ + 1 = 3 slots each exceed max(max_batch, 3) = 4: the
    full batch decodes plain, so speculation serves fewer than all
    tokens."""
    got = _hold(models, clock, _submit_run((6, 6, 6, 6), 8, head=4),
                max_batch=4)
    total = sum(len(t) for t in got["streams"])
    assert 0 < got["accepted"] + got["spec_rounds"] < total


def test_eos_inside_a_burst_truncates(models, clock):
    """The target as its own draft accepts whole bursts: an EOS picked
    inside one ends the stream exactly where the plain engine does."""
    jmodel = models["target"][0]
    rng = np.random.default_rng(4)
    for _ in range(40):
        p = tokens(rng, 6)
        ref = solo(jmodel, p, 12)
        inner = [i for i in range(2, len(ref) - 1) if ref[i] not in ref[:i]]
        if inner:
            eos = ref[inner[0]]
            break
    else:
        pytest.fail("no prompt with an interior EOS candidate")

    def script(eng):
        rid = eng.submit(p, 12, eos_token_id=eos)
        out = eng.run(max_wall=300.0)
        return dict(streams=[out[rid]], statuses=[eng.status(rid)])
    got = _hold(models, clock, script, draft="same")
    assert got["streams"] == [ref[:ref.index(eos) + 1]]
