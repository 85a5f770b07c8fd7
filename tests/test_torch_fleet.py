"""The port's ``FleetRouter`` (``generation/fleet.py``) against the JAX
package's on the CPU: twin fleets over the same tiny GPT (built by the JAX
package from a seed, carried into the port through ``raw_state()``), the
same traffic and, where a drill needs it, the same ``FLAGS_fault_inject``
spec in both packages.

Mirrors ``tests/test_fleet.py``'s routing, replica-loss and replica-label
tests and holds the port to the reference: ``placements`` (rid, replica,
reason) equal, every stream equal token for token (fp32), and the fleet
counters' increases (``fleet_requests_routed{replica,reason}``,
``fleet_replica_losses``, ``fleet_rerouted_requests``) equal, through
losses, the crash-loop budget, a raising callback and ``results()`` across
a loss.
"""

import contextlib

import numpy as np
import pytest

import paddle_tpu.observability as jobs
from paddle_tpu.generation.fleet import FleetRouter as JFleet
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.generation.fleet import FleetRouter
from paddle_tpu_torch.generation.serving import ServingEngine
from paddle_tpu_torch.testing import faults as tfaults
from torch_serving_twins import tiny_gpts

KW = dict(max_batch=2, page_size=8, max_seq_len=64)
COUNTERS = ("fleet_requests_routed", "fleet_replica_losses",
            "fleet_rerouted_requests")


@pytest.fixture(scope="module")
def models():
    return tiny_gpts(211)


@contextlib.contextmanager
def both_armed(spec):
    with jfaults.armed(spec), tfaults.armed(spec):
        yield


def counters(obs):
    """The fleet families' series, {(name, labels): value}."""
    out = {}
    metrics = obs.snapshot()["metrics"]
    for name in COUNTERS:
        for s in metrics.get(name, {}).get("series", []):
            out[name, tuple(sorted(s["labels"].items()))] = s["value"]
    return out


def increase(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def org_prompts(n_orgs, body_count, prefix_tokens, body_tokens, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_orgs):
        prefix = rng.integers(0, 256, (prefix_tokens,)).astype(np.int32)
        for _ in range(body_count):
            body = rng.integers(0, 256, (body_tokens,)).astype(np.int32)
            out.append(np.concatenate([prefix, body]))
    return out


def twins(models, drive, spec="", **kw):
    """``drive(fleet)`` on a JAX fleet and a port fleet built alike (under
    ``spec``); returns both drives' results, both fleets and both
    counters' increases."""
    jmodel, model = models
    res, fleets, incs = [], [], []
    for cls, m, obs in ((JFleet, jmodel, jobs), (FleetRouter, model, tobs)):
        before = counters(obs)
        with (jfaults if cls is JFleet else tfaults).armed(spec):
            fleet = cls(m, **dict(KW, **kw))
            res.append(drive(fleet))
        incs.append(increase(before, counters(obs)))
        fleets.append(fleet)
    return res, fleets, incs


def test_cold_prompts_round_robin(models):
    def drive(fleet):
        rng = np.random.default_rng(0)
        rids = [fleet.submit(rng.integers(0, 256, (9,)).astype(np.int32), 2)
                for _ in range(6)]
        out = fleet.run()
        return [out[r] for r in rids]

    res, fleets, incs = twins(models, drive, replicas=3)
    assert res[1] == res[0]
    assert fleets[1].placements == fleets[0].placements
    assert [ri for _, ri, _ in fleets[1].placements] == [0, 1, 2, 0, 1, 2]
    assert incs[1] == incs[0]


def test_affinity_routes_to_the_warm_replica(models):
    prompts = org_prompts(1, 3, 16, 1, seed=3)

    def drive(fleet):
        r0 = fleet.submit(prompts[0], 3, replica=1)
        out = fleet.run()
        rids = [fleet.submit(p, 3) for p in prompts[1:]]
        out2 = fleet.run()
        return [out[r0]] + [out2[r] for r in rids]

    res, fleets, incs = twins(models, drive, replicas=3)
    assert res[1] == res[0]
    assert fleets[1].placements == fleets[0].placements
    assert [p[1:] for p in fleets[1].placements[1:]] == [(1, "affinity")] * 2
    assert incs[1] == incs[0]
    # an affinity hit continues as the cold decode of the same prompt
    _, model = models
    solo = FleetRouter(model, replicas=1, **KW)
    srids = [solo.submit(p, 3) for p in prompts]
    sout = solo.run()
    assert res[1] == [sout[r] for r in srids]


def test_round_robin_policy_ignores_the_cache(models):
    def drive(fleet):
        rids = [fleet.submit(p, 2) for p in org_prompts(1, 4, 16, 1, seed=4)]
        out = fleet.run()
        return [out[r] for r in rids]

    res, fleets, incs = twins(models, drive, replicas=3,
                              policy="round_robin")
    assert res[1] == res[0]
    assert {w for _, _, w in fleets[1].placements} == {"round_robin"}
    assert fleets[1].placements == fleets[0].placements
    assert incs[1] == incs[0]


@pytest.mark.parametrize("deadline", [None, 30.0])
def test_balance_tiebreak(models, deadline):
    prompts = org_prompts(1, 4, 16, 1, seed=6)

    def drive(fleet):
        fleet.submit(prompts[0], 2, replica=0)
        fleet.submit(prompts[1], 2, replica=1)
        fleet.run()
        fleet.submit(prompts[2], 8, replica=0, deadline=deadline)
        rid = fleet.submit(prompts[3], 2, deadline=deadline)
        out = fleet.run()
        return rid, out

    res, fleets, incs = twins(models, drive, replicas=2)
    placed = {r: (ri, why) for r, ri, why in fleets[1].placements}
    assert placed[res[1][0]] == (1, "balance")
    assert fleets[1].placements == fleets[0].placements
    assert res[1][1] == res[0][1]
    assert incs[1] == incs[0]


def test_refusals(models):
    _, model = models
    with pytest.raises(ValueError, match="policy"):
        FleetRouter(model, replicas=2, policy="hash")
    with pytest.raises(ValueError, match="replica"):
        FleetRouter(model, replicas=0)
    with pytest.raises(ValueError, match="tp_degree"):
        FleetRouter(model, replicas=2, tp_degree=0, **KW)


def test_tensor_parallel_replicas_match_jax(models):
    """``tp_degree=2`` makes every replica a tensor-parallel engine (the
    port's on one device, JAX's over two host devices): placements,
    streams and counters as the JAX fleet's, and each replica's series
    under tp "2"."""
    def drive(fleet):
        rids = [fleet.submit(p, 3) for p in org_prompts(2, 2, 16, 2, seed=8)]
        out = fleet.run()
        return [out[r] for r in rids]

    res, fleets, incs = twins(models, drive, replicas=2, tp_degree=2)
    assert res[1] == res[0]
    assert fleets[1].placements == fleets[0].placements
    assert incs[1] == incs[0]
    assert [(e.replica, e.tp_degree) for e in fleets[1].engines] == [
        ("0", 2), ("1", 2)]


def test_streaming_callback_carries_the_fleet_rid(models):
    _, model = models
    fleet = FleetRouter(model, replicas=2, **KW)
    seen = []
    rng = np.random.default_rng(9)
    fleet.submit(rng.integers(0, 256, (5,)).astype(np.int32), 2)
    rid = fleet.submit(rng.integers(0, 256, (7,)).astype(np.int32), 3,
                       on_token=lambda r, t, d: seen.append((r, t, d)))
    out = fleet.run()
    assert {r for r, _, _ in seen} == {rid}
    assert [t for _, t, d in seen if not d] == out[rid]
    assert seen[-1] == (rid, None, True)
    assert fleet.status(rid) == "OK"


def _mix(fleet):
    rng = np.random.default_rng(31)
    rids = [fleet.submit(p, 4) for p in org_prompts(2, 3, 16, 1, seed=32)]
    rids += [fleet.submit(rng.integers(0, 256, (9,)).astype(np.int32), 4)
             for _ in range(2)]
    return rids


@pytest.mark.parametrize("spec", ["", "router_dispatch:every=4:times=2",
                                  "router_dispatch:every=3:times=4"])
def test_loss_reroutes_token_for_token(models, spec):
    def drive(fleet):
        rids = _mix(fleet)
        out = fleet.run(max_wall=120.0)
        return ([out[r] for r in rids], [fleet.status(r) for r in rids],
                fleet.losses, fleet.rerouted)

    res, fleets, incs = twins(models, drive, spec, replicas=2)
    assert res[1] == res[0]
    streams, statuses, losses, rerouted = res[1]
    assert set(statuses) == {"OK"}
    assert (losses >= 1) == bool(spec) and (rerouted >= 1) == bool(spec)
    assert fleets[1].placements == fleets[0].placements
    assert incs[1] == incs[0]
    assert not fleets[1].has_work()
    base = twins(models, drive, "", replicas=2)[0][1][0]
    assert streams == base


def test_crash_loop_bounded_by_the_loss_budget(models):
    def drive(fleet):
        _mix(fleet)
        try:
            fleet.run(max_wall=60.0)
        except Exception as exc:              # noqa: BLE001
            return type(exc).__name__, fleet.losses, fleet.max_losses
        return None

    res, _, incs = twins(models, drive, "router_dispatch:every=1",
                         replicas=2)
    assert res[1] == res[0] == ("InjectedFault", 6, 6)
    assert incs[1] == incs[0]


def test_raising_callback_is_not_a_loss(models):
    _, model = models
    fleet = FleetRouter(model, replicas=2, **KW)
    rng = np.random.default_rng(43)

    def bad_cb(rid, tok, done):
        raise ValueError("client bug")

    fleet.submit(rng.integers(0, 256, (7,)).astype(np.int32), 3,
                 on_token=bad_cb)
    with pytest.raises(ValueError, match="client bug"):
        while fleet.has_work():
            fleet.run_step()
    assert fleet.losses == 0


def test_results_survive_a_loss(models):
    def drive(fleet):
        rng = np.random.default_rng(41)
        rids = [fleet.submit(rng.integers(0, 256, (7,)).astype(np.int32), 3)
                for _ in range(4)]
        while fleet.has_work() and not fleet.results():
            fleet.run_step()
        early = dict(fleet.results())
        for ri in range(2):
            if fleet.engines[ri].has_work():
                fleet._lose_replica(ri, RuntimeError("test loss"))
        assert all(fleet.results()[r] == t for r, t in early.items())
        out = fleet.run(max_wall=120.0)
        return ([out[r] for r in rids], sorted(out) == sorted(rids),
                [fleet.status(r) for r in rids])

    res, fleets, incs = twins(models, drive, replicas=2)
    assert res[1] == res[0]
    assert res[1][1] and set(res[1][2]) == {"OK"}
    assert fleets[1].losses == fleets[0].losses >= 1
    assert incs[1] == incs[0]


def test_a_lost_replica_releases_its_device_state(models):
    _, model = models
    fleet = FleetRouter(model, replicas=2, **KW)
    _mix(fleet)
    fleet.run_step()
    lost = fleet.engines[0]
    fleet._lose_replica(0, RuntimeError("test loss"))
    assert fleet.engines[0] is not lost
    assert all(t is None for t in lost.pool.k_pages + lost.pool.v_pages)
    assert not lost._decode_fns and lost._chunk_fn is None
    assert lost._prefix is None
    fleet.run(max_wall=120.0)


def test_engine_series_do_not_collide(models):
    _, model = models
    rng = np.random.default_rng(51)
    engs = [ServingEngine(model, replica=f"tlbl{i}", **KW) for i in range(2)]
    for n, eng in zip((1, 2), engs):
        for _ in range(n):
            eng.submit(rng.integers(0, 256, (6,)).astype(np.int32), 2)
        eng.run(max_wall=60.0)
    fam = tobs.snapshot()["metrics"]["serving_requests_submitted"]
    got = {s["labels"]["replica"]: s["value"] for s in fam["series"]}
    assert (got["tlbl0"], got["tlbl1"]) == (1, 2)
    reps = {s["labels"]["replica"]
            for s in tobs.snapshot()["metrics"]["kv_pool_pages"]["series"]}
    assert {"tlbl0", "tlbl1"} <= reps
    fleet = FleetRouter(model, replicas=2, **KW)
    fam = tobs.snapshot()["metrics"]["fleet_replicas"]
    assert fam["series"][0]["value"] == 2
    assert fleet.statuses() == {}
