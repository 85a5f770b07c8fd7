"""LocalSGD across ranks and DGC against the JAX package's.

LocalSGD (a world of 2 gloo ranks, dp = 2; the reference's
``tests/test_train_step.py`` setup: ``Linear(4, 2)``, SGD at 0.1 through a
``HybridParallelOptimizer`` carrying ``strategy.localsgd``, mean squared
error, one batch of 8 rows):
- at k = 2 the replicas diverge after step 1 and are equal after step 2,
  the synced value the numpy emulation of two workers' local SGD; each
  rank's parameters after every step equal the JAX step's replica of that
  rank within 1e-6, and the loss is the mean of the replicas' losses;
- ``begin_step`` = 3 (k = 10): steps 1 and 2 synced, step 3 drifts;
- ``state_dict`` has the model's shapes and holds the replicas' mean, as
  the JAX step's does.

DGC (one process): ``DGCMomentum`` under ``TrainStep`` against the JAX
``DGCMomentum`` under its ``TrainStep``, parameters and the ``error`` slot
within 1e-6: before the rampup it is plain momentum, from it the
sparsified update with error feedback, and a two-level rampup schedule
step by step. ``fleet.distributed_optimizer`` under ``strategy.dgc`` turns
a ``Momentum`` into a ``DGCMomentum`` (in the ranks, after ``fleet.init``)
and raises ``TypeError`` for another optimizer.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_threads  # noqa: F401
import torch_zero_ranks as zranks
import torch_dist_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet.meta_optimizers.dgc_optimizer import \
    DGCMomentum as JDGCMomentum
from paddle_tpu.distributed.fleet.meta_optimizers.hybrid_parallel_optimizer \
    import HybridParallelOptimizer as JHPO
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu_torch.convert import load_state
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.fleet.meta_optimizers import DGCMomentum
from paddle_tpu_torch.hapi import TrainStep
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import Momentum

F32 = 1e-6
LSGD = {c["name"]: c for c in (
    dict(name="k2", k=2, steps=4), dict(name="begin3", k=10, begin=3,
                                        steps=3))}


def _data(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 4)).astype(np.float32),
            rng.standard_normal((8, 2)).astype(np.float32))


def _jloss(out, y):
    return JF.mse_loss(JTensor(out), JTensor(y))._value


def _jax_weights():
    paddle.seed(9)
    return {k: np.asarray(v) for k, v in jnn.Linear(4, 2).raw_state()[0]
            .items()}


def _jax_localsgd(case, x, y):
    """The JAX step's per-replica parameters and loss after each step,
    and its state_dict at the end."""
    paddle.seed(9)
    net = jnn.Linear(4, 2)
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("dp",))
    st = JStrategy()
    st.localsgd = True
    st.localsgd_configs = {"k_steps": case["k"],
                           "begin_step": case.get("begin", 1)}
    opt = JHPO(paddle.optimizer.SGD(0.1, parameters=net.parameters()),
               hcg=None, strategy=st)
    ts = JTrainStep(net, opt, loss_fn=_jloss, mesh=mesh)
    rows = []
    for _ in range(case["steps"]):
        loss = float(ts(paddle.to_tensor(x), paddle.to_tensor(y)))
        rows.append((loss, {k: np.asarray(v) for k, v in ts.params.items()}))
    sd = ts.state_dict()
    sd.pop("@opt_state")
    return rows, {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
                  for k, v in sd.items()}


@pytest.fixture(scope="module")
def runs():
    weights = _jax_weights()
    x, y = _data()
    ctx = spawn(zranks.localsgd_rank,
                args=(list(LSGD.values()), weights, x, y), nprocs=2,
                join=False)
    try:
        jx = {name: _jax_localsgd(c, x, y) for name, c in LSGD.items()}
        ctx.join(ranks.JOIN_TIMEOUT_S)
    finally:
        ctx.terminate()
    return dict(weights=weights, x=x, y=y, jax=jx, port=ctx.results)


def _replicas(runs, name, step):
    return [r[name]["rows"][step]["params"] for r in runs["port"]]


@pytest.mark.parametrize("name", list(LSGD))
def test_localsgd_replicas_match_jax(runs, name):
    jrows, _ = runs["jax"][name]
    for step, (jloss, jparams) in enumerate(jrows):
        for r in runs["port"]:
            got = r[name]
            assert got["localsgd_k"] == LSGD[name]["k"]
            assert abs(got["rows"][step]["loss"] - jloss) <= F32 * abs(jloss)
            for k, v in got["rows"][step]["params"].items():
                np.testing.assert_allclose(v, jparams[k][got["dp_rank"]],
                                           rtol=F32, atol=F32, err_msg=k)


def test_localsgd_diverges_then_syncs(runs):
    """k = 2: replicas differ after step 1 and are equal (bit for bit)
    after step 2, at the numpy emulation's mean of two local SGD traces."""
    a, b = _replicas(runs, "k2", 0)
    assert any(not np.allclose(a[k], b[k]) for k in a)
    a, b = _replicas(runs, "k2", 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    x, y, w0 = runs["x"], runs["y"], runs["weights"]
    W = [w0["weight"].copy(), w0["weight"].copy()]
    bb = [w0["bias"].copy(), w0["bias"].copy()]
    for _ in range(2):
        for d in range(2):
            xb, yb = x[d * 4:(d + 1) * 4], y[d * 4:(d + 1) * 4]
            g = 2.0 * (xb @ W[d] + bb[d] - yb) / (4 * 2)
            W[d] = W[d] - 0.1 * (xb.T @ g)
            bb[d] = bb[d] - 0.1 * g.sum(0)
    np.testing.assert_allclose(a["weight"], (W[0] + W[1]) / 2, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(a["bias"], (bb[0] + bb[1]) / 2, rtol=1e-4,
                               atol=1e-5)


def test_localsgd_begin_step_stays_dense(runs):
    for step in (0, 1):
        a, b = _replicas(runs, "begin3", step)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    a, b = _replicas(runs, "begin3", 2)
    assert any(not np.allclose(a[k], b[k]) for k in a)


def test_localsgd_state_dict_is_the_replicas_mean(runs):
    _, jsd = runs["jax"]["begin3"]
    for r in runs["port"]:
        sd = r["begin3"]["state"]
        assert {k: v.shape for k, v in sd.items()} == {
            "weight": (4, 2), "bias": (2,)}
        for k, v in sd.items():
            np.testing.assert_allclose(v, jsd[k], rtol=F32, atol=F32)


def test_fleet_dgc_wraps_momentum_only(runs):
    for r in runs["port"]:
        got = r["fleet_dgc"]
        assert (got["wrapper"], got["inner"], got["begin"],
                got["sparsity"]) == ("HybridParallelOptimizer",
                                     "DGCMomentum", 5, (0.9,))
        assert "Momentum" in got["refused"]


# ------------------------------------------------------------------- DGC
def _dgc_data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((16, 16)).astype(np.float32),
            rng.standard_normal((16, 8)).astype(np.float32))


DGC_CASES = {
    "pre_rampup": dict(rampup_begin_step=100),
    "sparsified": dict(rampup_begin_step=0, sparsity=[0.75]),
    "rampup": dict(rampup_begin_step=2, rampup_step=4,
                   sparsity=[0.5, 0.75]),
}


def _jax_dgc(kw, steps):
    x, y = _dgc_data()
    paddle.seed(13)
    net = jnn.Linear(16, 8)
    w = {k: np.asarray(v) for k, v in net.raw_state()[0].items()}
    opt = JDGCMomentum(0.05, parameters=net.parameters(), **kw)
    ts = JTrainStep(net, opt, loss_fn=_jloss)
    rows = []
    for _ in range(steps):
        ts(paddle.to_tensor(x), paddle.to_tensor(y))
        rows.append(({k: np.asarray(v) for k, v in ts.params.items()},
                     {k: np.asarray(s["error"])
                      for k, s in ts.opt_state["slots"].items()}))
    return w, rows


def _port_dgc(weights, cls, kw, steps):
    x, y = (torch.from_numpy(a) for a in _dgc_data())
    net = Linear(16, 8, device="cpu")
    load_state(net, weights)
    opt = cls(0.05, parameters=net.named_parameters(), **kw)
    ts = TrainStep(net, opt,
                   loss_fn=lambda out, yy: ((out - yy) ** 2).mean())
    rows = []
    for _ in range(steps):
        ts(x, y)
        rows.append(({k: p.detach().numpy().copy()
                      for k, p in net.named_parameters()},
                     {opt._names[p]: st.get("error", torch.zeros(0))
                      .numpy().copy() for p, st in opt.state.items()}))
    return rows


@pytest.mark.parametrize("name", list(DGC_CASES))
def test_dgc_matches_jax(name):
    kw = DGC_CASES[name]
    weights, jrows = _jax_dgc(kw, 6)
    rows = _port_dgc(weights, DGCMomentum, kw, 6)
    for (params, err), (jparams, jerr) in zip(rows, jrows):
        for k in jparams:
            np.testing.assert_allclose(params[k], jparams[k], rtol=F32,
                                       atol=F32, err_msg=k)
            np.testing.assert_allclose(err[k], jerr[k], rtol=F32, atol=F32,
                                       err_msg=k)
    if name == "pre_rampup":
        plain = _port_dgc(weights, Momentum, {}, 6)
        for (params, err), (mparams, _) in zip(rows, plain):
            for k in params:
                np.testing.assert_allclose(params[k], mparams[k], rtol=F32)
                assert not err[k].any()
    if name == "sparsified":
        before = weights["weight"]
        moved = (rows[0][0]["weight"] != before).mean()
        assert 0.05 < moved < 0.6, moved
        assert np.abs(rows[0][1]["weight"]).max() > 0


def test_dgc_refuses_nesterov():
    net = Linear(4, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="nesterov"):
        DGCMomentum(0.1, parameters=net.parameters(), use_nesterov=True)
