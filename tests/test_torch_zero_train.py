"""The hybrid Llama step with ZeRO across ranks against the JAX package's.

``examples/train_llama_hybrid.py``'s recipe on the tiny GQA Llama (4 heads
over 2 kv heads) with a ZeRO level: ``create_hybrid_communicate_group(dp,
sharding, mp)``, ``annotate_llama_tp(model)``,
``group_sharded_parallel(model, opt, level)``, ``TrainStep(model, opt,
mesh=hcg.get_mesh(), data_axes=("dp", "sharding"))``. The port runs it in
gloo ranks on the CPU (one world of 4, spawned once for the file), the JAX
package its ``TrainStep(mesh=...)`` with the same ``group_sharded_parallel``
level on its host devices; both start from the JAX model's weights and take
3 AdamW steps under warmup/cosine with a global-norm clip that binds.

- Rows: dp 2 x sharding 2 at stage 2, sharding 2 x mp 2 at stage 3,
  dp 2 x sharding 2 at stage 1 with labels at -100 spread unevenly over
  the four data ranks (the loss is the mean over the global batch's
  tokens, which a mean of the ranks' means misses), and sharding 2 at
  stage 3 under ``remat`` (a world of 2), whose recomputed layers gather
  their weights again in the backward.
- Per-step losses within 1e-5 relative of JAX's; the parameters gathered
  back (``convert.gather_state`` over the extended specs, which also holds
  the replicas equal bit for bit) within 1e-5 of JAX's, an element whose
  gradient sits near AdamW's eps allowed up to 3 lr (at most 1e-3 of the
  elements).
- The first batch's gradient norm over the logical parameters equals a
  one-process port model's within 1e-5 and exceeds the clip.
- Each rank's attention counts its heads (4 / mp over 2 / mp) and, at
  stage 3, holds its slice of every parameter.
- ``HybridParallelGradScaler`` (a world of 2, sharding 2, stage 2, an fp16
  ``Linear(16, 8)`` under SGD): a batch whose rows on rank 0 carry a huge
  input in a column whose weights are zero puts an inf in the gradient
  rows rank 1 owns; only rank 1 sees it locally, every rank skips the
  step and halves the scale, as the JAX single-controller scaler does on
  the same global batch, and the next step's weights match JAX's within
  fp16 rounding.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import torch_zero_ranks as zranks
import torch_dist_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import group_sharded_parallel as jgsp
from paddle_tpu.distributed.fleet.base_topology import (
    _reset_hcg, create_hybrid_communicate_group)
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models.llama import annotate_llama_tp as jannotate
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.convert import gather_state, shard_slices
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm

LR, CLIP, SEED = 1e-2, 0.5, 41
TOL = 1e-5
INF_COL, SCALE = 12, 1024.0


def _batches(seed, b=4, s=16, vocab=256):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        ids = rng.integers(0, vocab, (b, s + 1))
        out.append((ids[:, :-1].copy(), ids[:, 1:].copy()))
    return out


def _uneven():
    """The four data ranks keep 3, 16, 14 and 16 labels of 16."""
    out = _batches(7)
    for _, y in out:
        y[0, 3:] = -100
        y[2, :2] = -100
    return out


def _case(name, level, batches, dp=1, sharding=1, mp=1):
    return dict(name=name, level=level, dp=dp, sharding=sharding, mp=mp,
                lr=LR, clip=CLIP, batches=batches)


CASES = {c["name"]: c for c in (
    _case("dp2_s2_stage2", "os_g", _batches(5), dp=2, sharding=2),
    _case("s2_mp2_stage3", "p_g_os", _batches(5), sharding=2, mp=2),
    _case("uneven_stage1", "os", _uneven(), dp=2, sharding=2),
    dict(_case("s2_stage3_remat", "p_g_os", _batches(5), sharding=2),
         remat=True))}
FOUR = [c for c in CASES.values() if c["dp"] * c["sharding"] * c["mp"] == 4]
TWO = [c for c in CASES.values() if c not in FOUR]


def _sizes(case):
    return {a: case[a] for a in ("dp", "sharding", "mp")}


def _jax_weights():
    paddle.seed(SEED)
    model = JLlamaForCausalLM(JLlamaConfig.tiny())
    return {k: np.asarray(v) for k, v in model.raw_state()[0].items()}


def _jax_run(case):
    _reset_hcg()
    paddle.seed(SEED)
    model = JLlamaForCausalLM(JLlamaConfig.tiny())
    jannotate(model)
    hcg = create_hybrid_communicate_group(
        dp_degree=case["dp"], sharding_degree=case["sharding"],
        mp_degree=case["mp"])
    sched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(LR, T_max=10), 2,
                             LR / 10, LR)
    opt = paddle.optimizer.AdamW(
        sched, parameters=model.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
    wrapped, opt, _ = jgsp(model, opt, case["level"])
    step = JTrainStep(wrapped, opt, mesh=hcg.get_mesh(),
                      data_axes=("dp", "sharding"),
                      remat=case.get("remat", False))
    losses = [float(step(paddle.to_tensor(x.astype(np.int32)),
                         paddle.to_tensor(y.astype(np.int32))))
              for x, y in case["batches"]]
    step.sync_to_model()
    _reset_hcg()
    return losses, {k: np.asarray(v, np.float32)
                    for k, v in model.raw_state()[0].items()}


def _scaler_inputs():
    """fp16 weights with row INF_COL zero, and two global batches of 8
    rows: the first with 1e4 in column INF_COL of rank 0's rows."""
    paddle.seed(3)
    net = jnn.Linear(16, 8, bias_attr=False)
    w = np.asarray(net.weight.numpy()).astype(np.float16)
    w[INF_COL] = 0
    rng = np.random.default_rng(11)
    batches = []
    for i in range(2):
        x = rng.standard_normal((8, 16)).astype(np.float16)
        if i == 0:
            x[:4, INF_COL] = 1e4
        batches.append((x, rng.standard_normal((8, 8)).astype(np.float32)))
    return {"weight": w}, batches


def _jax_scaler(weights, batches):
    """The single-controller fp16 loop on the global batches: (found_inf,
    scale, weight) after each step."""
    net = jnn.Linear(16, 8, bias_attr=False)
    net.weight.set_value(weights["weight"].astype(np.float32))
    net.half()
    opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
    scaler = paddle.amp.GradScaler(init_loss_scaling=SCALE)
    rows = []
    for x, y in batches:
        out = net(paddle.to_tensor(x))
        loss = ((out.astype("float32") - paddle.to_tensor(y)) ** 2).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        found = scaler._found_inf
        scaler.update()
        opt.clear_grad()
        rows.append((found, scaler._scale,
                     np.asarray(net.weight.numpy(), np.float32)))
    return rows


def _port_model(weights):
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_numpy_state(weights)
    return model


@pytest.fixture(scope="module")
def runs():
    weights = _jax_weights()
    sw, sb = _scaler_inputs()
    four = spawn(zranks.zero_train_rank, args=(FOUR, weights), nprocs=4,
                 join=False)
    two = spawn(zranks.zero_train_rank,
                args=(TWO, weights, dict(sharding=2, scale=SCALE,
                                         batches=sb), sw),
                nprocs=2, join=False)
    try:
        jax = {name: _jax_run(c) for name, c in CASES.items()}
        jscaler = _jax_scaler(sw, sb)
        four.join(ranks.JOIN_TIMEOUT_S)
        two.join(ranks.JOIN_TIMEOUT_S)
    finally:
        four.terminate()
        two.terminate()
    port = {c["name"]: [r[c["name"]] for r in ctx.results]
            for ctx, cases in ((four, FOUR), (two, TWO)) for c in cases}
    return dict(weights=weights, jax=jax, port=port, jscaler=jscaler,
                scaler=[r["scaler"] for r in two.results],
                scaler_weights=sw)


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax(runs, name):
    jl, _ = runs["jax"][name]
    for r in runs["port"][name]:     # every rank reports the global loss
        rel = np.abs(np.subtract(r["losses"], jl)) / np.abs(jl)
        assert rel.max() <= TOL, (r["coords"], r["losses"], jl)


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_params_match_jax(runs, name):
    _, jp = runs["jax"][name]
    rs = runs["port"][name]
    got = gather_state([r["shard"] for r in rs], rs[0]["param_specs"],
                       [r["coords"] for r in rs], _sizes(CASES[name]))
    assert sorted(got) == sorted(jp)
    off = total = 0
    for k, want in jp.items():
        assert got[k].shape == want.shape, k
        diff = np.abs(got[k].astype(np.float64) - want)
        assert diff.max() <= 3 * LR, (k, diff.max())
        off += int((diff > TOL).sum())
        total += diff.size
    print(f"{name}: {off} of {total} elements beyond {TOL}")
    assert off <= 1e-3 * total


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_their_slices(runs, name):
    """Each rank counts its heads, and holds the slice of each parameter
    its spec gives it (at stage 3 the sharding slice of its mp shard)."""
    c = CASES[name]
    for r in runs["port"][name]:
        assert r["level"] == {"os": 1, "os_g": 2, "p_g_os": 3}[c["level"]]
        assert r["heads"] == (4 // c["mp"], 2 // c["mp"])
        for k, w in runs["weights"].items():
            idx = shard_slices(w.shape, r["param_specs"][k], r["coords"],
                               _sizes(c))
            assert r["shard"][k].shape == w[idx].shape, k
            if c["level"] == "p_g_os":
                assert "sharding" in str(r["param_specs"][k]), k


@pytest.mark.parametrize("name", list(CASES))
def test_clip_norm_is_the_logical_parameters(runs, name):
    """The first batch's norm over the sliced and sharded gradients
    equals one process's over the whole model, and binds."""
    model = _port_model(runs["weights"])
    x, y = CASES[name]["batches"][0]
    model(torch.from_numpy(x), torch.from_numpy(y)).backward()
    want = float(ClipGradByGlobalNorm(CLIP).global_norm_sq(
        p.grad for p in model.parameters()).sqrt())
    for r in runs["port"][name]:
        assert abs(r["norm"] - want) <= TOL * want, (r["norm"], want)
    assert want > CLIP


def test_uneven_labels_take_the_global_mean(runs):
    x, y = CASES["uneven_stage1"]["batches"][0]
    counts = [(y[i] >= 0).sum() for i in range(4)]
    assert len(set(counts)) > 1
    model = _port_model(runs["weights"])
    with torch.no_grad():
        rows = [float(model(torch.from_numpy(x[i:i + 1]),
                            torch.from_numpy(y[i:i + 1])))
                for i in range(4)]
    jl, _ = runs["jax"]["uneven_stage1"]
    assert abs(np.mean(rows) - jl[0]) > 100 * TOL * jl[0]
    for r in runs["port"]["uneven_stage1"]:
        assert abs(r["losses"][0] - jl[0]) <= TOL * jl[0]


def test_scaler_skips_the_same_step_on_every_rank(runs):
    jrows, rs = runs["jscaler"], runs["scaler"]
    w0 = runs["scaler_weights"]["weight"].astype(np.float32)
    # the inf lands in the rows rank 1 owns (dim 0 cut in two)
    assert rs[0]["opt_specs"]["weight"] == ("sharding", None)
    assert [r["rows"][0]["local_inf"] for r in rs] == [False, True]
    for step, (found, scale, jw) in enumerate(jrows):
        for r in rs:
            row = r["rows"][step]
            assert (row["found_inf"], row["scale"]) == (found, scale)
            np.testing.assert_allclose(row["weight"], jw, rtol=2e-3,
                                       atol=2e-3)
    assert jrows[0][:2] == (True, SCALE / 2) and not jrows[1][0]
    for r in rs:
        np.testing.assert_array_equal(r["rows"][0]["weight"], w0)
        assert not np.array_equal(r["rows"][1]["weight"], w0)


def test_stage3_gathers_on_use(runs):
    """Stage 3 gathers each of the tiny Llama's 21 parameters once a
    forward and reduce-scatters its gradient once a backward; under remat
    the 18 of its two decoder layers are gathered again when the layers
    are recomputed."""
    steps = 3
    plain = runs["port"]["s2_mp2_stage3"][0]["counts"]
    remat = runs["port"]["s2_stage3_remat"][0]["counts"]
    assert plain["all_gather"] == remat["reduce_scatter"] == 21 * steps
    assert remat["all_gather"] == (21 + 18) * steps
