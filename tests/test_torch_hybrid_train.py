"""The hybrid dp x mp Llama step across ranks against the JAX package's.

``examples/train_llama_hybrid.py``'s recipe on the tiny GQA Llama (4 heads
over 2 kv heads): ``create_hybrid_communicate_group(dp, mp)``,
``annotate_llama_tp(model)``, ``TrainStep(model, opt, mesh=hcg.get_mesh(),
data_axes=("dp",))``. The port runs it in gloo ranks on the CPU (spawned
once for the file: a world of 2 for dp = 2 and then mp = 2, a world of 4
for dp = 2 x mp = 2 and its uneven-labels case); the JAX package runs its
``TrainStep(mesh=...)`` on its host devices. Both start from the JAX
model's weights (each rank's shards cut by ``convert.shard_state``) and
take 3 AdamW steps under warmup/cosine with a global-norm clip that binds.

- Per-step losses within 1e-5 relative of JAX's.
- The parameters gathered back from the ranks (``convert.gather_state``,
  which also holds the dp replicas equal bit for bit) within 1e-5 of
  JAX's. An element whose gradient sits near AdamW's eps may move by up to
  about lr instead: at most 1e-3 of the elements may, by at most 3 lr.
- Each rank's attention counts its own heads (4 / mp over 2 / mp).
- The first batch's gradient norm over the logical parameters (each
  shard's squares summed over mp once, the replicated ones once) equals a
  one-process port model's within 1e-5 and exceeds the clip.
- Labels at -100 spread unevenly over the dp ranks: the loss is the mean
  over the global batch's tokens, which a mean of the ranks' means misses.
- ``DistributedBatchSampler()`` takes its rank and world from the runtime.
- ``fleet.init`` / ``distributed_model`` / ``distributed_optimizer``: at
  dp = 2 a ``DataParallel`` that broadcasts rank 0's parameters and
  averages gradients in the backward (``no_sync`` really skips it), at
  mp = 2 (and dp = 2 x mp = 2) a ``TensorParallel`` that broadcasts the
  replicated parameters, whose ``HybridParallelOptimizer`` averages the
  gradients over dp in ``step``.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import torch_dist_ranks as ranks
import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.base_topology import (
    _reset_hcg, create_hybrid_communicate_group)
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu.io import DistributedBatchSampler as JSampler
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models.llama import annotate_llama_tp as jannotate
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.convert import gather_state
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm

LR, CLIP, SEED = 1e-2, 0.5, 41
TOL = 1e-5
F32 = 1e-6                # one f32 SGD update against float64 arithmetic


def _batches(seed, b=4, s=16, vocab=256):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        ids = rng.integers(0, vocab, (b, s + 1))
        out.append((ids[:, :-1].copy(), ids[:, 1:].copy()))
    return out


def _uneven():
    """dp rank 0's rows (0, 1) keep 6 labels of 32, rank 1's 30."""
    out = _batches(7)
    for _, y in out:
        y[:2, 3:] = -100
        y[2, :2] = -100
    return out


def _case(name, dp, mp, batches):
    return dict(name=name, dp=dp, mp=mp, lr=LR, clip=CLIP, batches=batches)


CASES = {c["name"]: c for c in (
    _case("dp2", 2, 1, _batches(5)), _case("mp2", 1, 2, _batches(5)),
    _case("dp2_mp2", 2, 2, _batches(5)), _case("uneven", 2, 2, _uneven()))}


def _jax_weights():
    paddle.seed(SEED)
    model = JLlamaForCausalLM(JLlamaConfig.tiny())
    return {k: np.asarray(v) for k, v in model.raw_state()[0].items()}


def _jax_run(case):
    _reset_hcg()
    paddle.seed(SEED)
    model = JLlamaForCausalLM(JLlamaConfig.tiny())
    jannotate(model)
    hcg = create_hybrid_communicate_group(dp_degree=case["dp"],
                                          mp_degree=case["mp"])
    sched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(LR, T_max=10), 2,
                             LR / 10, LR)
    opt = paddle.optimizer.AdamW(
        sched, parameters=model.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
    step = JTrainStep(model, opt, mesh=hcg.get_mesh(), data_axes=("dp",))
    losses = [float(step(paddle.to_tensor(x.astype(np.int32)),
                         paddle.to_tensor(y.astype(np.int32))))
              for x, y in case["batches"]]
    step.sync_to_model()
    _reset_hcg()
    return losses, {k: np.asarray(v, np.float32)
                    for k, v in model.raw_state()[0].items()}


def _port_model(weights):
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_numpy_state(weights)
    return model


@pytest.fixture(scope="module")
def runs():
    weights = _jax_weights()
    two = spawn(ranks.hybrid_rank,
                args=([CASES["dp2"], CASES["mp2"]], weights), nprocs=2,
                join=False)
    four = spawn(ranks.hybrid_rank,
                 args=([CASES["dp2_mp2"], CASES["uneven"]], weights),
                 nprocs=4, join=False)
    try:
        jax = {name: _jax_run(c) for name, c in CASES.items()}
        two.join(ranks.JOIN_TIMEOUT_S)
        four.join(ranks.JOIN_TIMEOUT_S)
    finally:
        two.terminate()
        four.terminate()
    port = {}
    for ctx in (two, four):
        for name in ctx.results[0]:
            port[name] = [r[name] for r in ctx.results]
    port["fleet"] = [r["fleet"] for r in two.results + four.results]
    return dict(weights=weights, jax=jax, port=port)


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
    c = CASES[name]
    got = gather_state([r["shard"] for r in rs], rs[0]["specs"],
                       [r["coords"] for r in rs], {"dp": c["dp"],
                                                   "mp": c["mp"]})
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
def test_ranks_count_their_own_heads(runs, name):
    mp = CASES[name]["mp"]
    for r in runs["port"][name]:
        assert r["heads"] == (4 // mp, 2 // mp)
        # the head's shard is this rank's vocabulary columns
        assert r["shard"]["lm_head.weight"].shape == (64, 256 // mp)
        assert r["shard"]["llama.embed_tokens.weight"].shape == \
            (256 // mp, 64)


@pytest.mark.parametrize("name", list(CASES))
def test_clip_norm_is_the_logical_parameters(runs, name):
    """The hybrid clip's norm equals one process's over the whole model
    on the whole batch, and binds."""
    model = _port_model(runs["weights"])
    x, y = CASES[name]["batches"][0]
    model(torch.from_numpy(x), torch.from_numpy(y)).backward()
    want = float(ClipGradByGlobalNorm(CLIP).global_norm_sq(
        p.grad for p in model.parameters()).sqrt())
    for r in runs["port"][name]:
        assert abs(r["norm"] - want) <= TOL * want, (r["norm"], want)
    assert want > CLIP


def test_uneven_labels_take_the_global_mean(runs):
    """The uneven case's first loss is the global token mean; the mean of
    the two dp halves' own means is another number."""
    x, y = CASES["uneven"]["batches"][0]
    counts = [(y[:2] >= 0).sum(), (y[2:] >= 0).sum()]
    assert counts[0] != counts[1]
    model = _port_model(runs["weights"])
    with torch.no_grad():
        halves = [float(model(torch.from_numpy(x[i:i + 2]),
                              torch.from_numpy(y[i:i + 2])))
                  for i in (0, 2)]
    jl, _ = runs["jax"]["uneven"]
    assert abs(np.mean(halves) - jl[0]) > 100 * TOL * jl[0]
    for r in runs["port"]["uneven"]:
        assert abs(r["losses"][0] - jl[0]) <= TOL * jl[0]


def test_sampler_takes_rank_and_world_from_the_runtime(runs):
    for name in ("dp2", "dp2_mp2"):
        rs = runs["port"][name]
        for rank, r in enumerate(rs):
            n, me, batches = r["sampler"]
            assert (n, me) == (len(rs), rank)
            want = JSampler(list(range(10)), batch_size=2,
                            num_replicas=len(rs), rank=rank)
            assert batches == [list(b) for b in want]


def test_fleet_wrappers(runs):
    """A parameter no layer annotates (a plain ``nn.Linear``), rank r's
    weight filled with r + 1 and its input rows with r + 1: 3 (r + 1) is
    its gradient before any reduction; SGD at 0.1, its f32 update within
    1e-6 relative."""
    two, four = runs["port"]["fleet"][:2], runs["port"]["fleet"][2:]
    local = [3.0 * (r + 1) for r in range(4)]
    for r, got in enumerate(two):
        dp2 = got[(2, 1)]
        assert (dp2["wrapper"], dp2["optimizer"], dp2["mode"]) == (
            "DataParallel", "HybridParallelOptimizer", "DATA_PARALLEL")
        avg = (local[0] + local[1]) / 2
        np.testing.assert_allclose(dp2["synced"], np.full((2, 4), avg))
        # rank 0's weight (1), broadcast; the step applies the average
        np.testing.assert_allclose(dp2["stepped"],
                                   np.full((2, 4), 1 - 0.1 * avg), rtol=F32)
        np.testing.assert_allclose(dp2["local"], np.full((2, 4), local[r]))
        mp2 = got[(1, 2)]
        assert (mp2["wrapper"], mp2["optimizer"], mp2["mode"]) == (
            "TensorParallel", "HybridParallelOptimizer", "TENSOR_PARALLEL")
        # replicated: rank 0's weight, broadcast over mp; its gradient
        # stays local (only the layers' collectives carry TP) and dp is 1
        np.testing.assert_allclose(mp2["synced"], np.full((2, 4), local[r]))
        np.testing.assert_allclose(mp2["stepped"],
                                   np.full((2, 4), 1 - 0.1 * local[r]),
                                   rtol=F32)
    for r, got in enumerate(four):
        hyb = got[(2, 2)]
        assert (hyb["wrapper"], hyb["mode"]) == ("TensorParallel",
                                                 "TENSOR_PARALLEL")
        np.testing.assert_allclose(hyb["synced"], np.full((2, 4), local[r]))
        # step averages over r's dp group: the ranks of r's mp coordinate
        avg = (local[r % 2] + local[r % 2 + 2]) / 2
        np.testing.assert_allclose(hyb["stepped"],
                                   np.full((2, 4), 1 - 0.1 * avg), rtol=F32)
