"""Expert parallelism across gloo ranks against the JAX package's EP step,
and ``global_scatter`` / ``global_gather``.

The tiny MoE-GPT (2 layers, 8 experts, top-2) with ``expert_axis="dp"``
trains at dp = 2 (4 experts a rank) and dp = 4 (2 a rank) through
``TrainStep(mesh=...)`` with a global-norm clip at 0.5, against the
JAX package's ``TrainStep(mesh=...)`` of the same model at the same dp
(its experts sharded over dp by GSPMD), 3 AdamW steps from the same
seeded weights (``tests/torch_moe_twins.py``):

- each step's loss within the reference's own EP tolerance, rtol 2e-4
  (``tests/test_moe.py``), every rank reporting the same global loss;
- each rank holds ``E / P`` experts, and its first slice is
  ``convert.shard_state``'s cut of the whole weights;
- the parameters gathered back (``convert.gather_state`` rebuilds the
  expert stacks from the ranks' slices and holds the replicated
  parameters equal bit for bit) each within 1e-3 of JAX's update in L2.
  This also holds the expert gradients' scale: a slice's gradient holds
  every rank's tokens (the all-to-all's backward) and is divided by the
  ranks, not averaged over them.

``global_scatter`` / ``global_gather``: the four cases of
``tests/test_moe.py`` against the JAX package's functions, and a group of
more than one rank refused.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_moe_twins as twins
from paddle_tpu.distributed.utils import global_gather as jgather
from paddle_tpu.distributed.utils import global_scatter as jscatter
from paddle_tpu_torch.convert import gather_state, shard_state
from paddle_tpu_torch.distributed.utils import global_gather, global_scatter

RTOL = 2e-4
PARAM_RTOL = 1e-3
CFG = dict(num_hidden_layers=2, num_experts=8, expert_axis="dp")
CASES = [twins.case("ep2", 2, CFG, clip=0.5),
         twins.case("ep4", 4, CFG, clip=0.5)]


@pytest.fixture(scope="module")
def runs():
    return twins.run_both(CASES, twins.weights(CFG))


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_losses_match_jax_ep_step(runs, name):
    (jl, _), per_rank = runs[name]
    for res in per_rank:
        assert res["losses"] == per_rank[0]["losses"]
    np.testing.assert_allclose(per_rank[0]["losses"], jl, rtol=RTOL)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_each_rank_holds_its_expert_slice(runs, name):
    _, per_rank = runs[name]
    dp = len(per_rank)
    w = twins.weights(CFG)
    for res in per_rank:
        assert res["experts_here"] == [8 // dp]
        assert res["specs"]["h.1.moe.experts.w1"] == ("dp", None, None)
        cut = shard_state(w, res["specs"], res["coords"], {"dp": dp})
        assert sorted(res["first"]) == sorted(
            k for k in w if ".moe.experts." in k)
        for k, v in res["first"].items():
            np.testing.assert_array_equal(v, cut[k])


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_gathered_parameters_match_jax(runs, name):
    (_, jp), per_rank = runs[name]
    dp = len(per_rank)
    got = gather_state([r["shard"] for r in per_rank], per_rank[0]["specs"],
                       [r["coords"] for r in per_rank], {"dp": dp})
    assert sorted(got) == sorted(jp)
    errs = twins.param_errors(got, jp, twins.weights(CFG), hidden=64)
    assert max(errs.values()) <= PARAM_RTOL, max(errs.items(),
                                                 key=lambda kv: kv[1])


# --------------------------------------------- global_scatter / global_gather
def test_roundtrip_and_grads():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    counts = np.asarray([2, 1, 3], np.int64)
    t = torch.from_numpy(x).requires_grad_(True)
    z = global_gather(global_scatter(t, counts, counts), counts, counts)
    (z * z).sum().backward()
    jx = paddle.to_tensor(x, stop_gradient=False)
    jc = paddle.to_tensor(counts)
    jz = jgather(jscatter(jx, jc, jc), jc, jc)
    (jz * jz).sum().backward()
    np.testing.assert_array_equal(z.detach().numpy(), jz.numpy())
    np.testing.assert_array_equal(t.grad.numpy(), jx.grad.numpy())
    np.testing.assert_array_equal(t.grad.numpy(), 2 * x)


def test_unequal_count_layouts():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    lc, gc = np.asarray([3, 2]), np.asarray([2, 4])
    t = torch.from_numpy(x).requires_grad_(True)
    y = global_scatter(t, torch.from_numpy(lc), torch.from_numpy(gc))
    want = jscatter(paddle.to_tensor(x), paddle.to_tensor(lc),
                    paddle.to_tensor(gc))
    np.testing.assert_array_equal(y.detach().numpy(), want.numpy())
    # the backward is the other repack: dropped rows get no gradient
    y.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy()[:, 0], [1, 1, 0, 1, 1])


def test_count_layout_length_mismatch_raises():
    x = torch.zeros(3, 2)
    with pytest.raises(ValueError):
        global_scatter(x, np.asarray([1, 2]), np.asarray([1, 1, 1]))


def test_count_mismatch_raises():
    x = torch.zeros(4, 2)
    bad = np.asarray([1, 1, 1])
    with pytest.raises(ValueError):
        global_scatter(x, bad, bad)
    with pytest.raises(ValueError):
        global_gather(x, bad, bad)


class _TwoRanks:
    nranks = 2


def test_a_group_of_ranks_is_refused():
    with pytest.raises(NotImplementedError):
        global_scatter(torch.zeros(2, 2), np.asarray([1, 1]),
                       np.asarray([1, 1]), group=_TwoRanks())
    with pytest.raises(NotImplementedError):
        global_gather(torch.zeros(2, 2), np.asarray([1, 1]),
                      np.asarray([1, 1]), group=_TwoRanks())
