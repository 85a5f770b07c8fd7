"""The port's Megatron layers and mp_ops pairs across gloo ranks against
the JAX package's.

Four gloo ranks (spawned once for the file) build each layer at mp = 2 (a
dp = 2 x mp = 2 topology) and at mp = 4, load their shards of the same
seeded numpy weights, and run forward and backward under a fixed
cotangent. The JAX package runs the same layers on its ``hcg`` mesh (its
GSPMD branch, as in ``tests/test_tp_layers.py``), and its ``mp_ops`` pairs
inside ``shard_map``. Each rank's output, input gradient and weight-shard
gradient equal the matching part of JAX's within 1e-5 (fp32):
``ColumnParallelLinear`` (gathered or not), ``RowParallelLinear`` (input
parallel or not; the bias once, after the reduction),
``VocabParallelEmbedding``, ``ParallelCrossEntropy`` (an ignored label,
per-token losses), ``_parallel_matmul`` and ``_parallel_embedding``. The
remaining pairs are held to their algebra: split then concat is the
identity, value and gradient; reduce-scatter then all-gather of the ranks'
copies is mp times the input, and so is its gradient; identity then
all-reduce gives mp x and, as Megatron pairs them, gradient mp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_threads  # noqa: F401
import torch_dist_ranks as ranks
import paddle_tpu as paddle
from paddle_tpu.distributed.fleet import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, create_hybrid_communicate_group)
from paddle_tpu.distributed.fleet.base_topology import _reset_hcg
from paddle_tpu.distributed.fleet.layers.mpu import mp_ops
from paddle_tpu_torch.distributed import spawn

TOL = 1e-5
MPS = (2, 4)


def _inputs():
    rng = np.random.default_rng(3)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    labels = rng.integers(0, 40, (6,))
    labels[2] = -100
    return {"col_w": f(16, 32), "col_b": f(32), "col_x": f(4, 8, 16),
            "col_cot": f(4, 8, 32), "row_w": f(32, 16), "row_b": f(16),
            "row_x": f(4, 8, 32), "row_cot": f(4, 8, 16),
            "emb_w": f(64, 16), "ids": rng.integers(0, 64, (4, 6)),
            "emb_cot": f(4, 6, 16), "logits": f(6, 40), "labels": labels,
            "ce_cot": f(6, 1), "pm_x": f(4, 16), "pm_w": f(16, 32),
            "seq": f(8, 4)}


def _grad(t):
    return t.grad.numpy()


def _jax_case(x, mp):
    _reset_hcg()
    create_hybrid_communicate_group(dp_degree=4 // mp, mp_degree=mp)
    ref = {}
    for gather in (True, False):
        col = ColumnParallelLinear(16, 32, gather_output=gather)
        col.weight.set_value(x["col_w"])
        col.bias.set_value(x["col_b"])
        xin = paddle.to_tensor(x["col_x"], stop_gradient=False)
        y = col(xin)
        (y * paddle.to_tensor(x["col_cot"])).sum().backward()
        ref[f"col{gather}"] = (y.numpy(), _grad(xin), _grad(col.weight),
                               _grad(col.bias))
    for parallel in (False, True):
        row = RowParallelLinear(32, 16, input_is_parallel=parallel)
        row.weight.set_value(x["row_w"])
        row.bias.set_value(x["row_b"])
        xin = paddle.to_tensor(x["row_x"], stop_gradient=False)
        y = row(xin)
        (y * paddle.to_tensor(x["row_cot"])).sum().backward()
        ref[f"row{parallel}"] = (y.numpy(), _grad(xin), _grad(row.weight),
                                 _grad(row.bias))
    emb = VocabParallelEmbedding(64, 16)
    emb.weight.set_value(x["emb_w"])
    y = emb(paddle.to_tensor(x["ids"].astype(np.int32)))
    (y * paddle.to_tensor(x["emb_cot"])).sum().backward()
    ref["emb"] = (y.numpy(), _grad(emb.weight))
    logits = paddle.to_tensor(x["logits"], stop_gradient=False)
    loss = ParallelCrossEntropy()(logits, paddle.to_tensor(x["labels"]))
    (loss * paddle.to_tensor(x["ce_cot"])).sum().backward()
    ref["ce"] = (loss.numpy(), _grad(logits))
    _reset_hcg()
    mesh = Mesh(np.array(jax.devices()[:mp]), ("mp",))

    def pm(xv, wv):
        f = jax.shard_map(
            lambda a, b: mp_ops._parallel_matmul(a, b, "mp", True),
            mesh=mesh, in_specs=(P(), P(None, "mp")), out_specs=P(),
            check_vma=False)
        return f(xv, wv)

    y = pm(jnp.asarray(x["pm_x"]), jnp.asarray(x["pm_w"]))
    gx, gw = jax.grad(lambda a, b: jnp.sum(pm(a, b) ** 2), (0, 1))(
        jnp.asarray(x["pm_x"]), jnp.asarray(x["pm_w"]))
    ref["parallel_matmul"] = (np.asarray(y), np.asarray(gx), np.asarray(gw))

    def pe(tv):
        f = jax.shard_map(
            lambda t: mp_ops._parallel_embedding(jnp.asarray(x["ids"]), t,
                                                 "mp"),
            mesh=mesh, in_specs=P("mp", None), out_specs=P(),
            check_vma=False)
        return f(tv)

    table = jnp.asarray(x["emb_w"])
    ref["parallel_embedding"] = (
        np.asarray(pe(table)),
        np.asarray(jax.grad(lambda t: jnp.sum(pe(t) ** 2))(table)))
    seq = x["seq"]
    ref["split_concat"] = (seq, seq)
    ref["scatter_gather"] = (mp * seq, mp * seq)
    ref["identity_allreduce"] = (mp * seq, np.full_like(seq, mp))
    return ref


@pytest.fixture(scope="module")
def runs():
    x = _inputs()
    ctx = spawn(ranks.mp_layers_rank, args=(x,), nprocs=4, join=False)
    try:
        ref = {mp: _jax_case(x, mp) for mp in MPS}
        ctx.join(ranks.JOIN_TIMEOUT_S)
    finally:
        ctx.terminate()
    return ref, ctx.results


def _part(a, mp, r, axis):
    return np.array_split(a, mp, axis=axis)[r]


# which part of each reference tensor a rank holds: None whole, else the
# axis its mp rank's part is cut along
PARTS = {
    "colTrue": (None, None, 1, 0),
    "colFalse": (-1, None, 1, 0),
    "rowFalse": (None, None, 0, None),
    "rowTrue": (None, -1, 0, None),
    "emb": (None, 0),
    "ce": (None, -1),
    "parallel_matmul": (None, None, 1),
    "parallel_embedding": (None, 0),
    "split_concat": (None, None),
    "scatter_gather": (None, None),
    "identity_allreduce": (None, None),
}


@pytest.mark.parametrize("name", list(PARTS))
@pytest.mark.parametrize("mp", MPS)
def test_rank_parts_match_jax(runs, mp, name):
    ref, got = runs
    for rank_out in got:
        res = rank_out[mp]
        r = res["mp_rank"]
        for i, (want, axis) in enumerate(zip(ref[mp][name], PARTS[name])):
            if axis is not None:
                want = _part(want, mp, r, axis)
            np.testing.assert_allclose(res[name][i], want, rtol=TOL,
                                       atol=TOL,
                                       err_msg=f"{name} item {i} mp rank {r}")
