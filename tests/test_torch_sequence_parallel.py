"""Megatron sequence parallelism across gloo ranks against the JAX package.

Worlds of 2 and 4 processes on the CPU (mp = the world's size; rank
bodies in ``tests/torch_ctx_ranks.py``), spawned once for the file.

- The ops' gradients are the reference's (``tests/test_tp_layers.py``
  under ``shard_map`` on as many host devices): ``gather(scatter(x))`` of a
  replicated x returns x with the gradient 2x of ``sum(y ** 2)``;
  ``all_gather`` of the sequence slices has the gradient P of ``sum``;
  ``reduce_scatter`` sums the ranks' tensors and keeps the rank's slice,
  its gradient the whole weight. Exact (1e-6).
- ``LayerNorm`` (marked) -> ``ColumnSequenceParallelLinear`` ->
  ``RowSequenceParallelLinear`` on the rank's sequence slice: each rank's
  output is its slice of the JAX package's serial layers on the whole
  sequence, and with ``register_sequence_parallel_allreduce_hooks`` every
  gradient (each weight's shard, the marked norm and row bias all-reduced
  over mp) equals the full-batch gradient within 1e-5. Under
  ``accumulation_steps=2`` the hook waits for the second backward pass:
  after the first the norm's gradient is still the rank's own part.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import torch_ctx_ranks as ranks
from paddle_tpu.distributed.fleet.utils import sequence_parallel_utils as jsp
from paddle_tpu.jit import functional_call
from paddle_tpu.nn.layer import Layer as JLayer
from paddle_tpu.nn.layers.common import LayerNorm as JLayerNorm
from paddle_tpu.nn.layers.common import Linear as JLinear
from paddle_tpu_torch.distributed import spawn

EXACT = 1e-6
TOL = 1e-5
S, B, D, F = 8, 2, 16, 32


def _ops_inputs(n, rng):
    return dict(rep=rng.standard_normal((16, 4)).astype(np.float32),
                seq=np.arange(2.0 * n, dtype=np.float32).reshape(n * 2, 1),
                parts=rng.standard_normal((n, 8, 3)).astype(np.float32),
                w_rs=rng.standard_normal((8, 3)).astype(np.float32))


def _linear_inputs(rng):
    def r(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return dict(x=r(S, B, D, scale=1.0), g=r(S, B, D, scale=1.0),
                ln_w=1.0 + r(D), ln_b=r(D), w1=r(D, F), b1=r(F), w2=r(F, D),
                b2=r(D))


INPUTS = {n: dict(ops=_ops_inputs(n, np.random.default_rng(n)),
                  linears=_linear_inputs(np.random.default_rng(10 + n)))
          for n in (2, 4)}


def _jax_ops(n, x):
    mesh = Mesh(np.array(jax.devices()[:n]), ("mp",))

    def roundtrip(v):
        return jax.shard_map(lambda t: jsp.gather(jsp.scatter(t, "mp"),
                                                  "mp"),
                             mesh=mesh, in_specs=P(), out_specs=P(),
                             check_vma=False)(v)

    def allgather_sum(v):
        return jnp.sum(jax.shard_map(lambda t: jsp.all_gather(t, "mp"),
                                     mesh=mesh, in_specs=P("mp"),
                                     out_specs=P(("mp",)),
                                     check_vma=False)(v))

    def rs_loss(parts):
        y = jax.shard_map(lambda t: jsp.reduce_scatter(t, "mp"), mesh=mesh,
                          in_specs=P("mp"), out_specs=P("mp"),
                          check_vma=False)(parts.reshape(-1, 3))
        return jnp.sum(y * x["w_rs"]), y

    rep = jnp.asarray(x["rep"])
    (rs, y_rs), g_rs = jax.value_and_grad(rs_loss, has_aux=True)(
        jnp.asarray(x["parts"]))
    return dict(
        roundtrip=np.asarray(roundtrip(rep)),
        roundtrip_grad=np.asarray(jax.grad(
            lambda v: jnp.sum(roundtrip(v) ** 2))(rep)),
        allgather_grad=np.asarray(jax.grad(allgather_sum)(
            jnp.asarray(x["seq"]))),
        reduce_scatter=np.asarray(y_rs),
        reduce_scatter_grad=np.asarray(g_rs))


class _Serial(JLayer):
    def __init__(self):
        super().__init__()
        self.ln = JLayerNorm(D)
        self.col = JLinear(D, F)
        self.row = JLinear(F, D)

    def forward(self, x):
        return self.row(self.col(self.ln(x)))


def _jax_linears(w):
    with paddle.LazyGuard():
        net = _Serial()
    params = {"ln.weight": w["ln_w"], "ln.bias": w["ln_b"],
              "col.weight": w["w1"], "col.bias": w["b1"],
              "row.weight": w["w2"], "row.bias": w["b2"]}
    params = {k: jnp.asarray(v) for k, v in params.items()}
    assert sorted(params) == sorted(net.raw_state()[0])

    def loss(p):
        out = functional_call(net, p, jnp.asarray(w["x"]))
        return jnp.sum(out * w["g"]), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def runs():
    ctxs = {n: spawn(ranks.sp_rank, args=(INPUTS[n],), nprocs=n, join=False)
            for n in (2, 4)}
    try:
        want = {n: dict(ops=_jax_ops(n, INPUTS[n]["ops"]),
                        linears=_jax_linears(INPUTS[n]["linears"]))
                for n in (2, 4)}
        for ctx in ctxs.values():
            ctx.join(ranks.JOIN_TIMEOUT_S)
    finally:
        for ctx in ctxs.values():
            ctx.terminate()
    return want, {n: ctx.results for n, ctx in ctxs.items()}


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)))


@pytest.mark.parametrize("n", [2, 4])
def test_op_gradients_match_jax(runs, n):
    want, got = runs
    w = want[n]["ops"]
    x = INPUTS[n]["ops"]
    np.testing.assert_allclose(w["roundtrip_grad"], 2 * x["rep"], rtol=1e-6)
    np.testing.assert_allclose(w["allgather_grad"], float(n))
    for r, res in enumerate(got[n]):
        o = res["ops"]
        assert _err(o["roundtrip"], w["roundtrip"]) <= EXACT
        assert _err(o["roundtrip_grad"], w["roundtrip_grad"]) <= EXACT
        assert _err(o["allgather"], x["seq"]) == 0.0
        assert _err(o["allgather_grad"], np.split(w["allgather_grad"], n)[r]) \
            == 0.0
        assert _err(o["reduce_scatter"],
                    np.split(w["reduce_scatter"], n)[r]) <= EXACT
        assert _err(o["reduce_scatter_grad"],
                    w["reduce_scatter_grad"][r]) <= EXACT


def _want_grads(n, r, grads):
    return {"ln.weight": grads["ln.weight"], "ln.bias": grads["ln.bias"],
            "col.weight": np.split(grads["col.weight"], n, 1)[r],
            "col.bias": np.split(grads["col.bias"], n)[r],
            "row.weight": np.split(grads["row.weight"], n, 0)[r],
            "row.bias": grads["row.bias"]}


@pytest.mark.parametrize("n", [2, 4])
def test_linears_and_hooks_match_full_batch(runs, n):
    want, got = runs
    out, grads = want[n]["linears"]
    for r, res in enumerate(got[n]):
        lin = res["linears"]
        assert lin["marked"] == ["ln.bias", "ln.weight", "row.bias"]
        assert lin["hooks"] == 3
        assert _err(lin["out"], np.split(out, n, 0)[r]) <= TOL
        for k, g in _want_grads(n, r, grads).items():
            assert _err(lin["grads"][k], g) <= TOL * max(1, np.abs(g).max()), \
                (n, r, k)


@pytest.mark.parametrize("n", [2, 4])
def test_hooks_honour_accumulation_steps(runs, n):
    want, got = runs
    _, grads = want[n]["linears"]
    for r, res in enumerate(got[n]):
        acc = res["accumulated"]
        full = grads["ln.weight"]
        # after one of two passes: the rank's own part, not yet reduced
        assert _err(acc["local_ln_grad"], full) > 1e-3
        for k, g in _want_grads(n, r, grads).items():
            assert _err(acc["grads"][k], 2 * g) \
                <= 2 * TOL * max(1, np.abs(g).max()), (n, r, k)
