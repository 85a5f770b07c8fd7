"""The port's collectives across gloo ranks against the JAX package's.

The reference is single-controller: rank r's tensor is slice r of a
stacked tensor and every collective returns stacked results. Four gloo
ranks (spawned once for the file) each take their slice of the same seeded
numpy inputs and run every collective, p2p call, object collective and
subgroup of the reference's ``tests/test_communication.py``; rank r's
result must equal slice r of the JAX package's stacked result (over a JAX
group of four host devices), exactly or within 1e-6. ``ReduceOp.PROD``
keeps the sign of a zero product; a ``src`` / ``dst`` outside the group
raises. Designed differences, held here too: uneven ``alltoall_single``
splits (the reference refuses them), ``gather`` fills only ``dst``'s list,
``get_backend()`` names the torch backend.
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401
import torch_dist_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu_torch.distributed import spawn

N = 4
OPS = ("sum", "max", "min", "avg", "prod")


def _inputs():
    rng = np.random.default_rng(0)
    x = {"vals": rng.standard_normal((N, 4)).astype(np.float32),
         "signed": np.array([[-2.0, 0.0, 3.0], [3.0, -1.0, -0.0],
                             [1.0, 2.0, 1.0], [1.0, 1.0, 1.0]], np.float32),
         "chunks": np.stack([np.full((3,), float(i), np.float32)
                             for i in range(N)]),
         "a2a_single": np.arange(N * N, dtype=np.float32).reshape(N, N)}
    for j in range(N):
        x[f"rs{j}"] = np.random.default_rng(j).standard_normal(
            (N, 4)).astype(np.float32)
        x[f"a2a{j}"] = np.array([[r * 10 + j] for r in range(N)],
                                np.float32)
    return x


def _t(a):
    return paddle.to_tensor(np.array(a, copy=True))


def _jax(x):
    """The JAX package's stacked results, rank by rank."""
    jdist.destroy_process_group()
    g = jdist.new_group(list(range(N)))
    ref = {}
    for name in OPS:
        t = _t(x["vals"])
        jdist.all_reduce(t, op=getattr(jdist.ReduceOp, name.upper()),
                         group=g)
        ref[f"all_reduce_{name}"] = t.numpy()
    t = _t(x["signed"])
    jdist.all_reduce(t, op=jdist.ReduceOp.PROD, group=g)
    ref["all_reduce_prod_signed"] = t.numpy()
    sub = jdist.new_group([1, 3])
    t = _t(x["vals"][[1, 3]])
    jdist.all_reduce(t, group=sub)
    got = x["vals"].copy()               # non-members keep their input
    got[[1, 3]] = t.numpy()
    ref["all_reduce_subgroup"] = got
    t = _t(x["vals"])
    jdist.broadcast(t, src=3, group=g)
    ref["broadcast"] = t.numpy()
    t = _t(x["vals"])
    jdist.reduce(t, dst=2, group=g)
    ref["reduce"] = t.numpy()
    out = []
    jdist.all_gather(out, _t(x["vals"]), group=g)
    # rank r's list: element j is slice r of the reference's element j
    ref["all_gather"] = np.stack([o.numpy() for o in out], axis=1)
    t = paddle.zeros([N, 3])
    jdist.scatter(t, [_t(c) for c in x["chunks"]], src=0, group=g)
    ref["scatter"] = t.numpy()
    t = paddle.zeros([N, 4])
    jdist.reduce_scatter(t, [_t(x[f"rs{j}"]) for j in range(N)], group=g)
    ref["reduce_scatter"] = t.numpy()
    out = []
    jdist.alltoall(out, [_t(x[f"a2a{j}"]) for j in range(N)], group=g)
    ref["alltoall"] = np.stack([o.numpy() for o in out], axis=1)
    t = paddle.zeros([N, N])
    jdist.alltoall_single(t, _t(x["a2a_single"]), group=g)
    ref["alltoall_single"] = t.numpy()
    out = []
    jdist.gather(_t(x["vals"]), out, dst=0, group=g)
    ref["gather"] = np.stack([o.numpy() for o in out])
    objs = []
    jdist.all_gather_object(objs, "x", group=g)
    ref["n_objects"] = len(objs)
    g2 = jdist.new_group([0, 2])
    ref["group_api"] = (g2.nranks, g2.world_size, g2.get_group_rank(2),
                        g2.get_group_rank(3), jdist.get_group(g2.id) is g2)
    with pytest.raises(ValueError, match="not in group"):
        jdist.scatter(paddle.zeros([2, 2]), [paddle.ones([2])] * 2, src=0,
                      group=sub)
    with pytest.raises(ValueError, match="not in group"):
        jdist.reduce(_t(x["vals"][[1, 3]]), dst=2, group=sub)
    jdist.destroy_process_group()
    return ref


@pytest.fixture(scope="module")
def runs():
    x = _inputs()
    ctx = spawn(ranks.comm_rank, args=(x,), nprocs=N, join=False)
    try:
        ref = _jax(x)
        ctx.join(ranks.JOIN_TIMEOUT_S)
    finally:
        ctx.terminate()
    return x, ref, ctx.results


@pytest.mark.parametrize("name", [f"all_reduce_{o}" for o in OPS] + [
    "all_reduce_subgroup", "broadcast", "reduce", "all_gather", "scatter",
    "reduce_scatter", "alltoall", "alltoall_single"])
def test_rank_result_is_the_stacked_slice(runs, name):
    _, ref, got = runs
    for r in range(N):
        np.testing.assert_allclose(got[r][name], ref[name][r], rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")


def test_prod_keeps_the_sign_of_zero(runs):
    _, ref, got = runs
    want = ref["all_reduce_prod_signed"]
    assert np.signbit(want[0, 1]) and np.signbit(want[0, 2])
    for r in range(N):
        np.testing.assert_array_equal(got[r]["all_reduce_prod_signed"],
                                      want[r])
        np.testing.assert_array_equal(
            np.signbit(got[r]["all_reduce_prod_signed"]), np.signbit(want[r]))


def test_gather_fills_dst_only(runs):
    _, ref, got = runs
    np.testing.assert_array_equal(got[0]["gather"], ref["gather"])
    assert all(got[r]["gather"] is None for r in range(1, N))


def test_uneven_alltoall_single(runs):
    """Rank j sends j + 1 rows to every rank (the reference refuses uneven
    splits: a designed difference)."""
    _, _, got = runs
    for r in range(N):
        want = np.concatenate([
            (np.arange(N * (j + 1), dtype=np.float32)
             + 100 * j)[r * (j + 1):(r + 1) * (j + 1)] for j in range(N)])
        np.testing.assert_array_equal(got[r]["alltoall_single_uneven"], want)


def test_point_to_point(runs):
    _, _, got = runs
    for r in range(N):
        np.testing.assert_array_equal(
            got[r]["send_recv"],
            np.arange(4.0) if r == 1 else np.zeros(4))
        np.testing.assert_array_equal(got[r]["ring"],
                                      np.full(2, float((r - 1) % N)))


def test_object_collectives(runs):
    _, ref, got = runs
    for r in range(N):
        assert len(got[r]["all_gather_object"]) == ref["n_objects"] == N
        assert got[r]["all_gather_object"] == [{"rank": j} for j in range(N)]
        assert got[r]["scatter_object_list"] == [f"obj{r}"]


def test_group_api(runs):
    _, ref, got = runs
    for r in range(N):
        nranks, size, rank, g2, g3, same, backend = got[r]["group_api"]
        assert (nranks, size, g2, g3, same) == ref["group_api"]
        assert rank == {0: 0, 2: 1}.get(r, -1)
        assert backend == "gloo"
        assert got[r]["destroyed"]


def test_src_dst_outside_the_group_raise(runs):
    _, _, got = runs
    for r in range(N):
        errs = got[r]["errors"]
        assert len(errs) == 3 and all("not in group" in e for e in errs)


def test_collectives_are_counted(runs):
    _, _, got = runs
    counts = got[1]["counts"]
    assert counts["all_reduce"] == 7 and counts["alltoall_single"] == 2
    assert counts["recv"] == 2 and counts["send"] == 1
    assert "all_reduce" in got[0]["counts"]


def test_spawn_raises_a_failing_rank_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 raised") as e:
        spawn(ranks.failing_rank, args=(1,), nprocs=2,
              timeout=ranks.JOIN_TIMEOUT_S)
    assert "rank 1 was told to fail" in str(e.value)
    assert "Traceback" in str(e.value)


def test_spawn_joined_after_its_ranks_exited():
    """``join=False``, then ``join`` once every rank has exited, rank 0's
    result last in the queue: each rank's result is taken, however many
    wait before it."""
    import time
    ctx = spawn(ranks.rank_zero_last, args=(3,), nprocs=4, join=False)
    deadline = time.monotonic() + 60
    while any(p.is_alive() for p in ctx.processes) \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    ctx.join(30)
    assert ctx.results == [0, 1, 2, 3]


def test_spawn_join_times_out_and_stops_the_ranks():
    with pytest.raises(RuntimeError, match=r"still running after 2 s"):
        spawn(ranks.sleeping_rank, args=(600,), nprocs=2, timeout=2)
