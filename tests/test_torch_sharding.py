"""ZeRO sharding (``group_sharded_parallel`` stages 1-3) across ranks
against the JAX package's.

Without processes:
- The layout rule: the port's ``extend_spec_with_sharding`` /
  ``resolve_sharding_axis`` equal the JAX functions on the cases of
  ``tests/test_sharding.py`` and on every parameter of the tiny Llama
  (annotated for tensor parallelism) at sharding 2, sharding 2 x mp 2 and
  dp 2 x sharding 2 x mp 2.
- ``convert.shard_slices`` on a co-sharded ``("mp", "sharding")`` entry
  picks the rows JAX places on each device of that mesh.
- ``DygraphShardingOptimizer`` and ``HybridParallelOptimizer`` stamp
  stage 1 as in the reference; ``offload=True`` and an optimizer whose
  update is not elementwise are refused under sharding.

In gloo ranks (a world of 2 and one of 4, spawned once for the file):
``tests/test_sharding.py``'s MLP through ``group_sharded_parallel`` at
``"os"``, ``"os_g"`` and ``"p_g_os"`` (also ``exclude_layer``, and at
sharding 2 x mp 2 with the MLP annotated column/row, which co-shards
fc1's bias), 3 AdamW steps under a global-norm clip that binds, from the
JAX model's weights:
- per-step losses within 1e-5 relative of the JAX ``TrainStep``'s (its
  serial step for every case, its ``hcg(sharding_degree=2)`` mesh step at
  ``"os_g"``); the first batch's gradient norm over the logical
  parameters equals one process's;
- the parameters gathered from the ranks (replicas equal bit for bit)
  within 1e-5 of JAX's, an element whose gradient sits near AdamW's eps
  allowed 3 lr (at most 1e-3 of the elements);
- each rank's slots hold exactly the slice of the JAX step's slots that
  the JAX step's spec gives the rank (its ``opt_state`` sharding where it
  ran on a mesh, the JAX rule elsewhere), and at stage 3 its parameters
  too; ``exclude_layer``'s parameters stay whole; in bf16 with f32 masters
  each master is the slice and rounds to the parameter's slice bit for
  bit;
- stage 2 sends the gradients with reduce-scatters, stage 1 with none;
- gradient merge (k = 2) at stage 2 against the JAX step's, its buffer
  holding this rank's gradient slices;
- the wrappers' eager step (no TrainStep) on the ranks' rows gives the
  JAX eager step on the whole batch; ``save_group_sharded_model`` writes
  on rank 0 only, the whole values.
"""

import os

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_threads  # noqa: F401
import torch_zero_ranks as zranks
import torch_dist_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import group_sharded_parallel as jgsp
from paddle_tpu.distributed.fleet.base_topology import (
    _reset_hcg, create_hybrid_communicate_group)
from paddle_tpu.distributed.fleet.meta_parallel.sharding import (
    extend_spec_with_sharding as jextend,
    resolve_sharding_axis as jresolve)
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models.llama import annotate_llama_tp as jannotate
from paddle_tpu_torch.convert import gather_state, shard_slices
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.fleet import base_topology as ttopo
from paddle_tpu_torch.distributed.fleet import (
    DygraphShardingOptimizer, HybridParallelOptimizer)
from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
    extend_spec_with_sharding, extend_spec_with_sharding_on_mesh,
    resolve_sharding_axis, resolve_sharding_axis_on_mesh)
from paddle_tpu_torch.framework.io import load
from paddle_tpu_torch.hapi import TrainStep
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW, Lamb, LarsMomentum

LR, CLIP, SEED = 1e-2, 0.5, 7
TOL = 1e-5


class JMLP(jnn.Layer):
    """``tests/test_sharding.py``'s MLP."""

    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 64)
        self.fc2 = jnn.Linear(64, 16)

    def forward(self, x, y):
        h = paddle.nn.functional.relu(self.fc1(x))
        out = self.fc2(h)
        return ((out - y) ** 2).mean()


def _batches(n=3, bs=8):
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((bs, 16)).astype(np.float32),
             rng.standard_normal((bs, 16)).astype(np.float32))
            for _ in range(n)]


BATCHES = _batches()


def _case(name, level, sharding, **kw):
    return dict(name=name, level=level, sharding=sharding, clip=CLIP, **kw)


TWO = [_case("os2", "os", 2), _case("os_g2", "os_g", 2),
       _case("p_g_os2", "p_g_os", 2, save=True),
       _case("exclude2", "p_g_os", 2, exclude=True),
       _case("merge2", "os_g", 2, merge=2),
       _case("bf16_os2", "os", 2, bf16=True)]
FOUR = [_case("os4", "os", 4), _case("os_g4", "os_g", 4),
        _case("p_g_os4", "p_g_os", 4, save=True),
        _case("tp4", "p_g_os", 2, mp=2)]
CASES = {c["name"]: c for c in TWO + FOUR}
# saved by save_group_sharded_model after 2 steps, loaded into a new model
# and optimizer, and stepped once more: held to the case of the same name
# without the prefix
RESUMED_TWO = [dict(CASES[n], name="resumed_" + n)
               for n in ("os_g2", "p_g_os2", "bf16_os2")]
RESUMED_FOUR = [dict(CASES["tp4"], name="resumed_tp4")]
F32 = [n for n, c in CASES.items() if not c.get("bf16")]


def _strip(name):
    return name.removeprefix("_layer.")


def _jax_weights():
    paddle.seed(SEED)
    return {k: np.asarray(v) for k, v in JMLP().raw_state()[0].items()}


def _jax_run(level=None, hcg=None, merge=None):
    """The JAX TrainStep's 3 steps (gradient merge over ``merge`` calls):
    (losses, params, slots, slot specs); without ``hcg`` its serial
    step."""
    paddle.seed(SEED)
    model = JMLP()
    opt = paddle.optimizer.AdamW(
        LR, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
    wrapped = model
    if level is not None:
        wrapped, opt, _ = jgsp(model, opt, level)
    step = JTrainStep(wrapped, opt,
                      mesh=None if hcg is None else hcg.get_mesh(),
                      data_axes=("dp", "sharding"), gradient_merge_k=merge)
    losses = [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
              for x, y in BATCHES]
    step.sync_to_model()
    params = {k: np.asarray(v) for k, v in model.raw_state()[0].items()}
    slots = {_strip(k): {s: np.asarray(v) for s, v in d.items()}
             for k, d in step.opt_state["slots"].items()}
    specs = {_strip(k): tuple(d["moment1"].sharding.spec)
             for k, d in step.opt_state["slots"].items()} if hcg else None
    return losses, params, slots, specs


def _jax_eager(batch):
    paddle.seed(SEED)
    model = JMLP()
    opt = paddle.optimizer.AdamW(LR, parameters=model.parameters())
    model(*(paddle.to_tensor(a) for a in batch)).backward()
    opt.step()
    return {k: np.asarray(v) for k, v in model.raw_state()[0].items()}


def _sizes(case):
    return {"dp": case.get("dp", 1), "sharding": case["sharding"],
            "mp": case.get("mp", 1)}


def _within(got, want, what):
    """Elementwise within TOL, except at most 1e-3 of the elements (near
    AdamW's eps) within 3 lr."""
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.max() <= 3 * LR, (what, diff.max())
    return int((diff > TOL).sum()), diff.size


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights = _jax_weights()
    bf16 = {k: v.astype(np.float32) for k, v in weights.items()}
    out_dir = str(tmp_path_factory.mktemp("zero_save"))
    two = spawn(zranks.sharding_rank,
                args=(TWO, weights, bf16, BATCHES, out_dir, RESUMED_TWO),
                nprocs=2, join=False)
    four = spawn(zranks.sharding_rank,
                 args=(FOUR, weights, bf16, BATCHES, out_dir, RESUMED_FOUR),
                 nprocs=4, join=False)
    try:
        serial = _jax_run()
        merged = _jax_run(merge=2)
        _reset_hcg()
        mesh_run = _jax_run("os_g", create_hybrid_communicate_group(
            sharding_degree=2))
        _reset_hcg()
        eager = _jax_eager(BATCHES[0])
        two.join(ranks.JOIN_TIMEOUT_S)
        four.join(ranks.JOIN_TIMEOUT_S)
    finally:
        two.terminate()
        four.terminate()
    port = {}
    for ctx in (two, four):
        for name in ctx.results[0]:
            if name != "eager":
                port[name] = [r[name] for r in ctx.results]
    port["eager"] = [r["eager"] for r in two.results + four.results]
    return dict(weights=weights, serial=serial, merged=merged,
                mesh=mesh_run, eager=eager, port=port, out_dir=out_dir)


def _ref(runs, name):
    """The JAX serial run a case is held to."""
    return runs["merged" if CASES[name].get("merge") else "serial"]


# ----------------------------------------------------------- no processes
REF_CASES = [  # tests/test_sharding.py's TestExtendSpec
    ((), (64, 16), dict(sharding=8), ("sharding", None)),
    ((), (16, 128), dict(sharding=8), (None, "sharding")),
    ((None, "mp"), (64, 32), dict(dp=2, sharding=2, mp=2),
     ("sharding", "mp")),
    (("mp",), (64,), dict(dp=2, sharding=2, mp=2), (("mp", "sharding"),)),
    ((), (3, 5), dict(sharding=8), (None, None)),
    (("sharding", None), (64, 16), dict(sharding=8), ("sharding", None)),
]


def _jmesh(deg):
    _reset_hcg()
    return create_hybrid_communicate_group(
        dp_degree=deg.get("dp", 1), sharding_degree=deg.get("sharding", 1),
        mp_degree=deg.get("mp", 1)).get_mesh()


def _port_sizes(deg):
    return {a: deg.get(a, 1) for a in ("dp", "pp", "sharding", "sep", "mp")}


@pytest.mark.parametrize("spec,shape,deg,want", REF_CASES,
                         ids=["free", "largest-free", "tp-axis", "coshard",
                              "indivisible", "already"])
def test_extend_spec_equals_jax(spec, shape, deg, want):
    jmesh = _jmesh(deg)
    try:
        j = tuple(jextend(P(*spec), shape, jmesh, "sharding"))
        assert jresolve(jmesh) == resolve_sharding_axis(_port_sizes(deg))
    finally:
        _reset_hcg()
    got = extend_spec_with_sharding(spec, shape, _port_sizes(deg))
    assert got == j == want
    # the forms over a DeviceMesh read its names and shape
    mesh = type("Mesh", (), dict(mesh_dim_names=tuple(_port_sizes(deg)),
                                 shape=tuple(_port_sizes(deg).values())))
    assert extend_spec_with_sharding_on_mesh(spec, shape, mesh) == want
    assert resolve_sharding_axis_on_mesh(mesh) == "sharding"


@pytest.mark.parametrize("deg", [dict(sharding=2), dict(sharding=2, mp=2),
                                 dict(dp=2, sharding=2, mp=2)],
                         ids=["s2", "s2_mp2", "dp2_s2_mp2"])
def test_llama_specs_equal_jax(deg):
    """Every parameter of the annotated tiny Llama extends as JAX's."""
    paddle.seed(SEED)
    model = JLlamaForCausalLM(JLlamaConfig.tiny())
    jannotate(model)
    jmesh = _jmesh(deg)
    sizes = _port_sizes(deg)
    try:
        for name, p in model.named_parameters():
            spec = tuple(getattr(p, "dist_attr", None) or ())
            want = tuple(jextend(P(*spec), tuple(p.shape), jmesh,
                                 "sharding"))
            got = extend_spec_with_sharding(spec, tuple(p.shape), sizes)
            assert got == want, (name, got, want)
        assert resolve_sharding_axis(sizes) == jresolve(jmesh) == "sharding"
    finally:
        _reset_hcg()


def test_shard_slices_coshard_is_jax_placement():
    """A ``("mp", "sharding")`` dimension: each device's rows under JAX's
    NamedSharding are ``convert.shard_slices``' at its coordinates, and
    ``gather_state`` puts them back."""
    deg = dict(dp=2, sharding=2, mp=2)
    jmesh = _jmesh(deg)
    spec = (("mp", "sharding"), None)
    whole = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    try:
        import jax
        arr = jax.device_put(whole, NamedSharding(jmesh, P(*spec)))
        shards, coords = [], []
        for sh in arr.addressable_shards:
            pos = np.argwhere(jmesh.devices == sh.device)[0]
            c = dict(zip(jmesh.axis_names, (int(i) for i in pos)))
            idx = shard_slices(whole.shape, spec, c, _port_sizes(deg))
            np.testing.assert_array_equal(np.asarray(sh.data), whole[idx])
            shards.append({"w": whole[idx]})
            coords.append(c)
    finally:
        _reset_hcg()
    back = gather_state(shards, {"w": spec}, coords, _port_sizes(deg))
    np.testing.assert_array_equal(back["w"], whole)


def test_sharding_optimizers_stamp_stage1():
    """As ``tests/test_sharding.py``: ``DygraphShardingOptimizer`` stamps
    stage 1 on the sharding axis, ``HybridParallelOptimizer`` wraps one
    when the sharding degree exceeds 1 (the topology described for rank
    0, no runtime)."""
    hcg = ttopo.create_hybrid_communicate_group(sharding_degree=8,
                                                global_rank=0)
    try:
        net = zranks.MLP()
        opt = AdamW(1e-2, parameters=net.named_parameters())
        wrapped = DygraphShardingOptimizer(opt, hcg)
        assert (opt._group_sharded_level, opt._sharding_axis) == (
            1, "sharding")
        assert wrapped.get_lr() == opt.get_lr()
        opt2 = AdamW(1e-2, parameters=net.named_parameters())
        hp = HybridParallelOptimizer(opt2, hcg)
        assert isinstance(hp._inner_opt, DygraphShardingOptimizer)
        assert opt2._group_sharded_level == 1
    finally:
        ttopo._reset_hcg()


class _FakeMesh:
    """A mesh's names and shape only: the level and the optimizer are
    checked before the step touches the runtime."""

    device_type = "cpu"
    mesh_dim_names = ("dp", "sharding")
    shape = (1, 2)


@pytest.mark.parametrize("make", [
    lambda ps: Lamb(1e-3, parameters=ps),
    lambda ps: LarsMomentum(1e-3, parameters=ps)], ids=["lamb", "lars"])
def test_whole_norm_optimizers_refuse_sharding(make):
    net = zranks.MLP()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainStep(net, make(net.named_parameters()), mesh=_FakeMesh(),
                  sharding_level=2)


def test_offload_is_refused():
    from paddle_tpu_torch.distributed import group_sharded_parallel
    net = zranks.MLP()
    opt = AdamW(1e-2, parameters=net.named_parameters())
    for level in ("os", "p_g_os"):
        with pytest.raises(NotImplementedError, match="offload"):
            group_sharded_parallel(net, opt, level, offload=True)
    with pytest.raises(ValueError, match="level"):
        group_sharded_parallel(net, opt, "zero4")


# -------------------------------------------------------------- the ranks
@pytest.mark.parametrize("name", F32)
def test_losses_match_jax(runs, name):
    want = _ref(runs, name)[0]
    for r in runs["port"][name]:
        rel = np.abs(np.subtract(r["losses"], want)) / np.abs(want)
        assert rel.max() <= TOL, (r["coords"], r["losses"], want)
    if name == "os_g2":
        np.testing.assert_allclose(runs["mesh"][0], want, rtol=TOL)


@pytest.mark.parametrize("name", F32)
def test_gathered_params_match_jax(runs, name):
    rs = runs["port"][name]
    got = gather_state([r["shard"] for r in rs], rs[0]["param_specs"],
                       [r["coords"] for r in rs], _sizes(CASES[name]))
    want = _ref(runs, name)[1]
    assert sorted(got) == sorted(want)
    off = total = 0
    for k in want:
        o, t = _within(got[k], want[k], k)
        off, total = off + o, total + t
    print(f"{name}: {off} of {total} elements beyond {TOL}")
    assert off <= 1e-3 * total


@pytest.mark.parametrize("name", F32)
def test_clip_norm_is_the_logical_parameters(runs, name):
    from paddle_tpu_torch.convert import load_state
    net = zranks.MLP()
    load_state(net, runs["weights"])
    net(*(torch.from_numpy(a) for a in BATCHES[0])).backward()
    want = float(ClipGradByGlobalNorm(CLIP).global_norm_sq(
        p.grad for p in net.parameters()).sqrt())
    assert want > CLIP
    for r in runs["port"][name]:
        assert abs(r["norm"] - want) <= TOL * want, (r["norm"], want)


def _trim(spec):
    """A spec without its trailing None entries (a placed array's
    ``PartitionSpec`` drops them)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _jax_spec(runs, name, k, shape, param_spec):
    """The JAX step's spec of ``k``'s slots in case ``name``: its mesh
    step's where it ran one, else the JAX rule on the case's mesh."""
    if name == "os_g2":
        return runs["mesh"][3][k]
    jmesh = _jmesh(_sizes(CASES[name]))
    try:
        return tuple(jextend(P(*param_spec), shape, jmesh, "sharding"))
    finally:
        _reset_hcg()


@pytest.mark.parametrize("name", F32)
def test_slots_are_the_jax_slice(runs, name):
    """Each rank's moments: the JAX step's spec (its mesh step's
    ``opt_state`` sharding at os_g2), this rank's slice of JAX's values
    (within 1e-4 relative, or 1e-4 of the slot's largest element: a
    gradient summed in another order); the parameters' shapes too, sliced
    at stage 3."""
    case = CASES[name]
    want_params, want_slots = _ref(runs, name)[1:3]
    tp = {k: zranks.MLP_TP_SPECS.get(k, ()) if case.get("mp") else ()
          for k in want_params}
    for r in runs["port"][name]:
        for k, slots in r["slots"].items():
            shape = want_params[k].shape
            spec = _jax_spec(runs, name, k, shape, tp[k])
            assert _trim(r["opt_specs"][k]) == _trim(spec), (
                k, r["opt_specs"][k], spec)
            idx = shard_slices(shape, spec, r["coords"], _sizes(case))
            for s in ("moment1", "moment2"):
                want = want_slots[k][s][idx]
                scale = np.abs(want_slots[k][s]).max()
                assert slots[s].shape == want.shape, (k, s)
                np.testing.assert_allclose(slots[s], want, rtol=1e-4,
                                           atol=1e-4 * scale, err_msg=k)
            pspec = tuple(r["param_specs"][k])
            stored = case["level"] == "p_g_os" and not (
                case.get("exclude") and k.startswith("fc2"))
            assert _trim(pspec) == _trim(spec if stored else tp[k]), (
                k, pspec)
            assert r["shard"][k].shape == want_params[k][shard_slices(
                shape, pspec, r["coords"], _sizes(case))].shape
            if case.get("merge"):   # stage 2: the merge buffer's slices
                assert r["merge_buf"][k] == slots["moment1"].shape, k


def test_bf16_masters_are_the_slice(runs):
    """bf16 with f32 masters at stage 1: each master has the slot's
    slice shape and rounds to this rank's slice of the (bit-equal)
    replicas of the parameter."""
    rs = runs["port"]["bf16_os2"]
    case = CASES["bf16_os2"]
    whole = gather_state([r["shard"] for r in rs], rs[0]["param_specs"],
                         [r["coords"] for r in rs], _sizes(case))
    for r in rs:
        for k, slots in r["slots"].items():
            idx = shard_slices(whole[k].shape, r["opt_specs"][k],
                               r["coords"], _sizes(case))
            master = torch.from_numpy(slots["master"])
            assert master.shape == whole[k][idx].shape
            assert master.shape == slots["moment1"].shape
            np.testing.assert_array_equal(
                master.to(torch.bfloat16).float().numpy(), whole[k][idx])


def test_stage2_reduce_scatters(runs):
    """A step's collectives (the MLP's four parameters, all cut): stage 1
    all-reduces the gradients, stage 2 reduce-scatters them, stage 3
    gathers each parameter once a forward and nothing after the update."""
    steps = len(BATCHES)
    for n in ("2", "4"):
        c1 = runs["port"]["os" + n][0]["counts"]
        c2 = runs["port"]["os_g" + n][0]["counts"]
        c3 = runs["port"]["p_g_os" + n][0]["counts"]
        assert c1.get("reduce_scatter", 0) == 0
        assert c1["all_gather"] == c2["all_gather"] == 4 * steps
        assert c2["reduce_scatter"] == c3["reduce_scatter"] == 4 * steps
        assert c1["all_reduce"] == 5 * steps   # 4 gradients, the loss
        assert c2["all_reduce"] == 2 * steps   # the loss, the clip
        assert c3["all_gather"] == 4 * steps


def test_wrapper_eager_step_is_the_data_mean(runs):
    """Each world's ranks equal bit for bit, and the JAX eager step on the
    whole batch within TOL (the allowance near eps as above)."""
    want = runs["eager"]
    eager = runs["port"]["eager"]
    for world in (eager[:2], eager[2:]):
        for got in world:
            for k in want:
                np.testing.assert_array_equal(got[k], world[0][k])
                off, total = _within(got[k], want[k], k)
                assert off <= 1e-3 * total, (k, off)


@pytest.mark.parametrize("name", ["p_g_os2", "p_g_os4"])
def test_save_writes_rank0_whole(runs, name):
    rs = runs["port"][name]
    case = CASES[name]
    assert os.path.isdir(rs[0]["saved"])
    for r in rs[1:]:
        assert not os.path.exists(r["saved"])
    sd = load(os.path.join(rs[0]["saved"], "model.pdmodel"),
              return_numpy=True)
    whole = gather_state([r["shard"] for r in rs], rs[0]["param_specs"],
                         [r["coords"] for r in rs], _sizes(case))
    assert sorted(sd) == sorted(whole)
    for k, v in whole.items():
        np.testing.assert_array_equal(sd[k], v)
    for r in rs:    # get_all_parameters: the same whole values
        for v, k in zip(r["all_parameters"], whole):
            np.testing.assert_array_equal(v, whole[k])
    opt = load(os.path.join(rs[0]["saved"], "model.pdopt"),
               return_numpy=True)
    assert opt["@step"] == len(BATCHES)
    for k in whole:
        for s in ("moment1", "moment2"):
            got = gather_state([{k: r["slots"][k][s]} for r in rs],
                               rs[0]["opt_specs"],
                               [r["coords"] for r in rs], _sizes(case))[k]
            np.testing.assert_array_equal(opt[f"{k}_{s}_0"], got)


@pytest.mark.parametrize("name", [c["name"] for c in RESUMED_TWO
                                  + RESUMED_FOUR])
def test_resumes_from_saved_state(runs, name):
    """A run saved by ``save_group_sharded_model`` (model and optimizer
    state whole) and loaded into a new model and optimizer on the same
    ranks takes the next step as the run that went on: the same loss,
    parameter slices, slots and masters, bit for bit; a slot of another
    shape is refused with its name."""
    base = name.removeprefix("resumed_")
    for got, want in zip(runs["port"][name], runs["port"][base]):
        assert got["coords"] == want["coords"]
        assert got["losses"] == want["losses"], (got["losses"],
                                                 want["losses"])
        for k in want["shard"]:
            np.testing.assert_array_equal(got["shard"][k], want["shard"][k])
        assert sorted(got["slots"]) == sorted(want["slots"])
        for k, slots in want["slots"].items():
            assert sorted(got["slots"][k]) == sorted(slots)
            for s, v in slots.items():
                np.testing.assert_array_equal(got["slots"][k][s], v)
        assert "fc1.weight_moment1_0" in got["refused"]
        assert "(3, 16)" in got["refused"]

