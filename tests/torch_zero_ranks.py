"""Rank bodies for the port's ZeRO, LocalSGD and DGC tests (gloo on the
CPU), JAX-free as ``torch_dist_ranks.py`` is: each body starts the gloo
runtime, runs its cases from the numpy weights and batches the test
process sends, returns numpy results and tears the runtime down.
"""

from __future__ import annotations

import os

import torch
from torch import nn

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.convert import load_state
from paddle_tpu_torch.distributed.fleet import base_topology as topo
from torch_dist_ranks import _np, _start


class MLP(nn.Module):
    """``tests/test_sharding.py``'s MLP: 16 -> 64 -> relu -> 16, mean
    squared error."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        from paddle_tpu_torch.nn import Linear
        self.fc1 = Linear(16, 64, device="cpu", dtype=dtype)
        self.fc2 = Linear(64, 16, device="cpu", dtype=dtype)
        self.dtype = dtype

    def forward(self, x, y):
        out = self.fc2(torch.relu(self.fc1(x.to(self.dtype))))
        return ((out - y.to(out.dtype)) ** 2).mean()


# the MLP annotated for tensor parallelism: fc1 a column layer (its bias
# cut with it), fc2 a row layer
MLP_TP_SPECS = {"fc1.weight": (None, "mp"), "fc1.bias": ("mp",),
                "fc2.weight": ("mp", None)}


def _hcg(case):
    return topo.create_hybrid_communicate_group(
        dp_degree=case.get("dp", 1), sharding_degree=case.get("sharding", 1),
        mp_degree=case.get("mp", 1))


def _coords(hcg):
    return {"dp": hcg.get_data_parallel_rank(),
            "sharding": hcg.get_sharding_parallel_rank(),
            "mp": hcg.get_model_parallel_rank()}


def _slots(opt):
    """``{name: {slot: array}}`` of this rank (the master as ``master``,
    in f32)."""
    return {opt._names[p]: {k: _np(v.float()) for k, v in st.items()}
            for p, st in opt.state.items()}


def _mlp_step(case, weights):
    """``case``'s topology, and the MLP from ``weights`` through
    ``group_sharded_parallel`` and ``TrainStep(mesh=...)``: (hcg, net,
    wrapped model, wrapped optimizer, step)."""
    from paddle_tpu_torch.distributed import group_sharded_parallel
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    hcg = _hcg(case)
    dtype = torch.bfloat16 if case.get("bf16") else torch.float32
    net = MLP(dtype)
    load_state(net, weights)
    if case.get("mp", 1) > 1:
        for name, p in net.named_parameters():
            p.dist_attr = MLP_TP_SPECS.get(name)
    opt = AdamW(1e-2, parameters=net.named_parameters(),
                multi_precision=dtype != torch.float32,
                grad_clip=ClipGradByGlobalNorm(case["clip"]))
    exclude = [net.fc2] if case.get("exclude") else None
    model, wrapped, _ = group_sharded_parallel(net, opt, case["level"],
                                               exclude_layer=exclude)
    step = TrainStep(model, wrapped, mesh=hcg.get_mesh(),
                     data_axes=("dp", "sharding"),
                     gradient_merge_k=case.get("merge"))
    return hcg, net, model, wrapped, step


def _mlp_case(case, weights, batches, out_dir):
    from paddle_tpu_torch.distributed import save_group_sharded_model
    hcg, net, model, wrapped, step = _mlp_step(case, weights)
    x0, y0 = (torch.from_numpy(a) for a in batches[0])
    step.compute_loss_grads(*step.stage(x0, y0).vals)
    norm = float(step.optimizer._grad_clip.global_norm_sq(
        step.optimizer._params_grads()).sqrt())
    step.optimizer.clear_grad()
    dist.reset_collective_counts()
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in batches]
    counts = dist.collective_counts()
    out = dict(losses=losses, norm=norm, coords=_coords(hcg), counts=counts,
               level=step.sharding_level, axis=step.sharding_axis,
               param_specs=step._plan.param_specs,
               opt_specs=step._plan.opt_specs,
               shard={k: _np(p.float()) for k, p in net.named_parameters()},
               slots=_slots(step.optimizer),
               merge_buf={step.optimizer._names[p]: tuple(b.shape)
                          for p, b in (step._merge_buf or {}).items()})
    if case.get("save"):
        path = os.path.join(out_dir, f"{case['name']}_rank{dist.get_rank()}")
        save_group_sharded_model(model, path, optimizer=wrapped)
        whole = model.get_all_parameters()
        out["all_parameters"] = [_np(t) for t in whole]
        out["saved"] = path
    topo._reset_hcg()
    return out


def _resume_case(case, weights, batches, out_dir):
    """``case``'s steps but the last, saved by ``save_group_sharded_model``
    into ``out_dir/<name>``; then a new MLP and optimizer, loaded from
    rank 0's files on every rank, take the last step. Also a slot of
    neither the slice's shape nor the whole's, refused."""
    from paddle_tpu_torch.distributed import save_group_sharded_model
    from paddle_tpu_torch.framework.io import load
    path = os.path.join(out_dir, case["name"])
    _, _, model, wrapped, step = _mlp_step(case, weights)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in batches[:-1]]
    save_group_sharded_model(model, path, optimizer=wrapped)
    dist.barrier()
    topo._reset_hcg()
    saved = {k: v.float()     # numpy, which load_state reads, has no bf16
             for k, v in load(os.path.join(path, "model.pdmodel")).items()}
    opt_state = load(os.path.join(path, "model.pdopt"))
    hcg, net, model, wrapped, step = _mlp_step(case, saved)
    wrapped.set_state_dict(opt_state)
    x, y = (torch.from_numpy(a) for a in batches[-1])
    losses.append(float(step(x, y)))
    bad = dict(opt_state, **{"fc1.weight_moment1_0": torch.zeros(3, 16)})
    try:
        step.optimizer.set_state_dict(bad)
        refused = None
    except ValueError as e:
        refused = str(e)
    out = dict(losses=losses, coords=_coords(hcg),
               shard={k: _np(p.float()) for k, p in net.named_parameters()},
               slots=_slots(step.optimizer), refused=refused)
    topo._reset_hcg()
    return out


def _eager_case(n, weights, batch):
    """``group_sharded_parallel(..., "os_g")`` with no TrainStep: each rank
    takes its rows of the global batch, steps the wrapper's optimizer
    eagerly once."""
    from paddle_tpu_torch.distributed import group_sharded_parallel
    from paddle_tpu_torch.optimizer import AdamW
    hcg = topo.create_hybrid_communicate_group(sharding_degree=n)
    net = MLP()
    load_state(net, weights)
    opt = AdamW(1e-2, parameters=net.named_parameters())
    model, opt, _ = group_sharded_parallel(net, opt, "os_g")
    r = hcg.get_sharding_parallel_rank()
    x, y = (torch.from_numpy(a).chunk(n)[r] for a in batch)
    model(x, y).backward()
    opt.step()
    opt.clear_grad()
    out = {k: _np(p) for k, p in net.named_parameters()}
    topo._reset_hcg()
    return out


def sharding_rank(rank, cases, weights, bf16_weights, batches, out_dir,
                  resumed=()):
    """Each MLP case at its degrees and ZeRO level, each ``resumed`` case
    saved and loaded before its last step, then the wrappers' eager
    step."""
    _start()
    try:
        out = {c["name"]: (_resume_case if c in resumed else _mlp_case)(
            c, bf16_weights if c.get("bf16") else weights, batches, out_dir)
            for c in list(cases) + list(resumed)}
        out["eager"] = _eager_case(dist.get_world_size(), weights,
                                   batches[0])
        return out
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the Llama
def _llama_case(case, weights):
    from paddle_tpu_torch.distributed import group_sharded_parallel
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.llama import annotate_llama_tp
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as tlr
    hcg = _hcg(case)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_state(model, weights)
    annotate_llama_tp(model)
    lr = case["lr"]
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(lr, T_max=10), 2,
                             lr / 10, lr)
    opt = AdamW(sched, parameters=model.named_parameters(),
                weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(case["clip"]))
    wrapped, opt, _ = group_sharded_parallel(model, opt, case["level"])
    step = TrainStep(wrapped, opt, mesh=hcg.get_mesh(),
                     data_axes=("dp", "sharding"),
                     remat=case.get("remat", False))
    x0, y0 = (torch.from_numpy(a) for a in case["batches"][0])
    step.compute_loss_grads(*step.stage(x0, y0).vals)
    norm = float(step.optimizer._grad_clip.global_norm_sq(
        step.optimizer._params_grads()).sqrt())
    step.optimizer.clear_grad()
    dist.reset_collective_counts()
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in case["batches"]]
    out = dict(losses=losses, norm=norm, coords=_coords(hcg),
               counts=dist.collective_counts(),
               level=step.sharding_level, param_specs=step._plan.param_specs,
               heads=(model.llama.layers[0].self_attn.num_heads,
                      model.llama.layers[0].self_attn.num_kv_heads),
               shard={k: _np(p) for k, p in model.named_parameters()})
    topo._reset_hcg()
    return out


def _scaler_case(case, weights, batches):
    """fp16 ``Linear(16, 8)`` at sharding 2, stage 2, SGD under a
    ``HybridParallelGradScaler``: a batch whose inf sits in one rank's
    gradient slice."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed import group_sharded_parallel
    from paddle_tpu_torch.distributed.fleet import HybridParallelGradScaler
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import SGD
    hcg = _hcg(case)
    net = Linear(16, 8, bias=False, device="cpu", dtype=torch.float16)
    load_state(net, weights)
    opt = SGD(0.1, parameters=net.named_parameters())
    model, opt, _ = group_sharded_parallel(net, opt, "os_g")
    scaler = HybridParallelGradScaler(
        GradScaler(init_loss_scaling=case["scale"]), hcg)

    def loss_fn(out, y):
        return scaler.scale(((out.float() - y) ** 2).mean())

    step = TrainStep(model, opt, loss_fn=loss_fn, mesh=hcg.get_mesh(),
                     data_axes=("sharding",))
    rows = []
    for x, y in batches:
        step.compute_loss_grads(*step.stage(torch.from_numpy(x),
                                            torch.from_numpy(y)).vals)
        pg = step.optimizer._params_grads()
        local = not all(bool(torch.isfinite(g).all()) for _, g in pg)
        scaler.step(step.optimizer)
        found = scaler._found_inf
        scaler.update()
        step.optimizer.clear_grad()
        rows.append(dict(local_inf=local, found_inf=found,
                         scale=scaler._scale,
                         weight=_np(net.weight.float())))
    out = dict(rows=rows, coords=_coords(hcg),
               opt_specs=step._plan.opt_specs)
    topo._reset_hcg()
    return out


def zero_train_rank(rank, cases, weights, scaler_case=None,
                    scaler_weights=None):
    """The tiny Llama's cases, and on a world of 2 the fp16 scaler case."""
    _start()
    try:
        out = {c["name"]: _llama_case(c, weights) for c in cases}
        if scaler_case is not None:
            out["scaler"] = _scaler_case(scaler_case, scaler_weights,
                                         scaler_case["batches"])
        return out
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ LocalSGD and DGC
def _localsgd_case(case, weights, x, y):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        HybridParallelOptimizer
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import SGD
    hcg = topo.create_hybrid_communicate_group(dp_degree=2)
    net = Linear(4, 2, device="cpu")
    load_state(net, weights)
    st = DistributedStrategy()
    st.localsgd = True
    st.localsgd_configs = {"k_steps": case["k"],
                           "begin_step": case.get("begin", 1)}
    opt = HybridParallelOptimizer(
        SGD(0.1, parameters=net.named_parameters()), hcg=None, strategy=st)

    def loss_fn(out, yy):
        return ((out - yy) ** 2).mean()

    step = TrainStep(net, opt, loss_fn=loss_fn, mesh=hcg.get_mesh())
    rows = []
    for _ in range(case["steps"]):
        loss = float(step(torch.from_numpy(x), torch.from_numpy(y)))
        rows.append(dict(loss=loss, params={k: _np(p) for k, p in
                                            net.named_parameters()}))
    sd = step.state_dict()
    out = dict(rows=rows, localsgd_k=step.localsgd_k,
               state={k: _np(v) for k, v in sd.items() if k != "@opt_state"},
               dp_rank=hcg.get_data_parallel_rank())
    topo._reset_hcg()
    return out


def _fleet_dgc():
    """``fleet.distributed_optimizer`` under ``strategy.dgc``."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW, Momentum
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2}
    st.dgc = True
    st.dgc_configs = {"rampup_begin_step": 5, "sparsity": [0.9]}
    fleet.init(is_collective=True, strategy=st)
    net = nn.Linear(16, 8)
    wrapped = fleet.distributed_optimizer(
        Momentum(0.05, parameters=net.parameters()))
    inner = wrapped._inner_opt
    out = dict(inner=type(inner).__name__, begin=inner._rampup_begin,
               sparsity=inner._sparsity, wrapper=type(wrapped).__name__)
    try:
        fleet.distributed_optimizer(AdamW(1e-3,
                                          parameters=net.parameters()))
    except TypeError as e:
        out["refused"] = str(e)
    topo._reset_hcg()
    return out


def localsgd_rank(rank, cases, weights, x, y):
    _start()
    try:
        out = {c["name"]: _localsgd_case(c, weights, x, y) for c in cases}
        out["fleet_dgc"] = _fleet_dgc()
        return out
    finally:
        dist.destroy_process_group()
