"""Rank bodies for the port's multi-process tests (gloo on the CPU).

``paddle_tpu_torch.distributed.spawn`` starts each rank in a fresh
interpreter that imports this module (it imports neither JAX nor the JAX
package, so a rank starts in a few seconds). Every body starts the gloo
runtime with a short timeout, runs its cases, returns numpy results to the
test process and tears the runtime down.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.convert import load_state, shard_state
from paddle_tpu_torch.distributed.fleet import base_topology as topo

# a rank that never arrives fails its peers' calls after this long
GROUP_TIMEOUT_S = 60
# the test process gives up on its ranks after this long
JOIN_TIMEOUT_S = 240


def _start():
    torch.set_num_threads(1)
    dist.init_parallel_env(
        backend="gloo", device="cpu",
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _np(t):
    return t.detach().cpu().numpy().copy()


# --------------------------------------------------------------- hybrid
def _train_case(case, weights):
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.io import DistributedBatchSampler
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.llama import annotate_llama_tp
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as tlr

    hcg = topo.create_hybrid_communicate_group(dp_degree=case["dp"],
                                               mp_degree=case["mp"])
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    annotate_llama_tp(model)
    lr = case["lr"]
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(lr, T_max=10), 2,
                             lr / 10, lr)
    opt = AdamW(sched, parameters=model.named_parameters(),
                weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(case["clip"]))
    step = TrainStep(model, opt, mesh=hcg.get_mesh(), data_axes=("dp",))
    coords = {"dp": hcg.get_data_parallel_rank(),
              "mp": hcg.get_model_parallel_rank()}
    sizes = {"dp": case["dp"], "mp": case["mp"]}
    specs = {k: getattr(p, "dist_attr", None)
             for k, p in model.named_parameters()}
    load_state(model, shard_state(weights, specs, coords, sizes))
    heads = (model.llama.layers[0].self_attn.num_heads,
             model.llama.layers[0].self_attn.num_kv_heads)
    # the first batch's gradient norm over the logical parameters: the
    # clip binds when it exceeds case["clip"]
    x0, y0 = (torch.from_numpy(a) for a in case["batches"][0])
    step.compute_loss_grads(*step.stage(x0, y0).vals)
    norm = float(opt._grad_clip.global_norm_sq(
        [(p, p.grad) for p in opt._params()]).sqrt())
    opt.clear_grad()
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in case["batches"]]
    sampler = DistributedBatchSampler(list(range(10)), batch_size=2)
    out = dict(losses=losses, coords=coords, heads=heads, specs=specs,
               norm=norm,
               shard={k: _np(p) for k, p in model.named_parameters()},
               sampler=(sampler.nranks, sampler.local_rank, list(sampler)))
    topo._reset_hcg()
    return out


def _fleet_checks(rank, degrees):
    """fleet's wrappers at each (dp, mp) of ``degrees``: pure data
    parallelism gives a DataParallel that broadcasts rank 0's parameters
    when built and averages gradients in the backward (not under
    ``no_sync``); mp > 1 a TensorParallel, whose HybridParallelOptimizer
    averages the gradients over dp in ``step``."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD
    out = {}
    for dp, mp in degrees:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
        fleet.init(is_collective=True, strategy=strategy)
        net = torch.nn.Linear(4, 2, bias=False)
        with torch.no_grad():
            net.weight.fill_(float(rank + 1))
        model = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(SGD(0.1, parameters=[net.weight]))
        x = torch.full((3, 4), float(rank + 1))
        model(x).sum().backward()
        synced = _np(net.weight.grad)
        opt.step()
        stepped = _np(net.weight)
        opt.clear_grad()
        local = None
        if hasattr(model, "no_sync"):
            with model.no_sync():
                model(x).sum().backward()
            local = _np(net.weight.grad)
        out[(dp, mp)] = dict(
            wrapper=type(model).__name__, optimizer=type(opt).__name__,
            mode=fleet.get_hybrid_communicate_group().get_parallel_mode(),
            synced=synced, stepped=stepped, local=local)
        topo._reset_hcg()
    return out


def hybrid_rank(rank, cases, weights):
    """Each case trains the tiny Llama at its (dp, mp) from the same
    whole weights, cut to this rank's shards; then fleet's wrappers."""
    _start()
    try:
        out = {c["name"]: _train_case(c, weights) for c in cases}
        degrees = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
        out["fleet"] = _fleet_checks(rank, degrees[dist.get_world_size()])
        return out
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------- communication
def comm_rank(rank, x):
    """Every collective of the reference's ``tests/test_communication.py``
    on rank ``rank``'s slice of the stacked inputs ``x`` (name -> array
    with the world's size first); returns name -> this rank's result."""
    _start()
    n = dist.get_world_size()
    t = {k: torch.from_numpy(v[rank].copy()) for k, v in x.items()}
    out = {}
    try:
        for name in ("sum", "max", "min", "avg", "prod"):
            op = getattr(dist.ReduceOp, name.upper())
            v = t["vals"].clone()
            dist.all_reduce(v, op=op)
            out[f"all_reduce_{name}"] = _np(v)
        v = t["signed"].clone()
        dist.all_reduce(v, op=dist.ReduceOp.PROD)
        out["all_reduce_prod_signed"] = _np(v)
        sub = dist.new_group([1, 3])
        v = t["vals"].clone()
        task = dist.all_reduce(v, group=sub, sync_op=False)
        task.wait()
        out["all_reduce_subgroup"] = _np(v)
        v = t["vals"].clone()
        dist.broadcast(v, src=3)
        out["broadcast"] = _np(v)
        v = t["vals"].clone()
        dist.reduce(v, dst=2)
        out["reduce"] = _np(v)
        got = []
        dist.all_gather(got, t["vals"])
        out["all_gather"] = np.stack([_np(g) for g in got])
        v = torch.zeros(3)
        dist.scatter(v, [torch.from_numpy(c) for c in x["chunks"]]
                     if rank == 0 else None, src=0)
        out["scatter"] = _np(v)
        v = torch.zeros(4)
        dist.reduce_scatter(v, [t[f"rs{j}"] for j in range(n)])
        out["reduce_scatter"] = _np(v)
        got = []
        dist.alltoall(got, [t[f"a2a{j}"] for j in range(n)])
        out["alltoall"] = np.stack([_np(g) for g in got])
        v = torch.zeros(n)
        dist.alltoall_single(v, t["a2a_single"])
        out["alltoall_single"] = _np(v)
        # uneven splits: rank r sends r + 1 rows to every rank
        ins = torch.arange(n * (rank + 1), dtype=torch.float32) + 100 * rank
        v = torch.zeros(sum(j + 1 for j in range(n)))
        dist.alltoall_single(v, ins, [rank + 1] * n,
                             [j + 1 for j in range(n)])
        out["alltoall_single_uneven"] = _np(v)
        got = []
        dist.gather(t["vals"], got if rank == 0 else None, dst=0)
        out["gather"] = np.stack([_np(g) for g in got]) if got else None
        # p2p: rank 2 to rank 1, then a ring through batch_isend_irecv
        v = torch.zeros(4)
        if rank == 2:
            dist.send(torch.arange(4.0), dst=1)
        elif rank == 1:
            dist.recv(v, src=2)
        out["send_recv"] = _np(v)
        v = torch.zeros(2)
        tasks = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, torch.full((2,), float(rank)),
                       (rank + 1) % n),
            dist.P2POp(dist.irecv, v, (rank - 1) % n)])
        for tk in tasks:
            tk.wait()
        out["ring"] = _np(v)
        dist.barrier()
        dist.wait(t["vals"])
        objs = []
        dist.all_gather_object(objs, {"rank": rank})
        out["all_gather_object"] = objs
        got = []
        dist.scatter_object_list(got, [f"obj{j}" for j in range(n)]
                                 if rank == 0 else None, src=0)
        out["scatter_object_list"] = got
        g = dist.new_group([0, 2])
        out["group_api"] = (g.nranks, g.world_size, g.rank,
                            g.get_group_rank(2), g.get_group_rank(3),
                            dist.get_group(g.id) is g, dist.get_backend())
        errors = []
        for call in (lambda: dist.scatter(torch.zeros(2), None, src=0,
                                          group=sub),
                     lambda: dist.reduce(torch.zeros(2), dst=2, group=sub),
                     lambda: dist.send(torch.zeros(2), dst=0, group=sub)):
            try:
                call()
            except ValueError as e:
                errors.append(str(e))
        out["errors"] = errors
        dist.destroy_process_group(g)
        try:
            dist.get_group(g.id)
        except ValueError:
            out["destroyed"] = True
        out["counts"] = dist.collective_counts()
        return out
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ mp layers
def _leaf(a):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(True)


def _mp_case(x, mp):
    from paddle_tpu_torch.distributed.fleet import meta_parallel as M
    from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_ops
    hcg = topo.create_hybrid_communicate_group(dp_degree=4 // mp,
                                               mp_degree=mp)
    g = hcg.get_model_parallel_group()
    r = hcg.get_model_parallel_rank()

    def mine(a, axis):
        return np.array_split(a, mp, axis=axis)[r]

    out = {"mp_rank": r}
    for gather in (True, False):
        col = M.ColumnParallelLinear(16, 32, gather_output=gather,
                                     device="cpu")
        with torch.no_grad():
            col.weight.copy_(torch.from_numpy(mine(x["col_w"], 1)))
            col.bias.copy_(torch.from_numpy(mine(x["col_b"], 0)))
        xin = _leaf(x["col_x"])
        y = col(xin)
        cot = x["col_cot"] if gather else mine(x["col_cot"], -1)
        (y * torch.from_numpy(cot)).sum().backward()
        out[f"col{gather}"] = (_np(y), _np(xin.grad), _np(col.weight.grad),
                               _np(col.bias.grad))
    for parallel in (False, True):
        row = M.RowParallelLinear(32, 16, input_is_parallel=parallel,
                                  device="cpu")
        with torch.no_grad():
            row.weight.copy_(torch.from_numpy(mine(x["row_w"], 0)))
            row.bias.copy_(torch.from_numpy(x["row_b"]))
        xin = _leaf(mine(x["row_x"], -1) if parallel else x["row_x"])
        y = row(xin)
        (y * torch.from_numpy(x["row_cot"])).sum().backward()
        out[f"row{parallel}"] = (_np(y), _np(xin.grad), _np(row.weight.grad),
                                 _np(row.bias.grad))
    emb = M.VocabParallelEmbedding(64, 16, device="cpu")
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(mine(x["emb_w"], 0)))
    y = emb(torch.from_numpy(x["ids"]))
    (y * torch.from_numpy(x["emb_cot"])).sum().backward()
    out["emb"] = (_np(y), _np(emb.weight.grad))
    logits = _leaf(mine(x["logits"], -1))
    loss = M.ParallelCrossEntropy()(logits, torch.from_numpy(x["labels"]))
    loss.backward(torch.from_numpy(x["ce_cot"]))
    out["ce"] = (_np(loss), _np(logits.grad))
    # the mp_ops pairs: values and gradients of sum(f(...) ** 2)
    xin, w = _leaf(x["pm_x"]), _leaf(mine(x["pm_w"], 1))
    y = mp_ops._parallel_matmul(xin, w, g, gather_output=True)
    (y ** 2).sum().backward()
    out["parallel_matmul"] = (_np(y), _np(xin.grad), _np(w.grad))
    table = _leaf(mine(x["emb_w"], 0))
    y = mp_ops._parallel_embedding(torch.from_numpy(x["ids"]), table, g)
    (y ** 2).sum().backward()
    out["parallel_embedding"] = (_np(y), _np(table.grad))
    # split then concat is the identity, value and gradient; so is
    # reduce-scatter of the ranks' copies over the ranks, then gather
    xin = _leaf(x["seq"])
    y = mp_ops._c_concat(mp_ops._c_split(xin, g, -1), g, -1)
    (y * torch.from_numpy(x["seq"])).sum().backward()
    out["split_concat"] = (_np(y), _np(xin.grad))
    xin = _leaf(x["seq"])
    y = mp_ops._all_gather(mp_ops._reduce_scatter(xin, g, 0), g, 0)
    (y * torch.from_numpy(x["seq"])).sum().backward()
    out["scatter_gather"] = (_np(y), _np(xin.grad))
    xin = _leaf(x["seq"])
    y = mp_ops._mp_allreduce(mp_ops._c_identity(xin, g), g)
    y.sum().backward()
    out["identity_allreduce"] = (_np(y), _np(xin.grad))
    topo._reset_hcg()
    return out


def mp_layers_rank(rank, x):
    """The Megatron layers and the mp_ops pairs at mp = 2 (dp = 2) and
    mp = 4 on a world of 4."""
    _start()
    try:
        return {mp: _mp_case(x, mp) for mp in (2, 4)}
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------- spawn
def failing_rank(rank, bad):
    """Rank ``bad`` raises; the others return their rank."""
    if rank == bad:
        raise ValueError(f"rank {rank} was told to fail")
    return rank


def sleeping_rank(rank, seconds):
    import time
    time.sleep(seconds)
    return rank


def rank_zero_last(rank, seconds):
    """Rank 0 returns ``seconds`` after the others."""
    import time
    if rank == 0:
        time.sleep(seconds)
    return rank
