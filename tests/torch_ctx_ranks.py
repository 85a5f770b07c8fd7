"""Rank bodies for the long-context, sequence-parallel and expert-parallel
tests (gloo on the CPU; JAX-free, as ``torch_dist_ranks.py``).

Each body starts the runtime (``torch_dist_ranks._start``), builds the
hybrid topology of its case, runs it on this rank's part of the global
numpy inputs the test process hands it, returns numpy results and tears
the runtime down.
"""

from __future__ import annotations

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.fleet import base_topology as topo
from torch_dist_ranks import JOIN_TIMEOUT_S, _np, _start  # noqa: F401


def _chunk(a, n, r, dim=1):
    return torch.from_numpy(np.ascontiguousarray(
        np.split(a, n, axis=dim)[r])).requires_grad_(True)


# ------------------------------------------------------------- attention
def _gqa_dense(causal, scale):
    """An ``attn_fn`` that takes grouped kv (expanding it itself)."""
    from paddle_tpu_torch.distributed.fleet.utils.ring_flash_attention \
        import _dense_sdpa

    def fn(q, k, v):
        rep = q.shape[2] // k.shape[2]
        return _dense_sdpa(q, k.repeat_interleave(rep, dim=2),
                           v.repeat_interleave(rep, dim=2), causal, scale)
    return fn


def _attention_case(case, x):
    from paddle_tpu_torch.distributed.fleet.utils import (
        sep_scaled_dot_product_attention, ulysses_attention)
    from paddle_tpu_torch.distributed.communication import (
        collective_counts, reset_collective_counts)
    n = dist.get_world_size()
    hcg = topo.create_hybrid_communicate_group(sep_degree=n)
    r = hcg.get_sep_parallel_rank()
    q, k, v = (_chunk(x[name], n, r) for name in "qkv")
    reset_collective_counts()
    if case.get("attn_fn"):
        scale = 1.0 / np.sqrt(q.shape[-1])
        out = ulysses_attention(q, k, v, hcg, case["causal"], scale,
                                attn_fn=_gqa_dense(case["causal"], scale),
                                attn_fn_gqa=True)
    else:
        out = sep_scaled_dot_product_attention(
            q, k, v, hcg, method=case["method"], causal=case["causal"])
    (out * _chunk(x["do"], n, r).detach()).sum().backward()
    res = dict(out=_np(out), dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad),
               counts=collective_counts())
    topo._reset_hcg()
    return res


def attention_rank(rank, cases, inputs):
    """Each case (its global q/k/v/do in ``inputs[name]``) on this rank's
    contiguous sequence chunk."""
    _start()
    try:
        return {c["name"]: _attention_case(c, inputs[c["name"]])
                for c in cases if c["p"] == dist.get_world_size()}
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ sequence parallel
def _sp_ops(n, r, x):
    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as sp
    group = topo.get_hybrid_communicate_group().get_model_parallel_group()
    out = {}
    # replicated x through scatter then gather: loss sum(y^2) on every rank
    a = torch.from_numpy(x["rep"]).requires_grad_(True)
    y = sp.GatherOp.apply(sp.ScatterOp.apply(a, group), group)
    (y ** 2).sum().backward()
    out["roundtrip"], out["roundtrip_grad"] = _np(y), _np(a.grad)
    # my slice all-gathered: loss sum(y) on every rank
    b = _chunk(x["seq"], n, r, 0)
    y = sp.AllGatherOp.apply(b, group)
    y.sum().backward()
    out["allgather"], out["allgather_grad"] = _np(y), _np(b.grad)
    # every rank's whole tensor reduce-scattered, weighted by my slice
    c = torch.from_numpy(x["parts"][r]).requires_grad_(True)
    y = sp.ReduceScatterOp.apply(c, group)
    (y * _chunk(x["w_rs"], n, r, 0).detach()).sum().backward()
    out["reduce_scatter"], out["reduce_scatter_grad"] = _np(y), _np(c.grad)
    return out


def _sp_linears(n, r, w, accumulation_steps):
    """LayerNorm (marked) -> ColumnSequenceParallelLinear ->
    RowSequenceParallelLinear on this rank's sequence slice of ``w['x']``,
    the loss ``sum(out * w['g'])`` over the slice; the marked gradients
    all-reduced by the hooks after ``accumulation_steps`` backward passes
    of the same batch (their sum)."""
    from paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils \
        import (ColumnSequenceParallelLinear, RowSequenceParallelLinear,
                 is_sequence_parallel_parameter,
                 mark_as_sequence_parallel_parameter,
                 register_sequence_parallel_allreduce_hooks)
    from paddle_tpu_torch.nn.layers.common import LayerNorm
    d, f = w["w1"].shape
    ln = LayerNorm(d, device="cpu")
    col = ColumnSequenceParallelLinear(d, f, device="cpu")
    row = RowSequenceParallelLinear(f, d, device="cpu")
    net = torch.nn.ModuleDict(dict(ln=ln, col=col, row=row))
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w["ln_w"]))
        ln.bias.copy_(torch.from_numpy(w["ln_b"]))
        col.weight.copy_(torch.from_numpy(np.split(w["w1"], n, 1)[r]))
        col.bias.copy_(torch.from_numpy(np.split(w["b1"], n)[r]))
        row.weight.copy_(torch.from_numpy(np.split(w["w2"], n, 0)[r]))
        row.bias.copy_(torch.from_numpy(w["b2"]))
    mark_as_sequence_parallel_parameter(ln.weight)
    mark_as_sequence_parallel_parameter(ln.bias)
    handles = register_sequence_parallel_allreduce_hooks(
        net, accumulation_steps)
    x = torch.from_numpy(np.split(w["x"], n, 0)[r])
    g = torch.from_numpy(np.split(w["g"], n, 0)[r])
    local = None
    for i in range(accumulation_steps):
        out = row(col(ln(x)))
        (out * g).sum().backward()
        if i == 0:
            local = _np(ln.weight.grad)
    res = dict(out=_np(out), local_ln_grad=local,
               marked=sorted(k for k, p in net.named_parameters()
                             if is_sequence_parallel_parameter(p)),
               hooks=len(handles),
               grads={k: _np(p.grad) for k, p in net.named_parameters()})
    for h in handles:
        h.remove()
    return res


def sp_rank(rank, inputs):
    """The sequence-parallel ops and linears at mp = the world's size."""
    _start()
    try:
        n = dist.get_world_size()
        hcg = topo.create_hybrid_communicate_group(mp_degree=n)
        r = hcg.get_model_parallel_rank()
        out = dict(ops=_sp_ops(n, r, inputs["ops"]),
                   linears=_sp_linears(n, r, inputs["linears"], 1),
                   accumulated=_sp_linears(n, r, inputs["linears"], 2))
        topo._reset_hcg()
        return out
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ MoE
def _moe_case(case, weights):
    from paddle_tpu_torch.hapi import TrainStep
    from paddle_tpu_torch.models import MoEGPTConfig, MoEGPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    hcg = topo.create_hybrid_communicate_group(dp_degree=case["dp"])
    cfg = MoEGPTConfig.tiny(**case["cfg"])
    model = MoEGPTForCausalLM(cfg, device="cpu")
    model.load_numpy_state(weights)
    clip = case.get("clip")
    opt = AdamW(case["lr"], parameters=model.named_parameters(),
                weight_decay=0.01,
                grad_clip=None if clip is None else ClipGradByGlobalNorm(clip))
    step = TrainStep(model, opt, mesh=hcg.get_mesh(), data_axes=("dp",))
    specs = dict(step._plan.param_specs)
    first = {k: _np(p) for k, p in model.named_parameters()
             if specs.get(k)}
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in case["batches"]]
    out = dict(losses=losses, specs=specs, first=first,
               coords={"dp": hcg.get_data_parallel_rank()},
               experts_here=[b.moe.experts.w1.shape[0] for b in model.h
                             if hasattr(b, "moe")],
               shard={k: _np(p) for k, p in model.named_parameters()})
    topo._reset_hcg()
    return out


def moe_rank(rank, cases, weights):
    """Each case (dp degree, config, batches) trains the tiny MoE-GPT from
    the same whole weights through TrainStep(mesh=...)."""
    _start()
    try:
        return {c["name"]: _moe_case(c, weights[c["weights"]])
                for c in cases if c["dp"] == dist.get_world_size()}
    finally:
        dist.destroy_process_group()
