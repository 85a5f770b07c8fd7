"""``group_sharded_parallel`` / ``save_group_sharded_model`` (counterpart of
``paddle_tpu/distributed/sharding/group_sharded.py``).

``group_sharded_parallel`` wraps the model and the optimizer for level
``"os"`` (stage 1), ``"os_g"`` (stage 2) or ``"p_g_os"`` (stage 3), as the
reference does; ``TrainStep(mesh=...)`` over the result runs the ZeRO plan
(``fleet/meta_parallel/sharding/zero.py``). ``offload=True`` is refused by
design (the reference accepts and ignores it).

``save_group_sharded_model`` gathers the whole ``state_dict`` (stage-3
slices over the sharding group, tensor-parallel shards over ``mp``) and the
optimizer's, its slots and masters gathered the same way, and rank 0 alone
writes ``model.pdmodel`` / ``model.pdopt`` into the ``output`` directory
through ``framework.io.save``. Every rank must call it: the gathers are
collective.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
import torch.distributed as dist

from ..fleet.base_topology import try_get_hybrid_communicate_group
from ..fleet.meta_parallel.parallel_layers.mp_layers import is_sharded
from ..fleet.meta_parallel.sharding import (
    LEVEL_TO_STAGE, GroupShardedOptimizerStage2, GroupShardedStage2,
    GroupShardedStage3,
)
from ..fleet.meta_parallel.sharding.group_sharded_stage import \
    unwrap_optimizer
from ..fleet.meta_parallel.sharding.zero import all_gather_along


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size: int = 2 ** 23,
                           segment_size: int = 2 ** 20,
                           sync_comm: bool = False, dp_group=None,
                           exclude_layer=None):
    """``(model, optimizer, scaler)`` wrapped for ZeRO ``level``."""
    if level not in LEVEL_TO_STAGE:
        raise ValueError(
            f"level must be one of {sorted(LEVEL_TO_STAGE)}, got {level!r}")
    stage = LEVEL_TO_STAGE[level]
    if stage == 1:
        optimizer = GroupShardedOptimizerStage2(
            params=list(model.parameters()), optim=optimizer, group=group,
            offload=offload)
        return model, optimizer, scaler
    if stage == 2:
        optimizer = GroupShardedOptimizerStage2(
            params=list(model.parameters()), optim=optimizer, group=group,
            offload=offload)
        model = GroupShardedStage2(
            model, sharding_optimizer=optimizer, group=group,
            sync_buffers=sync_buffers, buffer_max_size=buffer_max_size,
            dp_group=dp_group)
        return model, optimizer, scaler
    model = GroupShardedStage3(
        model, optimizer=optimizer, group=group, sync_buffers=sync_buffers,
        segment_size=segment_size, offload=offload, sync_comm=sync_comm,
        dp_group=dp_group, exclude_layer=exclude_layer)
    return model, optimizer, scaler


def unwrap_model(model):
    """The model inside the sharding and fleet wrappers."""
    while True:
        inner = model._modules.get("_layer") or model._modules.get("_layers")
        if inner is None:
            return model
        model = inner


def _whole(t: torch.Tensor, p, plan, mp) -> torch.Tensor:
    """``t`` (of parameter ``p``) with the sharding cut and the
    tensor-parallel cut undone."""
    if plan is not None:
        t = plan.whole(t, p)
    if mp is not None and mp.nranks > 1 and is_sharded(p) and t.dim():
        t = all_gather_along(t, p.split_axis, mp)
    return t


def _mp_group(plan):
    if plan is not None:
        return plan.mp_group
    hcg = try_get_hybrid_communicate_group()
    return None if hcg is None else hcg.get_model_parallel_group()


@torch.no_grad()
def whole_parameters(model) -> Dict[str, torch.Tensor]:
    """``{name: whole parameter}`` of ``model`` (collective)."""
    target = unwrap_model(model)
    plan = getattr(target, "_zero_plan", None)
    mp = _mp_group(plan)
    return {k: _whole(p.detach(), p, plan, mp)
            for k, p in target.named_parameters()}


@torch.no_grad()
def save_group_sharded_model(model, output: str, optimizer=None) -> None:
    """Gather the whole model (and ``optimizer``) state; rank 0 writes
    ``output/model.pdmodel`` (and ``output/model.pdopt``)."""
    from ...framework.io import save
    target = unwrap_model(model)
    plan = getattr(target, "_zero_plan", None)
    mp = _mp_group(plan)
    params = dict(target.named_parameters())
    state = {k: (_whole(v, params[k], plan, mp) if k in params else v)
             for k, v in target.state_dict().items()}
    opt_state = None
    if optimizer is not None:
        inner = unwrap_optimizer(optimizer)
        opt_state = inner.state_dict()
        for p in inner._params():
            name = inner._names[p]
            for key, t in inner.state.get(p, {}).items():
                out = (f"{name}_fp32_master_0" if key == "master"
                       else f"{name}_{key}_0")
                opt_state[out] = _whole(t, p, plan, mp)
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(output, exist_ok=True)
    save(state, os.path.join(output, "model.pdmodel"))
    if opt_state is not None:
        save(opt_state, os.path.join(output, "model.pdopt"))
