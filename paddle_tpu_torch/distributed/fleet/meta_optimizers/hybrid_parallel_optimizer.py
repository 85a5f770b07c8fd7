"""HybridParallelOptimizer and HybridParallelGradScaler (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/hybrid_parallel_optimizer.py``).

Under the reference's single controller every gradient is the logical
whole, so its global-norm clip and its loss scaler's found-inf are global
by construction. Here a rank holds the gradients of its shards, so, as in
Paddle:

- the clip (:class:`HybridParallelClipGrad`) sums each gradient's squares
  once over the logical parameters: a tensor-parallel shard
  (``is_distributed``) over the ``mp`` group, a ZeRO slice (stages 2-3:
  the gradient is this rank's slice) over the sharding group, a slice of
  an mp shard over both, and a replicated gradient once, where every rank
  holds the same copy; in a pipeline each stage's sum is then summed over
  the ``pp`` group, a tied weight's copies counted once (``counted``);
  an expert-parallel slice of an MoE's stacked experts (``expert(p)``)
  over its expert group, once;
- in hybrid parallelism (any mode but pure data parallelism, where
  ``DataParallel`` reduces in the backward) ``step`` first averages every
  gradient over the ``dp`` group;
- with a sharding degree above one the optimizer wraps a
  :class:`~.dygraph_sharding_optimizer.DygraphShardingOptimizer`;
- :class:`HybridParallelGradScaler` takes the maximum of found-inf over
  the ``dp``, ``sharding`` and ``mp`` groups, so every rank skips the same
  step.
"""

from __future__ import annotations

import torch

from ....nn.clip import ClipGradByGlobalNorm
from ...communication import collectives as C
from ....amp.grad_scaler import GradScaler
from ...communication.group import ReduceOp
from ..base_topology import try_get_hybrid_communicate_group
from ..meta_parallel.meta_parallel_base import average_gradients
from ..meta_parallel.parallel_layers.mp_layers import is_sharded
from ..meta_parallel.sharding.group_sharded_stage import (
    OptimizerWrapper, unwrap_optimizer)
from .dygraph_sharding_optimizer import DygraphShardingOptimizer


def _live(group) -> bool:
    return group is not None and group.nranks > 1


class HybridParallelClipGrad:
    """A global-norm clip over sharded and replicated gradients.
    ``sliced(p)`` says whether ``p``'s gradient is this rank's ZeRO slice
    over ``sharding_group``. A pipeline stage's sum is summed over
    ``pp_group``, of the parameters ``counted(p)`` (default: all). The
    gradients of ``expert(p)`` parameters, slices of stacked experts, are
    summed over ``expert_group``. With one rank in each group it is
    ``clip`` itself."""

    def __init__(self, clip: ClipGradByGlobalNorm, mp_group,
                 sharding_group=None, sliced=None, pp_group=None,
                 counted=None, expert_group=None, expert=None):
        self._clip = clip
        self.clip_norm = clip.clip_norm
        self._mp = mp_group if _live(mp_group) else None
        self._sharding = (sharding_group if _live(sharding_group)
                          and sliced is not None else None)
        self._sliced = sliced
        self._pp = pp_group if _live(pp_group) else None
        self._counted = counted
        self._experts = expert_group if _live(expert_group) else None
        self._expert = expert

    def _plain(self) -> bool:
        return (self._mp is None and self._sharding is None
                and self._pp is None and self._counted is None
                and self._experts is None)

    def global_norm_sq(self, params_grads) -> torch.Tensor:
        """The squared norm of the logical parameters' gradients (f32)."""
        params_grads = list(params_grads)
        if self._plain():
            return self._clip.global_norm_sq(g for _, g in params_grads)
        dev = next(g.device for _, g in params_grads if g is not None)
        if self._counted is not None:
            params_grads = [(p, g) for p, g in params_grads
                            if self._counted(p)]
        experts = None
        if self._experts is not None:
            experts = self._clip.global_norm_sq(
                g for p, g in params_grads if self._expert(p)).to(dev)
            C.all_reduce(experts, group=self._experts)
            params_grads = [(p, g) for p, g in params_grads
                            if not self._expert(p)]

        def part(over_mp, over_sharding):
            return self._clip.global_norm_sq(
                g for p, g in params_grads
                if (self._mp is not None and is_sharded(p)) == over_mp
                and (self._sharding is not None
                     and self._sliced(p)) == over_sharding).to(dev)

        total, over_mp = part(False, False), part(True, False)
        if self._sharding is not None:
            sliced = torch.stack([part(True, True), part(False, True)])
            C.all_reduce(sliced, group=self._sharding)
            total, over_mp = total + sliced[1], over_mp + sliced[0]
        if self._mp is not None:
            C.all_reduce(over_mp, group=self._mp)
        total = total + over_mp
        if experts is not None:
            total = total + experts
        if self._pp is not None:
            C.all_reduce(total, group=self._pp)
        return total

    def __call__(self, params_grads):
        if self._plain():
            return self._clip(params_grads)
        total = self.global_norm_sq(params_grads)
        scale = self.clip_norm / torch.clamp(torch.sqrt(total),
                                             min=self.clip_norm)
        return [(p, None if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


def hybrid_clip(optimizer, mp_group, sharding_group=None,
                sliced=None, pp_group=None, counted=None,
                expert_group=None, expert=None) -> None:
    """Give ``optimizer`` the hybrid global-norm clip over ``mp_group``
    (and ZeRO's ``sharding_group``, a pipeline's ``pp_group`` and the
    expert slices' ``expert_group``); a hybrid clip already there is
    rebuilt over these groups, another clip stays as it is."""
    clip = optimizer._grad_clip
    if isinstance(clip, HybridParallelClipGrad):
        clip = clip._clip
    if isinstance(clip, ClipGradByGlobalNorm):
        optimizer._grad_clip = HybridParallelClipGrad(
            clip, mp_group, sharding_group, sliced, pp_group, counted,
            expert_group, expert)


class HybridParallelOptimizer(OptimizerWrapper):
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._hcg = hcg or try_get_hybrid_communicate_group()
        self._strategy = strategy
        if self._hcg is not None \
                and self._hcg.get_sharding_parallel_world_size() > 1 \
                and not isinstance(optimizer, DygraphShardingOptimizer):
            optimizer = DygraphShardingOptimizer(optimizer, self._hcg)
        super().__init__(optimizer)
        self._dp_group = None
        if self._hcg is not None:
            hybrid_clip(unwrap_optimizer(optimizer),
                        self._hcg.get_model_parallel_group())
            if self._hcg.get_parallel_mode() != "DATA_PARALLEL" \
                    and self._hcg.get_data_parallel_world_size() > 1:
                self._dp_group = self._hcg.get_data_parallel_group()

    def step(self):
        if self._dp_group is not None:
            average_gradients(self._inner_opt._params(), self._dp_group)
        return self._inner_opt.step()


class HybridParallelGradScaler(GradScaler):
    """A :class:`~....amp.GradScaler` (``scaler``'s state, or one built
    from ``**kw``) whose found-inf is the maximum over the topology's
    ``dp``, ``sharding`` and ``mp`` groups: a rank that holds only slices
    or shards of the gradients sees only their infs, and the ranks must
    skip the same steps."""

    def __init__(self, scaler=None, hcg=None, **kw):
        if isinstance(scaler, GradScaler):
            self.__dict__.update(scaler.__dict__)
        else:
            super().__init__(**kw)
        self._hcg = hcg or try_get_hybrid_communicate_group()

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        super().unscale_(optimizer)
        if not self._enable or self._hcg is None:
            return
        hcg = self._hcg
        groups = [g for g in (hcg.get_data_parallel_group(),
                              hcg.get_sharding_parallel_group(),
                              hcg.get_model_parallel_group()) if _live(g)]
        if not groups:
            return
        dev = next((g.device for _, g in optimizer._params_grads()),
                   torch.device("cpu"))
        found = torch.tensor([float(self._found_inf)], device=dev)
        for g in groups:
            C.all_reduce(found, op=ReduceOp.MAX, group=g)
        self._found_inf = bool(found.item())
