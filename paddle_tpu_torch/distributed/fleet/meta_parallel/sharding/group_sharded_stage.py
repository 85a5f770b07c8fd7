"""The GroupSharded stage 2 and 3 wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding/group_sharded_stage.py``).

As in the reference they stamp ``_group_sharded_level`` and
``_sharding_axis`` on the model and the optimizer, and
:class:`GroupShardedStage3` records ``exclude_layer``'s parameters; the
work is ``TrainStep(mesh=...)``'s ZeRO plan (``zero.py``). Their forwards
pass through. Their eager ``step`` outside a ``TrainStep`` averages the
gradients over the sharding group first (under a plan, the plan reduces
them), so the ranks stay equal and take the data mean; the whole
parameters update on every rank.

``offload=True`` is refused by design: the reference accepts it and
ignores it ("advisory").
"""

from __future__ import annotations

from torch import nn

from ...base_topology import try_get_hybrid_communicate_group
from ..meta_parallel_base import average_gradients
from .group_sharded_utils import resolve_sharding_axis


def unwrap_optimizer(optimizer):
    """The optimizer inside the fleet and sharding wrappers."""
    while isinstance(optimizer, OptimizerWrapper):
        optimizer = optimizer._inner_opt
    return optimizer


class OptimizerWrapper:
    """What the fleet and sharding optimizer wrappers share: the wrapped
    ``_inner_opt``, every attribute and ``clear_grad`` / ``state_dict`` /
    ``set_state_dict`` read through to it. With ``axis`` the innermost
    optimizer is stamped with stage 1 at least and the sharding axis, as
    the reference's stage-1 wrappers do. Subclasses override ``step``."""

    def __init__(self, optimizer, axis=None):
        self._inner_opt = optimizer
        if axis is not None:
            inner = unwrap_optimizer(optimizer)
            inner._group_sharded_level = max(
                getattr(inner, "_group_sharded_level", 0), 1)
            inner._sharding_axis = axis

    def __getattr__(self, item):
        try:
            return getattr(self.__dict__["_inner_opt"], item)
        except KeyError:
            raise AttributeError(item) from None

    def step(self):
        return self._inner_opt.step()

    def clear_grad(self, *a, **k):
        return self._inner_opt.clear_grad(*a, **k)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)


def hcg_axis(hcg):
    """The ZeRO axis of ``hcg``'s topology (None without one)."""
    if hcg is None:
        return None
    return resolve_sharding_axis({
        "dp": hcg.get_data_parallel_world_size(),
        "sharding": hcg.get_sharding_parallel_world_size()})


def axis_group(hcg, axis):
    """``hcg``'s group along ``axis`` (``sharding`` or ``dp``)."""
    if hcg is None or axis is None:
        return None
    return (hcg.get_sharding_parallel_group() if axis == "sharding"
            else hcg.get_data_parallel_group())


def eager_step(optimizer, group):
    """An eager step of a sharded optimizer: under a TrainStep's ZeRO plan
    the plan reduces the gradients; else each is averaged over ``group``
    (when it has more than one rank). Then the inner optimizer steps."""
    inner = unwrap_optimizer(optimizer)
    if inner._zero is not None:
        inner._zero.reduce_grads(inner._params())
    elif group is not None and group.nranks > 1:
        average_gradients(inner._params(), group)
    return inner.step()


def _refuse_offload(offload: bool) -> None:
    if offload:
        raise NotImplementedError(
            "group sharding's offload=True is refused by design: the "
            "reference accepts it and ignores it (ROADMAP Queue 3)")


def _sharding_axis_for(group) -> str:
    """The mesh axis ``group`` runs along (its ``axis_name``), else the
    topology's ZeRO axis, else ``sharding``."""
    axis = getattr(group, "axis_name", None)
    if axis:
        return axis
    return hcg_axis(try_get_hybrid_communicate_group()) or "sharding"


def _stamp(optimizers, level: int, axis: str) -> None:
    for o in (optimizers if isinstance(optimizers, (list, tuple))
              else [optimizers]):
        inner = unwrap_optimizer(o)
        inner._group_sharded_level = level
        inner._sharding_axis = axis


def _eager_group(group, axis):
    return group if group is not None else axis_group(
        try_get_hybrid_communicate_group(), axis)


class GroupShardedOptimizerStage2(OptimizerWrapper):
    """The optimizer wrapper of stages 1 and 2 (reference: the owner of
    the optimizer state's shard): stamps stage 1 on ``optim`` and
    delegates the rest."""

    def __init__(self, params, optim, group=None, offload=False,
                 device="gpu", **kw):
        _refuse_offload(offload)
        super().__init__(optim, _sharding_axis_for(group))
        self._group = group
        self.offload = offload

    def step(self):
        inner = unwrap_optimizer(self._inner_opt)
        return eager_step(self._inner_opt,
                          _eager_group(self._group, inner._sharding_axis))


class _GroupSharded(nn.Module):
    """What both model wrappers share: the wrapped ``_layer``, the forward
    passed through, attributes read through to the layer."""

    def __init__(self, layer: nn.Module, group, level: int, optimizers):
        super().__init__()
        self._layer = layer
        self._group = group
        self._group_sharded_level = level
        self._sharding_axis = _sharding_axis_for(group)
        if optimizers is not None:
            _stamp(optimizers, level, self._sharding_axis)

    def forward(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def __getattr__(self, item):
        try:
            return super().__getattr__(item)
        except AttributeError:
            return getattr(self._modules["_layer"], item)


class GroupShardedStage2(_GroupSharded):
    """Stage 2: gradients and optimizer state sharded."""

    def __init__(self, layer: nn.Module, sharding_optimizer=None,
                 group=None, sync_buffers: bool = False,
                 buffer_max_size: int = 2 ** 23,
                 auto_refresh_trainable: bool = True, device: str = "gpu",
                 dp_group=None):
        super().__init__(layer, group, 2, sharding_optimizer)


class GroupShardedStage3(_GroupSharded):
    """Stage 3: the parameters sharded too; ``exclude_layer``'s parameters
    stay whole (their optimizer state and gradients are still sharded, as
    in the reference)."""

    def __init__(self, layer: nn.Module, optimizer=None, group=None,
                 sync_buffers: bool = False, device: str = "gpu",
                 segment_size: int = 2 ** 20,
                 pertrain_sync_models: bool = True, offload: bool = False,
                 sync_comm: bool = False, dp_group=None, exclude_layer=None):
        _refuse_offload(offload)
        super().__init__(layer, group, 3, optimizer)
        self.offload = offload
        self._sharding_exclude_ids = {
            id(p) for m in (exclude_layer or ()) for p in m.parameters()}

    def get_all_parameters(self, convert2cpu: bool = False):
        """Every parameter of the layer whole: under a stage-3 plan the
        slices gathered over the sharding group (collective), a
        tensor-parallel shard gathered over ``mp``."""
        from ....sharding.group_sharded import whole_parameters
        out = list(whole_parameters(self._layer).values())
        return [t.cpu() for t in out] if convert2cpu else out
