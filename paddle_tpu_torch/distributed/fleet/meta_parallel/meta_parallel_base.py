"""The model wrappers ``fleet.distributed_model`` returns (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/meta_parallel_base.py``).

The reference's wrappers carry no runtime work: GSPMD sums the gradients
of a jitted step whose batch is sharded over ``dp``. Here each rank runs
its own backward, so the wrappers do what Paddle's do:

- every wrapper broadcasts the parameters from the first rank of the data
  parallel group when it is built (and :class:`TensorParallel` the
  replicated ones from the first rank of the ``mp`` group), so the
  replicas start equal;
- :class:`DataParallel` averages each gradient over its group as the
  backward produces it (a hook on the parameter); ``no_sync()`` really
  skips the reduction, for gradient accumulation.

In hybrid parallelism (``mp`` > 1) the data-parallel reduction is the
optimizer's (:class:`~..meta_optimizers.HybridParallelOptimizer`), as in
Paddle.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ...communication import collectives as C
from ...communication.group import Group, _world_group
from .parallel_layers.mp_layers import is_sharded


def _broadcast_params(module: nn.Module, group: Group, only=None) -> None:
    if group is None or group.process_group is None:
        return
    with torch.no_grad():
        for p in module.parameters():
            if only is None or only(p):
                C.broadcast(p.data, group.ranks[0], group)


def average_gradients(params, group: Group) -> None:
    """Each parameter's gradient averaged over ``group`` (all-reduced, then
    divided by its size)."""
    for p in params:
        if p.grad is not None:
            C.all_reduce(p.grad, group=group)
            p.grad.div_(group.nranks)


class MetaParallelBase(nn.Module):
    def __init__(self, layers: nn.Module, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)

    load_state_dict = set_state_dict


class TensorParallel(MetaParallelBase):
    """``mp_degree`` > 1: the parameters broadcast over ``dp``, the
    replicated ones (``is_distributed`` false) also over ``mp``."""

    def _prepare_for_model(self):
        self._layers._is_tensor_parallel = True
        if self._hcg is not None:
            _broadcast_params(self._layers,
                              self._hcg.get_data_parallel_group())
            _broadcast_params(
                self._layers, self._hcg.get_model_parallel_group(),
                lambda p: not is_sharded(p))


class ShardingParallel(MetaParallelBase):
    def _prepare_for_model(self):
        self._layers._is_sharding_parallel = True


class DataParallel(MetaParallelBase):
    """Data parallelism (reference: ``paddle.DataParallel``): each
    gradient is averaged over ``group`` (default: the topology's ``dp``
    group, else the world) as the backward accumulates it.
    ``comm_buffer_size``, ``last_comm_buffer_size`` and
    ``find_unused_parameters`` are taken and change nothing (the reduction
    is one all-reduce a parameter)."""

    def __init__(self, layers: nn.Module, hcg=None, strategy=None,
                 comm_buffer_size: int = 25, last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False, group=None):
        if group is None:
            group = (hcg.get_data_parallel_group() if hcg is not None
                     else _world_group())
        self._group = group
        self._sync = True
        super().__init__(layers, hcg, strategy)

    def _prepare_for_model(self):
        self._layers._is_data_parallel = True
        _broadcast_params(self._layers, self._group)
        for p in self._layers.parameters():
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(self._reduce)

    def _reduce(self, p: torch.Tensor) -> None:
        if self._sync:
            average_gradients([p], self._group)

    def scale_loss(self, loss):
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        """Gradients accumulate locally, unreduced, for the duration."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev
