"""Megatron sequence parallelism (counterpart of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``).

Dim 0 is the sequence (the reference's ``[s, b, h]`` layout in the
sequence-parallel regions); the group defaults to the hybrid topology's
``mp`` group. Each op is one of ``mp_ops``' autograd pairs, chosen by the
reference's gradients under per-rank autodiff, where every rank holds the
whole cotangent of a replicated value (Paddle's own convention):

  scatter / ScatterOp             fwd: keep my slice   bwd: all-gather
  gather / GatherOp               fwd: all-gather      bwd: keep my slice
  all_gather / AllGatherOp        fwd: all-gather      bwd: reduce-scatter
  reduce_scatter / ReduceScatterOp fwd: reduce-scatter bwd: all-gather

(``gather(scatter(x))`` then gives the reference's roundtrip gradient 2x
of ``sum(y ** 2)``, and ``all_gather`` the gradient P of ``sum``: the
JAX package takes the reduce-scatter adjoint for ``gather`` under
``shard_map``'s global-cotangent semantics, which lands on the same
numbers.)

The linears are real here, where the reference's are GSPMD annotations:
:class:`ColumnSequenceParallelLinear` all-gathers its sequence-sharded
input and leaves its output sharded over the output features;
:class:`RowSequenceParallelLinear` reduce-scatters its partial products
over the sequence and then adds its bias, which it marks as a
sequence-parallel parameter.

:func:`register_sequence_parallel_allreduce_hooks` is real too: the
reference's is a no-op because its gradients are already global, but a
rank here differentiates only its sequence shard, so every marked
parameter's gradient is all-reduced over the mp group once every
``accumulation_steps`` backward passes.
"""

from __future__ import annotations

import torch

from ...communication import collectives as C
from ..layers.mpu import mp_ops
from ..meta_parallel.parallel_layers.mp_layers import (
    ColumnParallelLinear, RowParallelLinear)
from ....amp.auto_cast import amp_cast


def scatter(x, group=None):
    """This rank's slice of the sequence (backward: all-gather)."""
    return mp_ops._c_split(x, group, 0)


def gather(x, group=None):
    """The ranks' sequence slices concatenated (backward: my slice)."""
    return mp_ops._c_concat(x, group, 0)


def all_gather(x, group=None):
    """The ranks' sequence slices concatenated (backward:
    reduce-scatter)."""
    return mp_ops._all_gather(x, group, 0)


def reduce_scatter(x, group=None):
    """The ranks' tensors summed, my sequence slice kept (backward:
    all-gather)."""
    return mp_ops._reduce_scatter(x, group, 0)


class ScatterOp:
    apply = staticmethod(scatter)


class GatherOp:
    apply = staticmethod(gather)


class AllGatherOp:
    apply = staticmethod(all_gather)


class ReduceScatterOp:
    apply = staticmethod(reduce_scatter)


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A column-parallel linear whose input arrives sequence-sharded: the
    input is all-gathered over the sequence, the output stays sharded over
    the output features."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, **kw):
        if gather_output:
            raise ValueError("ColumnSequenceParallelLinear: gather_output "
                             "must be False")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         False, fuse_matmul_bias, mp_group, name, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = all_gather(x, self.mp_group)
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        y = x @ w
        return y if b is None else y + b


class RowSequenceParallelLinear(RowParallelLinear):
    """A row-parallel linear whose output leaves sequence-sharded: the
    partial products are reduce-scattered over the sequence instead of
    all-reduced, then the bias (a sequence-parallel parameter) added."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, **kw):
        if not input_is_parallel:
            raise ValueError("RowSequenceParallelLinear: input_is_parallel "
                             "must be True")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         True, fuse_matmul_bias, mp_group, name, **kw)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        y = reduce_scatter(x @ w, self.mp_group)
        return y if b is None else y + b


def mark_as_sequence_parallel_parameter(parameter) -> None:
    """Tag a parameter of a sequence-parallel region (a norm's scale or
    bias): each rank's gradient holds only its sequence shard's part."""
    parameter.sequence_parallel = True


def is_sequence_parallel_parameter(parameter) -> bool:
    return getattr(parameter, "sequence_parallel", False)


def register_sequence_parallel_allreduce_hooks(
        layer, accumulation_steps: int = 1, fuse_allreduce: bool = False,
        group=None):
    """After every ``accumulation_steps``-th backward pass that reaches a
    marked parameter of ``layer``, its gradient is all-reduced over
    ``group`` (default: the topology's mp group). Nothing is registered
    without a group of more than one rank. ``fuse_allreduce`` is accepted
    for the reference's signature (each gradient is reduced alone).
    Returns the hook handles."""
    group = mp_ops.mp_group(group)
    if accumulation_steps <= 0 or group is None or group.nranks <= 1:
        return []
    handles = []
    for p in layer.parameters():
        if not is_sequence_parallel_parameter(p):
            continue
        count = [0]

        def hook(param, count=count):
            count[0] += 1
            if count[0] == accumulation_steps:
                count[0] = 0
                C.all_reduce(param.grad, group=group)

        handles.append(p.register_post_accumulate_grad_hook(hook))
    return handles
