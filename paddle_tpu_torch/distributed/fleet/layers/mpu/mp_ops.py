"""Megatron tensor-parallel collectives (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py``).

Each op is a ``torch.autograd.Function`` over a group (default: the hybrid
topology's ``mp`` group), paired forward and backward as Megatron pairs
them:

  _c_identity      fwd: identity        bwd: all-reduce (column-parallel in)
  _mp_allreduce    fwd: all-reduce      bwd: identity   (row-parallel out)
  _c_split         fwd: keep my slice   bwd: all-gather
  _c_concat        fwd: all-gather      bwd: keep my slice
  _reduce_scatter  fwd: reduce-scatter  bwd: all-gather (sequence-parallel)
  _all_gather      fwd: all-gather      bwd: reduce-scatter
  _all_to_all      fwd: all-to-all      bwd: the inverse all-to-all

The reference writes them as ``lax`` collectives inside ``shard_map``,
where JAX transposes each collective itself; each rank here runs its own
autograd, so each pair is spelled out. A group of one rank makes every op
the identity (no collective).

:func:`_mp_allreduce_shards` is the tensor-parallel serving engine's
reduction: every shard sits on the engine's one device, so the shards'
partial products are summed there in shard order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ....communication import collectives as C
from ....communication.group import Group


def mp_group(group: Optional[Group] = None) -> Optional[Group]:
    """``group``, else the hybrid topology's ``mp`` group (None without a
    topology: one rank)."""
    if group is not None:
        return group
    from ...base_topology import try_get_hybrid_communicate_group
    hcg = try_get_hybrid_communicate_group()
    return None if hcg is None else hcg.get_model_parallel_group()


def _n(group: Optional[Group]) -> int:
    return 1 if group is None else group.nranks


def _all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    x = x.contiguous().clone()
    C.all_reduce(x, group=group)
    return x


def _gather_cat(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    parts: List[torch.Tensor] = []
    C.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _my_slice(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    n = group.nranks
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} size {x.shape[dim]} not divisible by "
                         f"the group's {n} ranks")
    return x.chunk(n, dim=dim)[group.rank].contiguous()


def _scatter_sum(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    parts = [c.contiguous() for c in x.chunk(group.nranks, dim=dim)]
    out = torch.empty_like(parts[0])
    C.reduce_scatter(out, parts, group=group)
    return out


def _exchange(x: torch.Tensor, group: Group, split: int,
              concat: int) -> torch.Tensor:
    n = group.nranks
    if x.shape[split] % n:
        raise ValueError(f"all_to_all: dim {split} size {x.shape[split]} "
                         f"not divisible by the group's {n} ranks")
    send = torch.stack(x.chunk(n, dim=split), dim=0).contiguous()
    recv = torch.empty_like(send)
    C.alltoall_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _exchange(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g.contiguous(), ctx.group, ctx.concat, ctx.split),
                None, None, None)


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _my_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(g, ctx.group, ctx.dim), None, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _my_slice(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(g, ctx.group, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim if dim >= 0 else x.dim() + dim


def _c_identity(x: torch.Tensor, group: Optional[Group] = None):
    """Enter a column-parallel region."""
    group = mp_group(group)
    return x if _n(group) == 1 else _Identity.apply(x, group)


def _mp_allreduce(x: torch.Tensor, group: Optional[Group] = None):
    """Exit a row-parallel region: the shards' partial products summed."""
    group = mp_group(group)
    return x if _n(group) == 1 else _AllReduce.apply(x, group)


def _c_split(x: torch.Tensor, group: Optional[Group] = None, dim: int = -1):
    """This rank's slice of ``dim``."""
    group = mp_group(group)
    return x if _n(group) == 1 else _Split.apply(x, group, _dim(x, dim))


def _c_concat(x: torch.Tensor, group: Optional[Group] = None, dim: int = -1):
    """The ranks' shards concatenated along ``dim``."""
    group = mp_group(group)
    return x if _n(group) == 1 else _Concat.apply(x, group, _dim(x, dim))


def _reduce_scatter(x: torch.Tensor, group: Optional[Group] = None,
                    dim: int = 0):
    """Sum across the ranks, keep my slice of ``dim``."""
    group = mp_group(group)
    return x if _n(group) == 1 else _ReduceScatter.apply(x, group,
                                                         _dim(x, dim))


def _all_gather(x: torch.Tensor, group: Optional[Group] = None, dim: int = 0):
    """Concatenate the ranks' shards along ``dim``."""
    group = mp_group(group)
    return x if _n(group) == 1 else _AllGather.apply(x, group, _dim(x, dim))


def _all_to_all(x: torch.Tensor, group: Optional[Group] = None,
                split_axis: int = 0, concat_axis: int = 0):
    """``split_axis`` cut into one chunk a rank, chunk j sent to rank j,
    the chunks received concatenated along ``concat_axis`` in rank order
    (the reference's tiled ``all_to_all``); the backward is the inverse
    exchange."""
    group = mp_group(group)
    if _n(group) == 1:
        return x
    return _AllToAll.apply(x, group, _dim(x, split_axis),
                           _dim(x, concat_axis))


def _parallel_matmul(x: torch.Tensor, w_shard: torch.Tensor,
                     group: Optional[Group] = None,
                     gather_output: bool = True):
    """Column-parallel product on a weight shard ``(in, out / n)``."""
    y = _c_identity(x, group) @ w_shard
    return _c_concat(y, group, -1) if gather_output else y


def _parallel_embedding(ids: torch.Tensor, table_shard: torch.Tensor,
                        group: Optional[Group] = None):
    """Vocab-parallel lookup on a table shard ``(vocab / n, dim)``: rows
    outside this rank's range give zeros, then the ranks' lookups are
    summed."""
    group = mp_group(group)
    per = table_shard.shape[0]
    if _n(group) == 1:
        return table_shard[ids]
    local = ids - group.rank * per
    mine = (local >= 0) & (local < per)
    out = table_shard[torch.where(mine, local, torch.zeros_like(local))]
    out = out * mine.unsqueeze(-1).to(out.dtype)
    return _mp_allreduce(out, group)


def _mp_allreduce_shards(partials: Sequence[torch.Tensor]
                         ) -> List[torch.Tensor]:
    """The serving engine's row-parallel exit with every shard on one
    device: the partial products summed in shard order
    (``((p0 + p1) + p2) + ...``, in their own dtype: one rounding a sum, as
    a two-shard ``psum``), one tensor handed to every shard."""
    if not partials:
        raise ValueError("_mp_allreduce_shards needs at least one shard's "
                         "partial")
    total = partials[0]
    for p in partials[1:]:
        total = total + p
    return [total] * len(partials)
