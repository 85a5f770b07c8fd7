"""Eager collectives (counterpart of
``paddle_tpu/distributed/communication/collectives.py``), on
``torch.distributed``: NCCL on the card, gloo on the CPU.

The rank mapping, stated once: the reference is single-controller, so it
holds rank r's tensor as slice r of one stacked tensor (leading dimension
the group's size) and returns stacked results. Here each rank is a process
holding its own tensor, and rank r's result equals slice r of the
reference's stacked result on the same inputs. ``src`` and ``dst`` are
global ranks, as in the reference; one outside the group raises
``ValueError``. A caller outside the group returns at once with nothing
done, as Paddle's collectives do.

Designed differences: ``alltoall_single`` takes uneven ``in_split_sizes`` /
``out_split_sizes`` (the reference refuses them: XLA's all-to-all is
static-shape); ``gather`` fills ``gather_list`` on ``dst`` only (the
reference hands every caller the whole list); ``AVG`` is a sum divided by
the group's size (gloo has no average).

``collective_counts()`` counts the collectives each rank issued by name
(p2p included): the hybrid step's collectives a step read off it.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .group import Group, ReduceOp, _get_global_group

_COUNTS: Dict[str, int] = collections.Counter()

_TORCH_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.PROD: dist.ReduceOp.PRODUCT,
    ReduceOp.AVG: dist.ReduceOp.SUM,
}


def collective_counts() -> Dict[str, int]:
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


class Task:
    """The handle of an issued collective (reference: ``Task``): ``wait``
    blocks until it is done (a no-op for a synchronous call) and applies
    what the call finishes after the transfer (``AVG``'s division)."""

    def __init__(self, work=None, then=None):
        self._work = work
        self._then = then

    def wait(self) -> bool:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._then is not None:
            then, self._then = self._then, None
            then()
        return True

    def is_completed(self) -> bool:
        return self._work is None or self._work.is_completed()

    def synchronize(self):
        self.wait()


def _issue(name: str, group: Group, sync_op: bool, fn, then=None) -> Task:
    """Run ``fn(process_group, async_op)`` for a member of ``group`` and
    wrap its work; a non-member returns a finished task."""
    if not group.is_member():
        return Task()
    if group.process_group is None:
        raise RuntimeError(f"{name}: group {group.ranks} has no process "
                           "group (the runtime was not initialized)")
    _COUNTS[name] += 1
    task = Task(fn(group.process_group, not sync_op), then)
    if sync_op:
        task.wait()
    return task


def _local(group: Group, global_rank: int, what: str) -> int:
    r = group.get_group_rank(global_rank)
    if r < 0:
        raise ValueError(f"{what} rank {global_rank} not in group "
                         f"{group.ranks}")
    return r


def _avg(tensor, op, group):
    if op != ReduceOp.AVG:
        return None
    return lambda: tensor.div_(group.nranks)


def all_reduce(tensor: torch.Tensor, op: int = ReduceOp.SUM,
               group: Optional[Group] = None, sync_op: bool = True) -> Task:
    """Every rank ends with the reduction of all ranks' values."""
    group = _get_global_group(group)
    return _issue("all_reduce", group, sync_op,
                  lambda pg, a: dist.all_reduce(tensor, _TORCH_OPS[op], pg, a),
                  _avg(tensor, op, group))


def reduce(tensor: torch.Tensor, dst: int = 0, op: int = ReduceOp.SUM,
           group: Optional[Group] = None, sync_op: bool = True) -> Task:
    """Only ``dst`` receives the reduction; the other ranks keep their
    input (they reduce a copy)."""
    group = _get_global_group(group)
    _local(group, dst, "dst")
    mine = group.is_member() and group.ranks[group.rank] == dst
    buf = tensor if mine else tensor.clone()
    return _issue("reduce", group, sync_op,
                  lambda pg, a: dist.reduce(buf, dst, _TORCH_OPS[op], pg, a),
                  _avg(tensor, op, group) if mine else None)


def broadcast(tensor: torch.Tensor, src: int = 0,
              group: Optional[Group] = None, sync_op: bool = True) -> Task:
    group = _get_global_group(group)
    _local(group, src, "src")
    return _issue("broadcast", group, sync_op,
                  lambda pg, a: dist.broadcast(tensor, src, pg, a))


def all_gather(tensor_list: List, tensor: torch.Tensor,
               group: Optional[Group] = None, sync_op: bool = True) -> Task:
    """``tensor_list`` is refilled with one tensor a rank: element j is
    rank j's ``tensor``."""
    group = _get_global_group(group)
    del tensor_list[:]
    if group.is_member():
        tensor_list.extend(torch.empty_like(tensor)
                           for _ in range(group.nranks))
    return _issue("all_gather", group, sync_op,
                  lambda pg, a: dist.all_gather(tensor_list, tensor, pg, a))


def scatter(tensor: torch.Tensor, tensor_list: Optional[List] = None,
            src: int = 0, group: Optional[Group] = None,
            sync_op: bool = True) -> Task:
    """Rank ``src`` sends ``tensor_list[i]`` to the group's rank i, which
    receives it in ``tensor``."""
    group = _get_global_group(group)
    _local(group, src, "src")
    if not group.is_member():
        return Task()
    is_src = group.ranks[group.rank] == src
    if is_src:
        if tensor_list is None or len(tensor_list) != group.nranks:
            raise ValueError(f"scatter: src needs a tensor_list of "
                             f"{group.nranks} tensors")
    return _issue("scatter", group, sync_op,
                  lambda pg, a: dist.scatter(
                      tensor, list(tensor_list) if is_src else None, src, pg,
                      a))


def reduce_scatter(tensor: torch.Tensor, tensor_list: List,
                   op: int = ReduceOp.SUM, group: Optional[Group] = None,
                   sync_op: bool = True) -> Task:
    """Element i of every rank's ``tensor_list`` is reduced onto the
    group's rank i."""
    group = _get_global_group(group)
    if group.is_member() and len(tensor_list) != group.nranks:
        raise ValueError(f"reduce_scatter: len(tensor_list)="
                         f"{len(tensor_list)} != {group.nranks}")
    return _issue("reduce_scatter", group, sync_op,
                  lambda pg, a: dist.reduce_scatter(
                      tensor, list(tensor_list), _TORCH_OPS[op], pg, a),
                  _avg(tensor, op, group))


def alltoall(out_tensor_list: List, in_tensor_list: List,
             group: Optional[Group] = None, sync_op: bool = True) -> Task:
    """Rank r sends ``in_tensor_list[j]`` to rank j; ``out_tensor_list`` is
    refilled, element j being what rank j sent here."""
    group = _get_global_group(group)
    if group.is_member() and len(in_tensor_list) != group.nranks:
        raise ValueError(f"alltoall: len(in_tensor_list)="
                         f"{len(in_tensor_list)} != {group.nranks}")
    del out_tensor_list[:]
    if group.is_member():
        out_tensor_list.extend(torch.empty_like(t) for t in in_tensor_list)
    return _issue("alltoall", group, sync_op,
                  lambda pg, a: dist.all_to_all(
                      out_tensor_list, list(in_tensor_list), pg, a))


def alltoall_single(out_tensor: torch.Tensor, in_tensor: torch.Tensor,
                    in_split_sizes=None, out_split_sizes=None,
                    group: Optional[Group] = None,
                    sync_op: bool = True) -> Task:
    """Dim 0 of ``in_tensor`` is cut into one chunk a rank (equal, or
    ``in_split_sizes``); chunk j goes to rank j, and ``out_tensor``
    receives the chunks in rank order (``out_split_sizes``)."""
    group = _get_global_group(group)
    if group.is_member() and in_split_sizes is None \
            and in_tensor.shape[0] % group.nranks:
        raise ValueError(f"alltoall_single: dim 0 {in_tensor.shape[0]} not "
                         f"divisible by {group.nranks}")
    return _issue("alltoall_single", group, sync_op,
                  lambda pg, a: dist.all_to_all_single(
                      out_tensor, in_tensor,
                      None if out_split_sizes is None
                      else list(out_split_sizes),
                      None if in_split_sizes is None
                      else list(in_split_sizes), pg, a))


def gather(tensor: torch.Tensor, gather_list: Optional[List] = None,
           dst: int = 0, group: Optional[Group] = None,
           sync_op: bool = True) -> Task:
    """Every rank's ``tensor`` collected at ``dst``: there ``gather_list``
    is refilled, element j being rank j's."""
    group = _get_global_group(group)
    _local(group, dst, "dst")
    if not group.is_member():
        return Task()
    at_dst = group.ranks[group.rank] == dst
    if at_dst:
        if gather_list is None:
            raise ValueError("gather: dst needs a gather_list")
        del gather_list[:]
        gather_list.extend(torch.empty_like(tensor)
                           for _ in range(group.nranks))
    return _issue("gather", group, sync_op,
                  lambda pg, a: dist.gather(
                      tensor, gather_list if at_dst else None, dst, pg, a))


def barrier(group: Optional[Group] = None) -> None:
    group = _get_global_group(group)
    _issue("barrier", group, True, lambda pg, a: dist.barrier(pg, a))


def wait(tensor: torch.Tensor, group: Optional[Group] = None,
         use_calc_stream: bool = True) -> None:
    """Wait until the work queued on ``tensor``'s device is done."""
    if tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)


def all_gather_object(object_list: List, obj,
                      group: Optional[Group] = None) -> None:
    """``object_list`` is refilled with every rank's ``obj`` (pickled)."""
    group = _get_global_group(group)
    del object_list[:]
    if group.is_member():
        object_list.extend([None] * group.nranks)
    _issue("all_gather_object", group, True,
           lambda pg, a: dist.all_gather_object(object_list, obj, pg))


def scatter_object_list(out_object_list: List,
                        in_object_list: Optional[List] = None, src: int = 0,
                        group: Optional[Group] = None) -> None:
    """Rank ``src`` sends ``in_object_list[i]`` to the group's rank i;
    ``out_object_list`` is refilled with the one object received."""
    group = _get_global_group(group)
    _local(group, src, "src")
    if not group.is_member():
        return
    is_src = group.ranks[group.rank] == src
    if is_src and (in_object_list is None
                   or len(in_object_list) != group.nranks):
        raise ValueError("in_object_list must have group-size elements")
    got = [None]
    _issue("scatter_object_list", group, True,
           lambda pg, a: dist.scatter_object_list(
               got, list(in_object_list) if is_src else None, src, pg))
    del out_object_list[:]
    out_object_list.extend(got)
