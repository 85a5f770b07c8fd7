"""Communication groups (counterpart of
``paddle_tpu/distributed/communication/group.py``).

A :class:`Group` wraps a ``torch.distributed`` process group: the ordered
global ranks of its members, the caller's rank in it (-1 outside it) and
the ``ProcessGroup`` that collectives run on. Every group is made with a
``timeout``, so a rank that never arrives fails the others' calls instead of
stalling them. The reference realises a group as a one-axis device mesh
under JAX's single controller, where every member sits in the one process;
here each rank is a process of its own.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional, Sequence

import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


class ReduceOp:
    """Reduction ops (reference: ``paddle.distributed.ReduceOp``)."""

    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


class Group:
    """An ordered set of global ranks and the process group over them.

    ``rank`` is the caller's rank within the group, or -1 when the caller
    is not a member (the process group is then None). ``axis_name`` names
    the hybrid topology's axis for groups built from one (``dp``, ``mp``,
    ...). A group made without an initialized runtime (the topology's
    descriptive groups) has no process group; collectives over it raise.
    """

    def __init__(self, gid: int, ranks: Sequence[int], rank: int,
                 process_group=None, axis_name: Optional[str] = None):
        self.id = gid
        self.ranks = [int(r) for r in ranks]
        self.nranks = len(self.ranks)
        self.rank = int(rank)
        self.process_group = process_group
        self.axis_name = axis_name

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def name(self) -> str:
        return f"_default_pg_{self.id}"

    @property
    def backend(self) -> str:
        if self.process_group is None:
            return "none"
        return str(dist.get_backend(self.process_group))

    def is_member(self) -> bool:
        return self.rank >= 0

    def get_group_rank(self, global_rank: int) -> int:
        return (self.ranks.index(global_rank) if global_rank in self.ranks
                else -1)

    def __repr__(self):
        return (f"Group(id={self.id}, ranks={self.ranks}, rank={self.rank}, "
                f"backend={self.backend})")


_GROUP_MAP: Dict[int, Group] = {}
_BY_PG_NAME: Dict[str, Group] = {}
_next_gid = [1]


def resolve_group_axis(group, default: Optional[str] = None
                       ) -> Optional[str]:
    """The mesh axis a group addresses: its ``global_axis``, else its
    ``axis_name`` (the hybrid topology's groups carry one), else
    ``default``."""
    if group is None:
        return default
    return (getattr(group, "global_axis", None)
            or getattr(group, "axis_name", None) or default)


def _register(g: Group) -> Group:
    _GROUP_MAP[g.id] = g
    if g.process_group is not None:
        _BY_PG_NAME[g.process_group.group_name] = g
    return g


def _world_group() -> Group:
    if 0 not in _GROUP_MAP:
        if not dist.is_initialized():
            raise RuntimeError(
                "the distributed runtime is not initialized: call "
                "paddle_tpu_torch.distributed.init_parallel_env() first")
        n = dist.get_world_size()
        _register(Group(0, range(n), dist.get_rank(), dist.group.WORLD))
    return _GROUP_MAP[0]


def _get_global_group(group: Optional[Group] = None) -> Group:
    return group if group is not None else _world_group()


def from_process_group(pg) -> Group:
    """The :class:`Group` that wraps ``pg`` (a group made here, the world,
    or one a ``DeviceMesh`` holds)."""
    if pg is None or pg is dist.group.WORLD:
        return _world_group()
    g = _BY_PG_NAME.get(pg.group_name)
    if g is None:
        ranks = dist.get_process_group_ranks(pg)
        me = dist.get_rank()
        g = Group(_next_gid[0], ranks, ranks.index(me) if me in ranks else -1,
                  pg)
        _next_gid[0] += 1
        _register(g)
    return g


def new_group(ranks: Optional[Sequence[int]] = None,
              backend: Optional[str] = None,
              timeout: Optional[datetime.timedelta] = None,
              axis_name: Optional[str] = None) -> Group:
    """``paddle.distributed.new_group``: a group over ``ranks`` (default:
    every rank), sorted as the reference sorts them, whose collectives fail
    after ``timeout`` (default: ``init_parallel_env``'s). Collective: every
    rank of the world calls it, in the same order, members or not."""
    from .. import parallel
    world = _world_group()
    timeout = timeout or parallel._timeout
    ranks = sorted(int(r) for r in (range(world.nranks) if ranks is None
                                    else ranks))
    pg = dist.new_group(ranks, timeout=timeout, backend=backend)
    me = world.rank
    member = me in ranks
    g = Group(_next_gid[0], ranks, ranks.index(me) if member else -1,
              pg if member else None, axis_name)
    _next_gid[0] += 1
    return _register(g)


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return _world_group()
    if gid not in _GROUP_MAP:
        raise ValueError(f"group {gid} does not exist")
    return _GROUP_MAP[gid]


def destroy_process_group(group: Optional[Group] = None) -> None:
    """Without ``group``: tear the runtime down (every group, the world and
    the hybrid topology). With one: forget that group."""
    if group is not None:
        _GROUP_MAP.pop(group.id, None)
        if group.process_group is not None:
            _BY_PG_NAME.pop(group.process_group.group_name, None)
        return
    _GROUP_MAP.clear()
    _BY_PG_NAME.clear()
    _next_gid[0] = 1
    from .. import parallel
    from ..fleet import base_topology, fleet
    base_topology._reset_hcg()
    fleet._fleet_singleton.__init__()
    parallel._reset()
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_initialized()
