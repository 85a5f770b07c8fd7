"""The hybrid-parallel topology (counterpart of
``paddle_tpu/distributed/fleet/base_topology.py``).

:class:`CommunicateTopology` is the reference's rank grid, axes
``("data", "pipe", "sharding", "sep", "model")`` with the model axis
innermost. :class:`HybridCommunicateGroup` builds, on an initialized
runtime, one ``torch.distributed`` group per axis and coordinate: every
rank calls ``new_group`` for every group, in the same order (axis by axis,
then by the other axes' coordinates), and keeps the ones it belongs to.
Without a runtime it is the grid's description for ``global_rank`` (its
groups carry ranks but no process group). :meth:`~HybridCommunicateGroup.
get_mesh` is a ``torch.distributed.device_mesh.DeviceMesh`` over those
groups whose dimensions bear the reference's mesh-axis names ``dp``,
``pp``, ``sharding``, ``sep``, ``mp``.
"""

from __future__ import annotations

import collections
import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..communication.group import Group, _world_group, new_group

_HYBRID_AXES = ("dp", "pp", "sharding", "sep", "mp")
_TOPO_NAMES = ("data", "pipe", "sharding", "sep", "model")
_AXIS_OF = dict(zip(_HYBRID_AXES, _TOPO_NAMES))

_CURRENT_HCG: Optional["HybridCommunicateGroup"] = None

# the reference's name for a topology axis's group
CommGroup = Group


class CommunicateTopology:
    """The rank grid (reference class of the same name)."""

    def __init__(self, hybrid_group_names: Sequence[str] = _TOPO_NAMES,
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self.coordinate = collections.namedtuple("Coordinate",
                                                 self._parallel_names)
        self._world_size = int(np.prod(self._dims))
        self._coord2rank = dict(zip(
            (self.coordinate(*c)
             for c in itertools.product(*(range(d) for d in self._dims))),
            range(self._world_size)))
        self._rank2coord = {v: k for k, v in self._coord2rank.items()}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **args) -> int:
        return self._coord2rank[self.coordinate(**args)]

    def get_coord(self, rank: int):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Every group along ``axis_name``: one rank list for each
        combination of the other axes' coordinates."""
        axis = self._parallel_names.index(axis_name)
        other = [range(d) for i, d in enumerate(self._dims) if i != axis]
        out = []
        for combo in itertools.product(*other):
            ranks = []
            for i in range(self._dims[axis]):
                coord = list(combo)
                coord.insert(axis, i)
                ranks.append(self._coord2rank[self.coordinate(*coord)])
            out.append(ranks)
        return out

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = self.get_coord(global_rank)
        return self.get_rank(**coord._replace(**kwargs)._asdict())


class HybridCommunicateGroup:
    """The reference's getters over the topology's groups."""

    def __init__(self, topology: CommunicateTopology,
                 global_rank: Optional[int] = None):
        self._topo = topology
        deg = {n: topology.get_dim(n)
               for n in topology.get_hybrid_group_names()}
        self._dp_degree = deg.get("data", 1)
        self._pp_degree = deg.get("pipe", 1)
        self._sharding_degree = deg.get("sharding", 1)
        self._sep_degree = deg.get("sep", 1)
        self._mp_degree = deg.get("model", 1)
        self.nranks = topology.world_size()
        live = dist.is_initialized()
        if live:
            if dist.get_world_size() != self.nranks:
                raise ValueError(
                    f"hybrid topology of {self.nranks} ranks over a world of "
                    f"{dist.get_world_size()}")
            global_rank = dist.get_rank()
        self.global_rank = int(global_rank or 0)
        coord = topology.get_coord(self.global_rank)
        self._dp_rank = getattr(coord, "data", 0)
        self._pp_rank = getattr(coord, "pipe", 0)
        self._sharding_rank = getattr(coord, "sharding", 0)
        self._sep_rank = getattr(coord, "sep", 0)
        self._mp_rank = getattr(coord, "model", 0)
        self._groups: Dict[str, Group] = {}
        for axis in _HYBRID_AXES:
            for ranks in topology.get_comm_list(_AXIS_OF[axis]):
                member = self.global_rank in ranks
                if live:
                    g = new_group(ranks, axis_name=axis)
                elif member:
                    g = Group(-1, ranks, ranks.index(self.global_rank),
                              axis_name=axis)
                if member:
                    self._groups[axis] = g
        self._check = (_world_group() if live
                       else Group(0, range(self.nranks), self.global_rank))
        self._mesh = None

        global _CURRENT_HCG
        _CURRENT_HCG = self

    def get_mesh(self):
        """A ``DeviceMesh`` of shape (dp, pp, sharding, sep, mp) over this
        topology's groups, on the runtime's device type."""
        if self._mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            from ..parallel import ParallelEnv
            dev = ParallelEnv().device
            if dev is None:
                raise RuntimeError("get_mesh needs init_parallel_env()")
            grid = torch.arange(self.nranks).reshape(
                self._dp_degree, self._pp_degree, self._sharding_degree,
                self._sep_degree, self._mp_degree)
            self._mesh = DeviceMesh.from_group(
                [self._groups[a].process_group for a in _HYBRID_AXES],
                dev.type, mesh=grid, mesh_dim_names=_HYBRID_AXES)
        return self._mesh

    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_parallel_mode(self) -> str:
        if self._mp_degree == 1 and self._pp_degree == 1 \
                and self._sharding_degree == 1:
            return "DATA_PARALLEL" if self._dp_degree > 1 else "SINGLE"
        if self._mp_degree > 1 and self._pp_degree == 1:
            return "TENSOR_PARALLEL"
        if self._pp_degree > 1:
            return "PIPELINE_PARALLEL"
        return "SHARDING_PARALLEL"

    def get_global_rank(self) -> int:
        return self.global_rank

    # ------------------------------------------------------------------- dp
    def get_data_parallel_rank(self) -> int:
        return self._dp_rank

    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_data_parallel_group(self) -> Group:
        return self._groups["dp"]

    def get_data_parallel_group_src_rank(self) -> int:
        return self._groups["dp"].ranks[0]

    # ------------------------------------------------------------------- mp
    def get_model_parallel_rank(self) -> int:
        return self._mp_rank

    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_model_parallel_group(self) -> Group:
        return self._groups["mp"]

    def get_model_parallel_group_src_rank(self) -> int:
        return self._groups["mp"].ranks[0]

    # ------------------------------------------------------------------- pp
    def get_stage_id(self) -> int:
        return self._pp_rank

    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_pipe_parallel_group(self) -> Group:
        return self._groups["pp"]

    def is_first_stage(self) -> bool:
        return self._pp_rank == 0

    def is_last_stage(self) -> bool:
        return self._pp_rank == self._pp_degree - 1

    def get_p2p_groups(self):
        """None: the pipeline's transfers run over the ``pp`` group
        (``meta_parallel/pp_utils/p2p_communication.py``)."""
        return None

    # -------------------------------------------------------------- sharding
    def get_sharding_parallel_rank(self) -> int:
        return self._sharding_rank

    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_sharding_parallel_group_src_rank(self) -> int:
        return self._groups["sharding"].ranks[0]

    # ------------------------------------------------------------------ sep
    def get_sep_parallel_rank(self) -> int:
        return self._sep_rank

    def get_sep_parallel_world_size(self) -> int:
        return self._sep_degree

    def get_sep_parallel_group(self) -> Group:
        return self._groups["sep"]

    # ------------------------------------------------------- combined groups
    def get_check_parallel_group(self, sharding: bool = False) -> Group:
        return self._check

    def get_rank_from_stage(self, stage_id: int, **kwargs) -> int:
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pipe=stage_id, **kwargs)

    def __repr__(self):
        return (f"HybridCommunicateGroup(dp={self._dp_degree}, "
                f"pp={self._pp_degree}, sharding={self._sharding_degree}, "
                f"sep={self._sep_degree}, mp={self._mp_degree})")


def create_hybrid_communicate_group(
        dp_degree: int = 1, mp_degree: int = 1, pp_degree: int = 1,
        sharding_degree: int = 1, sep_degree: int = 1,
        global_rank: Optional[int] = None) -> HybridCommunicateGroup:
    topo = CommunicateTopology(
        _TOPO_NAMES,
        (dp_degree, pp_degree, sharding_degree, sep_degree, mp_degree))
    return HybridCommunicateGroup(topo, global_rank)


def try_get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _CURRENT_HCG


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if _CURRENT_HCG is None:
        raise RuntimeError("fleet.init(...) has not been called")
    return _CURRENT_HCG


def _reset_hcg():
    global _CURRENT_HCG
    _CURRENT_HCG = None
