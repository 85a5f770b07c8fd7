"""``paddle_tpu_torch.distributed`` (counterpart of
``paddle_tpu/distributed``): the runtime on ``torch.distributed``: the
parallel environment, groups, eager collectives and p2p, ``spawn``, and
``fleet`` with the hybrid topology, the Megatron layers and the wrappers.
NCCL runs on the card, gloo on the CPU when asked.

``get_backend()`` names the torch backend (``"nccl"`` / ``"gloo"``) where
the reference names XLA. ``group_sharded_parallel`` /
``save_group_sharded_model`` wrap a model and an optimizer for ZeRO; the
pipeline lives in ``fleet.meta_parallel``, long context and sequence
parallelism in ``fleet.utils``, expert parallelism in the MoE layer and
``utils`` (``global_scatter`` / ``global_gather``). ``auto_parallel``, the
distributed checkpoint, ``launch``, ``ps`` and ``rpc`` are not ported
yet.
"""

import torch.distributed as _dist

from . import communication, fleet, sharding, utils  # noqa: F401
from .communication import (  # noqa: F401
    Group, P2POp, ReduceOp, Task, all_gather, all_gather_object, all_reduce,
    alltoall, alltoall_single, barrier, batch_isend_irecv, broadcast,
    collective_counts, destroy_process_group, gather, get_group, irecv,
    isend, new_group, recv, reduce, reduce_scatter, reset_collective_counts,
    scatter, scatter_object_list, send, stream, wait,
)
from .communication import alltoall as all_to_all  # noqa: F401
from .communication import alltoall_single as all_to_all_single  # noqa: F401
from .fleet import DistributedStrategy as Strategy  # noqa: F401
from .fleet.meta_parallel.meta_parallel_base import DataParallel  # noqa: F401
from .parallel import (  # noqa: F401
    ParallelEnv, device_count, get_rank, get_world_size, init_parallel_env,
    is_initialized,
)
from .sharding import (  # noqa: F401
    group_sharded_parallel, save_group_sharded_model,
)
from .spawn import spawn  # noqa: F401


def get_backend(group=None) -> str:
    """The torch backend of ``group``'s process group (default: the
    world's)."""
    pg = None if group is None else group.process_group
    return str(_dist.get_backend(pg))


def is_available() -> bool:
    return _dist.is_available()
