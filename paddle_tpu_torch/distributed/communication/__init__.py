"""``paddle_tpu_torch.distributed.communication`` (counterpart of
``paddle_tpu/distributed/communication``): groups, eager collectives and
point-to-point transfers on ``torch.distributed``. The reference's
``in_jit`` (collectives inside a jitted program) has no eager twin: its
callers map to these calls."""

from . import stream  # noqa: F401
from .collectives import (  # noqa: F401
    Task, all_gather, all_gather_object, all_reduce, alltoall,
    alltoall_single, barrier, broadcast, collective_counts, gather, reduce,
    reduce_scatter, reset_collective_counts, scatter, scatter_object_list,
    wait,
)
from .group import (  # noqa: F401
    Group, ReduceOp, destroy_process_group, get_group, is_initialized,
    new_group,
)
from .p2p import P2POp, batch_isend_irecv, irecv, isend, recv, send  # noqa: F401
