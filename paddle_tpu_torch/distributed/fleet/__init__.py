"""Fleet (counterpart of ``paddle_tpu/distributed/fleet``): ``fleet.init``,
the hybrid topology, the tensor-parallel layers and ops, the model and
optimizer wrappers, ZeRO sharding, DGC, the RNG tracker, and ``utils``
(recompute, ring / Ulysses attention, sequence parallelism), on
``torch.distributed``."""

from . import (  # noqa: F401
    base_topology, layers, meta_optimizers, meta_parallel, random, utils,
)
from .base_topology import (  # noqa: F401
    CommGroup, CommunicateTopology, HybridCommunicateGroup,
    create_hybrid_communicate_group, get_hybrid_communicate_group,
)
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet import (  # noqa: F401
    Fleet, distributed_model, distributed_optimizer, init, is_initialized,
)
from .meta_optimizers import (  # noqa: F401
    DygraphShardingOptimizer, HybridParallelGradScaler,
    HybridParallelOptimizer,
)
from .meta_parallel import (  # noqa: F401
    ColumnParallelLinear, GroupShardedOptimizerStage2, GroupShardedStage2,
    GroupShardedStage3, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, parallel_matmul,
)
from .random import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
from .role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, Role, UserDefinedRoleMaker,
)


def _bind_fleet_method(name):
    def call(*a, **k):
        from .fleet import _fleet_singleton
        return getattr(_fleet_singleton, name)(*a, **k)
    call.__name__ = name
    return call


for _n in ("worker_num", "worker_index", "is_worker", "is_server",
           "is_first_worker", "worker_endpoints", "server_num",
           "server_index", "server_endpoints", "init_worker",
           "init_server", "run_server", "stop_worker", "barrier_worker"):
    globals()[_n] = _bind_fleet_method(_n)
del _n
