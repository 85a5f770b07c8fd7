"""``fleet.meta_parallel`` (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel``): the tensor-parallel layers,
the model wrappers and ZeRO sharding. The pipeline classes are a later
slice (ROADMAP Queue 1, item 4)."""

from .meta_parallel_base import (  # noqa: F401
    DataParallel, MetaParallelBase, ShardingParallel, TensorParallel,
)
from .parallel_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, parallel_matmul,
)
from .sharding import (  # noqa: F401
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3,
)
from ..random import RNGStatesTracker, get_rng_state_tracker  # noqa: F401
