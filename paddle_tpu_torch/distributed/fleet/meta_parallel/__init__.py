"""``fleet.meta_parallel`` (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel``): the tensor-parallel layers
and the model wrappers. The pipeline and ZeRO sharding classes are later
slices (ROADMAP Queue 1, items 3 and 4)."""

from .meta_parallel_base import (  # noqa: F401
    DataParallel, MetaParallelBase, ShardingParallel, TensorParallel,
)
from .parallel_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, parallel_matmul,
)
from ..random import RNGStatesTracker, get_rng_state_tracker  # noqa: F401
