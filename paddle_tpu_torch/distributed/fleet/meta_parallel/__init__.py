"""``fleet.meta_parallel`` (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel``): the tensor-parallel layers,
the model wrappers, the pipeline (``PipelineLayer``, ``PipelineTrainStep``,
``PipelineParallel``, ``pp_utils``) and ZeRO sharding."""

from .meta_parallel_base import (  # noqa: F401
    DataParallel, MetaParallelBase, ShardingParallel, TensorParallel,
)
from .parallel_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, parallel_matmul,
)
from . import pp_utils  # noqa: F401
from .pipeline_parallel import (  # noqa: F401
    PipelineParallel, PipelineTrainStep,
)
from .pp_layers import (  # noqa: F401
    LayerDesc, PipelineLayer, SegmentLayers, SharedLayerDesc,
)
from .sharding import (  # noqa: F401
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3,
)
from ..random import RNGStatesTracker, get_rng_state_tracker  # noqa: F401
