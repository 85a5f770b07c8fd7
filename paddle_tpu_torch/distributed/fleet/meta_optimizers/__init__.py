"""Dygraph meta-optimizers (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers``): the hybrid-parallel
optimizer and loss scaler, the stage-1 sharding optimizer and DGC."""

from .dgc_optimizer import DGCMomentum  # noqa: F401
from .dygraph_sharding_optimizer import DygraphShardingOptimizer  # noqa: F401
from .hybrid_parallel_optimizer import (  # noqa: F401
    HybridParallelClipGrad, HybridParallelGradScaler, HybridParallelOptimizer,
)
