"""Dygraph meta-optimizers (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers``): the hybrid-parallel
optimizer. The sharding and DGC optimizers are ROADMAP Queue 1, item 3."""

from .hybrid_parallel_optimizer import (  # noqa: F401
    HybridParallelClipGrad, HybridParallelOptimizer,
)
