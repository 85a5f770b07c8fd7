"""Tensor-parallel layers (:mod:`.mp_layers`)."""

from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, parallel_fused_linear_cross_entropy,
    parallel_matmul, shard_layers,
)
