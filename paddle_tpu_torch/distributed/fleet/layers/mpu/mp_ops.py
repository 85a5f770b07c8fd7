"""Megatron tensor-parallel collectives (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py``).

The reference's ``_mp_allreduce`` exits a row-parallel region by summing
the shards' partial products across the ``mp`` axis (``lax.psum`` inside a
``shard_map``). The port's tensor-parallel serving keeps every shard on
the engine's one device, so the reduction is local: the partials arrive
together, are summed in shard order (``((p0 + p1) + p2) + ...``, in their
own dtype: one rounding a sum, as a two-shard ``psum``) and every shard
gets the result. Placing the shards on several cards (an ``all_reduce`` on
NCCL) comes with the distributed runtime.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["_mp_allreduce"]


def _mp_allreduce(partials: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Exit a row-parallel region: the shards' partial products summed in
    shard order, handed to every shard (one tensor, shared)."""
    if not partials:
        raise ValueError("_mp_allreduce needs at least one shard's partial")
    total = partials[0]
    for p in partials[1:]:
        total = total + p
    return [total] * len(partials)
