"""Carry named weights from numpy into the port.

The JAX model's ``raw_state()`` gives name -> array dicts; through
``np.asarray`` they become numpy arrays, and bf16 ones arrive as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses. Those go
through float32 and are cast on the way in.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr.astype(np.float32))).to(torch.bfloat16)
    # a copy: arrays exported from JAX are read-only
    return torch.from_numpy(np.array(arr, order="C"))


def state_from_numpy(named: Mapping[str, np.ndarray],
                     device: DeviceLike = None,
                     dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device`` (default: the card), cast to ``dtype``
    when given, else kept in the source dtype."""
    dev = resolve_device(device)
    out = {}
    for name, arr in named.items():
        t = _to_torch(arr)
        out[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return out
