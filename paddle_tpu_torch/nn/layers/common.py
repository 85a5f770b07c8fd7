"""Core layers (counterpart of ``paddle_tpu/nn/layers/common.py``).

``Linear`` keeps Paddle's ``(in, out)`` weight layout and computes
``x @ W``, unlike ``torch.nn.Linear``: parameter names and shapes stay
identical to the JAX model's, so weights carry across unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from .. import functional as F


def _normal(shape, std: float, device, dtype,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    t = torch.empty(shape, device=device, dtype=dtype)
    return t.normal_(0.0, std, generator=generator)


class Linear(nn.Module):
    """y = x @ W (+ b), W of shape (in_features, out_features)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, std: float = 0.02, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or torch.float32
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(_normal((in_features, out_features), std,
                                           dev, dtype, generator))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=dev,
                                              dtype=dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(nn.Module):
    """Lookup table, weight of shape (num_embeddings, embedding_dim)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 std: float = 1.0, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(_normal(
            (num_embeddings, embedding_dim), std, resolve_device(device),
            dtype or torch.float32, generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]


class RMSNorm(nn.Module):
    """Root-mean-square norm with a learned scale (initialised to ones)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device),
            dtype=dtype or torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self.epsilon)
