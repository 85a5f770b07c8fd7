"""Core layers (counterpart of ``paddle_tpu/nn/layers/common.py``):
``Linear``, ``Embedding``, ``RMSNorm``, ``LayerNorm`` and ``Dropout``.

``Linear`` keeps Paddle's ``(in, out)`` weight layout and computes
``x @ W``, unlike ``torch.nn.Linear``: parameter names and shapes stay
identical to the JAX model's, so weights carry across unchanged. Under
``amp.auto_cast`` ``Linear`` casts its inputs as the op ``linear``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...amp.auto_cast import amp_cast
from ...device import DeviceLike, resolve_device
from .. import functional as F
from ..initializer import Normal


def _normal(shape, std: float, device, dtype,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    return Normal(0.0, std)(shape, device, dtype, generator)


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
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        y = x @ w
        return y if b is None else y + b

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


class LayerNorm(nn.Module):
    """Layer norm over the trailing ``normalized_shape`` axes, with a
    learned scale (ones) and shift (zeros); ``weight_attr=False`` /
    ``bias_attr=False`` drop them, as in Paddle."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        kw = dict(device=resolve_device(device), dtype=dtype or torch.float32)
        self.weight = (None if weight_attr is False else
                       nn.Parameter(torch.ones(self.normalized_shape, **kw)))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(self.normalized_shape, **kw)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self) -> str:
        return (f"normalized_shape={self.normalized_shape}, "
                f"epsilon={self.epsilon}")


class Dropout(nn.Module):
    """Paddle's ``Dropout`` layer: :func:`F.dropout` in training (its mask
    from ``generator``, required when ``p > 0``), the identity (or the
    ``downscale_in_infer`` scale) outside it."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)

    def extra_repr(self) -> str:
        return f"p={self.p}"
