"""Core layers (counterpart of ``paddle_tpu/nn/layers/common.py``):
``Linear``, ``Embedding``, ``RMSNorm``, ``LayerNorm``, ``GroupNorm``,
``Conv2D`` and ``Dropout``.

``Linear`` keeps Paddle's ``(in, out)`` weight layout and computes
``x @ W``, unlike ``torch.nn.Linear``: parameter names and shapes stay
identical to the JAX model's, so weights carry across unchanged. Under
``amp.auto_cast`` ``Linear`` casts its inputs as the op ``linear``.
"""

from __future__ import annotations

from typing import Optional

import math

import torch
from torch import nn

from ...amp.auto_cast import amp_cast
from ...device import DeviceLike, resolve_device
from .. import functional as F
from ..initializer import KaimingUniform, Normal, Uniform


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


class GroupNorm(nn.Module):
    """Group norm over ``num_groups`` groups of ``num_channels`` channels,
    with a learned per-channel scale (ones) and shift (zeros);
    ``weight_attr=False`` / ``bias_attr=False`` drop them."""

    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.data_format = data_format
        kw = dict(device=resolve_device(device), dtype=dtype or torch.float32)
        self.weight = (None if weight_attr is False else
                       nn.Parameter(torch.ones(num_channels, **kw)))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(num_channels, **kw)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)

    def extra_repr(self) -> str:
        return f"num_groups={self.num_groups}, epsilon={self.epsilon}"


class Conv2D(nn.Module):
    """2-D convolution, weight ``(out_channels, in_channels / groups, kh,
    kw)`` drawn from Kaiming-uniform at ``fan_in = in_channels / groups *
    kh * kw``, bias from ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` (the JAX
    package's defaults); ``bias_attr=False`` drops the bias. Padding takes
    Paddle's forms (:func:`~paddle_tpu_torch.nn.functional.conv2d`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCHW", *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"Conv2D(padding_mode={padding_mode!r}): only 'zeros'")
        ks = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
              else tuple(kernel_size))
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.data_format = groups, data_format
        dev, dtype = resolve_device(device), dtype or torch.float32
        fan_in = in_channels // groups * ks[0] * ks[1]
        self.weight = nn.Parameter(KaimingUniform(fan_in=fan_in)(
            (out_channels, in_channels // groups, *ks), dev, dtype,
            generator))
        bound = 1 / math.sqrt(fan_in)
        self.bias = (None if bias_attr is False else nn.Parameter(
            Uniform(-bound, bound)((out_channels,), dev, dtype, generator)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)

    def extra_repr(self) -> str:
        o, i, kh, kw = self.weight.shape
        return (f"{i * self.groups}, {o}, kernel_size=({kh}, {kw}), "
                f"stride={self.stride}, padding={self.padding}")


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
