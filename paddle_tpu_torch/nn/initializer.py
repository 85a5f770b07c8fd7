"""Initializers (counterpart of ``paddle_tpu/nn/initializer.py``): the ones
the ported layers call, ``Constant``, ``Normal``, ``Uniform``,
``XavierNormal``, ``XavierUniform`` and ``KaimingUniform``. The port has no
global random key, so an initializer draws from the ``torch.Generator`` it
is given.

The Xavier fans are the JAX package's ``_fans`` rule, copied: a shape of
three or more dimensions counts as a convolution weight ``[out_c, in_c,
*k]``, so ``Experts``' ``(E, d, h)`` has fan-in ``d * h`` and fan-out
``E * h``."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["Constant", "KaimingUniform", "Normal", "Uniform", "XavierNormal",
           "XavierUniform"]


class Constant:
    """A new tensor of ``dtype`` on ``device`` filled with ``value``."""

    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, device, dtype,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return torch.full(tuple(shape), self.value, device=device,
                          dtype=dtype)


class Normal:
    """Draws ``mean + std * N(0, 1)`` from ``generator`` into a new tensor
    of ``dtype`` on ``device`` (``Tensor.normal_`` in that dtype)."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, device, dtype,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        t = torch.empty(tuple(shape), device=device, dtype=dtype)
        return t.normal_(self.mean, self.std, generator=generator)


class Uniform:
    """Draws from ``U(low, high)`` with ``generator`` (``Tensor.uniform_``
    in ``dtype``)."""

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, device, dtype,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        t = torch.empty(tuple(shape), device=device, dtype=dtype)
        return t.uniform_(self.low, self.high, generator=generator)


def _fans(shape) -> tuple:
    """``(fan_in, fan_out)``: a 1-D shape is its own fan both ways, a 2-D
    ``(in, out)``, and three or more dimensions ``[out_c, in_c, *k]``."""
    shape = tuple(shape)
    if len(shape) < 2:
        f = shape[0] if shape else 1
        return f, f
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierNormal:
    """``N(0, gain * sqrt(2 / (fan_in + fan_out)))``."""

    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, device, dtype,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        fi, fo = _fans(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        return Normal(0.0, std)(shape, device, dtype, generator)


class XavierUniform:
    """``U(-limit, limit)``, ``limit = gain * sqrt(6 / (fan_in +
    fan_out))``."""

    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, device, dtype,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        fi, fo = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        return Uniform(-limit, limit)(shape, device, dtype, generator)


class KaimingUniform:
    """``U(-limit, limit)``, ``limit = gain * sqrt(3 / fan_in)`` with
    ``gain = sqrt(2 / (1 + negative_slope^2))`` for ``relu`` and
    ``leaky_relu`` (else 1); ``fan_in`` from the shape unless given
    (``Conv2D`` gives ``in_c / groups * kh * kw``)."""

    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, device, dtype,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        fi = self.fan_in or _fans(shape)[0]
        gain = (math.sqrt(2.0 / (1 + self.negative_slope ** 2))
                if self.nonlinearity in ("relu", "leaky_relu") else 1.0)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, device, dtype, generator)
