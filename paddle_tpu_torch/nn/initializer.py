"""Initializers (counterpart of ``paddle_tpu/nn/initializer.py``): the one
the ported models call, ``Normal``. The port has no global random key, so an
initializer draws from the ``torch.Generator`` it is given."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["Normal"]


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
