"""Device and random-generator resolution.

Entry points take ``device=None`` to mean the CUDA card. A caller who wants
the CPU (the tests) says so; a missing card is an error, never a quiet
fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on the CUDA card by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


def seed(value: int, device: DeviceLike = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``value``: the
    explicit random state every initialiser in the port takes."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(value))
