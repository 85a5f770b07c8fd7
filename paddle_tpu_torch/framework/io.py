"""Checkpoint save/load (counterpart of ``paddle_tpu/framework/io.py``).

``paddle.save`` / ``paddle.load``: nested dicts, lists and tuples of
tensors pickled with each tensor as a numpy payload, the ``.pdparams`` /
``.pdopt`` files ``Model.save`` and ``ModelCheckpoint`` write. numpy has
no bfloat16: a bf16 tensor is stored as its raw 16-bit words (``uint16``)
with a ``"bfloat16"`` marker, half the bytes of the reference's f32 copy.
``load`` also reads the JAX package's files: their payload class maps onto
this one, and their bf16 arrives as f32 with the marker.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

_JAX_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")


class _TensorPayload:
    """Pickle-stable tensor: a numpy array and its dtype (the reference's
    payload also carries a name and flags, which nothing reads)."""

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            self.dtype = "bfloat16"
            self.array = t.cpu().view(torch.int16).numpy().view(np.uint16)
        else:
            self.array = t.cpu().numpy()
            self.dtype = str(self.array.dtype)

    def to_tensor(self) -> torch.Tensor:
        if self.dtype == "bfloat16" and self.array.dtype == np.uint16:
            return torch.from_numpy(self.array.view(np.int16).copy()).view(
                torch.bfloat16)
        t = torch.from_numpy(np.array(self.array, copy=True))
        if self.dtype == "bfloat16":        # the reference's f32 copy
            t = t.to(torch.bfloat16)
        return t

    def numpy(self) -> np.ndarray:
        """The values as numpy (bf16 as float32)."""
        if self.dtype == "bfloat16":
            return self.to_tensor().float().numpy()
        return self.array


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _JAX_PAYLOAD:
            return _TensorPayload
        return super().find_class(module, name)


def _pack(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj: Any, return_numpy=False) -> Any:
    if isinstance(obj, _TensorPayload):
        return obj.numpy() if return_numpy else obj.to_tensor()
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs) -> None:
    """``paddle.save``: pickle a nested structure of tensors to ``path``
    (its directory is made)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """``paddle.load``: what :func:`save` wrote, tensors on the CPU (or
    numpy arrays with ``return_numpy``)."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy=return_numpy)
