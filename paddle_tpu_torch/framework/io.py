"""Checkpoint save/load (counterpart of ``paddle_tpu/framework/io.py``).

``paddle.save`` / ``paddle.load``: nested dicts, lists and tuples of
tensors pickled with each tensor as a numpy payload, the ``.pdparams`` /
``.pdopt`` files ``Model.save`` and ``ModelCheckpoint`` write. The files
are the JAX package's: each tensor is pickled as its
``paddle_tpu.framework.io._TensorPayload`` (fields ``dtype``, ``array``,
``stop_gradient``, ``name``, ``is_parameter``), and numpy having no
bfloat16, a bf16 tensor is stored as its f32 values with a ``"bfloat16"``
marker. So either package loads the other's files. This package does not
import the JAX one: :func:`save` writes the class under that path itself.
``load`` also reads the files of earlier versions of this module, which
stored bf16 as its raw 16-bit words (``uint16``).
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

_JAX_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")


class _TensorPayload:
    """Pickle-stable tensor: a numpy array, its dtype, and the JAX
    package's ``stop_gradient``, ``name`` and ``is_parameter`` (which
    :meth:`to_tensor` does not read)."""

    def __init__(self, t: torch.Tensor):
        self.stop_gradient = not t.requires_grad
        self.name = None
        self.is_parameter = isinstance(t, torch.nn.Parameter)
        t = t.detach()
        if t.dtype == torch.bfloat16:
            self.dtype = "bfloat16"
            self.array = t.cpu().float().numpy()
        else:
            self.array = t.cpu().numpy()
            self.dtype = str(self.array.dtype)

    def to_tensor(self) -> torch.Tensor:
        if self.dtype == "bfloat16" and self.array.dtype == np.uint16:
            # raw words, as earlier versions of this module wrote
            return torch.from_numpy(self.array.view(np.int16).copy()).view(
                torch.bfloat16)
        t = torch.from_numpy(np.array(self.array, copy=True))
        if self.dtype == "bfloat16":        # the f32 copy
            t = t.to(torch.bfloat16)
        return t

    def numpy(self) -> np.ndarray:
        """The values as numpy (bf16 as float32)."""
        if self.dtype == "bfloat16":
            return self.to_tensor().float().numpy()
        return self.array


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, naming :class:`_TensorPayload` by the JAX
    package's path. (The C pickler imports a class's module to check its
    path, and this package never imports the JAX one.)"""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        module, qualname = _JAX_PAYLOAD
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL
                       + f"{module}\n{qualname}\n".encode("utf-8"))
        self.memoize(obj)


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
        _Pickler(f, protocol=protocol).dump(_pack(obj))


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """``paddle.load``: what :func:`save` wrote, tensors on the CPU (or
    numpy arrays with ``return_numpy``)."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy=return_numpy)
