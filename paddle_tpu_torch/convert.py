"""Carry named weights and optimizer state from numpy into the port.

The JAX model's ``raw_state()`` gives name -> array dicts; through
``np.asarray`` they become numpy arrays, and bf16 ones arrive as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses. Those go
through float32 and are cast on the way in.

:func:`optimizer_state_from_jax` turns the JAX optimizer's state into what
the port's ``Optimizer.set_state_dict`` (and ``TrainStep.set_state_dict``
under ``"@opt_state"``) takes, so a run resumes where the JAX one stopped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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


def _plain(value: Any) -> Any:
    """A scheduler's state with nested schedulers as their own state
    dicts (the port's ``LRScheduler.set_state_dict`` descends into
    them)."""
    if hasattr(value, "state_dict") and callable(value.state_dict):
        return {k: _plain(v) for k, v in value.state_dict().items()}
    return value


def optimizer_state_from_jax(state: Mapping[str, Any],
                             names: Optional[Mapping[str, str]] = None,
                             lr_state: Optional[Mapping[str, Any]] = None
                             ) -> Dict[str, Any]:
    """The port's optimizer state from the JAX optimizer's.

    ``state`` is the ``"@opt_state"`` of the JAX ``TrainStep.state_dict()``
    (``{"slots": {name: {slot: array}}, "t": step, "master": {name: array}
    or None}``), or the eager optimizer's in that shape:
    ``{"slots": opt._slots, "master": opt._master, "t": opt._step_count}``.
    ``names`` maps a JAX parameter name to the port's where they differ.
    ``lr_state`` is the JAX scheduler's ``state_dict()``. Returns
    ``{"<name>_<slot>_0": array, "<name>_fp32_master_0": array, "@step":
    t}`` with numpy arrays (bf16 ones as float32), plus ``"LR_Scheduler"``
    when ``lr_state`` is given."""
    names = dict(names or {})
    out: Dict[str, Any] = {}
    for jname, slots in (state.get("slots") or {}).items():
        name = names.get(jname, jname)
        for key, arr in (slots.items() if isinstance(slots, Mapping)
                         else ()):
            out[f"{name}_{key}_0"] = _to_torch(arr).float().numpy()
    for jname, arr in (state.get("master") or {}).items():
        out[f"{names.get(jname, jname)}_fp32_master_0"] = (
            _to_torch(arr).float().numpy())
    out["@step"] = int(np.asarray(state.get("t", 0)))
    if lr_state is not None:
        out["LR_Scheduler"] = {k: _plain(v) for k, v in lr_state.items()}
    return out
