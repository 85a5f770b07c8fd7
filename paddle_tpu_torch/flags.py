"""The port's flag registry: ``FLAGS_<name>`` environment variables plus
:func:`set_flags` / :func:`get_flag`, holding only what the ported serving
and training slices read.

There is no ``use_pallas`` counterpart: a kernel wrapper launches its CUDA
kernel for a CUDA tensor and uses its plain PyTorch version only for a CPU
tensor. Values the port cannot serve yet raise ``NotImplementedError``
when read or set; values no version serves raise ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def _only(flag: str, allowed, later: str) -> Callable[[Any], None]:
    def check(value):
        if value != allowed:
            raise NotImplementedError(
                f"FLAGS_{flag}={value!r} is not ported yet ({later}); this "
                f"slice serves only {allowed!r}")
    return check


def _one_of(flag: str, *choices) -> Callable[[Any], None]:
    def check(value):
        if value not in choices:
            raise ValueError(f"FLAGS_{flag} must be one of {choices}, "
                             f"got {value!r}")
    return check


def _any(_value) -> None:
    return None


def _at_least_one(flag: str) -> Callable[[Any], None]:
    def check(value):
        if value < 1:
            raise ValueError(f"FLAGS_{flag} must be >= 1, got {value!r}")
    return check


# name -> (default, validator)
_FLAGS: Dict[str, tuple] = {
    "fused_block_decode": (True, _any),
    "fused_block_layers": (1, _at_least_one("fused_block_layers")),
    "fused_weight_dtype": ("native", _one_of("fused_weight_dtype", "native",
                                             "int4")),
    "serving_prefill_chunk": (256, _any),
    "serving_kv_dtype": ("native", _one_of("serving_kv_dtype", "native",
                                           "int8")),
    "serving_tp_degree": (1, _only("serving_tp_degree", 1,
                                   "tensor-parallel decode")),
    # dispatched-but-unread train steps TrainStep keeps before it waits
    "train_max_in_flight": (32, _at_least_one("train_max_in_flight")),
}

_values: Dict[str, Any] = {}


def _norm(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _FLAGS:
        raise KeyError(f"unknown flag {name!r}; the port defines "
                       f"{sorted(_FLAGS)}")
    return key


def _parse(key: str, value: Any) -> Any:
    kind = type(_FLAGS[key][0])
    if isinstance(value, str) and kind is not str:
        return _parse_bool(value) if kind is bool else kind(value)
    return kind(value)


def get_flag(name: str) -> Any:
    """Explicitly set value, else ``FLAGS_<name>`` from the environment,
    else the default."""
    key = _norm(name)
    if key in _values:
        value = _values[key]
    else:
        env = os.environ.get("FLAGS_" + key)
        value = _FLAGS[key][0] if env is None else _parse(key, env)
    _FLAGS[key][1](value)
    return value


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flags by name (with or without the ``FLAGS_`` prefix)."""
    parsed = {}
    for name, value in flags.items():
        key = _norm(name)
        parsed[key] = _parse(key, value)
        _FLAGS[key][1](parsed[key])
    _values.update(parsed)


def reset_flags() -> None:
    """Forget every :func:`set_flags` value (the environment still counts)."""
    _values.clear()
