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
    # the decode batch-bucket ladder: ','-separated rungs (rungs above an
    # engine's max_batch drop, max_batch is always the top rung); shrink
    # waits ``serving_bucket_patience`` steps of lower demand, growth is
    # immediate
    "serving_bucket_ladder": ("4,8,16,32", _any),
    "serving_bucket_patience": (8, _any),
    # usable KV pages when an engine is not given num_pages (0: the
    # worst case, 1 + max_batch * ceil(max_seq_len / page_size))
    "serving_page_budget": (0, _any),
    # SLO preemption: a waiting request whose deadline slack is inside the
    # horizon (seconds) and which cannot admit unseats the slackest running
    # request (slack larger by more than the margin), at most budget times
    # per victim
    "serving_preempt": (True, _any),
    "serving_preempt_budget": (2, _any),
    "serving_preempt_horizon": (1.0, _any),
    "serving_preempt_margin": (0.0, _any),
    # host-memory KV tier of the prefix cache, in pages (0: off): eviction
    # pressure spills cold cache-only pages to host memory instead of
    # dropping them, and a prefix hit restores them; past the budget the
    # coldest spilled pages drop
    "serving_kv_host_tier_pages": (0, _any),
    # speculative decoding (an engine built with draft_model=): the initial
    # draft length γ, snapped down to a rung of ``serving_spec_rungs``
    # (','-separated; each rung is one draft and one verify program);
    # per-request adaptive γ from the accept-rate EMA; the decode-slot
    # budget a step's rows may bill at γ + 1 slots each (0: max(max_batch,
    # smallest rung + 1)); the chunk width of the draft's catch-up sync.
    # Scheduling flags, read eagerly: γ reaches a program through its key
    "serving_spec_gamma": (4, _any),
    "serving_spec_rungs": ("2,4,8", _any),
    "serving_spec_adaptive": (True, _any),
    "serving_spec_max_slots": (0, _any),
    "serving_spec_sync_chunk": (64, _any),
    # dispatched-but-unread train steps TrainStep keeps before it waits
    "train_max_in_flight": (32, _at_least_one("train_max_in_flight")),
    # host-side telemetry (observability): the metrics registry and the
    # span tracer; off, instrumented objects bind no-op stubs when built
    "telemetry": (True, _any),
    # span-tracer ring capacity in events (the oldest drop first)
    "telemetry_ring": (16384, _any),
    # deterministic fault-injection spec (testing.faults): ';'-separated
    # '<site>:every=N' / '<site>:p=F[:seed=N][:times=N][:after=N]' entries;
    # empty: disabled, components bind no-op stubs when built
    "fault_inject": ("", _any),
    # replay recovery: consecutive no-progress replays a request survives
    # before it ends FAILED (a replay after progress resets the count)
    "serving_max_retries": (3, _any),
    # base seconds of the recovery backoff; doubles per consecutive
    # no-progress recovery (capped at 2 s)
    "serving_retry_backoff": (0.05, _any),
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


class FlagSnapshot:
    """An immutable view of some flags, resolved once: attribute and
    mapping access, and :meth:`as_tuple` for a program-cache key."""

    __slots__ = ("_values",)

    def __init__(self, values: Dict[str, Any]):
        object.__setattr__(self, "_values", dict(values))

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"flag {name!r} not in snapshot "
                                 f"(have {sorted(self._values)})") from None

    def __getitem__(self, name: str) -> Any:
        return self._values[name[6:] if name.startswith("FLAGS_") else name]

    def __contains__(self, name: str) -> bool:
        return (name[6:] if name.startswith("FLAGS_") else name) \
            in self._values

    def __setattr__(self, name, value):
        raise TypeError("FlagSnapshot is immutable")

    def as_tuple(self) -> tuple:
        """Hashable ``(name, value)`` pairs, sorted by name."""
        return tuple(sorted(self._values.items()))

    def __repr__(self) -> str:
        return f"FlagSnapshot({self._values!r})"


def snapshot(names=None) -> FlagSnapshot:
    """Resolve ``names`` (every flag when None) once into a
    :class:`FlagSnapshot`."""
    keys = sorted(_FLAGS) if names is None else [_norm(n) for n in names]
    return FlagSnapshot({k: get_flag(k) for k in keys})


# The flags a decode program reads: the flag part of a decode program's
# cache key (``generation/program_cache.py``), so engines built under other
# values of these never share a program. Telemetry, fault injection and the
# recovery budget are not among them: toggling them never rebuilds a
# program or a graph.
PROGRAM_FLAGS = ("fused_block_decode", "fused_block_layers")


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
