"""Decode program cache: one decode program per serving configuration.

Counterpart of ``paddle_tpu/generation/program_cache.py``. A decode program
is keyed on what makes it differ between deployments: the model's structure,
the batch bucket, the page budget, the pool dtype, the flags a program reads
(``flags.PROGRAM_FLAGS``) and kind-specific geometry in ``extra``. Weights
are never part of a key: they travel as arguments, so two engines over
same-structured models share one program.

On the CPU a program is the eager step, and ``trace_count(key)`` counts its
first calls (one per key for the life of the cache, as the JAX package
counts traces). On a CUDA device the serving engine captures the same eager
step as a CUDA graph per engine and bucket rung (the graph binds that
engine's pools and weights, so it cannot be shared) and notes each capture
on the key through the same probe: ``trace_count`` counts captures there.

Telemetry, as in the JAX package: ``program_cache_hits`` and
``program_cache_misses`` count lookups, ``program_cache_traces{kind, model,
tp}`` counts traces (``model`` is the signature's first 8 characters, ``tp``
the key's tensor-parallel degree: "1" unless the engine shards its decode),
and ``program_cache_compile_seconds`` times each: the
first call on the CPU, the eager warm-up plus the graph capture on the
card. The ``program_build`` fault site is checked before every build (bound
when the cache is made: :func:`clear_decode_program_cache` re-arms it).

Memwatch (``FLAGS_memwatch``, riding the telemetry gate, bound when the
cache is made): each trace also banks the program's memory sections into
``program_memory_bytes`` and the program table
(:mod:`..observability.memory`), one row per (model signature prefix,
kind, bucket, extra): the first call on the CPU, each capture on the card
(so ``captures`` counts an engine's graphs of the key there).

The cache never evicts: a generic program holds no model, but a graph held
by an engine keeps that engine's pools alive with the engine.
:func:`clear_decode_program_cache` drops every program.
"""

from __future__ import annotations

import hashlib
import re
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from .. import observability as obs
from ..testing import faults

__all__ = ["DecodeKey", "DecodeProgramCache", "decode_program_cache",
           "clear_decode_program_cache", "model_signature",
           "TAG_KV", "TAG_WT", "TAG_NLAYER", "TAG_TP", "ATOM_FUSED",
           "ATOM_GENERIC",
           "ATOM_SAMPLE", "ATOM_GREEDY"]

# heads of (tag, value) pairs inside DecodeKey.extra (the JAX package's
# analysis/key_vocab.py)
TAG_KV = "kv"            # ("kv", dtype): the paged-KV storage dtype
TAG_WT = "wt"            # ("wt", dtype): the fused decode's weight dtype
TAG_NLAYER = "nlayer"    # ("nlayer", (sizes...)): the fused layer groups
TAG_TP = "tp"            # ("tp", n): the tensor-parallel degree, n > 1 only
# bare atoms inside DecodeKey.extra: a speculative draft program's route
# and the draft and verify programs' mode
ATOM_FUSED = "fused"      # the draft scan runs the fused one-layer kernel
ATOM_GENERIC = "generic"  # the draft scan runs the model's cached forward
ATOM_SAMPLE = "sample"    # sampled (paired with top-k in the tuple)
ATOM_GREEDY = "greedy"    # greedy


def _key_tp(key) -> str:
    """The ``tp`` label of a key's series: the degree its ``extra`` carries
    as a ``("tp", n)`` pair (only when n > 1, so every tp = 1 key stays as
    it was), else "1"."""
    for item in key.extra:
        if isinstance(item, tuple) and len(item) == 2 and item[0] == TAG_TP:
            return str(item[1])
    return "1"


class DecodeKey(NamedTuple):
    """(model signature, batch bucket, page budget, dtype, flag tuple), plus
    ``kind`` to separate the program families sharing the cache and
    ``extra`` for kind-specific geometry."""
    kind: str                 # decode_fused | decode_fused_nlayer | ...
    model_sig: str
    batch_bucket: int
    page_budget: Tuple        # (num_pages, page_size, max_pages_per_seq)
    dtype: str
    flags: Tuple              # flags.snapshot(...).as_tuple()
    extra: Tuple = ()


# default object.__repr__ embeds a memory address: "<X object at 0x7f..>"
_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


def model_signature(model) -> str:
    """Structural identity of a model: class, config and the name, shape
    and dtype of every parameter and buffer, digested. Weight values are
    left out. Addresses in the config's repr are zeroed, so two instances
    of one config sign alike."""
    cfg_repr = _ADDR_RE.sub("0x0", repr(getattr(model, "config", None)))
    parts = [type(model).__name__, cfg_repr,
             f"training={getattr(model, 'training', False)}"]
    for name, t in sorted(model.named_parameters()):
        parts.append(f"{name}:{tuple(t.shape)}:{t.dtype}")
    for name, t in sorted(model.named_buffers()):
        if t is not None:
            parts.append(f"b:{name}:{tuple(t.shape)}:{t.dtype}")
    return hashlib.md5("|".join(parts).encode()).hexdigest()


class DecodeProgramCache:
    """Thread-safe keyed cache of decode programs with a trace count per
    key."""

    def __init__(self):
        # FLAGS_fault_inject 'program_build:...', bound when the cache is
        # made
        self._f_build = faults.site("program_build")
        self._lock = threading.Lock()
        self._programs: Dict[DecodeKey, Any] = {}
        self._trace_counts: Dict[DecodeKey, int] = {}
        self._compile_seconds: Dict[DecodeKey, float] = {}
        self.hits = 0
        self.misses = 0
        self._telemetry = obs.enabled()
        self._memwatch = self._telemetry and obs.memory.enabled()
        if self._telemetry:
            r = obs.registry()
            self._m_hits = r.counter(
                "program_cache_hits",
                "decode program cache admissions served from cache")
            self._m_misses = r.counter(
                "program_cache_misses",
                "decode program cache admissions that built a program")
            self._m_traces = r.counter(
                "program_cache_traces",
                "traces of cached programs: the first call on the CPU, "
                "each CUDA-graph capture on the card (steady state: one "
                "per key and engine); model = signature prefix; tp = "
                "tensor-parallel degree from the key",
                labels=("kind", "model", "tp"))
            self._m_compile = r.histogram(
                "program_cache_compile_seconds",
                "wall clock of each trace: the first call on the CPU, the "
                "eager warm-up plus the CUDA-graph capture on the card",
                labels=("kind", "model", "tp"))
        else:
            self._m_hits = self._m_misses = obs.NULL
            self._m_traces = self._m_compile = obs.NULL

    def get(self, key: DecodeKey, builder: Callable[[Callable], Any]):
        """The program for ``key``, built on first use (after the
        ``program_build`` fault check). ``builder(note_trace)`` returns the
        program; ``note_trace(seconds, measure=None)`` adds one to
        ``trace_count(key)`` and the seconds to the key's build time each
        time it runs (at the first call on the CPU, at each capture on the
        card), and under memwatch records ``measure()``'s memory sections
        (``note_trace.memwatch`` says whether it will: a caller measures
        nothing otherwise)."""
        with self._lock:
            fn = self._programs.get(key)
            if fn is not None:
                self.hits += 1
                self._m_hits.inc()
                return fn
        self._f_build.check(kind=key.kind)   # injected build failure
        fn = builder(self._tracer(key))      # may be slow: build unlocked
        with self._lock:
            cur = self._programs.setdefault(key, fn)
            if cur is fn:
                self.misses += 1
                self._m_misses.inc()
            else:
                self.hits += 1               # lost a benign build race
                self._m_hits.inc()
            return cur

    def _tracer(self, key: DecodeKey) -> Callable:
        labels = dict(kind=key.kind, model=key.model_sig[:8],
                      tp=_key_tp(key))
        traces = self._m_traces.labels(**labels)
        compile_s = self._m_compile.labels(**labels)
        memwatch = self._memwatch

        def note_trace(seconds: float, measure=None):
            with self._lock:
                self._trace_counts[key] = self._trace_counts.get(key, 0) + 1
                if self._telemetry:
                    self._compile_seconds[key] = (
                        self._compile_seconds.get(key, 0.0) + seconds)
            traces.inc()
            compile_s.observe(seconds)
            if memwatch and measure is not None:
                obs.memory.capture_program(
                    key.kind, key.batch_bucket, key.extra, measure,
                    model=key.model_sig[:8])
        note_trace.memwatch = memwatch
        return note_trace

    def trace_count(self, key: DecodeKey) -> int:
        with self._lock:
            return self._trace_counts.get(key, 0)

    def compile_seconds(self, key: DecodeKey) -> float:
        """Seconds of every trace of ``key`` (first calls on the CPU, warm-up
        and capture on the card); 0.0 with telemetry off."""
        with self._lock:
            return self._compile_seconds.get(key, 0.0)

    def keys(self) -> List[DecodeKey]:
        """Every key with a cached program, in build order."""
        with self._lock:
            return list(self._programs)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "programs": len(self._programs),
                    "traces": dict(self._trace_counts),
                    "compile_seconds": dict(self._compile_seconds)}

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()
            self._trace_counts.clear()
            self._compile_seconds.clear()
            self.hits = self.misses = 0


_GLOBAL: Optional[DecodeProgramCache] = None
_GLOBAL_LOCK = threading.Lock()


def decode_program_cache() -> DecodeProgramCache:
    """The process-wide decode program cache."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = DecodeProgramCache()
        return _GLOBAL


def clear_decode_program_cache() -> None:
    """Drop every cached program and the cache instance itself, so the next
    :func:`decode_program_cache` binds telemetry and the ``program_build``
    site under the flags of that moment."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.clear()
        _GLOBAL = None
