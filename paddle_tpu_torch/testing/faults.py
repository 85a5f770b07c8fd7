"""Deterministic, seeded fault injection.

Counterpart of ``paddle_tpu/testing/faults.py``: the same grammar, sites,
schedules and seeds, so one spec fires at the same checks in both
packages. A one-line ``FLAGS_fault_inject`` spec arms named *sites*, and an
armed site raises :class:`InjectedFault` on a deterministic schedule; the
serving engine's replay recovery, the fleet's replica-loss handling and
``Model.fit``'s step recovery run against it.

Spec grammar (``;``-separated site specs, ``:``-separated params)::

    FLAGS_fault_inject="decode_dispatch:every=5;prefill:p=0.1:seed=7"

    site-spec ::= site (':' param)*
    param     ::= 'every=N'   fire on every N-th check (counted per
                              bound site instance)
                | 'p=F'       fire each check with probability F from a
                              dedicated random.Random stream
                | 'seed=N'    the p= stream's seed (default: a stable
                              digest of the site name)
                | 'times=N'   stop after N fires (default: unlimited)
                | 'after=N'   ignore the first N checks

Sites (KNOWN_SITES; an unknown site in the spec is a construction-time
``ValueError``). The port checks these:

    prefill             ServingEngine whole-prompt prefill (post-detach)
    chunk_prefill       ServingEngine chunk dispatch (post-detach)
    decode_dispatch     ServingEngine decode dispatch (post-detach)
    bucket_migrate      ServingEngine bucket-ladder migration (checked at
                        begin, per compacted sequence and at commit)
    preempt             ServingEngine SLO preemption, before a victim is
                        unseated
    kv_spill            PrefixCache host tier, before each page spill and
                        each page restore (ctx carries op="spill"/"restore")
    program_build       decode program cache, before a build
    router_dispatch     FleetRouter, before a replica steps (a fire loses
                        the replica)
    spec_draft          ServingEngine speculative round, before the draft
                        scan and each draft sync chunk (ctx op="draft" /
                        "sync")
    spec_verify         ServingEngine speculative round, before the verify
    train_dispatch      TrainStep.__call__, before any parameter, gradient
                        or scheduler state moves
    train_sync          TrainStep.sync / pull_metrics, before the in-flight
                        window changes
    checkpoint_save     framework.save, before anything touches the disk
                        (process-shared: checked through :func:`check`)
    dataloader_worker   DataLoader process worker, before each batch (ctx
                        batch=index): a fire flushes the result queue and
                        exits the worker (``os._exit(3)``), the death the
                        loader's restarts recover from; each worker binds
                        its own site, so ``every=N`` counts a worker's
                        batches

Binding: call :func:`site` at construction time and keep the handle. With
``FLAGS_fault_inject`` unset (the default) :func:`site` returns the shared
:data:`NULL_SITE` stub and the hot path pays one no-op method call. A flag
set after a component was built does not arm it (rebuild it).

Each :func:`site` call returns a fresh ``FaultSite`` with its own call
counter and random stream, so one component's schedule never depends on
another's. Every fire increments the ``faults_injected{site=...}`` counter.
"""

from __future__ import annotations

import contextlib
import random
import threading
import zlib
from typing import Any, Dict, Optional

__all__ = [
    "InjectedFault", "FaultSite", "NULL_SITE", "KNOWN_SITES",
    "parse_spec", "active_spec", "enabled", "site", "check", "reset",
    "armed",
]

KNOWN_SITES = frozenset({
    "prefill", "chunk_prefill", "decode_dispatch", "bucket_migrate",
    "preempt", "kv_spill", "router_dispatch", "spec_draft", "spec_verify",
    "program_build", "train_dispatch", "train_sync", "dataloader_worker",
    "checkpoint_save",
})


class InjectedFault(RuntimeError):
    """The deterministic failure an armed site raises. Carries the site
    name and the 1-based check index so a log line identifies the exact
    schedule point that fired."""

    def __init__(self, site_name: str, call_index: int,
                 ctx: Optional[Dict[str, Any]] = None):
        self.site = site_name
        self.call_index = call_index
        self.ctx = dict(ctx or {})
        extra = f", {self.ctx}" if self.ctx else ""
        super().__init__(
            f"injected fault at site '{site_name}' "
            f"(check #{call_index}{extra})")


class SiteSpec:
    """One parsed site entry of the ``FLAGS_fault_inject`` grammar."""

    __slots__ = ("name", "every", "p", "seed", "times", "after")

    def __init__(self, name: str, every: Optional[int] = None,
                 p: Optional[float] = None, seed: Optional[int] = None,
                 times: Optional[int] = None, after: int = 0):
        if name not in KNOWN_SITES:
            raise ValueError(
                f"FLAGS_fault_inject: unknown site {name!r} "
                f"(known: {sorted(KNOWN_SITES)})")
        if (every is None) == (p is None):
            raise ValueError(
                f"FLAGS_fault_inject site {name!r} needs exactly one of "
                f"'every=N' or 'p=F'")
        if every is not None and every < 1:
            raise ValueError(f"site {name!r}: every must be >= 1")
        if p is not None and not (0.0 < p <= 1.0):
            raise ValueError(f"site {name!r}: p must be in (0, 1]")
        self.name = name
        self.every = every
        self.p = p
        # stable per-site default seed: runs reproduce without a seed
        self.seed = seed if seed is not None else zlib.crc32(name.encode())
        self.times = times
        self.after = max(0, after)

    def __repr__(self) -> str:
        mode = (f"every={self.every}" if self.every is not None
                else f"p={self.p}:seed={self.seed}")
        tail = "".join(
            [f":times={self.times}" if self.times is not None else "",
             f":after={self.after}" if self.after else ""])
        return f"{self.name}:{mode}{tail}"


def parse_spec(text: str) -> Dict[str, SiteSpec]:
    """Parse a full ``FLAGS_fault_inject`` value. Empty/whitespace text
    parses to ``{}`` (disabled); malformed text raises ``ValueError``
    at parse (= component construction) time, never mid-run."""
    out: Dict[str, SiteSpec] = {}
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = [p.strip() for p in entry.split(":")]
        name, params = parts[0], parts[1:]
        kw: Dict[str, Any] = {}
        for p in params:
            if "=" not in p:
                raise ValueError(
                    f"FLAGS_fault_inject: malformed param {p!r} in "
                    f"{entry!r} (want key=value)")
            key, _, val = p.partition("=")
            key = key.strip()
            val = val.strip()
            try:
                if key == "every":
                    kw["every"] = int(val)
                elif key == "p":
                    kw["p"] = float(val)
                elif key == "seed":
                    kw["seed"] = int(val)
                elif key == "times":
                    kw["times"] = int(val)
                elif key == "after":
                    kw["after"] = int(val)
                else:
                    raise ValueError(
                        f"FLAGS_fault_inject: unknown param {key!r} in "
                        f"{entry!r} (want every/p/seed/times/after)")
            except ValueError as e:
                if "FLAGS_fault_inject" in str(e):
                    raise
                raise ValueError(
                    f"FLAGS_fault_inject: bad value for {key!r} in "
                    f"{entry!r}: {val!r}") from None
        if name in out:
            raise ValueError(
                f"FLAGS_fault_inject: site {name!r} listed twice")
        out[name] = SiteSpec(name, **kw)
    return out


class FaultSite:
    """One armed injection point: a call counter plus the schedule from
    its :class:`SiteSpec`. ``check()`` either returns or raises
    :class:`InjectedFault`; it never partially mutates caller state."""

    armed = True

    __slots__ = ("name", "every", "p", "times", "after",
                 "calls", "fires", "_rng", "_m")

    def __init__(self, spec: SiteSpec):
        self.name = spec.name
        self.every = spec.every
        self.p = spec.p
        self.times = spec.times
        self.after = spec.after
        self.calls = 0
        self.fires = 0
        self._rng = (random.Random(spec.seed)
                     if spec.p is not None else None)
        from .. import observability as obs
        self._m = (obs.registry().counter(
            "faults_injected",
            "deterministic faults fired by FLAGS_fault_inject sites",
            labels=("site",)).labels(site=spec.name)
            if obs.enabled() else obs.NULL)

    def check(self, **ctx) -> None:
        """Count one pass through the site; raise when the schedule says
        so. ``ctx`` only decorates the exception message — hot paths
        pass nothing."""
        self.calls += 1
        if self.calls <= self.after:
            return
        if self.times is not None and self.fires >= self.times:
            return
        if self.every is not None:
            fire = (self.calls - self.after) % self.every == 0
        else:
            fire = self._rng.random() < self.p
        if fire:
            self.fires += 1
            self._m.inc()
            raise InjectedFault(self.name, self.calls, ctx)


class _NullSite:
    """Disabled binding: one no-op method call, nothing else."""

    armed = False
    __slots__ = ()

    def check(self, **ctx) -> None:
        return


NULL_SITE = _NullSite()

_LOCK = threading.Lock()
_PARSE_CACHE: Dict[str, Dict[str, SiteSpec]] = {}
# long-lived shared sites for module-level functions (checkpoint save):
# keyed by (spec text, site) so a flag change re-arms on next use
_SHARED: Dict[tuple, FaultSite] = {}


def _spec_text() -> str:
    from .. import flags
    return str(flags.get_flag("fault_inject")).strip()


def active_spec() -> Dict[str, SiteSpec]:
    """The parsed current spec (``{}`` when disabled). Parsing is cached
    per distinct flag string."""
    text = _spec_text()
    if not text:
        return {}
    with _LOCK:
        spec = _PARSE_CACHE.get(text)
        if spec is None:
            spec = _PARSE_CACHE[text] = parse_spec(text)
        return spec


def enabled() -> bool:
    return bool(active_spec())


def site(name: str):
    """Resolve an injection site at component-construction time. Returns
    a fresh armed :class:`FaultSite` (own counter + RNG stream) when the
    current spec names ``name``; the shared :data:`NULL_SITE` no-op stub
    otherwise. Unknown names raise ``ValueError`` — a typo'd site must
    fail loudly, not silently never fire."""
    if name not in KNOWN_SITES:
        raise ValueError(
            f"unknown fault site {name!r} (known: {sorted(KNOWN_SITES)})")
    spec = active_spec().get(name)
    if spec is None:
        return NULL_SITE
    return FaultSite(spec)


def check(name: str, **ctx) -> None:
    """Convenience for module-level functions with no construction
    moment (checkpoint save): checks a process-shared site instance so
    ``every=N`` schedules count across calls. Not for hot paths — it
    resolves the flag per call."""
    text = _spec_text()
    if not text:
        return
    key = (text, name)
    with _LOCK:
        shared = _SHARED.get(key)
    if shared is None:
        shared = site(name)
        if not shared.armed:
            return
        with _LOCK:
            shared = _SHARED.setdefault(key, shared)
    shared.check(**ctx)


def reset() -> None:
    """Drop parse caches and shared site counters (tests). Components
    that bound sites at construction keep their bindings — rebuild them
    to re-arm, exactly like telemetry."""
    with _LOCK:
        _PARSE_CACHE.clear()
        _SHARED.clear()


@contextlib.contextmanager
def armed(spec: str, **extra_flags):
    """Scoped arming for tests and drills: set ``FLAGS_fault_inject``
    to ``spec`` (plus any extra flags, e.g. fast retry backoffs) for
    components CONSTRUCTED inside the block, then restore every flag to
    its previous value and :func:`reset` the shared sites. One helper
    everywhere beats per-suite arm/disarm lists that drift."""
    from .. import flags
    names = ["fault_inject"] + list(extra_flags)
    prev = {n: flags.get_flag(n) for n in names}
    flags.set_flags({"fault_inject": spec, **extra_flags})
    try:
        yield
    finally:
        flags.set_flags(prev)
        reset()
