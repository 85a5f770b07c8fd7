"""Runtime telemetry: the metrics registry and span tracing.

Counterpart of ``paddle_tpu/observability``: a process-wide
:mod:`metrics <paddle_tpu_torch.observability.metrics>` registry (counters,
gauges, fixed-exponential-bucket histograms; JSON snapshot and Prometheus
text) and a :mod:`span tracer <paddle_tpu_torch.observability.tracing>`
(nested host-side timing events -> Chrome-trace JSON, mirrored into
``torch.profiler`` while a profiler session records).

Instrumented: ``generation.serving.ServingEngine`` (request lifecycle spans
and events, TTFT and inter-token histograms, queue, occupancy and KV-pool
gauges, recovery counters, prefix-cache counters) and
``generation.program_cache`` (hit, miss and trace counters, build-time
histograms). :mod:`memory <paddle_tpu_torch.observability.memory>` samples
the card's allocator watermarks.

Everything is gated behind ``FLAGS_telemetry`` (default on), resolved when
an instrumented object is built. Writes are host-side only: none runs
inside a captured CUDA graph (it would fire once at capture and never on
replay).

Usage::

    from paddle_tpu_torch import observability as obs

    reqs = obs.registry().counter("my_requests", "requests seen")
    lat = obs.registry().histogram("my_latency_seconds")
    with obs.span("handle", rid=7):
        ...
        lat.observe(dt)
    obs.registry().snapshot()          # JSON-able dict
    obs.to_prometheus()                # text exposition format
    obs.tracer().save("trace.json")    # open in chrome://tracing
"""

from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, LATENCY_BUCKETS,
                      MetricsRegistry, NULL, exponential_buckets, registry,
                      series_quantile)
from .tracing import (NULL_SPAN, Span, SpanTracer, null_counter, null_event,
                      null_span, tracer)
from .export import (chrome_trace, save_chrome_trace, save_snapshot,
                     to_prometheus)
from . import memory

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL",
    "LATENCY_BUCKETS", "exponential_buckets", "registry",
    "series_quantile", "Span", "SpanTracer", "NULL_SPAN", "tracer",
    "null_span", "null_event", "null_counter", "chrome_trace",
    "save_chrome_trace", "save_snapshot", "to_prometheus", "enabled",
    "span", "snapshot", "memory",
]


def enabled() -> bool:
    """Resolve ``FLAGS_telemetry``. Call at construction time and bind
    either real instruments or the ``NULL``/``null_span`` stubs, never per
    hot-path call (instrumented objects keep whichever binding they were
    built under; rebuild after toggling the flag)."""
    from .. import flags
    return bool(flags.get_flag("telemetry"))


def span(name: str, **args):
    """Scoped span honouring ``FLAGS_telemetry`` per call, for warm paths.
    Hot paths bind ``tracer().span`` instead."""
    if not enabled():
        return NULL_SPAN
    return tracer().span(name, **args)


def snapshot():
    """The live registry snapshot (JSON-able)."""
    return registry().snapshot()
