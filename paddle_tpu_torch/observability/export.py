"""Exporters over the registry snapshot / span ring.

Counterpart of ``paddle_tpu/observability/export.py``.

Two wire formats, both derived from the same JSON-able snapshot dict so
a saved snapshot and a live registry render identically:

  - :func:`to_prometheus` — Prometheus text exposition format
    (cumulative ``_bucket{le=...}`` histogram encoding);
  - :func:`chrome_trace` / :func:`save_chrome_trace` — the span ring as
    a Chrome-trace/Perfetto JSON object.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, Optional

from .metrics import registry
from .tracing import tracer

__all__ = ["to_prometheus", "chrome_trace", "save_chrome_trace",
           "save_snapshot"]


def _fmt_labels(labels: Dict[str, str], extra=()) -> str:
    pairs = [(k, str(v)) for k, v in sorted(labels.items())] + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_val(v: float) -> str:
    if v != v:                                  # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v)) if v != int(v) else str(int(v))


def to_prometheus(snapshot: Optional[Dict[str, Any]] = None) -> str:
    """Render a registry snapshot (default: the live process registry)
    as Prometheus text exposition format."""
    if snapshot is None:
        snapshot = registry().snapshot()
    lines = []
    for name, fam in sorted(snapshot.get("metrics", {}).items()):
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for s in fam.get("series", []):
            labels = s.get("labels", {})
            if fam["type"] == "histogram":
                cum = 0
                for upper, c in zip(s["buckets"], s["counts"]):
                    cum += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, [('le', _fmt_val(upper))])}"
                        f" {cum}")
                cum += s["counts"][len(s["buckets"])]
                lines.append(
                    f"{name}_bucket{_fmt_labels(labels, [('le', '+Inf')])}"
                    f" {cum}")
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} {_fmt_val(s['sum'])}")
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {s['count']}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels)} {_fmt_val(s['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def chrome_trace(events: Optional[Iterable[Dict[str, Any]]] = None
                 ) -> Dict[str, Any]:
    """Chrome-trace JSON object for ``events`` (default: the live span
    ring)."""
    if events is None:
        return tracer().chrome_trace()
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


def save_chrome_trace(path: str,
                      events: Optional[Iterable[Dict[str, Any]]] = None
                      ) -> None:
    with open(path, "w") as fh:
        json.dump(chrome_trace(events), fh)


def save_snapshot(path: str,
                  snapshot: Optional[Dict[str, Any]] = None) -> None:
    with open(path, "w") as fh:
        json.dump(snapshot if snapshot is not None
                  else registry().snapshot(), fh, indent=1)
