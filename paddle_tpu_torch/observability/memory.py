"""Memory watermarks: the card's allocator and the host process.

Counterpart of part of ``paddle_tpu/observability/memory.py``:
:func:`sample_device_memory` publishes the card's caching-allocator
watermarks (``torch.cuda.memory_stats``) under the JAX package's stat
names, and the host's peak RSS; :func:`section` is the ``"memory"`` section
a report embeds. The serving engine's live pool ledger rides the metrics
snapshot itself (``kv_pool_pages``/``kv_pool_bytes``).

The JAX package's compiled-program capture and its analytic estimator
are not part of this port yet, so :func:`section` lists no programs, and
the port defines no ``FLAGS_memwatch``, the flag that gates the capture.
"""

from __future__ import annotations

import resource
import sys
from typing import Any, Dict

import torch

__all__ = ["sample_device_memory", "section", "MEMWATCH_SCHEMA",
           "DEVICE_STATS"]

MEMWATCH_SCHEMA = 1

# the JAX package's stat name -> torch.cuda.memory_stats() key
DEVICE_STATS = {"bytes_in_use": "allocated_bytes.all.current",
                "peak_bytes_in_use": "allocated_bytes.all.peak",
                "bytes_reserved": "reserved_bytes.all.current",
                "peak_bytes_reserved": "reserved_bytes.all.peak"}


def sample_device_memory(publish: bool = True) -> Dict[str, Any]:
    """Each CUDA card's allocator watermarks (none without a card: the
    CPU reports nothing, as the JAX package's CPU backend does) and the
    host process's peak RSS. Publishes ``device_memory_bytes{device,stat}``
    and ``host_memory_bytes{stat}`` gauges when telemetry is on and returns
    the JSON-able sample either way."""
    out: Dict[str, Any] = {"devices": {}, "host": {}}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out["devices"][str(i)] = {name: int(stats.get(key, 0))
                                      for name, key in DEVICE_STATS.items()}
    ru = resource.getrusage(resource.RUSAGE_SELF)
    # linux reports ru_maxrss in KiB; darwin in bytes
    scale = 1 if sys.platform == "darwin" else 1024
    out["host"]["peak_rss"] = int(ru.ru_maxrss) * scale
    if publish:
        from . import enabled as _telemetry_on
        if _telemetry_on():
            from .metrics import registry
            r = registry()
            if out["devices"]:
                fam = r.gauge("device_memory_bytes",
                              "CUDA caching-allocator watermarks "
                              "(torch.cuda.memory_stats())",
                              labels=("device", "stat"))
                for dev, stats in out["devices"].items():
                    for k, v in stats.items():
                        fam.labels(device=dev, stat=k).set(float(v))
            fam = r.gauge("host_memory_bytes",
                          "host process memory watermarks",
                          labels=("stat",))
            for k, v in out["host"].items():
                fam.labels(stat=k).set(float(v))
    return out


def section() -> Dict[str, Any]:
    """The ``"memory"`` section a report embeds beside its telemetry
    snapshot: the schema, the captured programs (none: capture is not
    ported) and the device and host watermarks."""
    return {"schema": MEMWATCH_SCHEMA, "programs": [],
            "watermarks": sample_device_memory()}
