"""Device-time summary of one traced call, shared by the port's profile
tools (``torch_serving_profile.py``, ``torch_train_profile.py``).

``window(name, fn, top, group=None)`` traces ``fn`` once with
``torch.profiler`` and sums the device's own events: kernels, copies and
memsets (one stream, so they do not overlap). Two kinds of row carry
device time that is counted already and are left out:
  - a CPU-side op such as ``aten::mm``, which also carries its kernels'
    time (it is not a device event);
  - a user-annotated range on the device timeline (for example
    ``Optimizer.step#AdamW.step``), which spans kernels of its own.
``card()`` is the card's name and power limit as ``nvidia-smi`` prints them.
"""

from __future__ import annotations

import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def window(name: str, fn, top: int, group=None) -> dict:
    """Trace ``fn`` once: host-clock wall ms (ending in a synchronise), the
    summed device ms, the idle share ``1 - device / wall``, the number of
    device events (``device_events``: kernels, copies, memsets), the
    ``top`` kernels by device time with their launch counts, and with
    ``group`` (kernel name -> group name) the device ms of each group.
    Device fields are None when the trace saw no device activity."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]
    out = dict(window=name, wall_ms=1e3 * wall, device_ms=None,
               idle_share=None, kernels=[])
    if group is not None:
        out["groups_ms"] = None
    if not rows:   # the trace saw no device activity: not measured
        return out
    device_ms = sum(us for _, us, _ in rows) / 1e3
    rows.sort(key=lambda r: -r[1])
    out.update(device_ms=device_ms, idle_share=1.0 - device_ms / out[
        "wall_ms"], device_events=sum(n for _, _, n in rows),
        kernels=[dict(name=k[:80], device_ms=us / 1e3, count=n)
                 for k, us, n in rows[:top]])
    if group is not None:
        groups: dict = {}
        for key, us, _ in rows:
            groups[group(key)] = groups.get(group(key), 0.0) + us / 1e3
        out["groups_ms"] = groups
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
