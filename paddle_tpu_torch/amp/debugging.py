"""Numerics debugging (counterpart of ``paddle_tpu/amp/debugging.py``).

Three layers, as in the JAX package:

1. **Per-op checking.** While ``FLAGS_check_nan_inf`` is on (set through
   :func:`enable_tensor_checker` or ``flags.set_flags``), a
   ``TorchDispatchMode`` is installed on the thread that turned it on and
   checks the floating outputs of every ATen op (the autograd engine
   carries it into the backward): ``check_nan_inf_level`` 0 raises
   ``FloatingPointError`` naming the op, >= 1 warns and goes on. With
   ``TensorCheckerConfig(output_dir=...)`` every op also appends one JSONL
   line of output stats per floating output (NaN/Inf counts, min, max,
   mean, |mean|), the dump :func:`compare_accuracy` reads. With the flag
   off nothing is installed, so the ops pay nothing.
2. **Checked functions.** :func:`checked_jit` keeps the JAX package's name:
   it runs the function under the aborting check (there is no
   ``checkify``: the function is not compiled) and then checks its
   outputs; :func:`check_numerics` checks one tensor.
3. **Offline comparison.** :func:`compare_accuracy` aligns two stats dumps
   op by op (a bf16 run against an fp32 one) and writes a JSON report of
   the ops whose outputs diverge: the JAX function's report for the same
   two files.

Designed differences: op names are ATen's (``aten::mm``; the JAX package
names its own ops), so dumps align within one package. View ops
(``aten::t``, ``aten::view``, ...) and allocations (``aten::empty``: no
values yet) are not checked: the first op to write a non-finite value is
the one named. A hand-written kernel launched through ``ctypes`` is no
ATen op: its output is checked where the next op reads it. Nothing is
checked while a CUDA graph is being captured (a check reads the card) nor
on a graph's replay (it runs no Python).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import warnings
from typing import List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import flags

__all__ = [
    "DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
    "disable_tensor_checker", "record_op_stats", "check_numerics",
    "checked_jit", "compare_accuracy", "enable_operator_stats_collection",
    "disable_operator_stats_collection", "collect_operator_stats",
    "checker_installed",
]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


class _Dump:
    """The stats dump: one file for every thread (the backward's too)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.file = None
        self.seq = 0


_dump = _Dump()


def enable_operator_stats_collection():
    """The JAX package sets ``FLAGS_benchmark`` here, which nothing reads;
    this port has no such flag and does nothing."""


def disable_operator_stats_collection():
    """See :func:`enable_operator_stats_collection`."""


def _floats(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [(i, o) for i, o in enumerate(outs)
            if isinstance(o, torch.Tensor) and o.is_floating_point()]


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def record_op_stats(op_name: str, out) -> None:
    """Append one JSONL stats line per floating output of ``op_name`` when
    a dump is open (``TensorCheckerConfig(output_dir=...)``)."""
    if _dump.file is None:
        return
    for i, o in _floats(out):
        arr = o.detach().float().cpu().numpy()
        finite = arr[np.isfinite(arr)]
        dtype = str(o.dtype).replace("torch.", "")
        with _dump.lock:
            if _dump.file is None:
                return
            _dump.seq += 1
            _dump.file.write(json.dumps({
                "seq": _dump.seq, "op": op_name, "out": i,
                "shape": list(np.shape(arr)), "dtype": dtype,
                "num_nan": int(np.isnan(arr).sum()),
                "num_inf": int(np.isinf(arr).sum()),
                "min": float(finite.min()) if finite.size else None,
                "max": float(finite.max()) if finite.size else None,
                "mean": float(finite.mean()) if finite.size else None,
                "abs_mean": (float(np.abs(finite).mean()) if finite.size
                             else None),
            }) + "\n")


def _check_nan_inf(op_name: str, out, level: Optional[int]) -> None:
    """``FLAGS_check_nan_inf``'s check of one op's outputs (``level`` None
    reads ``check_nan_inf_level``)."""
    record_op_stats(op_name, out)
    for _, o in _floats(out):
        if not bool(torch.isfinite(o).all()):
            msg = f"Operator {op_name!r} output contains NaN or Inf."
            if level is None:
                level = int(flags.get_flag("check_nan_inf_level"))
            if level == 0:
                raise FloatingPointError(msg)
            warnings.warn(msg)
            return


# ops whose outputs hold no values yet (uninitialized memory): a kernel
# fills them later
_UNWRITTEN = frozenset({"aten::empty", "aten::empty_like",
                        "aten::empty_strided", "aten::empty_permuted",
                        "aten::new_empty", "aten::new_empty_strided",
                        "aten::resize_"})


class _NanInfMode(TorchDispatchMode):
    """Check every ATen op's floating outputs (views and allocations of
    uninitialized memory excepted)."""

    def __init__(self, level: Optional[int] = None):
        super().__init__()
        self.level = level

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (not func.is_view and func._schema.name not in _UNWRITTEN
                and not _capturing()):
            _check_nan_inf(func.name(), out, self.level)
        return out


_installed: Optional[_NanInfMode] = None


def checker_installed() -> bool:
    """Whether the per-op checker is installed (``FLAGS_check_nan_inf``)."""
    return _installed is not None


def _sync_checker(on) -> None:
    """Install the checker when the flag turns on, remove it when off."""
    global _installed
    if on and _installed is None:
        mode = _NanInfMode()
        mode.__enter__()
        _installed = mode
    elif not on and _installed is not None:
        mode, _installed = _installed, None
        mode.__exit__(None, None, None)


flags.on_change("check_nan_inf", _sync_checker)
_sync_checker(flags.get_flag("check_nan_inf"))


def enable_tensor_checker(checker_config=None):
    """Turn the per-op check on: abort (level 0) or, in another debug mode,
    warn (level 1) so a comparison run goes on past bad ops; with
    ``output_dir`` open ``op_stats.jsonl`` there."""
    mode = getattr(checker_config, "debug_mode",
                   DebugMode.CHECK_NAN_INF_AND_ABORT)
    abort = mode == DebugMode.CHECK_NAN_INF_AND_ABORT
    if checker_config is not None:
        out_dir = getattr(checker_config, "output_dir", None)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with _dump.lock:
                _dump.file = open(os.path.join(out_dir, "op_stats.jsonl"),
                                  "w")
                _dump.seq = 0
    flags.set_flags({"check_nan_inf": True,
                     "check_nan_inf_level": 0 if abort else 1})


def disable_tensor_checker():
    """Turn the per-op check off and close the dump."""
    flags.set_flags({"check_nan_inf": False, "check_nan_inf_level": 0})
    with _dump.lock:
        f, _dump.file = _dump.file, None
    if f is not None:
        f.close()


class TensorCheckerConfig:
    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """NaN/Inf check of one tensor: ``(n_nan, n_inf)`` as ints, raising
    ``FloatingPointError`` in the abort mode when either is non-zero.
    During a CUDA-graph capture it returns the counts as device tensors
    and checks nothing (the graph cannot read them back)."""
    t = torch.as_tensor(tensor)
    n_nan, n_inf = torch.isnan(t).sum(), torch.isinf(t).sum()
    if _capturing():
        return n_nan, n_inf
    n_nan, n_inf = int(n_nan), int(n_inf)
    if (n_nan or n_inf) and debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
        raise FloatingPointError(
            f"check_numerics: {op_type}:{var_name} has {n_nan} NaN, "
            f"{n_inf} Inf")
    return n_nan, n_inf


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)


def checked_jit(fn, errors=None):
    """``fn`` checked: each call runs it with every op's floating outputs
    checked (a non-finite value raises ``FloatingPointError`` naming the
    op), then checks its tensor outputs. ``errors`` is accepted for the
    JAX package's signature; only NaN/Inf are checked."""

    def call(*args, **kwargs):
        with _NanInfMode(level=0):
            out = fn(*args, **kwargs)
        for i, t in enumerate(_leaves(out)):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"checked_jit: output {i} of {getattr(fn, '__name__', fn)}"
                    f" contains NaN or Inf")
        return out

    return call


@contextlib.contextmanager
def collect_operator_stats():
    yield


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False,
                     atol=1e-3, rtol=1e-3):
    """Align two ``op_stats.jsonl`` dumps (a bf16 run against an fp32 run
    of the same model) op by op and write a JSON report of every op whose
    output stats diverge beyond tolerance or that produced NaN/Inf in one
    run only. Returns the divergent entries."""

    def load(p):
        path = p if p.endswith(".jsonl") else os.path.join(
            p, "op_stats.jsonl")
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    a, b = load(dump_path), load(another_dump_path)
    report: List[dict] = []
    n = min(len(a), len(b))
    for i in range(n):
        ra, rb = a[i], b[i]
        if ra["op"] != rb["op"] or ra["out"] != rb["out"]:
            report.append({"seq": ra["seq"], "issue": "op_mismatch",
                           "a": ra["op"], "b": rb["op"]})
            continue
        entry = {"seq": ra["seq"], "op": ra["op"], "out": ra["out"]}
        issues = []
        if (ra["num_nan"] > 0) != (rb["num_nan"] > 0) or \
           (ra["num_inf"] > 0) != (rb["num_inf"] > 0):
            issues.append("nan_inf_mismatch")
        for stat in ("mean", "abs_mean", "min", "max"):
            va, vb = ra.get(stat), rb.get(stat)
            if va is None or vb is None:
                continue
            if abs(va - vb) > atol + rtol * max(abs(va), abs(vb)):
                issues.append(f"{stat}_diverged")
        if issues:
            entry["issues"] = issues
            entry["a"] = {k: ra[k] for k in
                          ("num_nan", "num_inf", "mean", "min", "max")}
            entry["b"] = {k: rb[k] for k in
                          ("num_nan", "num_inf", "mean", "min", "max")}
            report.append(entry)
    if len(a) != len(b):
        report.append({"issue": "length_mismatch", "a_ops": len(a),
                       "b_ops": len(b)})
    with open(output_filename, "w") as f:
        json.dump({"compared_ops": n, "divergent": report}, f, indent=1)
    return report
