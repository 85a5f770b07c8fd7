"""Cross-process transport checks for handoff bundles.

Counterpart of ``paddle_tpu/testing/transport.py``. A bundle that claims to
cross a process boundary (``ServingEngine.harvest_request``'s) must survive
``pickle`` -> spawn -> unpickle with every payload byte-identical. An
in-process handoff passes the bundle by reference and cannot catch a CUDA
tensor, a live alias or a bound callback riding in it; only a real process
boundary does, and ``multiprocessing``'s *spawn* context is the strictest
one (a fresh interpreter, no inherited memory).

- :func:`export_payload_digests` walks a bundle on the exporting side and
  digests every numpy array and CPU tensor leaf (sha256 over the raw
  bytes, through a ``uint8`` view, so bfloat16 digests too) into
  :class:`PayloadDigest` records; a CUDA tensor or a callable leaf is
  refused;
- :func:`_adopt_and_report` runs on the adopting side: unpickle the wire
  blob, digest again, wrap in a :class:`TransportReport`.

:func:`assert_bundle_transportable` drives both and fails on any drift;
:func:`adopt_and_decode_in_child` resumes the decode in the spawned child,
on the port's Llama rebuilt from a seed (prefill/decode disaggregation:
the continuation must be bit-identical to a solo run).
"""

from __future__ import annotations

import hashlib
import multiprocessing as mp
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

TRANSPORT_SCHEMA_VERSION = 1

# spawn-child budget: a cold torch import (and the card's start) on a
# loaded host
_CHILD_TIMEOUT_S = 300.0

__all__ = ["PayloadDigest", "TransportReport", "TRANSPORT_SCHEMA_VERSION",
           "export_payload_digests", "assert_bundle_transportable",
           "adopt_and_decode_in_child"]


@dataclass
class PayloadDigest:
    """Host-pure fingerprint of one array payload inside a bundle."""
    path: str                   # e.g. "bundle['pages'][0].k[0]"
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    sha256: str


@dataclass
class TransportReport:
    """What the adopting side of a process boundary received."""
    v: int
    n_arrays: int
    total_bytes: int
    digests: List[PayloadDigest] = field(default_factory=list)


def _digest(path: str, shape, dtype: str, raw: bytes) -> PayloadDigest:
    return PayloadDigest(path=path, shape=tuple(shape), dtype=dtype,
                         nbytes=len(raw),
                         sha256=hashlib.sha256(raw).hexdigest())


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """A CPU tensor's raw bytes (any dtype, bfloat16 included)."""
    flat = t.detach().contiguous().reshape(-1)
    return flat.view(torch.uint8).numpy().tobytes()


def _walk(obj: Any, path: str, out: List[PayloadDigest],
          seen: set) -> None:
    if obj is None or isinstance(obj, (bool, int, float, str, bytes,
                                       np.generic)):
        return
    marker = id(obj)
    if marker in seen:
        return
    seen.add(marker)
    if isinstance(obj, np.ndarray):
        out.append(_digest(path, obj.shape, str(obj.dtype),
                           np.ascontiguousarray(obj).tobytes()))
        return
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu":
            raise AssertionError(
                f"bundle leaf {path} is device-backed ({obj.device} "
                "tensor) — concretize (.cpu()/.item()) before export")
        out.append(_digest(path, obj.shape, str(obj.dtype),
                           _tensor_bytes(obj)))
        return
    tmod = type(obj).__module__ or ""
    if tmod == "jax" or tmod.startswith(("jax.", "jaxlib")):
        raise AssertionError(
            f"bundle leaf {path} is device-backed ({type(obj).__name__})"
            " — concretize (np.asarray/.item()) before export")
    if callable(obj) and not isinstance(obj, type):
        raise AssertionError(
            f"bundle leaf {path} is a callable "
            f"({type(obj).__name__}) — strip callbacks at export and "
            "re-bind via the engine registry on adopt")
    if isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            _walk(obj[k], f"{path}[{k!r}]", out, seen)
        return
    if isinstance(obj, (list, tuple, set, frozenset)):
        items = obj if isinstance(obj, (list, tuple)) else sorted(
            obj, key=repr)
        for i, item in enumerate(items):
            _walk(item, f"{path}[{i}]", out, seen)
        return
    slots = getattr(type(obj), "__slots__", None)
    if slots is not None:
        for name in slots:
            _walk(getattr(obj, name), f"{path}.{name}", out, seen)
        return
    attrs = getattr(obj, "__dict__", None)
    if attrs is not None:
        for name in sorted(attrs):
            _walk(attrs[name], f"{path}.{name}", out, seen)
    # any other leaf (enum, range, ...) is pickle's problem: the round
    # trip in assert_bundle_transportable still covers it


def export_payload_digests(bundle: Any) -> List[PayloadDigest]:
    """Exporter-side census: every numpy array and CPU tensor leaf in
    ``bundle``, digested. Rejects device-backed and callable leaves."""
    out: List[PayloadDigest] = []
    _walk(bundle, "bundle", out, set())
    return out


def _adopt_and_report(blob: bytes) -> TransportReport:
    """Adopter-side seam: unpickle the wire blob and report what arrived.
    Runs inside the spawned child."""
    digests = export_payload_digests(pickle.loads(blob))
    return TransportReport(v=TRANSPORT_SCHEMA_VERSION,
                           n_arrays=len(digests),
                           total_bytes=sum(d.nbytes for d in digests),
                           digests=digests)


# ----------------------------------------------------- spawn-child workers
# module level, so the spawn context imports them by qualified name;
# results travel back over a Pipe as ("ok", payload) / ("error", repr)
def _report_child(blob: bytes, conn) -> None:
    try:
        conn.send(("ok", _adopt_and_report(blob)))
    except Exception as exc:  # noqa: BLE001 — relayed, the parent raises
        conn.send(("error", repr(exc)))
    finally:
        conn.close()


def _decode_child(blob: bytes, model_kind: str, model_seed: int,
                  engine_kw: Dict[str, Any], device: str,
                  config: Optional[Dict[str, Any]], dtype: str,
                  conn) -> None:
    try:
        from paddle_tpu_torch.device import seed
        from paddle_tpu_torch.generation.serving import ServingEngine
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

        if model_kind != "llama":
            raise ValueError(f"unknown model_kind: {model_kind!r} (the "
                             "port serves Llama)")
        cfg = LlamaConfig(**config) if config else LlamaConfig.tiny()
        model = LlamaForCausalLM(cfg, device=device,
                                 dtype=getattr(torch, dtype),
                                 generator=seed(model_seed, device))
        eng = ServingEngine(model, **engine_kw)
        rid = eng.adopt_request(pickle.loads(blob))
        res = eng.run()
        conn.send(("ok", res[rid]))
    except Exception as exc:  # noqa: BLE001 — relayed, the parent raises
        conn.send(("error", repr(exc)))
    finally:
        conn.close()


def _run_child(target, args, timeout: float) -> Any:
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=target, args=args + (child,))
    proc.start()
    child.close()
    try:
        if not parent.poll(timeout):
            raise AssertionError(
                f"spawned child {target.__name__} produced nothing "
                f"within {timeout:.0f}s")
        status, payload = parent.recv()
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.terminate()
            proc.join()
        parent.close()
    if status != "ok":
        raise AssertionError(f"{target.__name__} failed in the spawned "
                             f"child: {payload}")
    return payload


# ------------------------------------------------------------ public API
def assert_bundle_transportable(bundle: Any,
                                timeout: float = _CHILD_TIMEOUT_S
                                ) -> TransportReport:
    """Round-trip ``bundle`` through pickle into a spawned child and back;
    every array payload must arrive byte-identical.

    Raises AssertionError on a device-backed or callable leaf, an
    unpicklable member, a failure in the child, or any digest drift
    (count, path, shape, dtype or sha256). Returns the child's
    :class:`TransportReport`."""
    local = export_payload_digests(bundle)
    try:
        blob = pickle.dumps(bundle, protocol=pickle.HIGHEST_PROTOCOL)
    except Exception as exc:
        raise AssertionError(
            f"bundle is not picklable: {exc!r} — a member class cannot "
            "cross a process boundary") from exc
    report = _run_child(_report_child, (blob,), timeout)
    if report.v != TRANSPORT_SCHEMA_VERSION:
        raise AssertionError(
            f"transport report version {report.v} != "
            f"{TRANSPORT_SCHEMA_VERSION}")
    mismatches: List[str] = []
    remote = {d.path: d for d in report.digests}
    for d in local:
        got: Optional[PayloadDigest] = remote.pop(d.path, None)
        if got is None:
            mismatches.append(f"{d.path}: lost in transit")
        elif (got.shape, got.dtype, got.sha256) != (d.shape, d.dtype,
                                                    d.sha256):
            mismatches.append(
                f"{d.path}: sent {d.dtype}{list(d.shape)} "
                f"{d.sha256[:12]}, received {got.dtype}"
                f"{list(got.shape)} {got.sha256[:12]}")
    mismatches += [f"{p}: materialized only on arrival" for p in remote]
    if mismatches:
        raise AssertionError(
            "bundle payloads drifted across the process boundary: "
            + "; ".join(sorted(mismatches)))
    return report


def adopt_and_decode_in_child(bundle: Any, model_kind: str = "llama",
                              model_seed: int = 91,
                              engine_kw: Optional[Dict[str, Any]] = None,
                              timeout: float = _CHILD_TIMEOUT_S, *,
                              device: Optional[str] = None,
                              config: Optional[Dict[str, Any]] = None,
                              dtype: str = "float32") -> List[int]:
    """Ship ``bundle`` to a spawned child that rebuilds the port's Llama
    (``LlamaConfig(**config)``, default the tiny one, in ``dtype``) on
    ``device`` (default ``cuda``; raises here when there is no card) from
    ``seed(model_seed, device)``, adopts the request into a
    ``ServingEngine(**engine_kw)`` and decodes it to the end. Returns the
    child's token stream; the caller holds it to a solo run of the same
    model."""
    dev = resolve_device(device)
    blob = pickle.dumps(bundle, protocol=pickle.HIGHEST_PROTOCOL)
    return _run_child(_decode_child,
                      (blob, model_kind, model_seed, dict(engine_kw or {}),
                       str(dev), dict(config) if config else None,
                       str(dtype)), timeout)
