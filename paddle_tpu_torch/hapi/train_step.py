"""The train step (counterpart of ``paddle_tpu/hapi/train_step.py``).

The JAX package compiles forward, backward and update into one jitted XLA
program. Here the step runs eagerly on the card: the model's forward and
autograd backward (attention on the flash kernels), gradient accumulation
over micro-batches, then the optimizer's clip and update and one scheduler
step. ``__call__`` never waits for the card: it returns the loss as a
detached device tensor and keeps it in an in-flight window; every
``metrics_every`` calls :meth:`pull_metrics` reads the loss dispatched that
many steps earlier (already computed, so the read barely waits), and
:meth:`sync` is the hard barrier. At most ``FLAGS_train_max_in_flight``
losses stay unread: an older one is read (a throttle) when it is not done.
``wait_s`` sums the host's time blocked in those reads.

Options of the reference that run here:
  - ``remat``: each decoder layer of the model (every module with a
    ``remat`` attribute, such as ``LlamaModel``) runs under non-reentrant
    ``torch.utils.checkpoint``, its activations recomputed in the
    backward. The reference checkpoints the whole loss inside its jitted
    program, where XLA schedules the recompute; in eager PyTorch that
    would save nothing, since the whole forward would run again at once;
  - ``gradient_merge_k`` / ``gradient_merge_avg``: each call adds its
    gradients to a buffer (in the parameters' dtype); every k-th call
    updates with the buffer (divided by k with ``avg``) and zeroes it. The
    scheduler steps every call, the optimizer's step count only on
    updates;
  - ``stage()``: a batch placed on the model's device ahead of its step.

Telemetry (``FLAGS_telemetry``, bound when the step is built), as in the
JAX package: ``train_syncs``, ``train_throttles``, ``train_step_traces``,
``train_in_flight``, ``train_metrics_staleness`` and ``train_pull_seconds``,
and the spans ``train.pull_metrics`` and ``train.sync``. The step is eager,
so a trace is the first step of each new batch signature (the shapes and
dtypes of the batch's tensors), which is when the jitted reference
retraces. Under memwatch that step is measured: ``program_memory_bytes``
and a program-table row of kind ``train_step`` (bucket: the batch's
leading dimension; extra ``gradient_merge`` under gradient merge), its
``temp`` the rise of ``torch.cuda.max_memory_allocated`` over the step on
the card (0 on the CPU).

Fault sites (``FLAGS_fault_inject``, bound when the step is built):
``train_dispatch`` at the top of ``__call__``, before any parameter,
gradient or scheduler state moves, and ``train_sync`` at the top of
:meth:`sync` and :meth:`pull_metrics`, before the window changes.

The parameters live in the model, so ``sync_to_model()`` has nothing to
do. Not ported (``NotImplementedError``): meshes and parameter specs, ZeRO
sharding levels and LocalSGD (the distributed runtime).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import flags
from .. import observability as obs
from ..optimizer.lr import LRScheduler
from ..optimizer.optimizer import Optimizer
from ..testing import faults


class _TrainTelemetry:
    """The train loop's registry handles, resolved once a TrainStep (the
    probes ``sync_count`` / ``trace_count`` stay the test surface; these
    mirror them onto the registry)."""

    enabled = True

    def __init__(self):
        r = obs.registry()
        self.span = obs.tracer().span
        self.syncs = r.counter(
            "train_syncs", "host-blocking loss pulls (pull_metrics/sync)")
        self.throttles = r.counter(
            "train_throttles",
            "hard in-flight-window blocks (0 in a healthy loop)")
        self.traces = r.counter(
            "train_step_traces",
            "first steps of a new batch signature (steady state: 1)")
        self.in_flight = r.gauge(
            "train_in_flight",
            "dispatched-but-unsynced steps in the async window")
        self.staleness = r.gauge(
            "train_metrics_staleness",
            "steps between the displayed loss and the newest dispatch")
        self.pull_seconds = r.histogram(
            "train_pull_seconds",
            "wall clock of host metric pulls (near-zero when the pulled "
            "loss was dispatched >= k steps ago)")


class _NullTrainTelemetry:
    enabled = False

    def __init__(self):
        self.span = obs.null_span
        self.syncs = self.throttles = self.traces = obs.NULL
        self.in_flight = self.staleness = self.pull_seconds = obs.NULL


def _refuse(what: str) -> None:
    raise NotImplementedError(f"TrainStep({what}) is not ported: the "
                              f"distributed runtime, a later slice")


class StagedBatch:
    """A batch already on the model's device, what :meth:`TrainStep.stage`
    returns and ``TrainStep.__call__`` takes."""

    __slots__ = ("vals",)

    def __init__(self, vals: Tuple[Any, ...]):
        self.vals = vals


def _remat_units(model):
    """The model's modules with a ``remat`` switch; a model without one
    cannot remat."""
    units = [m for m in model.modules() if hasattr(m, "remat")]
    if not units:
        raise NotImplementedError(
            f"TrainStep(remat=True): {type(model).__name__} has no module "
            f"with a 'remat' switch (LlamaModel has one)")
    return units


@contextlib.contextmanager
def _switched_on(units):
    """Each unit's ``remat`` on for the duration (the forward and backward
    of one step)."""
    for m in units:
        m.remat = True
    try:
        yield
    finally:
        for m in units:
            m.remat = False


class TrainStep:
    def __init__(self, model, optimizer: Optimizer,
                 loss_fn: Optional[Callable] = None, mesh=None,
                 param_spec_fn=None, data_axes: Tuple[str, ...] = ("dp",),
                 donate: bool = True, grad_accum_steps: int = 1,
                 fused_grad_accum: bool = True, remat: bool = False,
                 sharding_level: Optional[int] = None,
                 sharding_axis: Optional[str] = None,
                 gradient_merge_k: Optional[int] = None,
                 gradient_merge_avg: bool = True,
                 localsgd_k: Optional[int] = None, metrics_every: int = 0,
                 max_in_flight: Optional[int] = None):
        if mesh is not None or param_spec_fn is not None:
            _refuse("mesh / param_spec_fn")
        if sharding_level or sharding_axis is not None:
            _refuse("sharding_level / sharding_axis")
        if localsgd_k is not None and localsgd_k > 1:
            _refuse("localsgd_k > 1")
        if int(grad_accum_steps) < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{grad_accum_steps}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.grad_accum_steps = int(grad_accum_steps)
        self.remat = bool(remat)
        self._remat_units = _remat_units(model) if self.remat else []
        self.gradient_merge_k = max(1, int(gradient_merge_k or 1))
        self.gradient_merge_avg = gradient_merge_avg
        self._merge_buf: Optional[Dict[torch.Tensor, torch.Tensor]] = None
        self._merge_count = 0
        if max_in_flight is None:
            max_in_flight = flags.get_flag("train_max_in_flight")
        self.metrics_every = max(0, int(metrics_every))
        self.max_in_flight = max(1, int(max_in_flight))
        self._inflight: deque = deque()
        self.sync_count = 0
        self.throttle_count = 0
        self.wait_s = 0.0      # host seconds blocked on loss reads
        self.last_metrics: Optional[Dict[str, Any]] = None
        self._last_loss: Optional[float] = None
        self._step_count = 0
        self._m = (_TrainTelemetry() if obs.enabled()
                   else _NullTrainTelemetry())
        self._memwatch = obs.enabled() and obs.memory.enabled()
        self._memwatch_model_sig: Optional[str] = None
        # batch signatures stepped so far (a new one is a trace)
        self._signatures: set = set()
        self._f_dispatch = faults.site("train_dispatch")
        self._f_sync = faults.site("train_sync")

    @property
    def trace_count(self) -> int:
        """Batch signatures stepped so far: the retrace probe (a
        steady-state loop holds it at 1)."""
        return len(self._signatures)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ------------------------------------------------------------------ step
    def _loss_of(self, batch: Tuple[Any, ...]) -> torch.Tensor:
        if self.loss_fn is not None:
            return self.loss_fn(self.model(*batch[:-1]), batch[-1])
        return self.model(*batch)

    def _micro_batches(self, batch):
        n = self.grad_accum_steps
        if n == 1:
            return [batch]
        for b in batch:
            if b.shape[0] % n:
                raise ValueError(f"batch dim {b.shape[0]} not divisible by "
                                 f"grad_accum_steps={n}")
        chunks = [b.chunk(n, dim=0) for b in batch]
        return [tuple(c[i] for c in chunks) for i in range(n)]

    def compute_loss_grads(self, *batch
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward and backward over ``grad_accum_steps`` micro-batches,
        whose gradients average (under ``remat`` each decoder layer is
        recomputed in the backward). Leaves the gradients in ``p.grad``
        (any earlier ones are dropped first) and returns ``(loss,
        grads)``: the detached mean loss and ``{name: grad}``, before the
        clip."""
        self.optimizer.clear_grad()
        n = self.grad_accum_steps
        total = None
        with _switched_on(self._remat_units):
            for mb in self._micro_batches(batch):
                loss = self._loss_of(mb)
                (loss / n if n > 1 else loss).backward()
                total = (loss.detach() if total is None
                         else total + loss.detach())
        loss = total / n if n > 1 else total
        grads = {k: p.grad for k, p in self.model.named_parameters()
                 if p.grad is not None}
        return loss, grads

    def apply_update(self) -> None:
        """The optimizer's clip and update at ``optimizer.get_lr()``, one
        scheduler step, and the gradients cleared. Under gradient merge the
        gradients go to the buffer instead, and every k-th call updates
        with the buffer."""
        if self.gradient_merge_k > 1:
            self._merge()
        else:
            self.optimizer.step()
        if isinstance(self.optimizer._lr, LRScheduler):
            self.optimizer._lr.step()
        self.optimizer.clear_grad()

    @torch.no_grad()
    def _merge(self) -> None:
        params = [p for p in self.optimizer._params()]
        if self._merge_buf is None:
            self._merge_buf = {p: torch.zeros_like(p) for p in params}
        for p in params:
            if p.grad is not None:
                self._merge_buf[p] += p.grad.to(p.dtype)
        self._merge_count += 1
        if self._merge_count % self.gradient_merge_k:
            return
        k = self.gradient_merge_k
        for p in params:
            buf = self._merge_buf[p]
            p.grad = buf / k if self.gradient_merge_avg else buf.clone()
        self.optimizer.step()
        for buf in self._merge_buf.values():
            buf.zero_()

    def stage(self, *batch) -> StagedBatch:
        """The batch's tensors on the model's device (copies from the host
        are ``non_blocking``): ``__call__`` takes the result, so a
        prefetcher can stage batch N+1 while the card runs step N."""
        dev = self.device
        return StagedBatch(tuple(
            b.to(dev, non_blocking=True) if isinstance(b, torch.Tensor)
            else b for b in batch))

    def __call__(self, *batch) -> torch.Tensor:
        """One training step; returns the detached loss without a host
        sync. Takes a batch's tensors or one :class:`StagedBatch`."""
        # the injected failure fires before anything moves: a caller can
        # re-dispatch the same batch
        self._f_dispatch.check()
        if len(batch) == 1 and isinstance(batch[0], StagedBatch):
            vals = batch[0].vals
        else:
            vals = self.stage(*batch).vals
        sig = tuple((tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
                    else type(v) for v in vals)
        traced = sig not in self._signatures
        if traced and self._memwatch:
            loss = self._measured_step(vals)
        else:
            loss, _ = self.compute_loss_grads(*vals)
            self.apply_update()
        if traced:
            self._signatures.add(sig)
            self._m.traces.inc()
        self._step_count += 1
        done = None
        if loss.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._inflight.append((self._step_count - 1, loss, done))
        if self.metrics_every and self._step_count % self.metrics_every == 0:
            self.pull_metrics()
        while len(self._inflight) > self.max_in_flight:
            _, old, ev = self._inflight.popleft()
            if ev is not None and not ev.query():
                self._read(ev.synchronize)
                self.throttle_count += 1
                self._m.throttles.inc()
        # after the pull and the throttles: what is still outstanding
        self._m.in_flight.set(len(self._inflight))
        return loss

    def _measured_step(self, vals) -> torch.Tensor:
        """One step (the first of its batch signature) with memwatch's
        row: the parameters, the optimizer state and the batch read, the
        loss written, the parameters and the optimizer state updated in
        place; on the card ``temp`` is the rise of the allocator's peak
        over the step."""
        cuda = vals and isinstance(vals[0], torch.Tensor) \
            and vals[0].device.type == "cuda"
        base = 0
        if cuda:
            base = torch.cuda.memory_allocated(vals[0].device)
            torch.cuda.reset_peak_memory_stats(vals[0].device)
        loss, _ = self.compute_loss_grads(*vals)
        self.apply_update()
        temp = (torch.cuda.max_memory_allocated(vals[0].device) - base
                if cuda else 0)
        if self._memwatch_model_sig is None:
            from ..generation.program_cache import model_signature
            self._memwatch_model_sig = model_signature(self.model)[:8]
        state = (self.model, self.optimizer.state, self._merge_buf)
        first = next((v for v in vals if isinstance(v, torch.Tensor)), None)
        obs.memory.capture_program(
            "train_step", int(first.shape[0]) if first is not None else 0,
            ("gradient_merge",) if self.gradient_merge_k > 1 else (),
            lambda: obs.memory.stats_from_tensors(
                (state, vals), (loss, state), state, temp=temp),
            model=self._memwatch_model_sig)
        return loss

    def _read(self, fn):
        """``fn()``, its wall time added to ``wait_s``."""
        t0 = time.perf_counter()
        out = fn()
        self.wait_s += time.perf_counter() - t0
        return out

    # --------------------------------------------------------------- metrics
    def pull_metrics(self, lag: Optional[int] = None
                     ) -> Optional[Dict[str, Any]]:
        """Read the loss dispatched ``lag`` steps ago (default
        ``metrics_every``) on the host, dropping older unread ones: one
        host read of a loss normally computed already, so the shown loss
        is ``lag`` steps stale. Returns ``{"loss", "loss_step",
        "staleness"}``, or the previous metrics when no loss is that old
        yet."""
        # the injected failure fires before the window changes: a caller
        # can retry the pull as it was
        self._f_sync.check()
        lag = (self.metrics_every or 1) if lag is None else max(0, int(lag))
        target = self._step_count - lag
        picked = None
        while self._inflight and self._inflight[0][0] <= target:
            picked = self._inflight.popleft()
        if picked is None:
            return self.last_metrics
        idx, dev, _ = picked
        t0 = time.perf_counter()
        with self._m.span("train.pull_metrics", step=idx):
            val = self._read(lambda: float(dev))
        self.sync_count += 1
        self._last_loss = val
        self.last_metrics = {"loss": val, "loss_step": idx,
                             "staleness": self._step_count - 1 - idx}
        if self._m.enabled:
            self._m.syncs.inc()
            self._m.pull_seconds.observe(time.perf_counter() - t0)
            self._m.staleness.set(self.last_metrics["staleness"])
            self._m.in_flight.set(len(self._inflight))
        return self.last_metrics

    def sync(self) -> Optional[float]:
        """Hard barrier: wait for every dispatched step and return the
        latest loss."""
        self._f_sync.check()
        if self._inflight:
            idx, dev, _ = self._inflight[-1]
            self._inflight.clear()
            with self._m.span("train.sync", step=idx):
                self._last_loss = self._read(lambda: float(dev))
            self.sync_count += 1
            self.last_metrics = {"loss": self._last_loss, "loss_step": idx,
                                 "staleness": 0}
            if self._m.enabled:
                self._m.syncs.inc()
                self._m.staleness.set(0)
                self._m.in_flight.set(0)
        return self._last_loss

    # ------------------------------------------------------------- utilities
    def sync_to_model(self) -> None:
        """Nothing to write back: the parameters live in the model."""

    def state_dict(self) -> Dict[str, Any]:
        """The model's state and, under ``"@opt_state"``, the optimizer's
        (its reference-named slots, masters, step count and scheduler)."""
        sd: Dict[str, Any] = dict(self.model.state_dict())
        sd["@opt_state"] = self.optimizer.state_dict()
        return sd

    def set_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore what :meth:`state_dict` wrote (``"@opt_state"`` also as
        ``convert.optimizer_state_from_jax`` gives it)."""
        sd = dict(sd)
        opt = sd.pop("@opt_state", None)
        self.model.load_state_dict(sd)
        if opt is not None:
            self.optimizer.set_state_dict(opt)
