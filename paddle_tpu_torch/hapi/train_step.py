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
do.

With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` whose dimensions
bear the reference's axis names, e.g. ``HybridCommunicateGroup.get_mesh()``)
the step is this rank's part of a hybrid step (:class:`_MeshPlan`): each
parameter's spec (its ``dist_attr``, or ``param_spec_fn(name, param)``; a
tuple of axis names, tuples of them or None, as a ``PartitionSpec``) says
how it is cut; the model's annotated ``Linear`` and ``Embedding`` layers
become Megatron's layers holding this rank's shards
(``mp_layers.shard_layers``, which also sets the attention modules' local
head counts); the step takes this rank's rows of the global batch, split
over the product of ``data_axes`` (the first major, as
``P(("dp", "sharding"))``), averages the gradients over them, clips by the
norm of the logical parameters (``HybridParallelClipGrad``) and returns the
loss of the global batch. A Llama's vocab-parallel head computes the mean
over the global batch's tokens (the unmasked ones counted over the data
ranks), so it is the reference's mean whatever the ranks' counts of
ignored labels.

ZeRO: the level and the axis are the kwargs, else the stamps of the
``group_sharded_parallel`` / ``DygraphShardingOptimizer`` wrappers; an
axis of one rank falls back to ``sharding``, then ``dp``, and no axis means
level 0, as in the reference (and without a mesh the level is 0). At a
level above 0 each parameter's spec is extended as the reference extends
it (``extend_spec_with_sharding``) and the ZeRO plan
(``distributed/fleet/meta_parallel/sharding/zero.py``) cuts the optimizer
state (stage 1), the gradients (stage 2) and the parameters (stage 3)
there; ``param_specs`` / ``opt_specs`` name each parameter's and its
slots' specs. At one rank of the sharding axis the plan is empty and the
step is the plain one. An optimizer whose update is not elementwise
(``Lamb``, ``LarsMomentum``, ``DGCMomentum``) raises
``NotImplementedError`` at a level above 0. A parameter spec may name
``mp``, at level 3 the sharding axis, and a data axis for the stacks of an
MoE's ``Experts`` that declares it (``expert_axis``); another axis of more
than one rank raises ``NotImplementedError``: a model split over ``pp``
trains through ``PipelineTrainStep`` / ``PipelineParallel``
(``distributed/fleet/meta_parallel/pipeline_parallel.py``), and ``sep``
cuts activations, not parameters (``fleet.utils``'
``sep_scaled_dot_product_attention``).

Expert parallelism: the expert axis must be the data group (the only data
axis of more than one rank). Each rank keeps its ``E / P`` experts
(``Experts.take_slice``), and every MoE layer routes the global batch over
the data group. An expert slice's gradient already holds every rank's
tokens (the all-to-all's backward brought them), the gradient of the sum
of the ranks' losses, so it is divided by the data ranks instead of
averaged over them; the clip sums its squares over the expert group once.
A sharding level above 0 with expert slices raises
``NotImplementedError``.

LocalSGD (``localsgd_k > 1``, or ``strategy.localsgd`` with ``k_steps`` and
``begin_step`` on a fleet-wrapped optimizer): the reference's scope. It
needs a mesh whose ``dp`` has more than one rank (``ValueError``), refuses
gradient accumulation, a sharding level and a sharded parameter
(``NotImplementedError``) and gradient merge (``ValueError``). Each dp rank
updates its own replica from its own rows with no gradient all-reduce; the
parameters alone are averaged over dp when the step count (from 1) is
below ``begin_step`` or a multiple of k; the returned loss is the mean of
the ranks' losses. ``strategy.gradient_merge`` turns gradient merge on the
same way.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import flags
from ..convert import entry_axes
from ..device import resolve_device
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


def _on_mesh(spec, names) -> Tuple:
    """``spec`` with the axes not in ``names`` dropped, as the reference
    drops those the mesh lacks (a tuple entry left with one axis becomes
    that axis)."""
    out = []
    for e in spec or ():
        kept = tuple(a for a in entry_axes(e) if a in names)
        out.append(kept[0] if len(kept) == 1 else (kept or None))
    return tuple(out)


def _without(spec, axis) -> Tuple:
    """``spec`` with ``axis`` taken out of every entry."""
    return _on_mesh(spec, {a for e in spec for a in entry_axes(e)} - {axis})


def _mesh_device(mesh) -> torch.device:
    """The device of a ``DeviceMesh`` (raising without it, never falling
    back to the CPU)."""
    if not (hasattr(mesh, "device_type")
            and hasattr(mesh, "mesh_dim_names")):
        raise TypeError("TrainStep(mesh=...) takes a torch.distributed "
                        "DeviceMesh (HybridCommunicateGroup.get_mesh())")
    return resolve_device(mesh.device_type)


def _group_over(mesh, axes):
    """The group over the product of ``axes`` (those with more than one
    rank): None without one, the mesh's own group for one, else a group
    made on every rank, in the same order, for each coordinate of the
    other axes (``new_group`` is collective)."""
    from ..distributed.communication.group import (from_process_group,
                                                   new_group)
    from ..distributed.fleet.meta_parallel.sharding import mesh_sizes
    sizes = mesh_sizes(mesh)
    live = [a for a in axes if sizes[a] > 1]
    if not live:
        return None
    if len(live) == 1:
        return from_process_group(mesh.get_group(live[0]))
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in live]
    other = [i for i in range(len(names)) if i not in dims]
    grid = mesh.mesh.permute(*other, *dims).reshape(
        -1, math.prod(sizes[a] for a in live))
    mine = None
    for ranks in grid.tolist():
        g = new_group(ranks)
        if g.is_member():
            mine = g
    return mine


class _MeshPlan:
    """What a mesh makes of the step on this rank: the data group (over
    the product of the data axes) and this rank's rows of a global batch,
    the model-parallel group, the model's layers swapped for their shards,
    and at a sharding level the ZeRO plan, each parameter cut where the
    reference's extended spec cuts it. Under LocalSGD the data ranks are
    replicas that average only their parameters, now and then."""

    MP_AXIS = "mp"

    def __init__(self, model, optimizer, mesh, param_spec_fn, data_axes,
                 level=0, axis=None, exclude_ids=(), localsgd=False):
        from ..distributed.communication.group import from_process_group
        from ..distributed.fleet.meta_optimizers.hybrid_parallel_optimizer \
            import hybrid_clip
        from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers \
            import shard_layers
        from ..distributed.fleet.meta_parallel.sharding import (
            ZeroPlan, extend_spec_with_sharding, mesh_sizes)
        dev = _mesh_device(mesh)
        if next(model.parameters()).device.type != dev.type:
            raise ValueError(f"TrainStep: the model is not on the mesh's "
                             f"{dev.type} device")
        sizes = mesh_sizes(mesh)
        names = tuple(sizes)
        mp = self.MP_AXIS

        data = [a for a in data_axes if a in names]
        self.data_group = _group_over(mesh, data)
        if self.data_group is None and data:
            self.data_group = from_process_group(mesh.get_group(data[0]))
        self.data_size = math.prod(sizes[a] for a in data)
        self.data_rank = 0
        for a in data:   # the first data axis major, as P(("dp", ...))
            self.data_rank = (self.data_rank * sizes[a]
                              + mesh.get_local_rank(a))
        self.mp_group = (from_process_group(mesh.get_group(mp))
                         if mp in names else None)
        self.localsgd = localsgd
        if optimizer.state:
            raise ValueError("TrainStep(mesh=...) cuts the parameters: "
                             "build it before the optimizer's first step")
        allowed = {mp} | ({axis} if level >= 3 else set())
        # an MoE's Experts declaring a data axis (expert parallelism)
        stacks = [m for m in model.modules() if hasattr(m, "take_slice")
                  and getattr(m, "expert_axis", None) in data]
        expert_of = {id(p): m.expert_axis for m in stacks
                     for p in m.parameters()}
        specs = {}
        for name, p in model.named_parameters():
            spec = (param_spec_fn(name, p) if param_spec_fn is not None
                    else getattr(p, "dist_attr", None))
            spec = _on_mesh(spec, names)
            for a in (a for e in spec for a in entry_axes(e)):
                if sizes[a] > 1 and a not in allowed \
                        and expert_of.get(id(p)) != a:
                    raise NotImplementedError(
                        f"{name}: spec {spec} shards over {a!r}; the step "
                        f"shards parameters over {mp!r}, at sharding "
                        f"level 3 the sharding axis, and an MoE's expert "
                        f"stacks over the data axis their Experts declare "
                        f"(a pipeline over 'pp' trains through "
                        f"PipelineTrainStep / PipelineParallel; 'sep' cuts "
                        f"activations through fleet.utils' "
                        f"sep_scaled_dot_product_attention)")
            if localsgd and any(e is not None for e in spec):
                raise NotImplementedError(
                    f"localsgd needs replicated parameters; {name!r} "
                    f"declares {spec}")
            specs[id(p)] = spec
        shard_layers(model, lambda n, p: _without(specs[id(p)], axis), mp,
                     self.mp_group)
        for p in model.parameters():
            # a column layer's bias, cut with its weight, unannotated
            if not specs[id(p)] and getattr(p, "dist_attr", None):
                specs[id(p)] = _on_mesh(p.dist_attr, names)
        for m in model.modules():
            if hasattr(type(m), "parallel_loss_groups"):
                m.parallel_loss_groups = (
                    self.mp_group, None if localsgd else self.data_group)
        self.expert_params = self._cut_experts(stacks, mesh, sizes, level)

        self.param_specs, self.opt_specs = {}, {}
        cuts, stored = {}, []
        for name, p in model.named_parameters():
            spec = specs[id(p)]
            self.param_specs[name] = self.opt_specs[name] = spec
            if not level:
                continue
            pad = spec + (None,) * (p.dim() - len(spec))
            shape = [n * (sizes[mp] if mp in entry_axes(e) else 1)
                     for n, e in zip(p.shape, pad)]
            ext = extend_spec_with_sharding(spec, shape, sizes, axis)
            self.opt_specs[name] = ext
            dim = next((d for d, e in enumerate(ext)
                        if axis in entry_axes(e)), None)
            if dim is None:
                continue
            if entry_axes(ext[dim])[-1] != axis:
                raise NotImplementedError(
                    f"{name}: spec {ext} cuts a dimension with {axis!r} "
                    f"major; the port cuts the sharding axis minor")
            cuts[p] = dim
            if level >= 3 and (id(p) not in exclude_ids or dim < len(spec)
                               and axis in entry_axes(spec[dim])):
                stored.append(p)
                self.param_specs[name] = ext
        self.zero = None
        sharding = None
        if level and sizes.get(axis, 1) > 1:
            sharding = from_process_group(mesh.get_group(axis))
            rest = (_group_over(mesh, [a for a in data if a != axis])
                    if axis in data else self.data_group)
            self.zero = ZeroPlan(model, level, cuts, stored, sharding, rest,
                                 self.data_group, self.mp_group)
            optimizer._zero = self.zero
        # at stage 1 the gradients are whole on every sharding rank
        experts = {id(p) for p in self.expert_params}
        hybrid_clip(optimizer, self.mp_group,
                    sharding if level >= 2 else None,
                    None if self.zero is None else self.zero.sliced_grad,
                    expert_group=self.data_group if experts else None,
                    expert=lambda p: id(p) in experts)

    def _cut_experts(self, stacks, mesh, sizes, level) -> list:
        """Each of ``stacks`` whose axis has more than one rank cut to this
        rank's experts; their parameters."""
        from ..distributed.communication.group import from_process_group
        out = []
        for m in stacks:
            ax = m.expert_axis
            if sizes[ax] <= 1:
                continue
            group = from_process_group(mesh.get_group(ax))
            if self.data_group is None \
                    or group.ranks != self.data_group.ranks:
                raise NotImplementedError(
                    f"expert parallelism over {ax!r} needs it to be the "
                    f"only data axis of more than one rank")
            if level:
                raise NotImplementedError(
                    "expert parallelism under a sharding level: ZeRO does "
                    "not cut expert slices")
            m.take_slice(group)
            out.extend(m.parameters())
        return out

    def rows(self, b):
        """This rank's rows of a global batch tensor."""
        if not isinstance(b, torch.Tensor) or self.data_size == 1:
            return b
        if b.shape[0] % self.data_size:
            raise ValueError(f"batch dim {b.shape[0]} not divisible by the "
                             f"{self.data_size} data-parallel ranks")
        return b.chunk(self.data_size, dim=0)[self.data_rank]

    def reduce(self, params, loss: torch.Tensor) -> torch.Tensor:
        """The gradients averaged over the data ranks (the ZeRO plan's
        reduction at a sharding level; none under LocalSGD); returns the
        loss averaged over them too."""
        from ..distributed.communication import collectives as C
        from ..distributed.fleet.meta_parallel.meta_parallel_base import \
            average_gradients
        if self.data_group is None:
            return loss
        if self.zero is not None:
            self.zero.reduce_grads(params)
        elif not self.localsgd:
            experts = {id(p) for p in self.expert_params}
            average_gradients([p for p in params if id(p) not in experts],
                              self.data_group)
            for p in self.expert_params:
                if p.grad is not None:
                    p.grad.div_(self.data_size)
        loss = loss.clone()
        C.all_reduce(loss, group=self.data_group)
        return loss / self.data_size if self.data_size > 1 else loss

    @torch.no_grad()
    def average(self, tensors) -> None:
        """Each tensor averaged over the data ranks, in place (LocalSGD's
        sync)."""
        from ..distributed.communication import collectives as C
        for t in tensors:
            C.all_reduce(t, group=self.data_group)
            t.div_(self.data_group.nranks)


def _resolve_sharding(level, axis, optimizer, model, mesh):
    """The ZeRO level and axis, as the reference resolves them: the
    kwargs, else the wrappers' stamps; an axis absent from the mesh or of
    one rank falls back to ``resolve_sharding_axis``; no axis, level 0."""
    from ..distributed.fleet.meta_parallel.sharding import (
        mesh_sizes, resolve_sharding_axis)
    sizes = mesh_sizes(mesh)
    if level is None:
        level = max(getattr(optimizer, "_group_sharded_level", 0),
                    getattr(model, "_group_sharded_level", 0))
    axis = (axis or getattr(optimizer, "_sharding_axis", None)
            or getattr(model, "_sharding_axis", None))
    if level and sizes.get(axis, 1) <= 1:
        axis = resolve_sharding_axis(sizes)
    if axis is None:
        level = 0
    return int(level), axis


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
        if param_spec_fn is not None and mesh is None:
            raise ValueError("TrainStep(param_spec_fn=...) needs a mesh")
        if int(grad_accum_steps) < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{grad_accum_steps}")
        # the strategy riding on a fleet-wrapped optimizer turns gradient
        # merge and LocalSGD on where the kwargs do not
        st = getattr(optimizer, "_strategy", None)
        if gradient_merge_k is None and getattr(st, "gradient_merge", False):
            gradient_merge_k = int(st.gradient_merge_configs.get("k_steps",
                                                                 1))
            gradient_merge_avg = bool(st.gradient_merge_configs.get("avg",
                                                                    True))
        self._lsgd_begin = 1
        if localsgd_k is None and getattr(st, "localsgd", False):
            localsgd_k = int(st.localsgd_configs.get("k_steps", 1))
            self._lsgd_begin = int(st.localsgd_configs.get("begin_step", 1))
        self.localsgd_k = max(1, int(localsgd_k or 1))
        self._lsgd_count = 0
        if self.localsgd_k > 1 and max(1, int(gradient_merge_k or 1)) > 1:
            raise ValueError("localsgd and gradient_merge are mutually "
                             "exclusive (as in the reference meta_optimizer "
                             "ordering)")
        self.model = model
        self._plan = None
        self.sharding_level, self.sharding_axis = 0, None
        if mesh is not None:
            from ..distributed.fleet.meta_parallel.sharding import (
                mesh_sizes, unwrap_optimizer)
            from ..distributed.sharding.group_sharded import unwrap_model
            _mesh_device(mesh)
            level, axis = _resolve_sharding(sharding_level, sharding_axis,
                                            optimizer, model, mesh)
            self.sharding_level, self.sharding_axis = level, axis
            if self.localsgd_k > 1:
                if mesh_sizes(mesh).get("dp", 1) <= 1:
                    raise ValueError("localsgd needs a mesh with a dp axis "
                                     "> 1")
                if int(grad_accum_steps) > 1 or level:
                    raise NotImplementedError(
                        "localsgd composes with plain DP only (reference "
                        "LocalSGDOptimizer has the same scope)")
            # the step itself averages the gradients over the data axes and
            # clips over the logical parameters: the wrappers' own
            # reductions stay off (DataParallel's hooks run under no_sync,
            # the optimizer wrappers' steps are their inner optimizer's)
            optimizer = unwrap_optimizer(optimizer)
            if level and not optimizer.elementwise:
                raise NotImplementedError(
                    f"{type(optimizer).__name__} under sharding level "
                    f"{level}: its update reads whole parameters, which a "
                    f"ZeRO rank does not hold (ROADMAP Queue 3, designed "
                    f"differences)")
            self._plan = _MeshPlan(
                unwrap_model(model), optimizer, mesh, param_spec_fn,
                data_axes, level, axis,
                getattr(model, "_sharding_exclude_ids", ()),
                self.localsgd_k > 1)
        elif self.localsgd_k > 1:
            raise ValueError("localsgd needs a mesh with a dp axis > 1")
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
        no_sync = getattr(self.model, "no_sync", None)
        with _switched_on(self._remat_units), \
                (no_sync() if self._plan is not None and no_sync
                 else contextlib.nullcontext()):
            for mb in self._micro_batches(batch):
                loss = self._loss_of(mb)
                (loss / n if n > 1 else loss).backward()
                total = (loss.detach() if total is None
                         else total + loss.detach())
        loss = total / n if n > 1 else total
        if self._plan is not None:
            loss = self._plan.reduce(self.optimizer._params(), loss)
        # under ZeRO stage 2 the plan holds the gradient slices
        held = (dict(self.optimizer._params_grads())
                if self.optimizer._zero is not None else {})
        grads = {k: held.get(p, p.grad)
                 for k, p in self.model.named_parameters()
                 if held.get(p, p.grad) is not None}
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
        if self.localsgd_k > 1:
            # the replicas' parameters averaged before begin_step and
            # every k-th step (the reference's count starts at 1)
            self._lsgd_count += 1
            if self._lsgd_count < self._lsgd_begin \
                    or self._lsgd_count % self.localsgd_k == 0:
                self._plan.average(p.data for p in self.model.parameters())
        if isinstance(self.optimizer._lr, LRScheduler):
            self.optimizer._lr.step()
        self.optimizer.clear_grad()

    @torch.no_grad()
    def _merge(self) -> None:
        params = [p for p in self.optimizer._params()]
        # under ZeRO stage 2 the buffer holds this rank's gradient slices
        zero = self.optimizer._zero
        if self._merge_buf is None:
            self._merge_buf = {
                p: torch.zeros_like(p if zero is None else zero.grad_like(p))
                for p in params}
        for p, g in self.optimizer._params_grads():
            self._merge_buf[p] += g.to(p.dtype)
        self._merge_count += 1
        if self._merge_count % self.gradient_merge_k:
            return
        k = self.gradient_merge_k
        for p in params:
            buf = self._merge_buf[p]
            g = buf / k if self.gradient_merge_avg else buf.clone()
            if zero is None:
                p.grad = g
            else:
                zero.set_grad(p, g)
        self.optimizer.step()
        for buf in self._merge_buf.values():
            buf.zero_()

    def stage(self, *batch) -> StagedBatch:
        """The batch's tensors on the model's device (copies from the host
        are ``non_blocking``; under a mesh, this rank's rows of them):
        ``__call__`` takes the result, so a prefetcher can stage batch N+1
        while the card runs step N."""
        dev = self.device
        if self._plan is not None:
            batch = tuple(self._plan.rows(b) for b in batch)
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
        (its reference-named slots, masters, step count and scheduler).
        Under ZeRO a rank's entries are its slices
        (``save_group_sharded_model`` gathers them). Under LocalSGD the
        parameters are the replicas' mean (collective), the value the next
        sync installs, as the reference's; the slots are this rank's."""
        sd: Dict[str, Any] = dict(self.model.state_dict())
        if self.localsgd_k > 1:
            names = {k for k, _ in self.model.named_parameters()}
            mean = {k: v.detach().clone() for k, v in sd.items()
                    if k in names}
            self._plan.average(mean.values())
            sd.update(mean)
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
