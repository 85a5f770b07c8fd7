"""Pipeline-parallel execution: ``PipelineTrainStep`` and
``PipelineParallel`` (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``).

The reference is one GSPMD program: its block region is stacked over the
``pp`` mesh axis, ``M + S - 1`` lockstep ticks run in a ``lax.scan``, a
``jnp.roll`` is its collective-permute and autodiff produces the backward
pipeline; the embedding and head run replicated on every device. Here,
as in upstream Paddle, each pipeline stage is a process holding only its
stage's entries (``PipelineLayer`` under a live topology); activations go
forward and their gradients back by explicit transfers over the ``pp``
group (``pp_utils/p2p_communication.py``), and each rank runs its own
schedule. The numerics are the contract, not the schedule: for the same
weights and batch each step's loss and the parameters are the
reference's.

The schedules. Each rank has an order of units F (a microbatch through a
virtual stage's entries), B (its backward) and, under ZBH1, W:

- ``"FThenB"``: all M forwards, then all backwards;
- ``"1F1B"`` (and ``"auto"``): ``S - s - 1`` warm-up forwards on stage
  s, then one forward and one backward alternately, then the cool-down
  backwards, so stage s holds at most ``S - s`` microbatches'
  activations; at ``V > 1`` Megatron's interleaved order over each
  rank's V chunks (virtual stage ``v S + s``; chunk v of rank S - 1 feeds
  chunk v + 1 of rank 0);
- ``"zbh1"``: the reference's zero-bubble table (``pipeline_zbh1.py``).

:func:`tick_table` runs the orders against each other (a unit starts at
the first tick after its inputs were produced) and every rank walks the
same table: at the end of each tick it sends what its unit produced and
receives what its neighbours' units produced for it, in one
``batch_isend_irecv`` (the shape meta first, on a link's first
activation of the step). Every transfer of a tick is matched within the
tick, so no order of blocking calls can deadlock under gloo or NCCL.

The step: this data rank's rows of the global batch (over ``dp`` and
``sharding``, as ``TrainStep(mesh=...)``), cut into M equal microbatches;
stage 0 feeds the inputs and stage S - 1 reads the labels and computes
each microbatch's loss, scaled by 1/M for its backward; gradients
accumulate over the microbatches. The tied weight's gradient is summed
over the ranks holding a copy (``PipelineLayer.shared_groups``), so the
copies update alike; then the gradients are averaged over the data ranks
through ``TrainStep``'s mesh plan (``hapi/train_step.py``
``_MeshPlan``), which also cuts the annotated layers into Megatron's and
runs ZeRO's plan at a sharding level. The global-norm clip sums the
squares of the logical parameters over mp (and the ZeRO slices) and then
over pp, the tied weight counted once, on the stage of its first use.
The loss, the mean of the microbatch losses on the last stage, is
broadcast over pp and averaged over the data ranks: every rank returns
the reference's loss. A column-parallel head (``tensor_parallel=True``)
gathers its logits over mp for ``loss_fn``, which takes whole logits as
the reference's does.

``remat`` (and ``PipelineLayer.recompute_interval``) checkpoints the
blocks with ``torch.utils.checkpoint``, the reference's memory control.
``abstract=True``, ``param_dtype`` and ``lower()`` lower StableHLO for a
simulated mesh in the reference and have no torch counterpart: they raise
``NotImplementedError``. ``donate`` changes nothing (the parameters are
updated in place).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ...communication import collectives as C
from ...communication.group import from_process_group
from .pp_layers import PipelineLayer, _SharedCall
from .pp_utils.p2p_communication import Wire

_SCHEDULES = ("auto", "1F1B", "FThenB", "zbh1")
Unit = Tuple[str, int, int]


# ------------------------------------------------------------- schedules
def _sequence(s: int, S: int, M: int, V: int, backward: bool
              ) -> List[Tuple[int, int]]:
    """Stage s's (virtual stage, microbatch) in compute order: microbatch
    groups of S through each chunk in turn (chunks reversed for the
    backward), Megatron's interleaved order; at V = 1 microbatch order."""
    out = []
    for k in range(M * V):
        g, r = divmod(k, S * V)
        v = r // S
        if backward:
            v = V - 1 - v
        out.append((v * S + s, g * S + r % S))
    return out


def unit_orders(S: int, M: int, V: int = 1, schedule: str = "1F1B",
                forward_only: bool = False) -> List[List[Unit]]:
    """Each stage's order of units ``(kind, virtual stage, microbatch)``
    under ``schedule`` (``"1F1B"`` / ``"auto"`` or ``"FThenB"``)."""
    orders = []
    for s in range(S):
        fw = [("F", c, m) for c, m in _sequence(s, S, M, V, False)]
        bw = [("B", c, m) for c, m in _sequence(s, S, M, V, True)]
        if forward_only:
            orders.append(fw)
            continue
        if schedule == "FThenB":
            orders.append(fw + bw)
            continue
        total = M * V
        if V == 1:
            warm = min(S - s - 1, total)
        elif M == S:
            warm = total
        else:
            warm = min((S - s - 1) * 2 + (V - 1) * S, total)
        order = fw[:warm]
        for i in range(total - warm):
            order += [fw[warm + i], bw[i]]
        orders.append(order + bw[total - warm:])
    return orders


def tick_table(orders: List[List[Unit]], S: int, V: int
               ) -> List[List[Optional[Unit]]]:
    """The stages' orders run against each other: at each tick every stage
    starts its next unit if what it needs was produced at an earlier tick
    (F needs the previous virtual stage's F, B its own F and the next
    virtual stage's B, W its own B), else idles that tick."""
    C = S * V
    done: Dict[Unit, int] = {}
    pos = [0] * S
    ticks: List[List[Optional[Unit]]] = []

    def ready(u, t):
        kind, c, m = u
        before = lambda key: done.get(key, t) < t  # noqa: E731
        if kind == "F":
            return c == 0 or before(("F", c - 1, m))
        if kind == "B":
            return before(("F", c, m)) and (c == C - 1
                                            or before(("B", c + 1, m)))
        return before(("B", c, m))

    while any(p < len(o) for p, o in zip(pos, orders)):
        t = len(ticks)
        row: List[Optional[Unit]] = [None] * S
        for s in range(S):
            if pos[s] < len(orders[s]) and ready(orders[s][pos[s]], t):
                row[s] = orders[s][pos[s]]
        if not any(row):
            raise RuntimeError(f"pipeline schedule stalls at tick {t}: "
                               f"{[o[p:p + 1] for o, p in zip(orders, pos)]}")
        for s, u in enumerate(row):
            if u is not None:
                done[u] = t
                pos[s] += 1
        ticks.append(row)
    return ticks


# ---------------------------------------------------------------- runner
class _Runner:
    """One rank's side of a tick table: the units of its virtual stages
    and the transfers at the end of each tick."""

    def __init__(self, pipe: PipelineLayer, S: int, stage: int, V: int,
                 group, device: torch.device, loss_fn: Callable,
                 remat: bool):
        self.pipe, self.S, self.stage, self.V = pipe, S, stage, V
        self.C = S * V
        self.wire = Wire(group, device) if S > 1 else None
        self.ranks = group.ranks if S > 1 else [None]
        if S > 1 and group.backend == "nccl":
            # a batch of p2p ops may open an NCCL group only if every rank
            # joins it: one collective opens it first
            C.all_reduce(torch.zeros(1, device=device), group=group)
        self.device = device
        self.loss_fn = loss_fn
        self.remat = remat or pipe.recompute_interval > 0
        self._leaves: Dict[int, List] = {}

    def _params(self, c) -> List[nn.Parameter]:
        seen, out = set(), []
        for _, fn in self.pipe.chunk_entries(c):
            mod = fn.layer if isinstance(fn, _SharedCall) else fn
            if isinstance(mod, nn.Module):
                for p in mod.parameters():
                    if p.requires_grad and id(p) not in seen:
                        seen.add(id(p))
                        out.append(p)
        return out

    def _leaf_modules(self, c) -> List[Tuple[nn.Module, List]]:
        """The modules of virtual stage ``c`` that own parameters, with
        them; a shared (tied) layer's are left out: a use through its
        ``forward_func`` reads its weight outside its own forward."""
        if c not in self._leaves:
            shared = {id(m) for layer in self.pipe.shared_layers.values()
                      for m in layer.modules()}
            out = []
            for _, fn in self.pipe.chunk_entries(c):
                if not isinstance(fn, nn.Module):
                    continue
                for m in fn.modules():
                    own = [p for p in m._parameters.values()
                           if p is not None and p.requires_grad]
                    if own and id(m) not in shared:
                        out.append((m, own))
            self._leaves[c] = out
        return self._leaves[c]

    @contextlib.contextmanager
    def _captured(self, c, on: bool):
        """While a forward runs: each leaf module's output, with its
        parameters (ZBH1's W takes their gradients from these)."""
        got: List[Tuple[List, torch.Tensor]] = []
        hooks = []
        if on:
            for m, own in self._leaf_modules(c):
                def hook(_m, _in, out, own=own):
                    if isinstance(out, torch.Tensor) and out.requires_grad:
                        got.append((own, out))
                hooks.append(m.register_forward_hook(hook))
        try:
            yield got
        finally:
            for h in hooks:
                h.remove()

    def _split_b(self, c, m, saved, grads):
        """ZBH1's B: one backward from the stage's output to its input and
        to each captured leaf output (the attention's backward runs here,
        once); returns the input's gradient (None on virtual stage 0)."""
        x, y, leaves = saved[(c, m)]
        dy = None if c == self.C - 1 else grads[(c, m)]
        ins = ([x] if c > 0 else []) + [out for _, out in leaves]
        if not ins:
            return None
        gs = torch.autograd.grad(y, ins, dy, retain_graph=True,
                                 allow_unused=True)
        saved[(c, m)] = (x, y, [(own, out, g) for (own, out), g in
                                zip(leaves, gs[1 if c > 0 else 0:])])
        return gs[0] if c > 0 else None

    def _split_w(self, c, m, saved, grads):
        """ZBH1's W: each leaf module's parameter gradients from its output
        gradient (its own backward node, e.g. a Linear's X^T dY); the
        other parameters (under remat, all) from the kept graph."""
        _, y, leaves = saved.pop((c, m))
        dy = None if c == self.C - 1 else grads.pop((c, m))
        done = set()
        for own, out, g in leaves:
            done.update(id(p) for p in own)
            if g is not None:
                torch.autograd.backward(out, g, inputs=own,
                                        retain_graph=True)
        rest = [p for p in self._params(c) if id(p) not in done]
        if rest:
            torch.autograd.backward(y, dy, inputs=rest)

    def _incoming(self, row) -> List[Tuple[str, Tuple[int, int], int]]:
        """What this stage receives at the end of a tick whose units are
        ``row``: ``(kind, (virtual stage, microbatch), source stage)``."""
        me, S, C = self.stage, self.S, self.C
        out = []
        for src in sorted({(me - 1) % S, (me + 1) % S} - {me}):
            u = row[src]
            if u is None:
                continue
            kind, c, m = u
            if kind == "F" and c + 1 < C and (c + 1) % S == me:
                out.append(("F", (c + 1, m), src))
            elif kind == "B" and c > 0 and (c - 1) % S == me:
                out.append(("B", (c - 1, m), src))
        return out

    def run(self, ticks, inputs, labels, M: int, train: bool = True,
            split: bool = False):
        """Walk ``ticks``: returns the sum of the microbatch losses (f32,
        on the last stage; None elsewhere) and, for a forward-only run
        without labels, the last stage's outputs by microbatch. ``split``
        runs B and W apart (ZBH1)."""
        me, C = self.stage, self.C
        acts: Dict[Tuple[int, int], torch.Tensor] = {}
        grads: Dict[Tuple[int, int], torch.Tensor] = {}
        saved: Dict[Tuple[int, int], Tuple[Any, Any]] = {}
        sent_meta, got_meta = set(), {}
        loss_sum, outputs = None, {}
        for row in ticks:
            sends = []
            u = row[me]
            if u is not None:
                kind, c, m = u
                if kind == "F":
                    x = inputs[m] if c == 0 else acts.pop((c, m))
                    if c > 0 and train:
                        x.requires_grad_(True)
                    capture = split and train and not self.remat
                    with torch.set_grad_enabled(train), \
                            self._captured(c, capture) as leaves:
                        y = self.pipe.run_entries(self.pipe.chunk_entries(c),
                                                  x, remat=self.remat)
                        if c == C - 1 and labels is not None:
                            loss = self.loss_fn(y, labels[m])
                            d = loss.detach().float()
                            loss_sum = d if loss_sum is None else loss_sum + d
                            y = loss / M
                    if c == C - 1 and labels is None:
                        outputs[m] = y.detach()
                    if train:
                        saved[(c, m)] = (x if c > 0 else None, y, leaves)
                    if c < C - 1:
                        sends.append(("F", y.detach(), (c + 1) % self.S,
                                      (c + 1, m)))
                elif kind == "B" and not split:
                    x, y, _ = saved.pop((c, m))
                    if c == C - 1:
                        torch.autograd.backward(y)
                    else:
                        torch.autograd.backward(y, grads.pop((c, m)))
                    if c > 0:
                        sends.append(("B", x.grad, (c - 1) % self.S,
                                      (c - 1, m)))
                elif kind == "B":
                    dx = self._split_b(c, m, saved, grads)
                    if c > 0:
                        sends.append(("B", dx, (c - 1) % self.S, (c - 1, m)))
                else:
                    self._split_w(c, m, saved, grads)
            self._transfer(row, sends, acts, grads, saved, sent_meta,
                           got_meta)
        return loss_sum, outputs

    def _transfer(self, row, sends, acts, grads, saved, sent_meta,
                  got_meta):
        """This tick's messages: local ones (one stage) put in place, the
        others sent and received in one batch, after the shape meta of a
        link's first activation."""
        incoming = self._incoming(row) if self.S > 1 else []
        if self.S == 1:
            for kind, t, _, key in sends:
                (acts if kind == "F" else grads)[key] = t.detach().clone()
            return
        meta_out = [(t, self.ranks[dst]) for kind, t, dst, _ in sends
                    if kind == "F" and dst not in sent_meta]
        meta_in = [src for kind, _, src in incoming
                   if kind == "F" and src not in got_meta]
        if meta_out or meta_in:
            for (_, t, dst, _) in (s for s in sends if s[0] == "F"):
                sent_meta.add(dst)
            got = self.wire.meta_exchange(
                meta_out, [self.ranks[s] for s in meta_in])
            got_meta.update(zip(meta_in, got))
        recvs = []
        for kind, key, src in incoming:
            if kind == "F":
                shape, dtype = got_meta[src]
            else:             # the gradient of what this stage sent
                y = saved[key][1]
                shape, dtype = y.shape, y.dtype
            buf = torch.empty(shape, dtype=dtype, device=self.device)
            (acts if kind == "F" else grads)[key] = buf
            recvs.append((buf, self.ranks[src]))
        self.wire.exchange([(t, self.ranks[dst]) for _, t, dst, _ in sends],
                           recvs)


# ------------------------------------------------------------------ step
class PipelineTrainStep:
    """One pipelined forward, backward and update on this rank's stage
    (the module docstring). The optimizer holds this stage's parameters
    (``parameters=pipe_layer.named_parameters()``); ``__call__(inputs,
    labels)`` takes the global batch and returns the global loss as a
    detached device tensor."""

    def __init__(self, pipe_layer: PipelineLayer, optimizer, mesh,
                 num_microbatches: int, loss_fn: Optional[Callable] = None,
                 remat: bool = True, donate: bool = True,
                 sharding_level: Optional[int] = None,
                 sharding_axis: Optional[str] = None,
                 virtual_pp_degree: int = 1, abstract: bool = False,
                 param_dtype=None, lowering_platform: str = "tpu",
                 schedule: str = "auto"):
        from ....hapi.train_step import (_MeshPlan, _mesh_device,
                                         _resolve_sharding)
        from ..meta_optimizers.hybrid_parallel_optimizer import hybrid_clip
        from .parallel_layers.mp_layers import ColumnParallelLinear
        from .sharding import mesh_sizes, unwrap_optimizer
        if abstract or param_dtype is not None:
            raise NotImplementedError(
                "abstract=True / param_dtype lower the step's StableHLO for "
                "a simulated mesh in the reference; a torch step has no "
                "such lowering (build the stage on the meta device to size "
                "it)")
        sizes = mesh_sizes(mesh)
        if "pp" not in sizes:
            raise ValueError("mesh has no 'pp' axis")
        if schedule not in _SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r}; one "
                             f"of {_SCHEDULES}")
        optimizer = unwrap_optimizer(optimizer)
        if schedule == "zbh1":
            if virtual_pp_degree != 1:
                raise NotImplementedError("zbh1 + interleaved VPP")
            level = (sharding_level
                     or getattr(optimizer, "_group_sharded_level", 0)
                     or getattr(pipe_layer, "_group_sharded_level", 0))
            if int(level or 0) >= 3:
                raise NotImplementedError(
                    "zbh1 + ZeRO stage 3: a W unit would gather the "
                    "stage's sliced parameters again outside its B; levels "
                    "1/2 compose, or use schedule='1F1B'")
        self.pipe_layer = pipe_layer
        self.optimizer = optimizer
        self.mesh = mesh
        self.S = sizes["pp"]
        self.M = int(num_microbatches)
        self.V = int(virtual_pp_degree)
        self.schedule = "1F1B" if schedule == "auto" else schedule
        if self.M < self.S:
            raise ValueError(
                f"accumulate_steps ({self.M}) must be >= pp degree ({self.S}) "
                "or the pipeline is mostly bubble")
        if self.V < 1:
            raise ValueError(f"virtual_pp_degree must be >= 1, got {self.V}")
        if self.V > 1 and self.M % self.S != 0:
            raise ValueError(
                f"interleaved schedule needs accumulate_steps ({self.M}) "
                f"divisible by pp degree ({self.S})")
        self.loss_fn = loss_fn or pipe_layer._loss_fn
        if self.loss_fn is None:
            raise ValueError("PipelineLayer needs a loss_fn for train_batch")
        start, end = pipe_layer.stack_region()
        if end - start < self.S * self.V:
            raise ValueError(
                f"stackable block region has {end - start} layers < "
                f"{self.S} stages x {self.V} virtual chunks")
        counts = pipe_layer.stage_block_counts() if self.V == 1 else None
        if schedule == "zbh1" and counts is not None \
                and len(set(counts)) > 1:
            raise NotImplementedError(
                f"zbh1 needs an even stage split; seg_method yields "
                f"per-stage block counts {counts} — use schedule='1F1B' or "
                f"an even seg_method")
        if pipe_layer.get_num_stages() != self.S:
            raise ValueError(f"PipelineLayer of {pipe_layer.get_num_stages()}"
                             f" stages on a mesh of pp = {self.S}")
        if pipe_layer.num_virtual_pipeline_stages != self.V and (
                self.S > 1 or self.V > 1):
            raise ValueError(
                f"virtual_pp_degree={self.V}: build the PipelineLayer with "
                f"num_virtual_pipeline_stages={self.V} (its placement is "
                f"fixed when it is built, on {pipe_layer.get_num_stages()} "
                f"stages)")
        dev = _mesh_device(mesh)
        level, axis = _resolve_sharding(sharding_level, sharding_axis,
                                        optimizer, pipe_layer, mesh)
        self.sharding_level, self.sharding_axis = level, axis
        if schedule == "zbh1":
            self._zbh1_scope(level, axis, sizes)
        self._plan = _MeshPlan(
            pipe_layer, optimizer, mesh, None, ("dp", "sharding"), level,
            axis, getattr(pipe_layer, "_sharding_exclude_ids", ()))
        last = pipe_layer.run_function[-1] if pipe_layer.run_function \
            else None
        if isinstance(last, ColumnParallelLinear) and self._is_last():
            last.gather_output = True
        self.stage = mesh.get_local_rank("pp")
        self.pp_group = from_process_group(mesh.get_group("pp"))
        # the tied copies' weights, summed over their group; counted once
        # by the clip, on the stage of the first use
        self._tied = []
        for key, group in pipe_layer.shared_groups.items():
            w = pipe_layer.shared_layers[key].get_parameter(
                pipe_layer.shared_weight_attrs[key])
            self._tied.append((w, group))
        copies = {id(p) for name, p in pipe_layer.named_parameters()
                  if name in pipe_layer.shared_aliases}
        hybrid_clip(optimizer, self._plan.mp_group,
                    self._plan.zero.group if level >= 2 and self._plan.zero
                    else None,
                    None if self._plan.zero is None
                    else self._plan.zero.sliced_grad,
                    pp_group=self.pp_group if self.S > 1 else None,
                    counted=(lambda p: id(p) not in copies) if copies
                    else None)
        self._runner = _Runner(pipe_layer, self.S, self.stage, self.V,
                               self.pp_group, dev, self.loss_fn, remat)
        if schedule == "zbh1":
            from .pipeline_zbh1 import zbh1_ticks
            self._ticks = zbh1_ticks(self.S, self.M)
        else:
            self._ticks = tick_table(
                unit_orders(self.S, self.M, self.V, self.schedule),
                self.S, self.V)
        self._step_count = 0

    def _is_last(self) -> bool:
        pipe = self.pipe_layer
        C = self.S * self.V
        return any(pipe.virtual_stage_of(i) == C - 1
                   for i in pipe.local_indices())

    def _zbh1_scope(self, level, axis, sizes) -> None:
        if level and axis != "dp":
            raise NotImplementedError(
                f"zbh1 + ZeRO over axis {axis!r}: the zero-bubble schedule "
                "shards optimizer state over 'dp' only — use a dp axis for "
                "sharding or schedule='1F1B'")
        from ....convert import entry_axes
        named = {a for _, p in self.pipe_layer.named_parameters()
                 for e in (getattr(p, "dist_attr", None) or ())
                 for a in entry_axes(e)}
        for ax, size in sizes.items():
            if size > 1 and ax not in {"pp", "dp"} | named:
                raise NotImplementedError(
                    f"zbh1: mesh axis {ax!r} (size {size}) is neither "
                    "pp/dp nor named by any param spec — the schedule "
                    "would replicate its work, not parallelize it; use "
                    "schedule='1F1B' or drop the axis")

    @property
    def device(self) -> torch.device:
        return self._runner.device

    def _microbatches(self, b) -> List[Any]:
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(b)
        b = self._plan.rows(b).to(self.device)
        if b.shape[0] % self.M:
            raise ValueError(f"{b.shape[0]} rows on this data rank do not "
                             f"split into {self.M} microbatches")
        return list(b.chunk(self.M, dim=0))

    def _global_loss(self, loss_sum) -> torch.Tensor:
        """The mean microbatch loss from the last stage on every stage."""
        loss = (loss_sum / self.M if loss_sum is not None
                else torch.zeros((), dtype=torch.float32,
                                 device=self.device))
        if self.S > 1:
            C.broadcast(loss, self.pp_group.ranks[-1], group=self.pp_group)
        return loss

    def forward_backward(self, inputs, labels) -> torch.Tensor:
        """This stage's schedule over the microbatches, then the tied sum
        and the data-parallel reduction of the gradients: returns the
        global loss; the gradients are left for the optimizer."""
        self.optimizer.clear_grad()
        loss_sum, _ = self._runner.run(
            self._ticks, self._microbatches(inputs),
            self._microbatches(labels), self.M,
            split=self.schedule == "zbh1")
        loss = self._global_loss(loss_sum)
        with torch.no_grad():
            for w, group in self._tied:
                if w.grad is None:
                    w.grad = torch.zeros_like(w)
                C.all_reduce(w.grad, group=group)
        return self._reduce(self.optimizer._params(), loss)

    def _reduce(self, params, loss):
        """The plan's data-parallel mean, skipped over one data rank (a
        gloo all-reduce of one rank still crosses the host)."""
        group = self._plan.data_group
        if group is None or group.nranks == 1:
            return loss
        return self._plan.reduce(params, loss)

    def __call__(self, inputs, labels) -> torch.Tensor:
        from ....optimizer.lr import LRScheduler
        loss = self.forward_backward(inputs, labels)
        self.optimizer.step()
        if isinstance(self.optimizer._lr, LRScheduler):
            self.optimizer._lr.step()
        self.optimizer.clear_grad()
        self._step_count += 1
        return loss

    @torch.no_grad()
    def evaluate(self, inputs, labels=None):
        """The pipelined forward alone: with ``labels`` the global mean
        loss on every rank; without, the last stage's outputs of this data
        rank's rows (None on the other stages)."""
        return _evaluate(self._runner, self.S, self.M, self.V,
                         self._microbatches, inputs, labels,
                         self._global_loss, self._reduce)

    # ------------------------------------------------------------- state
    def lower(self, *args, **kwargs):
        raise NotImplementedError(
            "lower() emits the reference's StableHLO for a simulated mesh; "
            "the torch step runs eagerly and has no lowering")

    def sync_to_model(self) -> None:
        """Nothing to write back: the stage's parameters live in the
        PipelineLayer."""

    def state_dict(self) -> Dict[str, Any]:
        """This stage's entries under their global names (``"{idx}.
        {rel}"``) and, under ``"@opt_state"``, the optimizer's state."""
        sd: Dict[str, Any] = dict(self.pipe_layer.state_dict())
        sd["@opt_state"] = self.optimizer.state_dict()
        return sd

    def set_state_dict(self, sd: Dict[str, Any]) -> None:
        sd = dict(sd)
        opt = sd.pop("@opt_state", None)
        _load_stage(self.pipe_layer, sd)
        if opt is not None:
            self.optimizer.set_state_dict(opt)

    def per_device_state_bytes(self) -> Dict[str, int]:
        """This rank's bytes of the training state: its stage's
        parameters, the optimizer's slots and f32 masters."""
        out = {"params": 0, "slots": 0, "master": 0}
        for p in self.pipe_layer.parameters():
            out["params"] += p.numel() * p.element_size()
        for st in self.optimizer.state.values():
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    key = "master" if k == "master" else "slots"
                    out[key] += v.numel() * v.element_size()
        out["total"] = out["params"] + out["slots"] + out["master"]
        return out


def _evaluate(runner, S, M, V, microbatches, inputs, labels, global_loss,
              reduce):
    ticks = tick_table(unit_orders(S, M, V, forward_only=True), S, V)
    lab = microbatches(labels) if labels is not None else None
    loss_sum, outs = runner.run(ticks, microbatches(inputs), lab, M,
                                train=False)
    if labels is not None:
        return reduce([], global_loss(loss_sum))
    if not outs:
        return None
    return torch.cat([outs[m] for m in range(M)], dim=0)


def _load_stage(pipe: PipelineLayer, sd: Dict[str, Any]) -> None:
    """The entries of ``sd`` that name this stage's parameters and buffers
    (a whole model's dict serves every stage); a missing one raises."""
    own = pipe.state_dict()
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"state_dict lacks this stage's {missing}")
    pipe.load_state_dict({k: sd[k] for k in own})


# -------------------------------------------------------------- facade
class PipelineParallel(nn.Module):
    """``fleet.distributed_model`` for ``pp_degree > 1`` (reference class
    of the same name): ``strategy.pipeline_configs`` gives
    ``accumulate_steps`` (M), ``micro_batch_size``,
    ``virtual_pp_degree`` and ``schedule_mode`` (``FThenB`` / ``1F1B``;
    ``zbh1`` too). ``train_batch`` builds a :class:`PipelineTrainStep`
    (with remat, as the reference's) on its first call."""

    def __init__(self, layers: PipelineLayer, hcg, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError(
                "PipelineParallel expects a PipelineLayer (reference: "
                "TypeError in pipeline_parallel.py __init__)")
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        pc = (strategy.pipeline_configs if strategy is not None else {})
        self.accumulate_steps = int(pc.get("accumulate_steps", 1))
        self.micro_batch_size = pc.get("micro_batch_size", None)
        self.virtual_pp_degree = int(pc.get("virtual_pp_degree", 1))
        self.schedule_mode = pc.get("schedule_mode", "1F1B")
        self._step: Optional[PipelineTrainStep] = None

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _ensure_step(self, optimizer) -> PipelineTrainStep:
        if self._step is None:
            layer_v = self._layers.num_virtual_pipeline_stages
            strat_v = self.virtual_pp_degree
            if layer_v > 1 and strat_v > 1 and layer_v != strat_v:
                raise ValueError(
                    f"conflicting virtual pipeline settings: PipelineLayer("
                    f"num_virtual_pipeline_stages={layer_v}) vs strategy "
                    f"pipeline_configs virtual_pp_degree={strat_v}")
            self._step = PipelineTrainStep(
                self._layers, optimizer, self._hcg.get_mesh(),
                self.accumulate_steps, remat=True,
                virtual_pp_degree=max(layer_v, strat_v),
                schedule=self.schedule_mode)
        return self._step

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """``data = [inputs, labels]`` for the global batch; the step cuts
        this data rank's rows into ``accumulate_steps`` microbatches."""
        if scaler is not None:
            raise NotImplementedError(
                "train_batch(scaler=...): the pipeline step takes no loss "
                "scaler (bf16 with f32 masters needs none)")
        inputs, labels = data
        step = self._ensure_step(optimizer)
        b = inputs.shape[0] if hasattr(inputs, "shape") else len(inputs)
        if b % step.M != 0:
            raise ValueError(
                f"global batch {b} not divisible by accumulate_steps {step.M}")
        if self.micro_batch_size is not None:
            expect = step.M * int(self.micro_batch_size)
            if b != expect:
                raise ValueError(
                    f"global batch {b} != accumulate_steps ({step.M}) x "
                    f"micro_batch_size ({self.micro_batch_size}) = {expect}")
        loss = step(inputs, labels)
        # the step advanced the optimizer's own scheduler; only step a
        # scheduler that is another object
        if lr_scheduler is not None \
                and lr_scheduler is not getattr(step.optimizer, "_lr", None):
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss: bool = True):
        """The pipelined forward on ``data = [inputs, labels]``: the global
        loss on every rank, or (``compute_loss=False``) the last stage's
        outputs of this data rank's rows (None on the other stages)."""
        inputs, labels = data
        step = self._step
        if step is None:
            step = _EvalOnly(self._layers, self._hcg, self.accumulate_steps,
                             self.virtual_pp_degree)
        self._layers.eval()
        try:
            return step.evaluate(inputs, labels if compute_loss else None)
        finally:
            self._layers.train()

    def state_dict(self, *a, **k):
        """This stage's entries under their global names."""
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd):
        _load_stage(self._layers, sd)

    load_state_dict = set_state_dict


class _EvalOnly:
    """The forward of a pipeline no step has trained yet: the step's rows
    (over ``dp`` x ``sharding``) and global loss, without its plan."""

    def __init__(self, pipe, hcg, M, V):
        from ....hapi.train_step import _group_over, _mesh_device
        mesh = hcg.get_mesh()
        self.S = hcg.get_pipe_parallel_world_size()
        self.M, self.V = int(M), max(int(V), pipe.num_virtual_pipeline_stages)
        self.pp_group = hcg.get_pipe_parallel_group()
        self.device = _mesh_device(mesh)
        self._data = _group_over(mesh, ["dp", "sharding"])
        self._runner = _Runner(pipe, self.S, hcg.get_stage_id(), self.V,
                               self.pp_group, self.device, pipe._loss_fn,
                               False)

    def evaluate(self, inputs, labels=None):
        data = self._data

        def rows(b):
            b = torch.as_tensor(b)
            if data is not None:
                b = b.chunk(data.nranks, dim=0)[data.rank]
            return list(b.to(self.device).chunk(self.M, dim=0))

        def reduce(_, loss):
            if data is not None:
                C.all_reduce(loss, group=data)
                loss = loss / data.nranks
            return loss

        return _evaluate(self._runner, self.S, self.M, self.V, rows, inputs,
                         labels, lambda s: PipelineTrainStep._global_loss(
                             self, s), reduce)
