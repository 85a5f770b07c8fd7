"""The ZeRO plan of a sharded ``TrainStep`` (port only).

The reference declares each ZeRO stage as a layout: the spec of the
optimizer slots and masters (stage 1), the gradients (stage 2) and the
parameters (stage 3) gains the sharding axis
(:func:`~.group_sharded_utils.extend_spec_with_sharding`), and XLA inserts
the collectives. Here each rank is a process, so the plan makes the moves
explicit over the sharding group, cutting every tensor where the extended
spec cuts it: along the spec's dimension, this rank's part of its
mp-local tensor (a co-sharded ``("mp", "sharding")`` dimension is cut by
mp first, then each mp part by sharding, so it is the same part). A
parameter that no dimension divides is whole on every rank and updated
alike everywhere.

- Stage >= 1: the optimizer keeps the slots and the f32 master of this
  rank's slice only (``Optimizer._update`` reads :meth:`ZeroPlan.owned`)
  and updates that slice; the new values are all-gathered over the
  sharding group into the whole parameter (:meth:`gather_params`), so
  every rank holds the owner's rounding of a bf16 parameter.
- Stage >= 2: a gradient goes to its owner with one reduce-scatter over
  the sharding group (:meth:`reduce_grads`), then is summed over the other
  data axes; the slices live here, not in ``p.grad``.
- Stage 3: a parameter is stored as its slice. While the model's forward
  runs (a forward pre-hook on the model and on every module that owns a
  sliced parameter), reading such a parameter off its module returns it
  gathered over the sharding group by :class:`_Gather`, whose backward
  reduce-scatters the gradient to the slice. Each read gathers (a tied
  weight read twice is gathered twice), and a decoder layer recomputed
  under ``remat`` gathers its weights again in the backward. A gathered
  weight lives as long as autograd keeps it (until the backward); no
  module keeps one between steps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ....communication import collectives as C
from ....communication.group import Group
from ..parallel_layers.mp_layers import is_sharded


def all_gather_along(part: torch.Tensor, dim: int, group: Group
                     ) -> torch.Tensor:
    """Every rank's ``part`` of ``group``, concatenated along ``dim`` in
    the group's rank order."""
    parts: List[torch.Tensor] = []
    C.all_gather(parts, part.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_along(whole: torch.Tensor, dim: int, group: Group
                         ) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum of every rank's
    ``whole`` over ``group``."""
    chunks = [c.contiguous() for c in whole.chunk(group.nranks, dim=dim)]
    out = torch.empty_like(chunks[group.rank])
    C.reduce_scatter(out, chunks, group=group)
    return out


class _Gather(torch.autograd.Function):
    """A stage-3 slice gathered into its whole (mp-local) parameter; the
    backward reduce-scatters the whole's gradient back to the slice."""

    @staticmethod
    def forward(ctx, part, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_along(part, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_along(grad, ctx.dim, ctx.group), None, None


class _GatherOnRead(dict):
    """A module's ``_parameters`` under stage 3: reading a sliced
    parameter (``module.weight``) while the plan is active returns it
    gathered; otherwise, and for iteration (``named_parameters``,
    ``state_dict``), the slice itself."""

    def __init__(self, items, plan: "ZeroPlan"):
        super().__init__(items)
        self.plan = plan

    def __getitem__(self, name):
        p = dict.__getitem__(self, name)
        if self.plan.active and p is not None and p in self.plan.stored:
            return self.plan.gather(p)
        return p


class ZeroPlan:
    """What ZeRO makes of one rank's step.

    ``cuts`` maps each parameter the sharding axis cuts to the dimension of
    its (mp-local) tensor that the cut runs along; ``stored`` are the ones
    held as slices (stage 3, not excluded). ``group`` is the sharding
    group (more than one rank), ``rest`` the group over the data axes but
    the sharding one (None when there is none), ``data`` the group over
    every data axis. A sliced gradient is the sum over ``group`` and
    ``rest`` divided by both sizes (when the sharding axis is not a data
    axis its ranks computed the same gradient, so this is still the data
    mean); a whole one is averaged over ``data``."""

    def __init__(self, model: nn.Module, level: int,
                 cuts: Dict[nn.Parameter, int], stored, group: Group,
                 rest: Optional[Group], data: Optional[Group],
                 mp_group: Optional[Group] = None):
        self.level = level
        self.cuts = cuts
        self.stored = set(stored)
        self.group = group
        self.rest = rest if rest is not None and rest.nranks > 1 else None
        self.data = data
        self.mp_group = mp_group
        self.active = 0
        self._grads: Dict[nn.Parameter, torch.Tensor] = {}
        if self.stored:
            self._store_slices(model)
        model._zero_plan = self

    # ------------------------------------------------------------- layout
    def _part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        n = t.shape[dim] // self.group.nranks
        return t.narrow(dim, self.group.rank * n, n)

    def owned(self, p: nn.Parameter) -> torch.Tensor:
        """This rank's slice of ``p`` (a view of its data), which the
        optimizer updates; ``p`` itself when it is not cut or is stored
        as its slice."""
        if p in self.stored or p not in self.cuts:
            return p
        return self._part(p.data, self.cuts[p])

    def owned_grad(self, p: nn.Parameter, g: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole gradient of ``p`` (stage 1); a
        slice as it is."""
        if p in self.cuts and p not in self.stored and g.shape == p.shape:
            return self._part(g, self.cuts[p])
        return g

    def owned_state(self, p: nn.Parameter, t: torch.Tensor
                    ) -> Optional[torch.Tensor]:
        """This rank's slice of a slot or master ``t`` of ``p`` that comes
        as the update keeps it, as the whole mp-local tensor, or as the
        whole logical tensor ``save_group_sharded_model`` writes (cut by
        mp first, then by sharding); None for any other shape."""
        want = self.owned(p).shape
        local = list(p.shape)
        if p in self.stored:
            local[self.cuts[p]] *= self.group.nranks
        mp = self.mp_group
        if mp is not None and mp.nranks > 1 and is_sharded(p):
            ax, n = p.split_axis, local[p.split_axis]
            if list(t.shape) == local[:ax] + [n * mp.nranks] + local[ax + 1:]:
                t = t.narrow(ax, mp.rank * n, n)
        if p in self.cuts and t.shape != want and list(t.shape) == local:
            t = self._part(t, self.cuts[p])
        return t if t.shape == want else None

    def sliced_grad(self, p: nn.Parameter) -> bool:
        """Whether the gradient the update reads is a slice (stage >= 2),
        to be summed over the sharding group by the global-norm clip."""
        return self.level >= 2 and p in self.cuts

    def grad_like(self, p: nn.Parameter) -> torch.Tensor:
        """A tensor of the shape of ``p``'s gradient as the update reads
        it (gradient merge's buffer)."""
        return self.owned(p) if self.sliced_grad(p) else p

    # ---------------------------------------------------------- gradients
    def _mean(self, g: torch.Tensor, sliced: bool) -> None:
        if sliced:
            if self.rest is not None:
                C.all_reduce(g, group=self.rest)
            g.div_(self.group.nranks
                   * (1 if self.rest is None else self.rest.nranks))
        elif self.data is not None:
            C.all_reduce(g, group=self.data)
            g.div_(self.data.nranks)

    @torch.no_grad()
    def reduce_grads(self, params) -> None:
        """Each gradient averaged over the data ranks: at stage >= 2 a cut
        parameter's reduce-scattered to this rank's slice (at stage 3 the
        backward did so) and kept here; the rest all-reduced in place."""
        for p in params:
            if p.grad is None:
                continue
            if not self.sliced_grad(p):
                self._mean(p.grad, False)
            elif p in self.stored:
                self._mean(p.grad, True)
            else:
                g = reduce_scatter_along(p.grad, self.cuts[p], self.group)
                p.grad = None
                self._mean(g, True)
                self._grads[p] = g

    def params_grads(self, params) -> List[Tuple[nn.Parameter,
                                                 torch.Tensor]]:
        out = []
        for p in params:
            g = self._grads.get(p, p.grad)
            if g is not None:
                out.append((p, g))
        return out

    def set_grad(self, p: nn.Parameter, g: torch.Tensor) -> None:
        """Hold ``g`` as ``p``'s gradient where :meth:`params_grads` reads
        it."""
        if self.sliced_grad(p) and p not in self.stored:
            self._grads[p] = g
        else:
            p.grad = g

    def clear_grads(self) -> None:
        self._grads.clear()

    # --------------------------------------------------------- parameters
    @torch.no_grad()
    def gather_params(self) -> None:
        """After the update: each cut parameter stored whole (stages 1-2)
        rebuilt from every rank's updated slice."""
        for p, dim in self.cuts.items():
            if p not in self.stored:
                p.data.copy_(all_gather_along(self.owned(p), dim,
                                              self.group))

    @torch.no_grad()
    def whole(self, t: torch.Tensor, p: nn.Parameter) -> torch.Tensor:
        """``t`` (``p``, its gradient, a slot or its master) with the
        sharding cut undone when it holds the slice; an mp shard stays
        one."""
        if p in self.cuts and t.dim() and t.shape == self.owned(p).shape:
            return all_gather_along(t, self.cuts[p], self.group)
        return t

    # ------------------------------------------------------------ stage 3
    def gather(self, p: nn.Parameter) -> torch.Tensor:
        return _Gather.apply(p, self.cuts[p], self.group)

    def _enter(self, *_):
        self.active += 1

    def _leave(self, *_):
        self.active -= 1

    @torch.no_grad()
    def _store_slices(self, model: nn.Module) -> None:
        """Each stored parameter cut to its slice (the same ``Parameter``,
        its data replaced), its owner's ``_parameters`` gathering it on
        read, and the hooks that mark the forward (the model's, and each
        owner's for a forward recomputed in the backward)."""
        for p in self.stored:
            p.data = self._part(p.data, self.cuts[p]).clone()
        owners = [m for m in model.modules()
                  if any(q in self.stored for q in m._parameters.values())]
        for m in owners:
            m._parameters = _GatherOnRead(m._parameters, self)
        for m in owners if model in owners else [model] + owners:
            m.register_forward_pre_hook(self._enter)
            m.register_forward_hook(self._leave, always_call=True)
