"""``MoELayer``: GShard-style static-capacity mixture of experts on one card
(counterpart of ``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

Routing is the JAX package's, step for step: top-k choices become one-hot
COMBINE ``(T, E, C)`` weights with a first-come-first-served position in
each expert (choice 0 of every token first), tokens past the capacity
dropped (combine 0: the residual carries them), and DISPATCH is the
constant support of combine. Token -> expert movement is one product
``td,tec->ecd``, expert -> token another ``ecd,tec->td``; the experts are
one stacked module (``Experts``: ``(E, d, h)`` / ``(E, h, d)`` weights, two
batched products) or a list of per-expert modules (``_ListExperts``).
Everything is plain PyTorch: the JAX package has no kernel here.

``jax.lax.top_k`` returns the lower expert index on a tie, and
``torch.topk`` promises no order, so the choices come from a stable
descending sort.

Across data-parallel ranks (``TrainStep(mesh=...)`` stamps the data group
on every MoE layer through ``parallel_loss_groups``) the routing is the
reference's over the GLOBAL batch, whose rows the ranks hold in rank
order: one all-gather of each rank's ``(k, E)`` table of per-expert choice
counts gives the global token count (the capacity's T) and each choice's
exclusive prefix (the ranks before this one, plus every rank's earlier
choices), and the aux loss's ``me`` / ``ce`` are sums all-reduced over the
group (``mp_ops``' identity-then-all-reduce pair, whose backward
all-reduces the cotangents: the gate's gradient is the reference's)
divided by the global T.

Expert parallelism (``Experts(expert_axis=...)``, ``moe_group``): the
whole ``(E, ...)`` stack is drawn from the seed and ``TrainStep`` cuts it
to this rank's ``E / P`` experts (``expert_group``, the data group). Each
rank builds its ``(E, C, d)`` dispatch of its own tokens (the positions of
different ranks never overlap), one all-to-all sends each expert's rows to
its owner, which sums the ranks' parts and runs its experts, and a second
all-to-all hands every rank all the experts' outputs for its combine.
``mp_group`` and ``recompute_interval`` (stored and ignored by the JAX
package) raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn

from .....device import DeviceLike, resolve_device
from .....distributed.communication import collectives as C
from .....distributed.communication.group import resolve_group_axis
from .....distributed.fleet.layers.mpu.mp_ops import (
    _all_to_all, _c_identity, _mp_allreduce)
from .....nn import functional as F
from .....nn.initializer import Constant, XavierUniform
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate


def _live(group) -> bool:
    return group is not None and group.nranks > 1


# ------------------------------------------------------------------ dispatch
def top_k_dispatch(logits: torch.Tensor, k: int,
                   capacity: Union[int, Callable[[int], int]],
                   aux_mode: Optional[str] = None, group=None):
    """``(combine, dispatch, aux_loss)`` from gate logits ``(T, E)``:
    combine ``(T, E, C)`` f32, dispatch ``(T, E, C)`` bool, aux_loss an f32
    scalar (0 when ``aux_mode`` is None). Differentiable with respect to
    the logits through combine and the aux loss.

    Probabilities are the f32 softmax of the logits. Choice i of a token
    takes position ``cumsum - m + prev_count`` in its expert (every
    earlier choice of every token counted first) and is dropped at or past
    ``capacity`` (an int, or a function of the global token count); the
    kept choices' probabilities are renormalised to sum to one (a token
    with none kept divides by 1). The aux loss ("gshard" or "switch") is
    ``E * sum(mean prob * first-choice fraction)``.

    With a ``group`` of more than one rank the logits are this rank's rows
    of a global batch held in rank order, and the routing is the global
    batch's: every position, the capacity and the means count all ranks'
    tokens (one all-gather of the ``(k, E)`` count tables, one all-reduce
    of the probabilities' sums)."""
    t, e = logits.shape
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    # stable: on a tie the lower expert index first, as jax.lax.top_k
    top = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    masks = [nn.functional.one_hot(top[:, i], e).float() for i in range(k)]
    counts = torch.stack([m.sum(dim=0) for m in masks])      # (k, E)

    if _live(group):
        table = []
        C.all_gather(table, counts.contiguous(), group=group)
        table = torch.stack(table)                           # (R, k, E)
        glob = table.sum(dim=0)
        # ranks before this one, then every rank's earlier choices
        starts = table[:group.rank].sum(dim=0) + torch.cumsum(
            glob, dim=0) - glob
        total = int(glob[0].sum())
        # the sum over the ranks, whose backward sums the ranks'
        # cotangents too: each rank's loss reads every rank's part
        prob_sum = _mp_allreduce(_c_identity(probs.sum(dim=0), group),
                                 group)
    else:
        starts = torch.cumsum(counts, dim=0) - counts
        glob, total, prob_sum = counts, t, None
    if callable(capacity):
        capacity = capacity(total)

    if aux_mode in ("gshard", "switch"):
        if prob_sum is None:
            aux = (probs.mean(dim=0) * masks[0].mean(dim=0)).sum() * e
        else:
            aux = ((prob_sum / total) * (glob[0] / total)).sum() * e
    else:
        aux = torch.zeros((), dtype=torch.float32, device=dev)

    gates, places = [], []
    for i, m in enumerate(masks):
        pos = torch.cumsum(m, dim=0) - m + starts[i]         # (T, E)
        keep = m * (pos < capacity)                          # drop overflow
        gates.append((probs * m).sum(dim=-1))               # (T,)
        places.append((keep, pos))

    denom = sum(g * kp.sum(dim=-1) for g, (kp, _) in zip(gates, places))
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    slots = torch.arange(capacity, device=dev)
    combine = torch.zeros((t, e, capacity), dtype=torch.float32,
                          device=dev)
    for g, (keep, pos) in zip(gates, places):
        w = (g / denom)[:, None] * keep                      # (T, E)
        # the kept one-hot slot; a position past the capacity has none
        slot = ((pos.long()[:, :, None] == slots)
                & (keep[:, :, None] > 0)).float()
        combine = combine + w[:, :, None] * slot
    return combine, combine > 0.0, aux


# ------------------------------------------------------------------- experts
class Experts(nn.Module):
    """Stacked expert FFNs ``act(x @ w1 + b1) @ w2 + b2`` over the expert
    axis: ``w1`` ``(E, d, h)``, ``w2`` ``(E, h, d)`` (Xavier-uniform with
    the JAX package's 3-D fans), biases ``(E, 1, h)`` and ``(E, 1, d)``
    (zeros); the activation defaults to exact GELU.

    ``expert_axis`` (a mesh axis, e.g. "dp") declares expert parallelism:
    the four stacks carry the spec ``(axis, None, None)`` and
    ``TrainStep(mesh=...)`` keeps this rank's ``E / P`` experts
    (:meth:`take_slice`), the whole stack having been drawn first."""

    def __init__(self, num_expert: int, d_model: int, d_hidden: int,
                 activation: Callable = None,
                 expert_axis: Optional[str] = None, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or torch.float32
        self.num_expert, self.d_model, self.d_hidden = (num_expert, d_model,
                                                        d_hidden)
        self.act = activation or F.gelu
        xavier, zero = XavierUniform(), Constant(0.0)
        self.w1 = nn.Parameter(xavier((num_expert, d_model, d_hidden), dev,
                                      dtype, generator))
        self.b1 = nn.Parameter(zero((num_expert, 1, d_hidden), dev, dtype))
        self.w2 = nn.Parameter(xavier((num_expert, d_hidden, d_model), dev,
                                      dtype, generator))
        self.b2 = nn.Parameter(zero((num_expert, 1, d_model), dev, dtype))
        self.expert_axis = expert_axis
        self.expert_group = None
        if expert_axis is not None:
            for p in self.parameters():
                p.dist_attr = (expert_axis, None, None)

    @torch.no_grad()
    def take_slice(self, group) -> None:
        """Keep this rank's ``E / P`` experts of ``group`` (the same
        ``Parameter`` objects, their data narrowed)."""
        n = group.nranks
        if self.num_expert % n:
            raise ValueError(f"{self.num_expert} experts do not split over "
                             f"{n} ranks")
        for p in self.parameters():
            p.data = p.data.chunk(n, dim=0)[group.rank].clone()
        self.expert_group = group

    def forward(self, dispatched: torch.Tensor) -> torch.Tensor:
        """``(E, C, d) -> (E, C, d)`` (this rank's experts only under expert
        parallelism)."""
        h = self.act(torch.bmm(dispatched, self.w1) + self.b1)
        return torch.bmm(h, self.w2) + self.b2


class _ListExperts(nn.Module):
    """A list of per-expert modules, expert e applied to its slice
    ``dispatched[e]`` (the JAX package's reference-parity path)."""

    def __init__(self, experts: Sequence[nn.Module]):
        super().__init__()
        self.experts = nn.ModuleList(list(experts))

    def forward(self, dispatched: torch.Tensor) -> torch.Tensor:
        return torch.stack([ex(dispatched[i])
                            for i, ex in enumerate(self.experts)], dim=0)


# ------------------------------------------------------------------ MoELayer
class MoELayer(nn.Module):
    """Paddle's ``MoELayer(d_model, experts, gate, moe_group, mp_group,
    recompute_interval, ...)``. ``experts`` is an :class:`Experts`, a list
    of per-expert modules, or None (an :class:`Experts` FFN of
    ``num_expert`` x ``d_hidden`` is built, exact GELU); ``gate`` a
    :class:`BaseGate`, a name ("naive", "gshard", "switch"), a ``{"type":
    name}`` dict, or None (GShard), built with ``top_k``. Built on the card
    unless ``device`` says otherwise; new weights are drawn from
    ``generator``. ``moe_group`` names the expert axis when
    ``expert_axis`` does not (the group's topology axis, as the reference
    resolves it).

    The capacity of T tokens (the global batch's, across the data group
    stamped in ``parallel_loss_groups``) is ``max(ceil(capacity_factor * k
    * T / E), 4)``. The forward routes ``x`` ``(..., d)`` flattened to T
    tokens, casts the dispatch mask and then the combine weights to the
    activations' dtype before each product (as the JAX package does: in
    bf16 the weights round first), and stores the aux loss on the gate."""

    # (mp group, data group), stamped by TrainStep(mesh=...)
    parallel_loss_groups = (None, None)

    def __init__(self, d_model: int, experts=None,
                 gate: Union[BaseGate, dict, str, None] = None,
                 moe_group=None, mp_group=None, recompute_interval: int = 0,
                 num_expert: Optional[int] = None,
                 d_hidden: Optional[int] = None, top_k: int = 2,
                 capacity_factor: float = 1.2,
                 expert_axis: Optional[str] = None, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mp_group is not None:
            raise NotImplementedError(
                "MoELayer: mp_group is not ported (the JAX package stores "
                "it and shards nothing over it)")
        if recompute_interval:
            raise NotImplementedError(
                "MoELayer: recompute_interval is not ported (the JAX "
                "package stores it and recomputes nothing)")
        if expert_axis is None and moe_group is not None:
            expert_axis = resolve_group_axis(moe_group)
        self.expert_axis = expert_axis
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.d_model = d_model
        if isinstance(experts, Experts):
            self.experts = experts
            num_expert = experts.num_expert
        elif isinstance(experts, (list, tuple, nn.ModuleList)):
            self.experts = _ListExperts(experts)
            num_expert = len(list(experts))
        elif experts is None:
            if num_expert is None or d_hidden is None:
                raise ValueError("need experts=... or num_expert + d_hidden")
            self.experts = Experts(num_expert, d_model, d_hidden,
                                   expert_axis=expert_axis, **kw)
        else:
            raise TypeError(f"unsupported experts {experts!r}")
        self.num_expert = num_expert

        if isinstance(gate, BaseGate):
            self.gate = gate
        else:
            name = (gate if isinstance(gate, str)
                    else (gate or {}).get("type", "gshard"))
            cls = {"naive": NaiveGate, "gshard": GShardGate,
                   "switch": SwitchGate}[name]
            self.gate = cls(d_model, num_expert, world_size=1, top_k=top_k,
                            **kw)
        self.top_k = self.gate.top_k
        self.capacity_factor = capacity_factor
        self.recompute_interval = recompute_interval

    def capacity(self, num_tokens: int) -> int:
        c = int(math.ceil(self.capacity_factor * self.top_k * num_tokens
                          / self.num_expert))
        return max(c, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        d = shape[-1]
        xt = x.reshape(-1, d)
        t = xt.shape[0]
        logits = self.gate(xt)
        combine, dispatch, aux = top_k_dispatch(
            logits, self.top_k, self.capacity,
            getattr(self.gate, "aux_loss_mode", None),
            self.parallel_loss_groups[1])
        e, cap = combine.shape[1], combine.shape[2]
        # token -> expert: td,tec->ecd over the constant mask
        mask = dispatch.reshape(t, e * cap).to(xt.dtype)
        dispatched = (mask.transpose(0, 1) @ xt).reshape(e, cap, d)
        group = getattr(self.experts, "expert_group", None)
        if _live(group):
            # each owner sums the ranks' parts of its experts' rows (their
            # positions never overlap), runs them, and every rank gets
            # all the experts' outputs back
            n = group.nranks
            mine = _all_to_all(dispatched, group, 0, 0).reshape(
                n, e // n, cap, d).sum(dim=0)
            expert_out = _all_to_all(self.experts(mine).repeat(n, 1, 1),
                                     group, 0, 0)
        else:
            expert_out = self.experts(dispatched)           # (E, C, d)
        # expert -> token: ecd,tec->td, the weights in the outputs' dtype
        out = (combine.reshape(t, e * cap).to(expert_out.dtype)
               @ expert_out.reshape(e * cap, d))
        self.gate.set_loss(aux)
        return out.reshape(shape)
