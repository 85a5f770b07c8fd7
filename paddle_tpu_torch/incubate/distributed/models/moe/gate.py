"""MoE gates (counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate.py``).

A gate maps token activations ``(T, d)`` to raw logits ``(T, E)``; top-k
selection, capacity and the auxiliary loss are
:func:`~.moe_layer.top_k_dispatch`'s. The layer stores the aux loss on its
gate (``set_loss``), and a trainer collects it with ``get_loss(clear=True)``,
the reference's protocol.

As in the JAX package, ``GShardGate``'s ``random_routing`` and
``SwitchGate``'s ``switch_eps`` are stored and never applied (no second
expert is dropped at random, no jitter is added), and the ``capacity``
pairs are stored for the reference's signature: the layer's
``capacity_factor`` sets the capacity. A ``group`` is stored, as in the
JAX package: the layer routes over the data group ``TrainStep`` stamps on
it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .....device import DeviceLike, resolve_device
from .....nn import functional as F
from .....nn.initializer import XavierUniform


class BaseGate(nn.Module):
    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 top_k: int = 2):
        super().__init__()
        self.d_model = d_model
        self.num_expert = num_expert           # experts per rank
        self.world_size = world_size
        self.tot_expert = num_expert * world_size
        self.top_k = top_k
        self._loss: Optional[torch.Tensor] = None

    def set_loss(self, loss) -> None:
        self._loss = loss

    def get_loss(self, clear: bool = True):
        loss = self._loss
        if clear:
            self._loss = None
        return loss

    @property
    def has_loss(self) -> bool:
        return self._loss is not None


class NaiveGate(BaseGate):
    """A linear gate, ``x @ gate`` with ``gate`` ``(d_model, E)``
    (Xavier-uniform); no aux loss."""

    aux_loss_mode = None

    def __init__(self, d_model, num_expert, world_size=1, top_k=2, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(d_model, num_expert, world_size, top_k)
        self.gate = nn.Parameter(XavierUniform()(
            (d_model, self.tot_expert), resolve_device(device),
            dtype or torch.float32, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.gate)           # logits (T, E)


class GShardGate(NaiveGate):
    """GShard's top-2 gate with its load-balance loss ``E * sum(me * ce)``
    (``random_routing`` stored, not applied)."""

    aux_loss_mode = "gshard"

    def __init__(self, d_model, num_expert, world_size=1, top_k=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(d_model, num_expert, world_size, top_k=top_k,
                         device=device, dtype=dtype, generator=generator)
        self.capacity_factor = capacity
        self.random_routing = random_routing
        self.group = group


class SwitchGate(NaiveGate):
    """Switch Transformer's top-1 gate with its load-balance loss
    (``switch_eps`` stored, not applied)."""

    aux_loss_mode = "switch"

    def __init__(self, d_model, num_expert, world_size=1, top_k=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(d_model, num_expert, world_size, top_k=top_k,
                         device=device, dtype=dtype, generator=generator)
        self.switch_eps = switch_eps
        self.capacity_factor = capacity
        self.group = group
