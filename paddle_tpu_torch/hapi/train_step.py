"""The train step (counterpart of ``paddle_tpu/hapi/train_step.py``).

The JAX package compiles forward, backward and update into one jitted XLA
program. Here the step runs eagerly on the card: the model's forward and
autograd backward (attention on the flash kernels), gradient accumulation
over micro-batches, then the optimizer's clip and update and one scheduler
step. ``__call__`` never waits for the card: it returns the loss as a
detached device tensor, and :meth:`sync` is the one host read.

The parameters live in the model, so ``sync_to_model()`` has nothing to
do. Not ported (``NotImplementedError``): meshes and parameter specs, ZeRO
sharding levels, gradient merge, LocalSGD, ``remat`` and the
``metrics_every`` pull cadence; telemetry and fault sites wait for the
serving extensions' observability slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..optimizer.lr import LRScheduler
from ..optimizer.optimizer import Optimizer


def _refuse(what: str) -> None:
    raise NotImplementedError(f"TrainStep({what}) is not ported: a later "
                              f"slice (distributed runtime or Model.fit)")


class TrainStep:
    def __init__(self, model, optimizer: Optimizer,
                 loss_fn: Optional[Callable] = None, mesh=None,
                 param_spec_fn=None, grad_accum_steps: int = 1,
                 remat: bool = False, sharding_level: Optional[int] = None,
                 sharding_axis: Optional[str] = None,
                 gradient_merge_k: Optional[int] = None,
                 localsgd_k: Optional[int] = None, metrics_every: int = 0):
        if mesh is not None or param_spec_fn is not None:
            _refuse("mesh / param_spec_fn")
        if sharding_level or sharding_axis is not None:
            _refuse("sharding_level / sharding_axis")
        if gradient_merge_k is not None and gradient_merge_k > 1:
            _refuse("gradient_merge_k > 1")
        if localsgd_k is not None and localsgd_k > 1:
            _refuse("localsgd_k > 1")
        if remat:
            _refuse("remat=True")
        if metrics_every:
            _refuse("metrics_every")
        if int(grad_accum_steps) < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{grad_accum_steps}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.grad_accum_steps = int(grad_accum_steps)
        self._last_loss: Optional[torch.Tensor] = None
        self._last_value: Optional[float] = None

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
        whose gradients average. Leaves the gradients in ``p.grad`` (any
        earlier ones are dropped first) and returns ``(loss, grads)``:
        the detached mean loss and ``{name: grad}``, before the clip."""
        self.optimizer.clear_grad()
        n = self.grad_accum_steps
        total = None
        for mb in self._micro_batches(batch):
            loss = self._loss_of(mb)
            (loss / n if n > 1 else loss).backward()
            total = loss.detach() if total is None else total + loss.detach()
        loss = total / n if n > 1 else total
        grads = {k: p.grad for k, p in self.model.named_parameters()
                 if p.grad is not None}
        return loss, grads

    def apply_update(self) -> None:
        """The optimizer's clip and update at ``optimizer.get_lr()``, one
        scheduler step, and the gradients cleared."""
        self.optimizer.step()
        if isinstance(self.optimizer._lr, LRScheduler):
            self.optimizer._lr.step()
        self.optimizer.clear_grad()

    def __call__(self, *batch) -> torch.Tensor:
        """One training step; returns the detached loss without a host
        sync."""
        loss, _ = self.compute_loss_grads(*batch)
        self.apply_update()
        self._last_loss = loss
        return loss

    # --------------------------------------------------------------- metrics
    def sync(self) -> Optional[float]:
        """Block until the last step's loss is on the host and return it."""
        if self._last_loss is not None:
            self._last_value = float(self._last_loss)
            self._last_loss = None
        return self._last_value

    # ------------------------------------------------------------- utilities
    def sync_to_model(self) -> None:
        """Nothing to write back: the parameters live in the model."""

    def state_dict(self) -> Dict[str, Any]:
        sd: Dict[str, Any] = dict(self.model.state_dict())
        sd["@opt_state"] = self.optimizer.state_dict()
        return sd
