"""Loss scaling (counterpart of ``paddle_tpu/amp/grad_scaler.py``).

Dynamic loss scaling for fp16 training: ``scale`` multiplies the loss,
``unscale_`` divides the gradients back (in f32) and looks for inf/NaN,
``step`` skips the update when it found any, and ``update`` shrinks the
scale by ``decr_ratio`` after ``decr_every_n_nan_or_inf`` bad steps (never
below 1) and grows it by ``incr_ratio`` after ``incr_every_n_steps`` good
ones. The inf check is one host read a step, as in the reference.
"""

from __future__ import annotations

import torch


class GradScaler:
    def __init__(self, enable: bool = True, init_loss_scaling: float = 65536.0,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 2000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        if not self._enable:
            return
        inv = 1.0 / self._scale
        finite = []
        for p in optimizer._params():
            if p.grad is not None:
                g = p.grad.float() * inv
                finite.append(torch.isfinite(g).all())
                p.grad = g.to(p.grad.dtype)
        self._found_inf = bool(finite) and not bool(
            torch.stack(finite).all())

    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self) -> None:
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, loss) -> None:
        """The loss was scaled by the caller through :meth:`scale`."""
        self.step(optimizer)
        self.update()

    def get_loss_scaling(self) -> torch.Tensor:
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v: float):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)

    set_state_dict = load_state_dict


AmpScaler = GradScaler
