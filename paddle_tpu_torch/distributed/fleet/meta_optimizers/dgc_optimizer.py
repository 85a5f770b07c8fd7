"""DGC, Deep Gradient Compression momentum (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/dgc_optimizer.py``; Lin et
al., "Deep Gradient Compression", ICLR 2018).

The update rule, step for step the reference's:

  - momentum correction:   u_t = m u_{t-1} + g_t
  - error accumulation:    v_t = v_{t-1} + u_t
  - top-k sparsification:  mask = |v_t| >= tau(s), update = v_t mask
  - error feedback:        v_{t+1} = v_t (1 - mask)
  - momentum factor masking: u_{t+1} = u_t (1 - mask)
  - sparsity rampup:       from ``rampup_begin_step`` on, chunk i of
                           ``rampup_step / len(sparsity)`` steps uses
                           ``sparsity[i]``; plain momentum before it

tau is the ``s``-quantile (``torch.quantile``'s linear interpolation,
``jnp.quantile``'s default) of a strided sample of at most 4096 of
``|v_t|``'s elements. ``t`` is the optimizer's step count after this step
(1 on the first), as in the reference. The gradients' all-reduce stays
dense, as in the reference: what DGC sends sparsely on NCCL there is the
data-parallel average here (``TrainStep(mesh=...)`` or the fleet
wrappers). Its threshold reads the whole tensor, so it is no elementwise
update and refuses a ZeRO sharding level.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ....optimizer.optimizer import Momentum, _zeros

__all__ = ["DGCMomentum"]

_SAMPLE = 4096


class DGCMomentum(Momentum):
    elementwise = False

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 rampup_begin_step: int = 0, rampup_step: int = 1,
                 sparsity: Sequence[float] = (0.999,), parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 num_trainers: Optional[int] = None,
                 multi_precision: bool = False, name=None):
        if use_nesterov:
            raise NotImplementedError(
                "DGCMomentum does not support use_nesterov=True (the "
                "sparsified momentum-correction update is plain "
                "momentum); use Momentum without strategy.dgc")
        super().__init__(learning_rate, momentum, parameters, use_nesterov,
                         weight_decay, grad_clip, multi_precision, name)
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(1, int(rampup_step))
        self._sparsity = tuple(float(s) for s in sparsity) or (0.999,)

    def init_slot(self, p):
        return {"velocity": _zeros(p), "error": _zeros(p)}

    def _current_sparsity(self, t: int) -> float:
        per = max(1, self._rampup_step // len(self._sparsity))
        idx = min(max((t - self._rampup_begin) // per, 0),
                  len(self._sparsity) - 1)
        return self._sparsity[idx]

    def apply_one(self, p, g, slots, lr, t, wd):
        g32, p32 = g.float(), p.float()
        if wd:
            g32 = g32 + wd * p32
        u, v = slots["velocity"], slots["error"]
        u2 = self._momentum * u + g32
        if t < self._rampup_begin:      # dense momentum before the rampup
            slots["velocity"] = u2
            return (p32 - lr * u2).to(p.dtype)
        acc = v + u2
        flat = acc.abs().reshape(-1)
        stride = max(1, flat.shape[0] // _SAMPLE)
        sample = flat[::stride][:_SAMPLE]
        # the level in f32, as the reference's traced one
        s = torch.tensor(self._current_sparsity(t),
                         dtype=torch.float32).clamp(0.0, 1.0)
        tau = torch.quantile(sample, s.to(sample.device))
        mask = (acc.abs() >= tau).float()
        slots["velocity"] = u2 * (1.0 - mask)
        slots["error"] = acc * (1.0 - mask)
        return (p32 - lr * (acc * mask)).to(p.dtype)
