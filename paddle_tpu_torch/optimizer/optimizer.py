"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

``Optimizer``, ``Adam`` and ``AdamW`` as ``torch.optim.Optimizer``
subclasses that take Paddle's constructor arguments. The update is the
reference's ``Adam.apply_one`` step for step: f32 moments, bias correction
with a float step count, ``mhat / (sqrt(vhat) + eps)``, AdamW's decoupled
decay ``upd + wd * p32``, and with ``multi_precision`` a bf16/fp16
parameter updated through its f32 master copy and cast back. The update is
plain PyTorch, one parameter at a time (the reference leaves it to XLA).

Parameters are named for ``state_dict`` and ``apply_decay_param_fun``:
pass ``model.named_parameters()`` to use the module's names, or plain
tensors to get ``param_<i>``. State keys follow the reference:
``<name>_moment1_0``, ``<name>_moment2_0``, ``<name>_fp32_master_0``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..nn.clip import ClipGradBase
from .lr import LRScheduler

_HALF = (torch.float16, torch.bfloat16)


class Optimizer(torch.optim.Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip: Optional[ClipGradBase] = None,
                 name=None, multi_precision: bool = False):
        if parameters is None:
            raise ValueError("optimizer created without a parameter list")
        entries = list(parameters)
        if entries and isinstance(entries[0], dict):
            raise NotImplementedError(
                "parameter groups are not ported: a later slice")
        named = [e if isinstance(e, tuple) else (f"param_{i}", e)
                 for i, e in enumerate(entries)]
        if not isinstance(weight_decay, (int, float, type(None))):
            raise NotImplementedError(
                "weight_decay must be a float: regularizer objects are not "
                "ported")
        super().__init__([p for _, p in named], {})
        self._names = {p: n for n, p in named}
        self._lr = learning_rate
        self._weight_decay = 0.0 if weight_decay is None else weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._steps = 0

    # ------------------------------------------------------- functional core
    def init_slot(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def apply_one(self, p, g, slots, lr, t, wd):
        """Returns the updated ``p``; updates ``slots`` in place."""
        raise NotImplementedError

    # -------------------------------------------------------------- lr logic
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    # ------------------------------------------------------------ eager path
    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]
                if p.requires_grad]

    def _wd_excluded_for_param(self, p) -> bool:
        return False

    def _decay_for(self, p) -> float:
        if self._wd_excluded_for_param(p):
            return 0.0
        return float(self._weight_decay)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("step(closure) is not ported")
        params_grads = [(p, p.grad) for p in self._params()
                        if p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._steps += 1
        t, lr = self._steps, self.get_lr()
        for p, g in params_grads:
            if g is None:
                continue
            st = self.state[p]
            if not st:
                st.update(self.init_slot(p))
            use_master = self._multi_precision and p.dtype in _HALF
            if use_master and "master" not in st:
                st["master"] = p.detach().float()
            pc = st["master"] if use_master else p
            new_p = self.apply_one(pc, g.to(pc.dtype), st, lr, t,
                                   self._decay_for(p))
            if use_master:
                st["master"] = new_p
            p.copy_(new_p)

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._params():
            p.grad = None

    # ------------------------------------------------------------ state dict
    def state_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for p in self._params():
            st = self.state.get(p)
            if not st:
                continue
            name = self._names[p]
            for key in sorted(k for k in st if k != "master"):
                out[f"{name}_{key}_0"] = st[key]
            if "master" in st:
                out[f"{name}_fp32_master_0"] = st["master"]
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        out["@step"] = self._steps
        return out

    def load_state_dict(self, state_dict):
        raise NotImplementedError(
            "restoring optimizer state is not ported: a later slice, with "
            "Model.fit and checkpoints")


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False):
        if lazy_mode or amsgrad:
            raise NotImplementedError("lazy_mode and amsgrad are not ported")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._decoupled_wd = False   # Adam: L2-style (coupled) decay

    def init_slot(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def apply_one(self, p, g, slots, lr, t, wd):
        g32 = g.float()
        p32 = p.float()
        if wd and not self._decoupled_wd:
            g32 = g32 + wd * p32
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g32
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * (g32 * g32)
        tf = float(t)
        mhat = m / (1 - self._beta1 ** tf)
        vhat = v / (1 - self._beta2 ** tf)
        upd = mhat / (torch.sqrt(vhat) + self._eps)
        if wd and self._decoupled_wd:
            upd = upd + wd * p32
        slots["moment1"], slots["moment2"] = m, v
        return (p32 - lr * upd).to(p.dtype)


class AdamW(Adam):
    """Decoupled weight decay; ``apply_decay_param_fun(name)`` returning
    False exempts a parameter (the reference contract passes its name)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name=name, amsgrad=amsgrad)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _wd_excluded_for_param(self, p):
        return (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(self._names[p]))
