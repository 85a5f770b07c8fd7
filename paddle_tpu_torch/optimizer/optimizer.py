"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

``Optimizer`` and its subclasses are ``torch.optim.Optimizer``s that take
Paddle's constructor arguments. Each keeps the reference's functional
shape: ``init_slot(p)`` makes a parameter's state (f32 slots under the
reference's accumulator names) and ``apply_one(p, g, slots, lr, t, wd)``
returns the updated parameter and updates ``slots`` in place, step for step
the reference's arithmetic. With ``multi_precision`` a bf16/fp16 parameter
is updated through its f32 master copy and cast back. The update is plain
PyTorch, one parameter at a time (the reference leaves it to XLA);
``use_multi_tensor`` is accepted and changes nothing, as in the reference.

Parameters are named for ``state_dict``, ``apply_decay_param_fun`` and
``lr_ratio``: pass ``model.named_parameters()`` to use the module's names,
or plain tensors to get ``param_<i>``. State keys follow the reference:
``<name>_moment1_0``, ``<name>_moment2_0``, ``<name>_fp32_master_0``.

``parameters`` may also be a list of groups, dicts with ``params`` and
optionally ``learning_rate`` (a factor on the optimizer's rate, Paddle's
``optimize_attr``) and ``weight_decay`` (replacing the optimizer's). A
tensor with an ``optimize_attr = {"learning_rate": f}`` attribute gets the
same factor, as in the reference. ``weight_decay`` is a float (``L2Decay``
alike: ``g + wd * p``, or AdamW's decoupled ``+ wd * p``) or a regularizer
of ``paddle_tpu_torch.regularizer``; ``L1Decay(c)`` adds ``c * sign(p)``
to the gradient (the reference reads its coefficient as an L2 one).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..nn.clip import ClipGradBase
from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler

_HALF = (torch.float16, torch.bfloat16)
_GROUP_KEYS = {"params", "learning_rate", "weight_decay"}


def _as_decay(wd):
    """``("l2" | "l1", coeff)`` of a float or a regularizer."""
    if wd is None:
        return ("l2", 0.0)
    if isinstance(wd, L1Decay):
        return ("l1", wd.coeff)
    if isinstance(wd, L2Decay):
        return ("l2", wd.coeff)
    if isinstance(wd, (int, float)):
        return ("l2", float(wd))
    raise TypeError(f"weight_decay must be a float, L1Decay or L2Decay; got "
                    f"{type(wd).__name__}")


class Optimizer(torch.optim.Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip: Optional[ClipGradBase] = None,
                 name=None, multi_precision: bool = False):
        if parameters is None:
            raise ValueError("optimizer created without a parameter list")
        entries = list(parameters)
        groups = (entries if entries and isinstance(entries[0], dict)
                  else [{"params": entries}])
        named, torch_groups = [], []
        for g in groups:
            extra = set(g) - _GROUP_KEYS
            if extra:
                raise NotImplementedError(
                    f"parameter group keys {sorted(extra)} are not ported "
                    f"(ported: {sorted(_GROUP_KEYS)})")
            members = []
            for e in g["params"]:
                n, p = (e if isinstance(e, tuple)
                        else (f"param_{len(named)}", e))
                named.append((n, p))
                members.append(p)
            torch_groups.append({
                "params": members,
                "lr_scale": float(g.get("learning_rate", 1.0)),
                "decay": (_as_decay(g["weight_decay"])
                          if "weight_decay" in g else None)})
        super().__init__(torch_groups, {})
        self._names = {p: n for n, p in named}
        self._lr = learning_rate
        self._decay = _as_decay(weight_decay)
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

    def _lr_scale(self, p, group) -> float:
        attr = getattr(p, "optimize_attr", None) or {}
        return group["lr_scale"] * float(attr.get("learning_rate", 1.0))

    def _wd_excluded_for_param(self, p) -> bool:
        return False

    def _decay_for(self, p, group):
        """The parameter's ``(kind, coeff)``: its group's decay, else the
        optimizer's; excluded parameters get none."""
        if self._wd_excluded_for_param(p):
            return ("l2", 0.0)
        return group["decay"] or self._decay

    def _update(self, p, g, group, lr, t):
        st = self.state[p]
        if not st:
            st.update(self.init_slot(p))
        use_master = self._multi_precision and p.dtype in _HALF
        if use_master and "master" not in st:
            st["master"] = p.detach().float()
        pc = st["master"] if use_master else p
        g = g.to(pc.dtype)
        kind, coeff = self._decay_for(p, group)
        if kind == "l1":
            g = g + coeff * torch.sign(pc)
            coeff = 0.0
        new_p = self.apply_one(pc, g, st, lr * self._lr_scale(p, group), t,
                               coeff)
        if use_master:
            st["master"] = new_p
        p.copy_(new_p)

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter with a gradient, after the clip,
        at ``get_lr()`` (times each parameter's factors). ``closure``, when
        given, recomputes the loss and the gradients first; its loss is
        returned."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params_grads = [(p, p.grad) for p in self._params()
                        if p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._steps += 1
        t, lr = self._steps, self.get_lr()
        group_of = {p: g for g in self.param_groups for p in g["params"]}
        for p, g in params_grads:
            if g is not None:
                self._update(p, g, group_of[p], lr, t)
        return loss

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._params():
            p.grad = None

    clear_gradients = clear_grad

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

    @torch.no_grad()
    def set_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore what :meth:`state_dict` wrote (tensors or numpy arrays,
        e.g. from ``framework.io.load`` or ``convert.optimizer_state_from_
        jax``): the step count, the scheduler, and each parameter's slots
        and master, on the parameter's device."""
        self._steps = int(state.get("@step", 0))
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
        for p in self._params():
            name = self._names[p]
            slots = {}
            for key, tmpl in self.init_slot(p).items():
                v = state.get(f"{name}_{key}_0")
                if v is not None:
                    slots[key] = _tensor_like(v, tmpl)
            master = state.get(f"{name}_fp32_master_0")
            if master is not None:
                slots["master"] = _tensor_like(
                    master, torch.empty(0, dtype=torch.float32,
                                        device=p.device))
            if slots:
                st = self.state[p]
                st.clear()
                st.update(self.init_slot(p))
                st.update(slots)

    def load_state_dict(self, state_dict):
        self.set_state_dict(state_dict)


def _tensor_like(v, tmpl: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        t = v.detach()
    else:
        t = torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
    return t.to(device=tmpl.device, dtype=tmpl.dtype).clone()


def _zeros(p):
    return torch.zeros_like(p, dtype=torch.float32)


def _coupled(g32, p32, wd):
    return g32 + wd * p32 if wd else g32


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def apply_one(self, p, g, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        return p - lr * g


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_slot(self, p):
        return {"velocity": _zeros(p)}

    def apply_one(self, p, g, slots, lr, t, wd):
        if wd:
            g = g + wd * p
        v = self._momentum * slots["velocity"] + g.float()
        upd = g.float() + self._momentum * v if self._nesterov else v
        slots["velocity"] = v
        return p - lr * upd.to(p.dtype)


class Adam(Optimizer):
    """Adam with coupled (L2-style) decay. ``amsgrad`` keeps the running
    maximum of the second moment (``moment2_max``) and divides by it;
    ``lazy_mode`` only changes sparse (row) gradients, which the port never
    makes (an ``Embedding``'s gradient is dense), so it is accepted and
    changes nothing."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._amsgrad = bool(amsgrad)
        self._decoupled_wd = False   # Adam: L2-style (coupled) decay

    def init_slot(self, p):
        slots = {"moment1": _zeros(p), "moment2": _zeros(p)}
        if self._amsgrad:
            slots["moment2_max"] = _zeros(p)
        return slots

    def apply_one(self, p, g, slots, lr, t, wd):
        g32 = g.float()
        p32 = p.float()
        if wd and not self._decoupled_wd:
            g32 = g32 + wd * p32
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g32
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * (g32 * g32)
        tf = float(t)
        mhat = m / (1 - self._beta1 ** tf)
        if self._amsgrad:
            slots["moment2_max"] = torch.maximum(slots["moment2_max"], v)
            vhat = slots["moment2_max"] / (1 - self._beta2 ** tf)
        else:
            vhat = v / (1 - self._beta2 ** tf)
        upd = mhat / (torch.sqrt(vhat) + self._eps)
        if wd and self._decoupled_wd:
            upd = upd + wd * p32
        slots["moment1"], slots["moment2"] = m, v
        return (p32 - lr * upd).to(p.dtype)


class AdamW(Adam):
    """Decoupled weight decay; ``apply_decay_param_fun(name)`` returning
    False exempts a parameter (the reference contract passes its name), and
    ``lr_ratio(name)`` scales a parameter's learning rate (layer-wise
    decay)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        if isinstance(weight_decay, L1Decay):
            raise TypeError("AdamW's decay is decoupled: weight_decay must "
                            "be a float or L2Decay, not L1Decay")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name=name, amsgrad=amsgrad)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _wd_excluded_for_param(self, p):
        return (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(self._names[p]))

    def _lr_scale(self, p, group):
        scale = super()._lr_scale(p, group)
        if self._lr_ratio is not None:
            scale *= float(self._lr_ratio(self._names[p]))
        return scale


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_slot(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def apply_one(self, p, g, slots, lr, t, wd):
        g32 = _coupled(g.float(), p.float(), wd)
        m = self._beta1 * slots["moment"] + (1 - self._beta1) * g32
        u = torch.maximum(self._beta2 * slots["inf_norm"], g32.abs())
        slots["moment"], slots["inf_norm"] = m, u
        return p - (lr / (1 - self._beta1 ** float(t))) * (
            m / (u + self._eps)).to(p.dtype)


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_slot(self, p):
        s = {"mean_square": _zeros(p), "momentum": _zeros(p)}
        if self._centered:
            s["mean_grad"] = _zeros(p)
        return s

    def apply_one(self, p, g, slots, lr, t, wd):
        g32 = _coupled(g.float(), p.float(), wd)
        ms = self._rho * slots["mean_square"] + (1 - self._rho) * g32 * g32
        if self._centered:
            mg = self._rho * slots["mean_grad"] + (1 - self._rho) * g32
            denom = torch.sqrt(ms - mg * mg + self._eps)
            slots["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = self._momentum * slots["momentum"] + lr * g32 / denom
        slots["mean_square"], slots["momentum"] = ms, mom
        return p - mom.to(p.dtype)


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def init_slot(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)}

    def apply_one(self, p, g, slots, lr, t, wd):
        g32 = _coupled(g.float(), p.float(), wd)
        acc = slots["moment"] + g32 * g32
        slots["moment"] = acc
        return p - (lr * g32 / (torch.sqrt(acc) + self._eps)).to(p.dtype)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def init_slot(self, p):
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def apply_one(self, p, g, slots, lr, t, wd):
        g32 = _coupled(g.float(), p.float(), wd)
        asg = (self._rho * slots["avg_squared_grad"]
               + (1 - self._rho) * g32 * g32)
        upd = (g32 * torch.sqrt(slots["avg_squared_update"] + self._eps)
               / torch.sqrt(asg + self._eps))
        slots["avg_squared_update"] = (
            self._rho * slots["avg_squared_update"]
            + (1 - self._rho) * upd * upd)
        slots["avg_squared_grad"] = asg
        return p - lr * upd.to(p.dtype)


def _trust(num, den):
    """``num / den`` where both are positive, else 1 (the layer-wise trust
    ratio of Lamb and LARS)."""
    ok = (num > 0) & (den > 0)
    return torch.where(ok, num / torch.where(ok, den, 1.0), 1.0)


class Lamb(Optimizer):
    """Layer-wise adaptive Adam. ``exclude_from_weight_decay_fn(name)``
    returning True exempts a parameter (the reference passes the parameter,
    whose name is what such a function reads)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_slot(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _wd_excluded_for_param(self, p):
        return (self._exclude_fn is not None
                and bool(self._exclude_fn(self._names[p])))

    def apply_one(self, p, g, slots, lr, t, wd):
        g32, p32 = g.float(), p.float()
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g32
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * g32 * g32
        tf = float(t)
        mhat = m / (1 - self._beta1 ** tf)
        vhat = v / (1 - self._beta2 ** tf)
        r = mhat / (torch.sqrt(vhat) + self._eps) + wd * p32
        trust = _trust(torch.sqrt((p32 * p32).sum()),
                       torch.sqrt((r * r).sum()))
        slots["moment1"], slots["moment2"] = m, v
        return (p32 - lr * trust * r).to(p.dtype)


class LarsMomentum(Optimizer):
    """LARS: the learning rate of each parameter is scaled by
    ``lars_coeff * ||w|| / (||g|| + wd * ||w|| + epsilon)``; parameters
    whose name contains a string of ``exclude_from_weight_decay`` get no
    decay."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-9, exclude_from_weight_decay=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lars_weight_decay,
                         grad_clip, name, multi_precision)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._eps = epsilon
        self._exclude = list(exclude_from_weight_decay or [])

    def init_slot(self, p):
        return {"velocity": _zeros(p)}

    def _wd_excluded_for_param(self, p):
        return any(s in self._names[p] for s in self._exclude)

    def apply_one(self, p, g, slots, lr, t, wd):
        g32, p32 = g.float(), p.float()
        w_norm = torch.sqrt((p32 * p32).sum())
        g_norm = torch.sqrt((g32 * g32).sum())
        local_lr = _trust(self._lars_coeff * w_norm,
                          g_norm + wd * w_norm + self._eps)
        local_lr = torch.where((w_norm > 0) & (g_norm > 0), local_lr, 1.0)
        v = self._momentum * slots["velocity"] + lr * local_lr * (
            g32 + wd * p32)
        slots["velocity"] = v
        return (p32 - v).to(p.dtype)


class NAdam(Optimizer):
    """Nesterov Adam with momentum decay ``psi``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def init_slot(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p),
                "mu_product": torch.ones((), dtype=torch.float32,
                                         device=p.device)}

    def apply_one(self, p, g, slots, lr, t, wd):
        p32 = p.float()
        g32 = _coupled(g.float(), p32, wd)
        tf = float(t)
        mu_t = self._beta1 * (1 - 0.5 * 0.96 ** (tf * self._psi))
        mu_t1 = self._beta1 * (1 - 0.5 * 0.96 ** ((tf + 1) * self._psi))
        mu_prod = slots["mu_product"] * mu_t
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g32
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * g32 * g32
        mhat = (mu_t1 * m / (1 - mu_prod * mu_t1)
                + (1 - mu_t) * g32 / (1 - mu_prod))
        vhat = v / (1 - self._beta2 ** tf)
        slots.update(moment1=m, moment2=v, mu_product=mu_prod)
        return (p32 - lr * mhat / (torch.sqrt(vhat) + self._eps)).to(p.dtype)


class RAdam(Optimizer):
    """Rectified Adam: the adaptive step only once the variance's
    approximate degrees of freedom ``rho_t`` exceed 5."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def init_slot(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def apply_one(self, p, g, slots, lr, t, wd):
        p32 = p.float()
        g32 = _coupled(g.float(), p32, wd)
        tf = float(t)
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g32
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * g32 * g32
        mhat = m / (1 - self._beta1 ** tf)
        rho_inf = 2.0 / (1 - self._beta2) - 1
        b2t = self._beta2 ** tf
        rho_t = rho_inf - 2 * tf * b2t / (1 - b2t)
        slots["moment1"], slots["moment2"] = m, v
        if rho_t <= 5.0:
            return (p32 - lr * mhat).to(p.dtype)
        r = math.sqrt(max((rho_t - 4) * (rho_t - 2) * rho_inf / max(
            (rho_inf - 4) * (rho_inf - 2) * rho_t, 1e-12), 0.0))
        vhat = torch.sqrt(v / (1 - b2t)) + self._eps
        return (p32 - lr * (r * mhat / vhat)).to(p.dtype)


class ASGD(Optimizer):
    """Steps with the mean of the last ``batch_num`` gradients (a circular
    buffer of them per parameter: ``batch_num`` times its memory). The live
    parameter is the iterate, not an averaged copy."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._n = int(batch_num)

    def init_slot(self, p):
        return {"grad_buf": torch.zeros((self._n,) + tuple(p.shape),
                                        dtype=torch.float32,
                                        device=p.device),
                "grad_sum": _zeros(p)}

    def apply_one(self, p, g, slots, lr, t, wd):
        p32 = p.float()
        g32 = _coupled(g.float(), p32, wd)
        pos = (int(t) - 1) % self._n
        gsum = slots["grad_sum"] - slots["grad_buf"][pos] + g32
        buf = slots["grad_buf"].clone()
        buf[pos] = g32
        slots["grad_buf"], slots["grad_sum"] = buf, gsum
        return (p32 - lr * gsum / min(float(t), float(self._n))).to(p.dtype)


class Rprop(Optimizer):
    """Resilient backprop: a per-weight step grown by ``etas[1]`` while the
    gradient keeps its sign and shrunk by ``etas[0]`` (with no move) when
    it flips, within ``learning_rate_range``; the first step size is the
    learning rate when the slot is made."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_minus, self._eta_plus = etas

    def init_slot(self, p):
        return {"prev_grad": _zeros(p),
                "step_size": torch.full(p.shape, float(self.get_lr()),
                                        dtype=torch.float32,
                                        device=p.device)}

    def apply_one(self, p, g, slots, lr, t, wd):
        g32 = g.float()
        sign = torch.sign(g32 * slots["prev_grad"])
        size = slots["step_size"]
        step = torch.clamp(
            torch.where(sign > 0, size * self._eta_plus,
                        torch.where(sign < 0, size * self._eta_minus, size)),
            self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, 0.0, g32)   # no step on a sign flip
        slots["prev_grad"], slots["step_size"] = g_eff, step
        return (p.float() - torch.sign(g_eff) * step).to(p.dtype)


class LBFGS(Optimizer):
    """Limited-memory BFGS driven by ``step(closure)``: the two-loop
    recursion over a history of (s, y) pairs, with an optional backtracking
    Armijo line search (``line_search_fn`` ``"strong_wolfe"`` or
    ``"backtracking"``, as in the reference). For full-batch deterministic
    use; the closure clears nothing, it computes the loss and calls
    ``backward()``."""

    def __init__(self, learning_rate=1.0, max_iter=20, tolerance_grad=1e-7,
                 tolerance_change=1e-9, history_size=100,
                 line_search_fn=None, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.max_iter = int(max_iter)
        self.tol_grad = tolerance_grad
        self.tol_change = tolerance_change
        self.history = int(history_size)
        self.line_search_fn = line_search_fn
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []
        self._prev_flat = None
        self._prev_grad = None

    def _flat(self, vals):
        return torch.cat([v.reshape(-1).float() for v in vals])

    def _assign(self, flat):
        off = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    def _direction(self, g):
        q = g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.dot(y, s)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        gamma = 1.0
        if self._s:
            s, y = self._s[-1], self._y[-1]
            gamma = torch.dot(s, y) / torch.dot(y, y)
        r = gamma * q
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, r)
            r = r + (a - b) * s
        return -r

    @torch.no_grad()
    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step needs a closure computing the "
                             "loss with backward()")
        with torch.enable_grad():
            loss = closure()
        params = self._params()
        flat = self._flat(params)
        g = self._flat([p.grad for p in params])
        if self._prev_flat is not None:
            s, y = flat - self._prev_flat, g - self._prev_grad
            if float(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self.history:
                    self._s.pop(0)
                    self._y.pop(0)
        d = self._direction(g)
        lr = self.get_lr()
        if self.line_search_fn in ("strong_wolfe", "backtracking"):
            f0, gd, t = float(loss.detach()), float(torch.dot(g, d)), lr
            for _ in range(10):
                self._assign(flat + t * d)
                self.clear_grad()
                with torch.enable_grad():
                    f1 = float(closure().detach())
                if f1 <= f0 + 1e-4 * t * gd:
                    break
                t *= 0.5
        else:
            self._assign(flat + lr * d)
        # the pair is formed from the evaluation points: the next step's
        # s = x_{k+1} - x_k and y = g_{k+1} - g_k
        self._prev_flat, self._prev_grad = flat, g
        self._steps += 1
        return loss
