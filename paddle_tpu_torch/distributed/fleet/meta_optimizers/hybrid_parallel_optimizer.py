"""HybridParallelOptimizer (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/hybrid_parallel_optimizer.py``).

Under the reference's single controller every gradient is the logical
whole, so its global-norm clip is global by construction. Here a rank
holds the gradients of its shards, so, as in Paddle:

- the squared norm of the sharded parameters (``is_distributed``) is
  summed over the ``mp`` group once, and the replicated ones' is added
  once (each ``mp`` rank holds the same copy), which gives the clip over
  the logical parameters (:class:`HybridParallelClipGrad`);
- in hybrid parallelism (any mode but pure data parallelism, where
  ``DataParallel`` reduces in the backward) ``step`` first averages every
  gradient over the ``dp`` group.
"""

from __future__ import annotations

import torch

from ....nn.clip import ClipGradByGlobalNorm
from ...communication import collectives as C
from ..base_topology import try_get_hybrid_communicate_group
from ..meta_parallel.meta_parallel_base import average_gradients
from ..meta_parallel.parallel_layers.mp_layers import is_sharded


class HybridParallelClipGrad:
    """A global-norm clip over sharded and replicated gradients: with one
    ``mp`` rank it is ``clip`` itself."""

    def __init__(self, clip: ClipGradByGlobalNorm, mp_group):
        self._clip = clip
        self.clip_norm = clip.clip_norm
        self._mp = mp_group

    def global_norm_sq(self, params_grads) -> torch.Tensor:
        """The squared norm of the logical parameters' gradients (f32)."""
        if self._mp is None or self._mp.nranks == 1:
            return self._clip.global_norm_sq(g for _, g in params_grads)
        sharded = self._clip.global_norm_sq(
            g for p, g in params_grads if is_sharded(p))
        replicated = self._clip.global_norm_sq(
            g for p, g in params_grads if not is_sharded(p))
        dev = next(g.device for _, g in params_grads if g is not None)
        sharded = sharded.to(dev)
        C.all_reduce(sharded, group=self._mp)
        return sharded + replicated.to(dev)

    def __call__(self, params_grads):
        if self._mp is None or self._mp.nranks == 1:
            return self._clip(params_grads)
        total = self.global_norm_sq(params_grads)
        scale = self.clip_norm / torch.clamp(torch.sqrt(total),
                                             min=self.clip_norm)
        return [(p, None if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


def hybrid_clip(optimizer, mp_group) -> None:
    """Give ``optimizer`` the hybrid global-norm clip over ``mp_group``
    (once; another clip stays as it is)."""
    clip = optimizer._grad_clip
    if isinstance(clip, ClipGradByGlobalNorm):
        optimizer._grad_clip = HybridParallelClipGrad(clip, mp_group)


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._hcg = hcg or try_get_hybrid_communicate_group()
        self._strategy = strategy
        self._inner_opt = optimizer
        self._dp_group = None
        if self._hcg is not None:
            hybrid_clip(optimizer, self._hcg.get_model_parallel_group())
            if self._hcg.get_parallel_mode() != "DATA_PARALLEL" \
                    and self._hcg.get_data_parallel_world_size() > 1:
                self._dp_group = self._hcg.get_data_parallel_group()

    def __getattr__(self, item):
        try:
            return getattr(self.__dict__["_inner_opt"], item)
        except KeyError:
            raise AttributeError(item) from None

    def step(self):
        if self._dp_group is not None:
            average_gradients(self._inner_opt._params(), self._dp_group)
        return self._inner_opt.step()

    def clear_grad(self, *a, **k):
        return self._inner_opt.clear_grad(*a, **k)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)
