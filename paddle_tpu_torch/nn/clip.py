"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

Only ``ClipGradByGlobalNorm``, the clip the training path uses, is ported.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken in f32 over all gradients; each scaled gradient
    is cast back to its own dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def global_norm_sq(self, grads: Iterable[Optional[torch.Tensor]]
                       ) -> torch.Tensor:
        """Sum of squared norms, f32, on the gradients' device (no host
        sync)."""
        total = torch.zeros((), dtype=torch.float32)
        for g in grads:
            if g is not None:
                total = total.to(g.device) + g.float().square().sum()
        return total

    def __call__(self, params_grads: List[Tuple[object, torch.Tensor]]):
        total_sq = self.global_norm_sq(g for _, g in params_grads)
        scale = self.clip_norm / torch.clamp(torch.sqrt(total_sq),
                                             min=self.clip_norm)
        return [(p, None if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]
