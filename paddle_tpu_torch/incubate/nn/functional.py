"""Fused-op surface (counterpart of ``paddle_tpu/incubate/nn/functional.py``).

Only the ``position_ids`` branch of the rotary embedding is ported: it is
the one the Llama serving path runs.
"""

from __future__ import annotations

import torch


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """Rotary embedding of q/k/v ``(B, S, H, D)`` at ``position_ids``
    ``(B, S)``: angles computed directly from the positions in f32, the
    neox rotate-half applied in each tensor's own dtype. Returns
    ``(q, k, v)`` with ``None`` passed through."""
    if (position_ids is None or sin is not None or cos is not None
            or not use_neox_rotary_style or time_major):
        raise NotImplementedError(
            "only the position_ids branch (neox style, batch-major, no "
            "sin/cos tables) of fused_rotary_position_embedding is ported")
    d = q.shape[-1]
    pid = position_ids.to(torch.float32)
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=q.device) / d
    inv = 1.0 / (rotary_emb_base ** exps)
    freqs = pid[..., None] * inv                           # (B, S, D/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    sin_b = torch.sin(emb)[:, :, None, :]
    cos_b = torch.cos(emb)[:, :, None, :]

    def rope(t):
        if t is None:
            return None
        t1, t2 = t.chunk(2, dim=-1)
        rot = torch.cat([-t2, t1], dim=-1)
        return t * cos_b.to(t.dtype) + rot * sin_b.to(t.dtype)

    return rope(q), rope(k), rope(v)
