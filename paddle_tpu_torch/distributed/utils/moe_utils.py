"""``global_scatter`` / ``global_gather`` (counterpart of
``paddle_tpu/distributed/utils/moe_utils.py``): the reference's ragged
per-expert repack of rows, on the host-visible counts.

The JAX package reproduces Paddle's single-controller semantics and never
moves rows between devices (its MoE dispatches through static-capacity
products), so here too the repack is local: ``x``'s rows, grouped in
run-length blocks by ``local_count``, are laid out in blocks of
``global_count``; each block copies ``min`` of the two counts (excess rows
dropped, a short block zero-padded). Each op's backward is the other
repack. A ``group`` of more than one rank raises ``NotImplementedError``
(the reference ignores its group).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["global_scatter", "global_gather"]


def _host_counts(c) -> np.ndarray:
    if isinstance(c, torch.Tensor):
        c = c.detach().cpu().numpy()
    return np.asarray(c).astype(np.int64).ravel()


def _repack(x: torch.Tensor, src: np.ndarray, dst: np.ndarray):
    if src.shape != dst.shape:
        raise ValueError(f"count layouts differ in length: {src.shape[0]} "
                         f"vs {dst.shape[0]}")
    out = x.new_zeros((int(dst.sum()),) + tuple(x.shape[1:]))
    a = b = 0
    for s, d in zip(src.tolist(), dst.tolist()):
        n = min(s, d)
        if n:
            out[b:b + n] = x[a:a + n]
        a += s
        b += d
    return out


class _Repack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst):
        ctx.src, ctx.dst = src, dst
        return _repack(x, src, dst)

    @staticmethod
    def backward(ctx, g):
        return _repack(g, ctx.dst, ctx.src), None, None


def _check_group(group) -> None:
    if group is not None and getattr(group, "nranks", 1) > 1:
        raise NotImplementedError(
            "global_scatter / global_gather move no rows between ranks (the "
            "reference's single-controller repack); a group of "
            f"{group.nranks} ranks is refused")


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    """Rows of ``x`` in ``local_count`` blocks repacked into
    ``global_count`` blocks."""
    _check_group(group)
    lc, gc = _host_counts(local_count), _host_counts(global_count)
    if int(lc.sum()) != x.shape[0]:
        raise ValueError(f"local_count sums to {int(lc.sum())}, x has "
                         f"{x.shape[0]} rows")
    return _Repack.apply(x, lc, gc)


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    """The inverse of :func:`global_scatter`."""
    _check_group(group)
    lc, gc = _host_counts(local_count), _host_counts(global_count)
    if int(gc.sum()) != x.shape[0]:
        raise ValueError(f"global_count sums to {int(gc.sum())}, x has "
                         f"{x.shape[0]} rows")
    return _Repack.apply(x, gc, lc)
