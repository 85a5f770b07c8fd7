"""Activation recompute (counterpart of
``paddle_tpu/distributed/fleet/utils/recompute.py``): the reference's
``fleet.utils.recompute(function, *args)``, on non-reentrant
``torch.utils.checkpoint``. The forward keeps only the inputs; the
backward runs the function again to rebuild its activations.

The reference's contract holds: a Layer's (or a bound method's
Layer's) parameters receive gradients, non-tensor positional arguments
pass through unchanged (a Python flag stays a Python value), a nested
return comes back in its structure, and a trainable tensor passed as a
keyword raises ``TypeError``. ``use_reentrant`` is accepted for the
signature (the reference's ``jax.checkpoint`` has one mode too).

The replayed dropout masks equal the first forward's: the port's dropout
draws from explicit generators (never the global one), so besides the
default generators that ``preserve_rng_state`` restores, the state of
every ``generator`` attribute of the Layer's modules is saved before the
forward and set again for the recompute (then put back where the
backward found it).
"""

from __future__ import annotations

import contextlib
from typing import List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["recompute"]


def _generators(function) -> List[torch.Generator]:
    owner = function if isinstance(function, nn.Module) \
        else getattr(function, "__self__", None)
    if not isinstance(owner, nn.Module):
        return []
    out: List[torch.Generator] = []
    for m in owner.modules():
        g = getattr(m, "generator", None)
        if isinstance(g, torch.Generator) and all(g is not h for h in out):
            out.append(g)
    return out


def _replay(gens: List[torch.Generator]):
    """(forward context, recompute context): the first records each
    generator's state, the second sets it for the recompute and restores
    the current one after."""
    saved: list = []

    @contextlib.contextmanager
    def forward():
        saved[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def again():
        now = [g.get_state() for g in gens]
        for g, st in zip(gens, saved):
            g.set_state(st)
        try:
            yield
        finally:
            for g, st in zip(gens, now):
                g.set_state(st)

    return forward(), again()


def recompute(function, *args, use_reentrant: bool = True,
              preserve_rng_state: bool = True, **kwargs):
    """``function(*args, **kwargs)`` under activation recompute."""
    for k, v in kwargs.items():
        if isinstance(v, torch.Tensor) and v.requires_grad:
            raise TypeError(
                f"recompute() keyword argument {k!r} is a trainable tensor; "
                "keyword arguments are constants (no gradient flows). Pass "
                "it positionally instead, as the reference requires.")
    gens = _generators(function)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state,
                      context_fn=lambda: _replay(gens), **kwargs)
