"""The sampling law as plain PyTorch functions.

Counterparts of ``paddle_tpu/generation/__init__.py``'s
``_apply_logit_adjust``, ``_top_k_filter`` and ``_top_p_filter`` and of
``paddle_tpu/generation/serving.py``'s ``_spec_filtered_probs``: the
repetition penalty and the min-length eos mask, temperature, a static
top-k, a nucleus top-p and a softmax over f32 logits rows. The speculative
engine's draft and verify programs return these distributions, and its
rejection sampler divides them; ``GenerationMixin.generate`` samples from
them.

Draws differ from the JAX package by design (its ``jax.random`` bits
cannot be reproduced): :func:`race_sample` takes its uniforms as an input,
so a CUDA graph replays it with the uniforms staged for each call.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["_apply_logit_adjust", "_top_k_filter", "_top_p_filter",
           "_spec_filtered_probs", "race_sample"]

_NEG_INF = -1e30
# the least uniform a race draws with: -log(u) stays finite
_U_MIN = 1e-20

Scalar = Union[float, torch.Tensor]


def _f32(x: Scalar, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _apply_logit_adjust(lg: torch.Tensor, seen: torch.Tensor, step: int,
                        repetition_penalty: float, min_new_tokens: int,
                        eos_token_id) -> torch.Tensor:
    """The repetition penalty over the tokens already seen (``seen``:
    (rows, V) bool; positive logits divide by the penalty, negative ones
    multiply), then, while ``step < min_new_tokens``, ``eos_token_id``
    masked to -1e30. Shared by the sampling and beam loops."""
    if repetition_penalty != 1.0:
        pen = torch.where(lg > 0, lg / repetition_penalty,
                          lg * repetition_penalty)
        lg = torch.where(seen, pen, lg)
    if eos_token_id is not None and step < min_new_tokens:
        lg = lg.clone()
        lg[..., int(eos_token_id)] = _NEG_INF
    return lg


def _top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the logits at or above the k-th largest of each row (ties at
    the threshold all stay, as the JAX package's ``logits < kth``); the
    rest become -1e30."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG_INF, logits)


def _top_p_filter(logits: torch.Tensor, top_p: Scalar) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of descending-probability
    tokens whose mass reaches ``top_p`` (the first token always stays: the
    exclusive cumulative sum starts at 0). ``top_p`` may be a device
    tensor, so a captured graph reads it at replay."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    keep = cum_excl < _f32(top_p, logits)
    cutoff = torch.where(keep, sorted_desc, torch.inf).amin(
        dim=-1, keepdim=True)
    return torch.where(logits >= cutoff, logits, _NEG_INF)


def _spec_filtered_probs(rows: torch.Tensor, temperature: Scalar, top_k: int,
                         top_p: Scalar) -> torch.Tensor:
    """The sampling law of f32 logits ``rows`` (..., V) as a distribution:
    divide by ``temperature`` (at least 1e-6), keep the top ``top_k``
    (static; 0 keeps all), then the ``top_p`` nucleus, softmax.
    ``temperature`` and ``top_p`` may be device tensors."""
    lg = rows / _f32(temperature, rows).clamp_min(1e-6)
    if top_k and top_k > 0:
        lg = _top_k_filter(lg, int(top_k))
    lg = _top_p_filter(lg, top_p)
    return torch.softmax(lg, dim=-1)


def race_sample(q: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw from each distribution row of ``q`` (..., V) by an
    exponential race: ``argmax(q / -log(u))`` over uniforms ``u`` of q's
    shape, which picks index i with probability ``q_i / sum(q)``. A token
    of probability 0 never wins."""
    e = -torch.log(u.clamp_min(_U_MIN))
    return torch.argmax(q / e, dim=-1)
