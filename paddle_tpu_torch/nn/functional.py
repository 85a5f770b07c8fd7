"""Functional surface of the ported slices (counterpart of
``paddle_tpu/nn/functional.py``): RMSNorm, SwiGLU, the training attention
(``scaled_dot_product_attention`` on the flash kernels) and the paged
attention that routes a whole-prompt prefill (S > 1), a prefill chunk
(S > 1 under a ``PagedChunkState``) or a decode step (S == 1)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as TF

from ..kernels.decode_attention import cached_attention
from ..kernels.flash_attention import flash_attention_bshd
from ..kernels.paged_attention import (PagedChunkState, PagedDecodeState,
                                       is_paged_state, paged_attention,
                                       paged_chunk_attention, write_paged_kv,
                                       write_paged_prompt,
                                       write_paged_prompt_at)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm: f32 moments, cast back to x's dtype, then the weight."""
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    out = (h * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    return out


def swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """silu(x) * y; with ``y=None`` x splits in two on its last axis."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return TF.silu(x) * y


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True) -> torch.Tensor:
    """SDPA in Paddle's ``(B, S, H, D)`` layout, GQA kv unexpanded (query
    head h reads kv head ``h // (H // Hkv)``). Runs the flash-attention
    kernels (:func:`flash_attention_bshd`) for every length. A mask or
    dropout took the JAX package's dense XLA path, which is not ported."""
    if attn_mask is not None:
        raise NotImplementedError(
            "scaled_dot_product_attention with attn_mask (the dense path) is "
            "not ported: a later slice")
    if dropout_p > 0.0:
        raise NotImplementedError(
            "scaled_dot_product_attention with dropout_p > 0 (the dense "
            "path) is not ported: a later slice")
    return flash_attention_bshd(query, key, value, causal=is_causal)


def paged_scaled_dot_product_attention(query, key, value, state
                                       ) -> Tuple[torch.Tensor,
                                                  PagedDecodeState]:
    """Paged (block-table) attention of ``query``/``key``/``value``
    ``(B, S, H|Hkv, D)`` against one layer's :class:`PagedDecodeState` or,
    for chunked prefill, :class:`PagedChunkState`; the state's type picks
    the S > 1 route.

    Prefill (S > 1, ``PagedDecodeState``, empty sequences): the prompt's k/v
    are written to the pool and the prompt attends causally to itself
    (:func:`cached_attention`, the prefill kernel). Chunked prefill (S > 1,
    ``PagedChunkState``, B = 1): the chunk is written at positions
    ``seq_lens .. seq_lens+S-1`` (positions past the block table dropped)
    and attends to the written prefix plus itself through the block table
    (:func:`paged_chunk_attention`); the returned ``seq_lens`` advance by
    the full S, so the driver keeps the true lengths. Decode (S == 1): the
    token is written at position ``seq_lens`` and attends through the
    block tables (:func:`paged_attention`). The state's pools are native
    tensors or ``QuantizedPages``: every write quantizes for an int8 pool
    and every reader dequantizes (whole-prompt prefill attends to the
    prompt's own unquantized k/v, as the JAX package does). Returns
    ``(out, new_state)``, the state of the type given; the pools are
    updated in place."""
    if not is_paged_state(state):
        raise NotImplementedError(
            f"{type(state).__name__}: only the paged states "
            "(PagedDecodeState, PagedChunkState) are ported")
    kp, vp, bt, sl = state
    s = query.shape[1]
    if s > 1 and isinstance(state, PagedChunkState):
        if query.shape[0] != 1:
            raise NotImplementedError(
                "chunked paged prefill is per-request (B = 1); got batch "
                f"{query.shape[0]}")
        write_paged_prompt_at(kp, vp, key, value, bt, sl)
        out = paged_chunk_attention(query, kp, vp, bt, sl)
    elif s > 1:
        # the whole-prompt contract: the sequences are empty. Checked where
        # the lengths are on the host already; on the card it is the
        # caller's (reading them back would stall every layer)
        if sl.device.type == "cpu" and int(sl.max()) != 0:
            raise ValueError(
                "paged prefill (S > 1) requires empty sequences (seq_lens "
                f"all 0); got max {int(sl.max())}. Use a PagedChunkState "
                "(chunked prefill) to extend non-empty sequences")
        write_paged_prompt(kp, vp, key, value, bt)
        out = cached_attention(query, key, value, s)
    else:
        write_paged_kv(kp, vp, key[:, 0], value[:, 0], bt, sl)
        out = paged_attention(query[:, 0], kp, vp, bt, sl + 1)[:, None]
    return out, type(state)(kp, vp, bt, sl + s)
