"""Functional surface of the ported slices (counterpart of
``paddle_tpu/nn/functional.py``): RMSNorm, SwiGLU, dropout, the training
attention (``scaled_dot_product_attention`` on the flash kernels, or its
dense path with a mask or dropout; ``flash_attention``;
``flash_attn_unpadded`` on the kernels' segment-id variant for packed
sequences), the paged attention that routes a whole-prompt prefill
(S > 1), a prefill chunk (S > 1 under a ``PagedChunkState``) or a decode
step (S == 1), and generation's attention over a ring-buffer cache
(``cached_scaled_dot_product_attention``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as TF

from ..amp.auto_cast import amp_cast
from ..kernels.decode_attention import cached_attention, update_kv_cache
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


def dropout(x: torch.Tensor, p: float = 0.5, axis=None,
            training: bool = True, mode: str = "upscale_in_train",
            name=None, *, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
    """Paddle's ``dropout``. In training the keep-mask is ``rand < 1 - p``
    drawn from ``generator`` (required: the port has no global random
    key), over ``x``'s shape or, with ``axis``, over those axes only
    (broadcast along the others); ``upscale_in_train`` divides the kept
    values by ``1 - p``. Outside training it is the identity, or a scale
    by ``1 - p`` under ``downscale_in_infer``."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            return (x * (1.0 - p)).to(x.dtype)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [n if i in axes else 1 for i, n in enumerate(shape)]
    keep = _keep_mask(shape, p, x.device, generator)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def _keep_mask(shape, p: float, device, generator) -> torch.Tensor:
    if generator is None:
        raise ValueError("dropout in training draws its mask from an "
                         "explicit torch.Generator: pass generator=")
    draw = torch.rand(shape, generator=generator, device=generator.device)
    return draw.to(device) < (1.0 - p)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None, *,
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """SDPA in Paddle's ``(B, S, H, D)`` layout, GQA kv unexpanded (query
    head h reads kv head ``h // (H // Hkv)``).

    Without a mask or training dropout it runs the flash-attention kernels
    (:func:`flash_attention_bshd`) at every length. With ``attn_mask``
    (bool: True keeps; else additive, broadcast to ``(B, H, S, T)``) or
    ``dropout_p > 0`` in training it takes the JAX package's dense path, in
    plain PyTorch: scores in q's dtype, the causal and a bool mask filled
    with -1e30, softmax in f32 cast to q's dtype, then dropout of the
    probabilities with a keep-mask drawn from ``generator`` (required
    then). Only this path expands GQA kv. Under ``amp.auto_cast`` the
    inputs are cast as the op ``sdpa``."""
    query, key, value = amp_cast("sdpa", query, key, value)
    if attn_mask is None and not (dropout_p > 0.0 and training):
        return flash_attention_bshd(query, key, value, causal=is_causal)
    return _sdpa_dense(query, key, value, attn_mask, dropout_p, is_causal,
                       training, generator)


def _sdpa_dense(q, k, v, attn_mask, dropout_p, is_causal, training,
                generator):
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scores = torch.matmul(qt, kt.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if is_causal:
        s, t = scores.shape[-2:]
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(rows < cols, -1e30)
    if attn_mask is not None:
        mask = attn_mask.to(q.device)
        if mask.dtype == torch.bool:
            scores = torch.where(mask, scores, -1e30)
        else:
            scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        keep = _keep_mask(probs.shape, dropout_p, q.device, generator)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            0.0).to(q.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)


def _refuse_softmax_and_dropout(return_softmax, dropout, training):
    if return_softmax:
        raise NotImplementedError(
            "return_softmax requires materializing the (S, S) matrix the "
            "flash kernels exist to avoid: use the plain "
            "flash_attention_ref for debugging")
    if dropout and training:   # inference dropout is a no-op, like the ref
        raise NotImplementedError("attention dropout is not folded into "
                                  "the flash kernels")


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    fixed_seed_offset=None, rng_name: str = "",
                    training: bool = True, name=None):
    """Paddle's ``flash_attention``: ``(B, S, H, D)`` layout, returns
    ``(out, None)`` (the softmax is never materialised). Runs the flash
    kernels; ``return_softmax`` and training-time dropout raise, as in the
    JAX package."""
    _refuse_softmax_and_dropout(return_softmax, dropout, training)
    return scaled_dot_product_attention(query, key, value, is_causal=causal,
                                        training=training), None


def _segment_ids(cu: torch.Tensor, total: int, device) -> torch.Tensor:
    """Token i's segment: the index of the boundary interval that holds it
    (``searchsorted(cu, i, right=True)``: 1 for the first sequence)."""
    pos = torch.arange(total, device=device)
    return torch.searchsorted(cu.to(device=device, dtype=torch.int64), pos,
                              right=True).to(torch.int32)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None,
                        dropout: float = 0.0, causal: bool = False,
                        return_softmax: bool = False,
                        fixed_seed_offset=None, rng_name: str = "",
                        training: bool = True, name=None):
    """Varlen (packed) attention: ``query`` ``(total_q, H, D)``,
    ``key``/``value`` ``(total_k, Hkv, D)`` with cumulative boundaries
    ``cu_seqlens_q``/``cu_seqlens_k`` (leading 0). Returns ``(out, None)``,
    out ``(total_q, H, D)``; differentiable.

    The pack becomes one flash call whose segment ids (token i of sequence
    j carries j + 1) keep the sequences apart: the kernels' segment-id
    variant, for a self-attention pack (identical boundaries; the global
    causal order is then each sequence's own) and for any pack without a
    causal mask. A *causal* cross-pack (``cu_q != cu_k``) takes the JAX
    package's dense, segment-masked route with each sequence's local
    positions, in plain PyTorch: it launches no kernel. The route is chosen
    by layout, never on failure, as in the JAX package; the kernels take
    any total length, so the JAX package's dense fallback for a total that
    is not block-divisible has no counterpart. Deciding ``cu_q == cu_k``
    reads both boundary tensors on the host once a call (the JAX package
    reads them with ``np.asarray``). ``max_seqlen_*`` are taken for
    Paddle's signature and not needed."""
    _refuse_softmax_and_dropout(return_softmax, dropout, training)
    same_pack = torch.equal(cu_seqlens_q.detach().cpu().long(),
                            cu_seqlens_k.detach().cpu().long())
    tq, tk = query.shape[0], key.shape[0]
    seg_q = _segment_ids(cu_seqlens_q, tq, query.device)
    seg_k = _segment_ids(cu_seqlens_k, tk, query.device)
    sc = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    if same_pack or not causal:
        out = flash_attention_bshd(query[None], key[None], value[None],
                                   segment_ids=seg_q[None],
                                   kv_segment_ids=seg_k[None], causal=causal,
                                   sm_scale=sc)
        return out[0], None
    return _unpadded_dense(query, key, value, cu_seqlens_q, cu_seqlens_k,
                           seg_q, seg_k, sc), None


def _unpadded_dense(q, k, v, cu_q, cu_k, seg_q, seg_k, sc):
    """The causal cross-pack: dense f32 scores masked to one sequence and
    to its local causal order (JAX's ``flash_attn_unpadded`` dense route);
    a row that sees no key emits zeros."""
    h, hkv = q.shape[1], k.shape[1]
    kx = k.repeat_interleave(h // hkv, dim=1) if hkv != h else k
    vx = v.repeat_interleave(h // hkv, dim=1) if hkv != h else v
    s = torch.einsum("qhd,khd->hqk", q.float(), kx.float()) * sc
    mask = seg_q[:, None] == seg_k[None, :]
    zero = torch.zeros(1, dtype=torch.int64, device=q.device)
    start_q = torch.cat([zero, cu_q.to(q.device).long()])[seg_q.long()]
    start_k = torch.cat([zero, cu_k.to(q.device).long()])[seg_k.long()]
    loc_q = torch.arange(q.shape[0], device=q.device) - start_q
    loc_k = torch.arange(k.shape[0], device=q.device) - start_k
    mask &= loc_q[:, None] >= loc_k[None, :]
    s = s.masked_fill(~mask[None], -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[None, :, None], p, torch.zeros_like(p))
    return torch.einsum("hqk,khd->qhd", p, vx.float()).to(q.dtype)


def cached_scaled_dot_product_attention(query, key, value, k_cache, v_cache,
                                        offset: int):
    """Attention over a ring-buffer KV cache (the masked-MHA cache branch
    of Paddle's ``fused_multi_transformer``): the new key/value block
    ``(B, S, Hkv, D)`` is written into the caches ``(B, T, Hkv, D)`` at
    sequence position ``offset`` (a host int; :func:`update_kv_cache`, in
    place), then ``query`` ``(B, S, H, D)`` (GQA allowed) attends causally
    to the written prefix ``[0, offset + S)``: S > 1 runs the prefill
    kernel, S == 1 the dense composition, as the JAX package does outside
    Pallas (:func:`cached_attention`). Returns ``(out, k_cache, v_cache)``,
    the caches the same tensors."""
    off = int(offset)
    update_kv_cache(k_cache, v_cache, key, value, off)
    out = cached_attention(query, k_cache, v_cache, off + query.shape[1])
    return out, k_cache, v_cache


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
            f"{type(state).__name__}: paged attention takes a paged state "
            "(PagedDecodeState, PagedChunkState); a (k_cache, v_cache) "
            "ring buffer goes through cached_scaled_dot_product_attention")
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
