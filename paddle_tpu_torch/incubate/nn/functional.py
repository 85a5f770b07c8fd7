"""Fused-op surface (counterpart of ``paddle_tpu/incubate/nn/functional.py``).

Ported: the ``position_ids`` branch of the rotary embedding (the one the
Llama paths run), ``fused_linear_cross_entropy`` (the Llama training
loss), ``fused_rms_norm`` (the RMSNorm kernels) and
``variable_length_memory_efficient_attention`` (the flash kernels'
segment-id variant).
"""

from __future__ import annotations

import torch

from ...kernels.flash_attention import flash_attention_bshd
from ...kernels.rms_norm import rms_norm


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, **kwargs):
    """Paddle's fused residual-add + RMSNorm: ``h = x (+ bias)
    (+ residual)`` in PyTorch, then the RMSNorm kernels over the last axis
    (:func:`~paddle_tpu_torch.kernels.rms_norm.rms_norm`, differentiable),
    then ``+ norm_bias``. Returns ``(out, h)`` when a residual is given,
    else ``out``.

    The value is the JAX package's TPU route (its Pallas kernel): f32
    throughout and one rounding to x's dtype. Off the TPU the JAX package
    takes ``nn.functional.rms_norm``, which rounds ``x * r`` to x's dtype
    before the weight; in float32 the two agree. ``norm_weight=None``
    normalizes with a weight of ones (the same value as no weight). A
    ``begin_norm_axis`` other than the last axis and ``quant_scale > 0``
    raise ``NotImplementedError`` (the JAX package ignores them)."""
    if begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError(
            f"fused_rms_norm normalizes over the last axis only; got "
            f"begin_norm_axis={begin_norm_axis} for {x.dim()} dims")
    if quant_scale is not None and quant_scale > 0:
        raise NotImplementedError(
            "fused_rms_norm with quant_scale > 0 (quantized output) is not "
            "ported")
    h = x
    if bias is not None:
        h = h + bias
    if residual is not None:
        h = h + residual
    weight = norm_weight
    if weight is None:
        weight = torch.ones(h.shape[-1], dtype=h.dtype, device=h.device)
    out = rms_norm(h, weight, epsilon)
    if norm_bias is not None:
        out = out + norm_bias
    return (out, h) if residual is not None else out


def variable_length_memory_efficient_attention(
        query, key, value, seq_lens=None, kv_seq_lens=None, mask=None,
        scale=None, causal=False, pre_cache_length=0):
    """Ragged-batch attention in the ``(B, H, S, D)`` layout: row b's first
    ``seq_lens[b]`` positions carry segment 0 and the rest (padding)
    segment 1, and the flash kernels' segment-id variant keeps the two
    apart (padding rows attend to padding only, as in the JAX package).
    Without ``seq_lens`` it is plain flash attention. ``kv_seq_lens``,
    ``mask`` and ``pre_cache_length`` raise ``NotImplementedError`` (the
    JAX package ignores them)."""
    if kv_seq_lens is not None or mask is not None or pre_cache_length:
        raise NotImplementedError(
            "variable_length_memory_efficient_attention: kv_seq_lens, mask "
            "and pre_cache_length are not ported")
    qb, kb, vb = (t.transpose(1, 2) for t in (query, key, value))
    seg = None
    if seq_lens is not None:
        lens = torch.as_tensor(seq_lens, device=query.device).reshape(-1)
        pos = torch.arange(qb.shape[1], device=query.device)[None, :]
        seg = (pos >= lens[:, None]).to(torch.int32)
    out = flash_attention_bshd(qb, kb, vb, segment_ids=seg, causal=causal,
                               sm_scale=scale)
    return out.transpose(1, 2)


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


def _logits_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` with f32 output, as the reference's
    ``preferred_element_type=float32``: bf16/fp16 products accumulate in
    f32 and are not rounded back to the inputs' dtype. On the card that is
    one cuBLAS GEMM with an f32 output; on the host the inputs are widened
    first, which gives the same exact products."""
    if h.dtype == torch.float32:
        return h @ w
    if h.is_cuda:
        return torch.mm(h, w, out_dtype=torch.float32)
    return h.float() @ w.float()


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """Sum over token chunks of ``logsumexp(h W) - (h W)[label]``: the
    forward keeps only each token's f32 lse, the backward recomputes one
    chunk's logits at a time, so at most one (chunk, vocab) f32 block is
    live. The logits are f32 products (``_logits_f32``); the backward's
    dlogits are cast to the inputs' dtype for the two gradient products.
    Rows with a negative label add nothing."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, transpose_y, chunk):
        w = weight.t() if transpose_y else weight              # (H, V)
        vocab = w.shape[1]
        total = torch.zeros((), device=hidden.device, dtype=torch.float32)
        lses = []
        for c0 in range(0, hidden.shape[0], chunk):
            logits = _logits_f32(hidden[c0:c0 + chunk], w)
            lse = torch.logsumexp(logits, dim=-1)
            lab = labels[c0:c0 + chunk]
            gold = logits.gather(1, lab.clamp(0, vocab - 1)[:, None])[:, 0]
            total = total + torch.where(lab >= 0, lse - gold,
                                        torch.zeros_like(lse)).sum()
            lses.append(lse)
        count = (labels >= 0).sum().clamp_min(1).to(torch.float32)
        ctx.save_for_backward(hidden, weight, labels, torch.cat(lses), count)
        ctx.transpose_y, ctx.chunk = transpose_y, chunk
        return total / count

    @staticmethod
    def backward(ctx, grad):
        hidden, weight, labels, lse, count = ctx.saved_tensors
        w = weight.t() if ctx.transpose_y else weight
        vocab = w.shape[1]
        scale = grad.float() / count
        dh = torch.empty_like(hidden)
        dw = torch.zeros(w.shape, device=w.device, dtype=torch.float32)
        for c0 in range(0, hidden.shape[0], ctx.chunk):
            h_c = hidden[c0:c0 + ctx.chunk]
            lab = labels[c0:c0 + ctx.chunk]
            p = torch.exp(_logits_f32(h_c, w) - lse[c0:c0 + ctx.chunk, None])
            p.scatter_add_(1, lab.clamp(0, vocab - 1)[:, None],
                           -torch.ones_like(p[:, :1]))
            p = p * ((lab >= 0).float() * scale)[:, None]
            dlogits = p.to(hidden.dtype)
            dh[c0:c0 + ctx.chunk] = dlogits @ w.t()
            dw += (h_c.t() @ dlogits).float()
        dw = dw.to(weight.dtype)
        return dh, (dw.t() if ctx.transpose_y else dw), None, None, None


def fused_linear_cross_entropy(hidden, weight, labels, transpose_y=False,
                               ignore_index=-100, chunk_tokens=1024):
    """LM-head product + softmax cross-entropy without materialising the
    (tokens, vocab) f32 logits: the product runs over chunks of
    ``chunk_tokens`` tokens (a GEMM with f32 logits out, then the softmax
    in f32), and the backward recomputes each chunk.

    ``weight``: (H, V), or (V, H) with ``transpose_y=True`` (tied
    embeddings). Labels < 0 or == ``ignore_index`` are masked out; returns
    the mean loss over unmasked tokens (the count clamped to >= 1)."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    l2 = labels.reshape(-1).long()
    l2 = torch.where(l2 == ignore_index, torch.full_like(l2, -1), l2)
    return _FusedLinearCrossEntropy.apply(h2, weight, l2, bool(transpose_y),
                                          max(1, int(chunk_tokens)))
