"""Fused-op surface (counterpart of ``paddle_tpu/incubate/nn/functional.py``).

Ported: every branch of the rotary embedding (angles from
``position_ids`` or from ``sin``/``cos`` tables, neox or interleaved,
batch- or time-major), ``fused_linear_cross_entropy`` (the training loss
of the Llama and GPT paths), the weight-only quantization pair
``weight_quantize`` / ``weight_only_linear`` (shared with
:mod:`paddle_tpu_torch.nn.quant`), ``fused_rms_norm`` (the RMSNorm
kernels), ``variable_length_memory_efficient_attention`` (the flash
kernels' segment-id variant); the training-side fused ops
``fused_layer_norm``, ``fused_dropout_add``,
``fused_bias_dropout_residual_layer_norm``, ``fused_linear``,
``fused_linear_activation``, ``fused_matmul_bias``, ``swiglu``,
``fused_multi_head_attention`` (its attention through SDPA: the flash
kernels, not causal, when unmasked and without training dropout),
``fused_feedforward`` and ``fused_ec_moe``, compositions in PyTorch as
the JAX package's are in XLA, their dropout drawn from an explicit
``generator``; and Paddle's fused serving entry points:
``fused_multi_transformer`` (the whole stack over ``(2, B, H, T, D)``
caches), ``masked_multihead_attention`` (one-token attention over a
``(2, B, T, H, D)`` cache), ``fused_block_decode`` (the one-layer fused
decode kernel) and ``block_multihead_attention`` (attention through block
tables: prefill on the prefill kernel, decode on the paged decode kernel).

Unlike the JAX package, whose ``masked_multihead_attention`` and
``fused_multi_transformer`` decode dispatch through the decode program
cache with the caches donated, the port runs them eagerly and updates the
caller's caches in place: a CUDA graph binds its tensors' addresses, and a
caller passes its caches anew on each call.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...kernels.decode_attention import cached_attention, update_kv_cache
from ...kernels.flash_attention import flash_attention_bshd
from ...kernels.fused_block_decode import BlockDecodeWeights
from ...kernels.fused_block_decode import fused_block_decode as _fbd
from ...kernels.paged_attention import PagedDecodeState
from ...kernels.rms_norm import rms_norm
from ...nn import functional as F
from ...nn.functional import paged_scaled_dot_product_attention


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
    """Rotary embedding of q/k/v ``(B, S, H, D)`` (``(S, B, H, D)`` with
    ``time_major``), the JAX package's branches: without ``sin``/``cos``
    the angles come from ``position_ids`` ``(B, S)`` (batch-major) or from
    the positions ``0..S-1``, in f32, with each frequency twice
    (``cat([f, f])``); with tables ``(S, D)`` (more dimensions reshape to
    ``(S, D)``) their rows are taken at ``position_ids`` when given. The
    neox style rotates halves; the other style pairs even and odd lanes,
    reading the tables' even lanes. Applied in each tensor's own dtype.
    Returns ``(q, k, v)`` with ``None`` passed through."""
    s = q.shape[0 if time_major else 1]
    d = q.shape[-1]
    f32 = torch.float32
    if sin is None or cos is None:
        exps = torch.arange(0, d, 2, dtype=f32, device=q.device) / d
        inv = 1.0 / (rotary_emb_base ** exps)
    if (sin is None or cos is None) and position_ids is not None:
        # straight from the positions: decode positions pass the chunk
        freqs = position_ids.to(f32)[..., None] * inv       # (B, S, D/2)
        emb = torch.cat([freqs, freqs], dim=-1)
        sin_b, cos_b = torch.sin(emb)[:, :, None], torch.cos(emb)[:, :, None]
    else:
        if sin is None or cos is None:
            freqs = torch.outer(torch.arange(s, dtype=f32, device=q.device),
                                inv)
            emb = torch.cat([freqs, freqs], dim=-1)
            sin_v, cos_v = torch.sin(emb), torch.cos(emb)
        else:
            sin_v = sin.reshape(s, d) if sin.dim() > 2 else sin
            cos_v = cos.reshape(s, d) if cos.dim() > 2 else cos
        if sin is not None and cos is not None and position_ids is not None:
            pid = position_ids.long()
            sin_b, cos_b = sin_v[pid][:, :, None], cos_v[pid][:, :, None]
        elif time_major:
            sin_b, cos_b = sin_v[:, None, None], cos_v[:, None, None]
        else:
            sin_b, cos_b = sin_v[None, :, None], cos_v[None, :, None]

    def rope(t):
        if t is None:
            return None
        sn, cs = sin_b.to(t.dtype), cos_b.to(t.dtype)
        if use_neox_rotary_style:
            t1, t2 = t.chunk(2, dim=-1)
            return t * cs + torch.cat([-t2, t1], dim=-1) * sn
        even, odd = t[..., 0::2], t[..., 1::2]
        cs, sn = cs[..., 0::2], sn[..., 0::2]
        return torch.stack([even * cs - odd * sn, odd * cs + even * sn],
                           dim=-1).reshape(t.shape)

    return rope(q), rope(k), rope(v)


# --------------------------------------------------- training-side fused ops
_QUANT_OUT_ARGS = ("quant_round_type", "quant_max_bound", "quant_min_bound")


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None,
                     quant_scale=-1, residual_alpha=1.0, **kwargs):
    """Paddle's fused residual-add + LayerNorm: ``h = x (+ bias)
    (+ residual)``, then layer norm over the axes from
    ``begin_norm_axis`` (-1: the last axis). Returns ``(out, h)`` when a
    residual is given, else ``out``. Another negative axis (the JAX
    package normalizes the last axis for every negative value),
    ``quant_scale > 0``, ``residual_alpha`` != 1 and any other keyword
    but the quantized output's rounding and bounds (which only
    ``quant_scale`` uses) raise ``NotImplementedError``: the JAX package
    ignores them."""
    if begin_norm_axis < 0 and begin_norm_axis != -1:
        raise NotImplementedError(
            f"fused_layer_norm: begin_norm_axis={begin_norm_axis}; give a "
            "non-negative axis or -1 (the last)")
    unknown = sorted(set(kwargs) - set(_QUANT_OUT_ARGS))
    if ((quant_scale is not None and quant_scale > 0)
            or residual_alpha != 1.0 or unknown):
        raise NotImplementedError(
            "fused_layer_norm: quant_scale > 0 (quantized output), "
            f"residual_alpha != 1 and {unknown or 'other keywords'} are "
            "not ported")
    h = x
    if bias is not None:
        h = h + bias
    if residual is not None:
        h = h + residual
    shape = (tuple(h.shape[begin_norm_axis:]) if begin_norm_axis >= 0
             else h.shape[-1])
    out = F.layer_norm(h, shape, norm_weight, norm_bias, epsilon)
    return (out, h) if residual is not None else out


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      *, generator: Optional[torch.Generator] = None):
    """``dropout(x) + y``; training dropout draws from ``generator``."""
    return F.dropout(x, p=p, training=training, mode=mode,
                     generator=generator) + y


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True, *,
        generator: Optional[torch.Generator] = None):
    """``layer_norm(dropout(x + bias) + residual)`` over the last axis;
    training dropout draws from ``generator``."""
    h = x if bias is None else x + bias
    h = F.dropout(h, p=dropout_rate, training=training, generator=generator)
    h = h + residual
    return F.layer_norm(h, h.shape[-1], ln_scale, ln_bias, ln_epsilon)


def _t(w, on: bool):
    return w.transpose(-1, -2) if on else w


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """``x @ W (+ b)``; ``transpose_weight``: W is ``(out, in)``."""
    return F.linear(x, _t(weight, transpose_weight), bias)


def fused_linear_activation(x, y, bias=None, trans_x=False, trans_y=False,
                            activation="gelu"):
    """``act(x @ y + bias)``: exact GELU for ``"gelu"``, ReLU for
    ``"relu"``, no activation for any other name (as in the JAX
    package)."""
    out = _t(x, trans_x) @ _t(y, trans_y)
    if bias is not None:
        out = out + bias
    if activation == "gelu":
        return F.gelu(out)
    if activation == "relu":
        return F.relu(out)
    return out


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False):
    """``x @ y (+ bias)``, either side transposed on its last two axes."""
    out = _t(x, transpose_x) @ _t(y, transpose_y)
    return out if bias is None else out + bias


def swiglu(x, y=None):
    """``silu(x) * y`` (``y=None``: x split in two on its last axis)."""
    return F.swiglu(x, y)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=None,
                               transpose_qkv_wb=False, *,
                               generator: Optional[torch.Generator] = None):
    """Paddle's fused attention block on ``x`` ``(B, S, D)``: (pre-LN) ->
    qkv through ``qkv_weight`` ``(3, H, Dh, D)`` (+ ``qkv_bias`` ``(3, H,
    Dh)``) -> with ``cache_kv`` ``(2, B, Sc, H, Dh)`` the cached k/v
    prepended -> :func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`
    (not causal; unmasked and without training dropout it is the flash
    kernels) -> ``linear_weight`` ``(H * Dh, D)`` (+ bias) -> dropout ->
    (+ residual) -> (post-LN). Dropout in training draws from
    ``generator``. ``ring_id`` != -1 (tensor parallel),
    ``transpose_qkv_wb`` and a ``num_heads`` other than ``qkv_weight``'s
    raise ``NotImplementedError`` (the JAX package ignores them)."""
    if ring_id != -1 or transpose_qkv_wb:
        raise NotImplementedError(
            "fused_multi_head_attention: ring_id (tensor parallel) and "
            "transpose_qkv_wb are not ported; qkv_weight is (3, H, Dh, D)")
    if num_heads is not None and num_heads != qkv_weight.shape[1]:
        raise NotImplementedError(
            f"fused_multi_head_attention: num_heads={num_heads} but "
            f"qkv_weight {tuple(qkv_weight.shape)} has {qkv_weight.shape[1]}"
            " heads (the heads come from the weight)")
    residual = x
    h = x
    if pre_layer_norm:
        h = F.layer_norm(h, h.shape[-1], pre_ln_scale, pre_ln_bias,
                         pre_ln_epsilon)
    b, s, _ = h.shape
    nh, hd = qkv_weight.shape[1], qkv_weight.shape[2]
    qkv = torch.einsum("bsd,thed->bsthe", h, qkv_weight)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape(1, 1, 3, nh, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if cache_kv is not None:
        k = torch.cat([cache_kv[0], k], dim=1)
        v = torch.cat([cache_kv[1], v], dim=1)
    out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0, training=training,
        generator=generator)
    out = F.linear(out.reshape(b, s, nh * hd), linear_weight, linear_bias)
    out = F.dropout(out, p=dropout_rate, training=training, mode=mode,
                    generator=generator)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1], ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln1_epsilon=1e-5,
                      ln2_epsilon=1e-5, pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1, *,
                      generator: Optional[torch.Generator] = None):
    """Paddle's fused FFN block: (pre-LN) -> linear1 -> the activation of
    :mod:`~paddle_tpu_torch.nn.functional` named ``activation`` -> dropout
    -> linear2 -> dropout -> + residual -> (post-LN). Dropout in training
    draws from ``generator``; ``ring_id`` != -1 (tensor parallel) raises
    ``NotImplementedError``."""
    if ring_id != -1:
        raise NotImplementedError(
            "fused_feedforward: ring_id (tensor parallel) is not ported")
    residual = x
    h = x
    if pre_layer_norm:
        h = F.layer_norm(h, h.shape[-1], ln1_scale, ln1_bias, ln1_epsilon)
    h = F.linear(h, linear1_weight, linear1_bias)
    h = getattr(F, activation)(h)
    h = F.dropout(h, p=dropout1_rate, training=training, mode=mode,
                  generator=generator)
    h = F.linear(h, linear2_weight, linear2_bias)
    h = F.dropout(h, p=dropout2_rate, training=training, mode=mode,
                  generator=generator)
    out = residual + h
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1], ln2_scale, ln2_bias,
                           ln2_epsilon)
    return out


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu"):
    """Paddle's expert-choice soft-combined MoE FFN: every token through
    every expert, ``act(x @ W0[e] + b0[e]) @ W1[e] + b1[e]`` (batched
    products; ``act`` GELU in its tanh form, as ``jax.nn.gelu``'s default,
    or ReLU), weighted by ``softmax(gate)`` ``(B, S, E)`` and summed."""
    act = {"gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
           "relu": torch.relu}[act_type]
    h = act(torch.einsum("bsd,edh->bseh", x, bmm0_weight) + bmm0_bias)
    out = torch.einsum("bseh,ehd->bsed", h, bmm1_weight) + bmm1_bias
    return torch.einsum("bsed,bse->bsd", out, torch.softmax(gate, dim=-1))


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
    Rows with a negative label add nothing. With a tensor-parallel
    ``group`` the weight is this rank's vocabulary shard and each row's
    lse and label logit are reduced over the group
    (``parallel_fused_linear_cross_entropy``); ``count`` replaces the
    local count of unmasked rows (the data-parallel global count)."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, transpose_y, chunk, group=None,
                count=None):
        w = weight.t() if transpose_y else weight              # (H, V)
        vocab = w.shape[1]
        # a tensor-parallel group: w is this rank's vocabulary shard
        start = 0 if group is None else group.rank * vocab
        total = torch.zeros((), device=hidden.device, dtype=torch.float32)
        lses = []
        for c0 in range(0, hidden.shape[0], chunk):
            logits = _logits_f32(hidden[c0:c0 + chunk], w)
            lab = labels[c0:c0 + chunk]
            if group is None:
                lse = torch.logsumexp(logits, dim=-1)
                gold = logits.gather(1, lab.clamp(0, vocab - 1)[:, None])[:, 0]
            else:
                from ...distributed.fleet.meta_parallel.parallel_layers \
                    .mp_layers import _vocab_parallel_stats
                lse, gold, _ = _vocab_parallel_stats(logits, lab - start,
                                                     group)
            total = total + torch.where(lab >= 0, lse - gold,
                                        torch.zeros_like(lse)).sum()
            lses.append(lse)
        if count is None:
            count = (labels >= 0).sum().clamp_min(1).to(torch.float32)
        ctx.save_for_backward(hidden, weight, labels, torch.cat(lses), count)
        ctx.transpose_y, ctx.chunk, ctx.start = transpose_y, chunk, start
        ctx.sharded = group is not None
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
            if ctx.sharded:
                local = lab - ctx.start
                hit = (local >= 0) & (local < vocab)
                p.scatter_add_(1, local.clamp(0, vocab - 1)[:, None],
                               -hit.float()[:, None])
            else:
                p.scatter_add_(1, lab.clamp(0, vocab - 1)[:, None],
                               -torch.ones_like(p[:, :1]))
            p = p * ((lab >= 0).float() * scale)[:, None]
            dlogits = p.to(hidden.dtype)
            dh[c0:c0 + ctx.chunk] = dlogits @ w.t()
            dw += (h_c.t() @ dlogits).float()
        dw = dw.to(weight.dtype)
        return (dh, (dw.t() if ctx.transpose_y else dw), None, None, None,
                None, None)


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


# ---------------------------------------------------- serving entry points
def _host_int(x) -> int:
    """A scalar (a host int, or a one-element array or tensor, read once)
    as a host int."""
    if isinstance(x, torch.Tensor):
        return int(x.reshape(()))
    return int(np.asarray(x).reshape(()))


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _index(x, device) -> torch.Tensor:
    """Block tables and lengths as int32 tensors on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=torch.int32)


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, pre_layer_norm=True,
                            epsilon=1e-5, cache_kvs=None, pre_caches=None,
                            rotary_embs=None, time_step=None, attn_mask=None,
                            dropout_rate=0.0, rotary_emb_dims=0,
                            activation="gelu", training=False,
                            mode="upscale_in_train", trans_qkvw=True,
                            ring_id=-1, name=None):
    """Paddle's whole-stack fused transformer with KV caches: each layer
    runs (pre-)LayerNorm -> qkv -> rotary (``rotary_embs``
    ``(2, B, 1, S, D)`` cos/sin with ``rotary_emb_dims > 0``) -> attention
    -> out-proj -> residual -> (pre-)LayerNorm -> ffn1 -> gelu (tanh) or
    relu -> ffn2 -> residual, post-LN when ``pre_layer_norm=False``.

    ``x`` ``(B, S, E)``; ``qkv_weights[i]`` ``(3, H, D, E)`` with
    ``trans_qkvw`` else ``(E, 3, H, D)``; linear weights in the ``(in,
    out)`` layout; each bias list may be empty or None. With ``cache_kvs``
    (one ``(2, B, H, T, D)`` tensor a layer) the block's k/v are written at
    ``time_step`` (a host int or a one-element tensor, read once a call;
    default 0), in place, and the queries attend causally to the written
    prefix; the call returns ``(out, cache_kvs)``. Without caches the
    block attends causally to itself, or under ``attn_mask`` (bool: True
    keeps; else additive) densely, and the call returns ``out``.

    On the card a block of S > 1 queries launches the prefill kernel (over
    a contiguous copy of the cache's written prefix: the cache's
    ``(B, T, H, D)`` view is strided); a one-token step is the dense
    composition. ``pre_caches``, ``ring_id`` != -1 (tensor parallel),
    training dropout and activations other than gelu/relu raise
    ``NotImplementedError`` (the JAX package ignores them)."""
    if pre_caches is not None or ring_id != -1:
        raise NotImplementedError(
            "fused_multi_transformer: pre_caches and ring_id (tensor "
            "parallel) are not ported")
    if training and dropout_rate > 0.0:
        raise NotImplementedError(
            "fused_multi_transformer: training dropout is not ported")
    if activation not in ("gelu", "relu"):
        raise NotImplementedError(
            f"fused_multi_transformer: activation {activation!r} (gelu or "
            "relu)")
    use_cache = cache_kvs is not None
    b, s, _ = x.shape
    rot = rotary_embs if rotary_embs is not None and rotary_emb_dims > 0 \
        else None
    off = _host_int(time_step) if time_step is not None else 0

    def bias(lst, i):
        return lst[i] if lst else None

    hid = x
    for i in range(len(qkv_weights)):
        qkvw = qkv_weights[i]
        if not trans_qkvw:             # (E, 3, H, D) -> (3, H, D, E)
            qkvw = qkvw.permute(1, 2, 3, 0)
        nh, hd = qkvw.shape[1], qkvw.shape[2]
        residual = hid
        ln_in = hid
        if pre_layer_norm:
            ln_in = _ln(hid, ln_scales[i], bias(ln_biases, i), epsilon)
        qkv = torch.einsum("bse,nhde->bsnhd", ln_in, qkvw)
        if qkv_biases:
            qkv = qkv + qkv_biases[i][None, None]
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # (B, S, H, D)
        if rot is not None:
            q = _apply_rot(q, rot[0], rot[1])
            k = _apply_rot(k, rot[0], rot[1])
        if use_cache:
            ck = cache_kvs[i]                                 # (2,B,H,T,D)
            k_view, v_view = ck[0].transpose(1, 2), ck[1].transpose(1, 2)
            update_kv_cache(k_view, v_view, k, v, off)
            if s > 1:
                attn = cached_attention(
                    q.contiguous(), k_view[:, :off + s].contiguous(),
                    v_view[:, :off + s].contiguous(), off + s)
            else:
                attn = cached_attention(q, k_view, v_view, off + s)
        elif attn_mask is None:
            attn = cached_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), s)
        else:
            attn = _causal_sdpa(q, k, v, attn_mask)
        out = attn.reshape(b, s, nh * hd) @ linear_weights[i]
        if linear_biases:
            out = out + linear_biases[i]
        hid = residual + out
        if not pre_layer_norm:
            hid = _ln(hid, ln_scales[i], bias(ln_biases, i), epsilon)

        residual = hid
        ffn_in = hid
        if pre_layer_norm:
            ffn_in = _ln(hid, ffn_ln_scales[i], bias(ffn_ln_biases, i),
                         epsilon)
        f1 = ffn_in @ ffn1_weights[i]
        if ffn1_biases:
            f1 = f1 + ffn1_biases[i]
        f1 = (torch.nn.functional.gelu(f1, approximate="tanh")
              if activation == "gelu" else torch.relu(f1))
        f2 = f1 @ ffn2_weights[i]
        if ffn2_biases:
            f2 = f2 + ffn2_biases[i]
        hid = residual + f2
        if not pre_layer_norm:
            hid = _ln(hid, ffn_ln_scales[i], bias(ffn_ln_biases, i),
                      epsilon)
    hid = hid.to(x.dtype)
    return (hid, cache_kvs) if use_cache else hid


def _ln(x, scale, bias, eps):
    """LayerNorm over the last axis in f32, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _apply_rot(t, cos_r, sin_r):
    """Neox rotate-half with cos/sin tables (B, 1, S, D), applied in t's
    dtype."""
    cos_b = cos_r.transpose(1, 2).to(t.dtype)
    sin_b = sin_r.transpose(1, 2).to(t.dtype)
    t1, t2 = t.chunk(2, dim=-1)
    return t * cos_b + torch.cat([-t2, t1], dim=-1) * sin_b


def _causal_sdpa(q, k, v, mask):
    """Dense f32 attention of (B, S, H, D) under ``mask`` (bool: True
    keeps, else additive; None: causal)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    sc = torch.einsum("bhqd,bhkd->bhqk", qt * scale, kt)
    if mask is not None:
        sc = (torch.where(mask.to(torch.bool), sc, -1e30)
              if mask.dtype != sc.dtype else sc + mask)
    else:
        sq, sk = sc.shape[-2:]
        tri = (torch.arange(sq, device=q.device)[:, None]
               >= torch.arange(sk, device=q.device)[None, :])
        sc = torch.where(tri, sc, -1e30)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, dim=-1), vt)
    return o.transpose(1, 2).to(q.dtype)


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               sequence_lengths=None, rotary_tensor=None,
                               out_scale=-1, seq_len=1, rotary_emb_dims=0,
                               **kwargs):
    """Paddle's one-token decode attention over a running cache: ``x``
    ``(B, 3 * H * D)`` packs the token's q, k and v; ``cache_kv``
    ``(2, B, T, H, D)``. The k/v are written at ``sequence_lengths`` (a
    host int or a one-element tensor, read once; default ``T - 1``), in
    place, and q attends to positions ``[0, sequence_lengths]`` (the dense
    composition, as in the JAX package). Returns ``(out (B, H * D),
    cache_kv)``, the cache the same tensor. ``bias``, ``src_mask``,
    ``rotary_tensor``, ``rotary_emb_dims > 0`` and ``out_scale > 0``
    raise ``NotImplementedError`` (the JAX package ignores them)."""
    if cache_kv is None:
        raise ValueError("masked_multihead_attention needs cache_kv")
    if (bias is not None or src_mask is not None or rotary_tensor is not None
            or rotary_emb_dims > 0 or out_scale > 0):
        raise NotImplementedError(
            "masked_multihead_attention does not fold bias, src_mask, "
            "rotary or out_scale: apply them outside the op")
    b = x.shape[0]
    t, h, d = cache_kv.shape[2], cache_kv.shape[3], cache_kv.shape[4]
    cur = (_host_int(sequence_lengths) if sequence_lengths is not None
           else t - 1)
    qkv = x.reshape(b, 1, 3, h, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    kc, vc = update_kv_cache(cache_kv[0], cache_kv[1], k, v, cur)
    out = cached_attention(q, kc, vc, cur + 1)
    return out.reshape(b, h * d), cache_kv


def fused_block_decode(x, ln1_weight, q_proj_weight, k_proj_weight,
                       v_proj_weight, out_proj_weight, ln2_weight,
                       gate_proj_weight, up_proj_weight, down_proj_weight,
                       key_cache, value_cache, block_tables, seq_lens,
                       num_heads: int, num_kv_heads: Optional[int] = None,
                       rope_theta: float = 10000.0, epsilon: float = 1e-6):
    """One fused Llama decode layer over the paged KV cache: ``x <- x +
    attn(rms_norm(x))`` (rotary, the paged append and the read inside),
    then ``x <- x + swiglu_ffn(rms_norm(x))``, on the fused block decode
    kernel (:func:`~paddle_tpu_torch.kernels.fused_block_decode.
    fused_block_decode`). ``x`` ``(B, hidden)``, one token a slot; linear
    weights ``(in, out)``; pools ``(Hkv, num_pages, page, D)``;
    ``block_tables`` ``(B, max_pages)`` and ``seq_lens`` ``(B,)`` (taken to
    int32 on x's device). Returns ``(out, key_cache, value_cache)``, the
    pools appended in place."""
    w = BlockDecodeWeights(
        ln1=ln1_weight, wq=q_proj_weight, wk=k_proj_weight,
        wv=v_proj_weight, wo=out_proj_weight, ln2=ln2_weight,
        wg=gate_proj_weight, wu=up_proj_weight, wd=down_proj_weight)
    return _fbd(x, w, key_cache, value_cache, _index(block_tables, x.device),
                _index(seq_lens, x.device), num_heads=num_heads,
                num_kv_heads=num_kv_heads or num_heads,
                rope_theta=rope_theta, epsilon=epsilon)


# the reference's defaults for the options block_multihead_attention does
# not fold: only a value other than these asks for unfolded behaviour
_BMHA_DEFAULTS = {"max_seq_len": -1, "block_size": None,
                  "use_neox_style": False, "use_neox_rotary_style": False,
                  "quant_round_type": 1, "quant_max_bound": 127.0,
                  "quant_min_bound": -127.0, "out_scale": -1,
                  "out_shift": None, "out_smooth": None,
                  "compute_dtype": "default", "rope_theta": 10000.0}


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              block_tables, **kwargs):
    """Paddle's block(page)-table serving attention, the uniform-phase
    subset: every row prefilling (``seq_lens_encoder > 0`` and
    ``seq_lens_this_time == S``: the prompt's k/v are written to its pages
    and it attends causally to itself on the prefill kernel) or every row
    decoding one token (``seq_lens_encoder == 0``, ``seq_lens_this_time ==
    1``: the token is written at ``seq_lens_decoder`` and attends through
    the block tables on the paged decode kernel). ``qkv`` ``(B, S, 3, H,
    D)``; pools ``(Hkv, num_pages, page, D)``, updated in place. Returns
    ``(out (B, S, H * D), key_cache, value_cache)``.

    The lengths are read on the host (the phase is checked there). A mixed
    or partly inactive batch, and any option the CUDA op fuses (rotary
    embeddings, cache-quant scales, shift/smooth) at a value other than
    the reference's default, raise ``NotImplementedError``."""
    unsupported = sorted(
        k for k, v in kwargs.items()
        if v is not None and v != _BMHA_DEFAULTS.get(k, None))
    if unsupported:
        raise NotImplementedError(
            "block_multihead_attention does not fold "
            f"{unsupported} — apply rope/quant/offsets outside the op")
    this = _host_array(seq_lens_this_time)
    enc = _host_array(seq_lens_encoder)
    b, s = qkv.shape[0], qkv.shape[1]
    # the uniform-phase contract: ALL rows prefill or ALL rows decode one
    # token; inactive rows or mixed batches would write into pool pages
    if not (((enc > 0).all() and (this == s).all())
            or ((enc == 0).all() and (this == 1).all() and s == 1)):
        raise NotImplementedError(
            "block_multihead_attention handles uniform batches only "
            "(all-prefill or all-decode with every row active); for "
            "ragged/mixed scheduling drive ServingEngine or the paged "
            "pieces directly")
    q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
    # the reference's phase encoding: encoder lengths set during prefill,
    # decoder lengths during decode
    lens = np.where(enc > 0, 0, _host_array(seq_lens_decoder))
    state = PagedDecodeState(key_cache, value_cache,
                             _index(block_tables, qkv.device),
                             _index(lens, qkv.device))
    out, state = paged_scaled_dot_product_attention(q, k, v, state)
    h, d = out.shape[2], out.shape[3]
    return out.reshape(b, s, h * d), state.k_pages, state.v_pages


# ------------------------------------------------- weight-only quantization
# The JAX package dequantizes and multiplies outside any Pallas kernel
# (``jnp.matmul`` on the dequantized weight), so these are PyTorch ops.
_INT4 = ("int4", "weight_only_int4")
_INT8 = ("int8", "weight_only_int8")


def weight_quantize(x, algo: str = "weight_only_int8", group_size: int = -1):
    """Per-channel (or, with ``group_size > 0``, per (group, out) block)
    abs-max quantization of a weight ``x`` ``(in_features, out_features)``:
    returns ``(int8 payload, f32 scales)``, the scales ``(out,)`` or
    ``(in // group_size, out)``. ``scale = max(amax, 1e-8) / qmax`` (127
    for int8, 7 for int4) and ``q = clip(round(w / scale))`` (round half to
    even). int4 packs rows ``2i`` and ``2i + 1`` into one byte, the even
    row in the low nibble (the reference's packing, not the fused decode's
    ``Int4Tiles``)."""
    if algo not in ("weight_only_int8", "weight_only_int4"):
        raise ValueError(f"unsupported weight_quantize algo {algo!r}")
    w = x.detach().float()
    k, n = w.shape
    if group_size > 0:
        if k % group_size:
            raise ValueError(f"in_features {k} not divisible by "
                             f"group_size {group_size}")
        wg = w.reshape(k // group_size, group_size, n)
        amax = wg.abs().amax(dim=1)                      # (G, N)
    else:
        amax = w.abs().amax(dim=0, keepdim=True)         # (1, N)
    qmax = 127.0 if algo == "weight_only_int8" else 7.0
    scale = amax.clamp_min(1e-8) / qmax
    if group_size > 0:
        q = torch.clamp(torch.round(wg / scale[:, None, :]), -qmax, qmax)
        q = q.reshape(k, n)
    else:
        q = torch.clamp(torch.round(w / scale), -qmax, qmax)
    q = q.to(torch.int8)
    if algo == "weight_only_int4":
        if k % 2:
            raise ValueError("int4 packing needs an even in_features")
        byte = (q[0::2].int() & 0x0F) | ((q[1::2].int() & 0x0F) << 4)
        q = torch.where(byte > 127, byte - 256, byte).to(torch.int8)
    return q, (scale if group_size > 0 else scale.reshape(n))


def _dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                       weight_dtype: str, group_size: int,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """Unpack and scale a :func:`weight_quantize` payload (one packing for
    ``weight_only_linear`` and ``nn.quant.weight_dequantize``): an int4
    byte's low nibble is the even row, sign-extended, its high nibble (an
    arithmetic shift) the odd row. The scaling runs in f32, then one cast
    to ``out_dtype``."""
    if weight_dtype in _INT4:
        b = q.int()
        lo = b & 0x0F
        lo = torch.where(lo > 7, lo - 16, lo)
        w = torch.stack((lo, b >> 4), dim=1).reshape(q.shape[0] * 2,
                                                     q.shape[1])
    elif weight_dtype in _INT8:
        w = q
    else:
        raise ValueError(f"unsupported weight dtype {weight_dtype!r}")
    wf = w.float()
    if group_size > 0:
        g = wf.shape[0] // group_size
        wf = (wf.reshape(g, group_size, -1)
              * scale.float()[:, None, :]).reshape(wf.shape)
    else:
        wf = wf * scale.float().reshape(1, -1)
    return wf.to(out_dtype)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype: str = "int8", group_size: int = -1):
    """``x @ dequantize(weight) (+ bias)``: the weight dequantized to the
    activation dtype, the GEMM in that dtype with f32 accumulation and an
    f32 output (as the reference's ``preferred_element_type``), the bias
    added in f32, one cast back to x's dtype. ``x`` and ``bias`` stay
    differentiable (the int8 weight has no gradient)."""
    wf = _dequantize_weight(weight, weight_scale, weight_dtype, group_size,
                            x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if (x.dtype != torch.float32 and x.is_cuda
            and not (torch.is_grad_enabled() and x.requires_grad)):
        out = torch.mm(x2, wf, out_dtype=torch.float32)
    else:
        out = x2.float() @ wf.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype).reshape(*lead, wf.shape[1])
