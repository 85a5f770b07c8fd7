"""Fused-op surface (counterpart of ``paddle_tpu/incubate/nn/functional.py``).

Ported: the ``position_ids`` branch of the rotary embedding (the one the
Llama paths run), ``fused_linear_cross_entropy`` (the Llama training
loss), ``fused_rms_norm`` (the RMSNorm kernels),
``variable_length_memory_efficient_attention`` (the flash kernels'
segment-id variant), and Paddle's fused serving entry points:
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
