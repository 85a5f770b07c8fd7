"""Fused transformer-block decode: one Llama layer, or a group of N
stacked layers, decoded per call.

Counterpart of ``paddle_tpu/kernels/fused_block_decode.py`` (native
weights and pools; the tensor-parallel entries are a later slice).
:func:`fused_block_decode` runs rms -> q/k/v -> RoPE at each slot's
position -> paged attention with the new token folded in -> o-proj +
residual -> rms -> SwiGLU -> down + residual, and appends the new token's
k/v to the pool. On a CUDA tensor it is one call of the C entry in
``csrc/fused_block_decode.cu``, which launches those phases in order with
hand-written GEMVs; on a CPU tensor it is :func:`fused_block_decode_ref`.
:func:`fused_multi_block_decode` runs that chain for a group of layers
whose weights :func:`stack_block_weights` stacked (q|k|v and gate|up
merged), one call of ``csrc/fused_multi_block_decode.cu`` per group.

Weights keep the JAX package's ``(in, out)`` Linear layout, so a layer's
:class:`BlockDecodeWeights` carry across unchanged.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .paged_attention import (_check_index, _check_pools,
                              paged_attention_ref, write_paged_kv)

__all__ = ["BlockDecodeWeights", "MultiBlockDecodeWeights",
           "fused_block_decode", "fused_block_decode_ref",
           "fused_multi_block_decode", "fused_multi_block_decode_ref",
           "stack_block_weights"]


class BlockDecodeWeights(NamedTuple):
    """One decoder layer's weights in the (in, out) Linear layout."""
    ln1: torch.Tensor   # (H,)       input rms_norm weight
    wq: torch.Tensor    # (H, nh*d)
    wk: torch.Tensor    # (H, nkv*d)
    wv: torch.Tensor    # (H, nkv*d)
    wo: torch.Tensor    # (nh*d, H)
    ln2: torch.Tensor   # (H,)       post-attention rms_norm weight
    wg: torch.Tensor    # (H, I)     SwiGLU gate
    wu: torch.Tensor    # (H, I)     SwiGLU up
    wd: torch.Tensor    # (I, H)     SwiGLU down


def _inv_freq(d: int, theta: float, device) -> torch.Tensor:
    """Rotary inverse frequencies (d/2,) f32, the composition of the JAX
    package's ``_rope_tables``."""
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    return 1.0 / (theta ** exps)


def _rope_tables(seq_lens: torch.Tensor, d: int, theta: float):
    """Per-slot decode rotary tables at positions ``seq_lens``: (sin, cos),
    each (B, d) float32."""
    pos = seq_lens.to(torch.float32)
    freqs = pos[:, None] * _inv_freq(d, theta, seq_lens.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.sin(emb), torch.cos(emb)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """F.rms_norm's composition: f32 moments, cast, then scale in the
    activation dtype."""
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _rope_heads(t: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor) -> torch.Tensor:
    """Neox rotate-half at per-row angles; sin/cos (B, d) f32, applied in
    the activation dtype."""
    c = cos[:, None, :].to(t.dtype)
    s = sin[:, None, :].to(t.dtype)
    t1, t2 = t.chunk(2, dim=-1)
    return t * c + torch.cat([-t2, t1], dim=-1) * s


def fused_block_decode_ref(x, weights: BlockDecodeWeights, k_pages, v_pages,
                           block_tables, seq_lens, *, num_heads: int,
                           num_kv_heads: int, rope_theta: float = 10000.0,
                           epsilon: float = 1e-6,
                           sm_scale: Optional[float] = None):
    """Plain version of :func:`fused_block_decode`: the unfused chain
    (write the new token, then attend over ``seq_lens + 1``), computed in
    f32 from the given inputs and cast to x's dtype at the end. The pools
    are updated in place. Returns ``(out, k_pages, v_pages)``."""
    b, hidden = x.shape
    d = weights.wq.shape[1] // num_heads
    w = BlockDecodeWeights(*(t.float() for t in weights))
    xf = x.float()
    h = _rms(xf, w.ln1, epsilon)
    q = (h @ w.wq).reshape(b, num_heads, d)
    k = (h @ w.wk).reshape(b, num_kv_heads, d)
    v = (h @ w.wv).reshape(b, num_kv_heads, d)
    sin, cos = _rope_tables(seq_lens, d, rope_theta)
    q = _rope_heads(q, sin, cos)
    k = _rope_heads(k, sin, cos)
    write_paged_kv(k_pages, v_pages, k, v, block_tables, seq_lens)
    attn = paged_attention_ref(q, k_pages, v_pages, block_tables,
                               seq_lens + 1, sm_scale)
    x2 = xf + attn.reshape(b, num_heads * d) @ w.wo
    h2 = _rms(x2, w.ln2, epsilon)
    f = F.silu(h2 @ w.wg) * (h2 @ w.wu)
    out = x2 + f @ w.wd
    return out.to(x.dtype), k_pages, v_pages


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_SCRATCH_ARGTYPES = [ctypes.c_int] * 7
_inv_freq_cache: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def _cached_inv_freq(d: int, theta: float, device) -> torch.Tensor:
    key = (d, float(theta), device)
    inv = _inv_freq_cache.get(key)
    if inv is None:
        inv = _inv_freq_cache[key] = _inv_freq(d, theta, device)
    return inv


def _check_weights(weights, shapes, device, dtype):
    for name, shape in shapes.items():
        t = getattr(weights, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"weights.{name} must be {shape}, "
                             f"got {tuple(t.shape)}")
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"weights.{name} must be {dtype} on {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"weights.{name} must be contiguous and "
                             "16-byte aligned")


def _check_geometry(what, x, nh, nkv, d, hidden, inter):
    """What both kernels take: even head_dim, widths that are multiples of
    8 (16-byte weight rows), a contiguous float32 or bfloat16 x."""
    if nh % nkv:
        raise ValueError(f"query heads {nh} not divisible by kv heads {nkv}")
    if d % 2 or any(n % 8 for n in (hidden, nh * d, nkv * d, inter)):
        raise ValueError(f"{what} needs even head_dim and widths that are "
                         "multiples of 8")
    if not x.is_contiguous() or x.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise ValueError("x must be contiguous float32 or bfloat16")


def fused_block_decode(x, weights: BlockDecodeWeights, k_pages, v_pages,
                       block_tables, seq_lens, *, num_heads: int,
                       num_kv_heads: int, rope_theta: float = 10000.0,
                       epsilon: float = 1e-6,
                       sm_scale: Optional[float] = None):
    """One fused block decode step.

    x: (B, hidden), one token's hidden state per slot; k/v_pages:
    (Hkv, num_pages, page, D); block_tables: (B, max_pages) int32;
    seq_lens: (B,) int32 tokens already in the pool. Returns
    ``(out, k_pages, v_pages)`` with the new token appended to the pools in
    place. CPU tensors take :func:`fused_block_decode_ref`; CUDA tensors
    run the kernel (float32 or bfloat16, every width a multiple of 8,
    head_dim even)."""
    if x.device.type == "cpu":
        return fused_block_decode_ref(
            x, weights, k_pages, v_pages, block_tables, seq_lens,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            rope_theta=rope_theta, epsilon=epsilon, sm_scale=sm_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_decode runs on cuda or cpu, "
                         f"got {x.device}")
    b, hidden = x.shape
    nh, nkv = num_heads, num_kv_heads
    d = weights.wq.shape[1] // nh
    inter = weights.wg.shape[1]
    _check_geometry("fused_block_decode", x, nh, nkv, d, hidden, inter)
    _check_weights(weights, dict(
        ln1=(hidden,), wq=(hidden, nh * d), wk=(hidden, nkv * d),
        wv=(hidden, nkv * d), wo=(nh * d, hidden), ln2=(hidden,),
        wg=(hidden, inter), wu=(hidden, inter), wd=(inter, hidden)),
        x.device, x.dtype)
    _check_pools(k_pages, v_pages, x.device, x.dtype)
    hkv, num_pages, page, dk = k_pages.shape
    if hkv != nkv or dk != d:
        raise ValueError(f"pools {tuple(k_pages.shape)} do not match "
                         f"{nkv} kv heads of dim {d}")
    maxp = block_tables.shape[1]
    _check_index("block_tables", block_tables, (b, maxp), x.device)
    _check_index("seq_lens", seq_lens, (b,), x.device)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    inv = _cached_inv_freq(d, rope_theta, x.device)
    code = _build.dtype_code(x.dtype)
    size = _build.bind("fused_block_decode", "ptt_fused_block_decode_scratch",
                       _SCRATCH_ARGTYPES, ctypes.c_longlong)(
        code, b, hidden, nh, nkv, d, inter)
    scratch = torch.empty(size, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = _build.bind("fused_block_decode", "ptt_fused_block_decode",
                     _ARGTYPES)
    rc = fn(code, x.data_ptr(), *(t.data_ptr() for t in weights),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            seq_lens.data_ptr(), inv.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, hidden, nh, nkv, d, inter, num_pages,
            page, maxp, float(epsilon), float(sm_scale),
            _build.stream_handle(x.device))
    _build.check(rc, "fused_block_decode")
    fused_block_decode.launches += 1
    return out, k_pages, v_pages


fused_block_decode.launches = 0


# ------------------------------------------------------ N layers per call
class MultiBlockDecodeWeights(NamedTuple):
    """A group of ``n`` decoder layers' weights, stacked on a leading layer
    axis with the width-parallel projections merged:

      ln1   (n, H)
      wqkv  (n, H, (nh + 2*nkv) * d)    q|k|v concatenated on columns
      wo    (n, nh*d, H)
      ln2   (n, H)
      wgu   (n, H, 2*I)                 gate|up concatenated on columns
      wd    (n, I, H)

    Built once per engine by :func:`stack_block_weights` (a device copy of
    the layer weights; the per-layer originals keep serving prefill)."""
    ln1: torch.Tensor
    wqkv: torch.Tensor
    wo: torch.Tensor
    ln2: torch.Tensor
    wgu: torch.Tensor
    wd: torch.Tensor

    @property
    def n_layers(self) -> int:
        return int(self.ln1.shape[0])


def stack_block_weights(layers: Sequence[BlockDecodeWeights],
                        weight_dtype: str = "native"
                        ) -> MultiBlockDecodeWeights:
    """Stack per-layer :class:`BlockDecodeWeights` into one
    :class:`MultiBlockDecodeWeights` group, merging q|k|v and gate|up on
    the output axis. ``weight_dtype="int4"`` (packed int4 tiles) is a
    later slice."""
    if weight_dtype == "int4":
        raise NotImplementedError(
            "int4 weight tiles (weight_dtype='int4') are not ported yet (a "
            "later slice of paddle_tpu_torch)")
    if weight_dtype != "native":
        raise ValueError(f"weight_dtype must be 'native' or 'int4', "
                         f"got {weight_dtype!r}")
    ws = list(layers)
    return MultiBlockDecodeWeights(
        ln1=torch.stack([w.ln1 for w in ws]),
        wqkv=torch.stack([torch.cat([w.wq, w.wk, w.wv], dim=1) for w in ws]),
        wo=torch.stack([w.wo for w in ws]),
        ln2=torch.stack([w.ln2 for w in ws]),
        wgu=torch.stack([torch.cat([w.wg, w.wu], dim=1) for w in ws]),
        wd=torch.stack([w.wd for w in ws]))


def fused_multi_block_decode_ref(x, weights: MultiBlockDecodeWeights,
                                 k_pages, v_pages, block_tables, seq_lens, *,
                                 num_heads: int, num_kv_heads: int,
                                 rope_theta: float = 10000.0,
                                 epsilon: float = 1e-6,
                                 sm_scale: Optional[float] = None):
    """Plain version of :func:`fused_multi_block_decode`: per layer, the
    chain of :func:`fused_block_decode_ref` (in f32, cast to x's dtype at
    the layer's end) with the q/k/v and gate/up projections as the merged
    matmuls; each output column contracts the same inputs, so in float32
    the result is the per-layer chain's bit for bit. ``k_pages`` and
    ``v_pages`` are sequences of the group's per-layer pools, updated in
    place. Returns ``(out, k_pages, v_pages)`` (lists)."""
    n = weights.n_layers
    if len(k_pages) != n or len(v_pages) != n:
        raise ValueError(f"expected {n} per-layer pools, got "
                         f"{len(k_pages)}/{len(v_pages)}")
    b, _ = x.shape
    nh, nkv = num_heads, num_kv_heads
    d = weights.wqkv.shape[2] // (nh + 2 * nkv)
    qw, kvw = nh * d, nkv * d
    inter = weights.wd.shape[1]
    sin, cos = _rope_tables(seq_lens, d, rope_theta)
    kps, vps = list(k_pages), list(v_pages)
    for i in range(n):
        xf = x.float()
        h = _rms(xf, weights.ln1[i].float(), epsilon)
        qkv = h @ weights.wqkv[i].float()
        q = _rope_heads(qkv[:, :qw].reshape(b, nh, d), sin, cos)
        k = _rope_heads(qkv[:, qw:qw + kvw].reshape(b, nkv, d), sin, cos)
        v = qkv[:, qw + kvw:].reshape(b, nkv, d)
        write_paged_kv(kps[i], vps[i], k, v, block_tables, seq_lens)
        attn = paged_attention_ref(q, kps[i], vps[i], block_tables,
                                   seq_lens + 1, sm_scale)
        x2 = xf + attn.reshape(b, qw) @ weights.wo[i].float()
        h2 = _rms(x2, weights.ln2[i].float(), epsilon)
        gu = h2 @ weights.wgu[i].float()
        f = F.silu(gu[:, :inter]) * gu[:, inter:]
        # the inter-layer cast: the next layer's f32 carry starts from x's
        # dtype, as one layer a call would leave it
        x = (x2 + f @ weights.wd[i].float()).to(x.dtype)
    return x, kps, vps


_MULTI_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 13
                   + [ctypes.c_int] * 10 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])


def fused_multi_block_decode(x, weights: MultiBlockDecodeWeights, k_pages,
                             v_pages, block_tables, seq_lens, *,
                             num_heads: int, num_kv_heads: int,
                             rope_theta: float = 10000.0,
                             epsilon: float = 1e-6,
                             sm_scale: Optional[float] = None):
    """One decode step through a group of N stacked layers.

    x: (B, hidden); ``weights`` a :class:`MultiBlockDecodeWeights` group;
    k/v_pages: sequences of the N layers' pools, each (Hkv, num_pages,
    page, D); block_tables: (B, max_pages) int32; seq_lens: (B,) int32
    tokens already in the pools. Returns ``(out, k_pages, v_pages)`` with
    each layer's new token appended to its pools in place. CPU tensors
    take :func:`fused_multi_block_decode_ref`; CUDA tensors run the kernel
    (float32 or bfloat16, every width a multiple of 8, head_dim even), one
    launch a group."""
    if x.device.type == "cpu":
        return fused_multi_block_decode_ref(
            x, weights, k_pages, v_pages, block_tables, seq_lens,
            num_heads=num_heads, num_kv_heads=num_kv_heads,
            rope_theta=rope_theta, epsilon=epsilon, sm_scale=sm_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_multi_block_decode runs on cuda or cpu, "
                         f"got {x.device}")
    n = weights.n_layers
    b, hidden = x.shape
    nh, nkv = num_heads, num_kv_heads
    d = weights.wqkv.shape[2] // (nh + 2 * nkv)
    inter = weights.wd.shape[1]
    _check_geometry("fused_multi_block_decode", x, nh, nkv, d, hidden, inter)
    _check_weights(weights, dict(
        ln1=(n, hidden), wqkv=(n, hidden, (nh + 2 * nkv) * d),
        wo=(n, nh * d, hidden), ln2=(n, hidden), wgu=(n, hidden, 2 * inter),
        wd=(n, inter, hidden)), x.device, x.dtype)
    if len(k_pages) != n or len(v_pages) != n:
        raise ValueError(f"expected {n} per-layer pools, got "
                         f"{len(k_pages)}/{len(v_pages)}")
    for kp, vp in zip(k_pages, v_pages):
        _check_pools(kp, vp, x.device, x.dtype)
        if kp.shape != k_pages[0].shape:
            raise ValueError("the group's pools must share one shape")
    hkv, num_pages, page, dk = k_pages[0].shape
    if hkv != nkv or dk != d:
        raise ValueError(f"pools {tuple(k_pages[0].shape)} do not match "
                         f"{nkv} kv heads of dim {d}")
    maxp = block_tables.shape[1]
    _check_index("block_tables", block_tables, (b, maxp), x.device)
    _check_index("seq_lens", seq_lens, (b,), x.device)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    inv = _cached_inv_freq(d, rope_theta, x.device)
    # the 2N pool pointers (k0, v0, k1, ...) as a host array: the entry
    # hands each layer's pair to that layer's attention launch
    pools = (ctypes.c_void_p * (2 * n))(
        *(p.data_ptr() for pair in zip(k_pages, v_pages) for p in pair))
    code = _build.dtype_code(x.dtype)
    size = _build.bind("fused_multi_block_decode",
                       "ptt_fused_multi_block_decode_scratch",
                       _SCRATCH_ARGTYPES, ctypes.c_longlong)(
        code, b, hidden, nh, nkv, d, inter)
    scratch = torch.empty(size, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = _build.bind("fused_multi_block_decode",
                     "ptt_fused_multi_block_decode", _MULTI_ARGTYPES)
    rc = fn(code, x.data_ptr(), *(t.data_ptr() for t in weights),
            pools, block_tables.data_ptr(), seq_lens.data_ptr(),
            inv.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, b, hidden,
            nh, nkv, d, inter, num_pages, page, maxp, float(epsilon),
            float(sm_scale), _build.stream_handle(x.device))
    _build.check(rc, "fused_multi_block_decode")
    fused_multi_block_decode.launches += 1
    return out, list(k_pages), list(v_pages)


fused_multi_block_decode.launches = 0
