"""Attention of a block of queries against a contiguous KV cache.

Counterpart of ``paddle_tpu/kernels/decode_attention.py``: the serving
prefill attends a whole prompt causally to itself, and generation's
ring-buffer cache (:func:`update_kv_cache` writes it in place) attends a
block of queries to its written prefix, through :func:`cached_attention`,
which for S > 1 runs :func:`flash_prefill`, the hand-written CUDA kernel in
``csrc/flash_prefill.cu``. Layouts follow the JAX package: q
``(B, S, H, D)``, caches ``(B, T, Hkv, D)``, query head h reads kv head
``h // (H // Hkv)``.

Unlike the TPU kernel, which refused a cache length that is not a multiple
of its kv block (and ``cached_attention`` then dropped to the dense path),
the CUDA kernel masks the ragged tail itself and takes every S > 1 call.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30
_MAX_HEAD_DIM = 128


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    offset: int):
    """Write ``k_new``/``v_new`` (B, S, Hkv, D) into the caches
    (B, T, Hkv, D) at sequence position ``offset`` (a host int), cast to
    the caches' dtype, in place; returns the caches. As the JAX package's
    ``dynamic_update_slice``, a start that would run the block past T is
    clamped to ``T - S``."""
    s, t = k_new.shape[1], k_cache.shape[1]
    off = min(max(int(offset), 0), t - s)
    k_cache[:, off:off + s] = k_new.to(k_cache.dtype)
    v_cache[:, off:off + s] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: int,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention of ``q`` (B, S, H, D) against caches (B, T, Hkv, D) whose
    first ``cur_len`` positions are valid; the S query rows sit at absolute
    positions ``cur_len - S .. cur_len - 1``, masked causally. S > 1 runs
    the prefill kernel; S == 1 the dense composition."""
    if q.shape[1] > 1:
        return flash_prefill(q, k_cache, v_cache, cur_len, sm_scale)
    return cached_attention_dense(q, k_cache, v_cache, cur_len, sm_scale)


def cached_attention_dense(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cur_len: int,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Dense composition that materialises the (S, T) scores, in f32."""
    b, s, h, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    if h % hkv:
        raise ValueError(f"query heads {h} not divisible by kv heads {hkv}")
    rep = h // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, s, hkv, rep, d).float() * sm_scale
    scores = torch.einsum("bsgrd,btgd->bgrst", qf, k_cache.float())
    q_pos = cur_len - s + torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    scores = scores.masked_fill(~(k_pos <= q_pos), _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v_cache.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def flash_prefill_ref(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cur_len: int,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`flash_prefill`: the dense composition."""
    return cached_attention_dense(q, k_cache, v_cache, cur_len, sm_scale)


# bf16 runs csrc/prefill_mma.cuh: blocks of 128 query rows of one head,
# one resident on an SM (by registers), walking kv tiles of 128
_MMA_ROWS, _MMA_KEYS, _MMA_BLOCKS_PER_SM = 128, 128, 1
_MIN_SPLIT_TILES = 2      # kv tiles a part of a split walk takes at least


def prefill_splits(dtype, heads: int, s: int, kv_bound: int,
                   device) -> int:
    """Parts each block's kv walk is split into, for ``heads`` (batch x
    query heads) of ``s`` query rows (bf16; fp32 never splits): as many as
    keep every resident block slot of the card busy when the blocks alone
    would not, each part at least ``_MIN_SPLIT_TILES`` of the at most
    ``kv_bound`` keys a block walks. A split leaves f32 partial results
    that a second kernel of the same call merges."""
    if dtype != torch.bfloat16:
        return 1
    blocks = heads * -(-s // _MMA_ROWS)
    slots = _MMA_BLOCKS_PER_SM * _build.sm_count(device.index or 0)
    tiles = -(-kv_bound // _MMA_KEYS)
    return max(1, min(slots // blocks, tiles // _MIN_SPLIT_TILES))


def split_scratch(nsplit: int, rows: int, d: int, device):
    """f32 scratch (partial outputs, their (m, l)) of an ``nsplit``-way
    split over ``rows`` query rows, or null pointers for no split."""
    if nsplit == 1:
        return (), [0, 0]
    po = torch.empty((nsplit, rows, d), dtype=torch.float32, device=device)
    pml = torch.empty((nsplit, rows, 2), dtype=torch.float32, device=device)
    return (po, pml), [po.data_ptr(), pml.data_ptr()]


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def flash_prefill(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cur_len: int,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal prefill attention without materialising the scores.

    CPU tensors take :func:`flash_prefill_ref`. CUDA tensors launch the
    kernel: float32 or bfloat16, contiguous, S > 1, D <= 128, any T; a
    tensor it does not take raises."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k_cache, v_cache, cur_len, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on cuda or cpu, got {q.device}")
    b, s, h, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v caches must share a (B, T, Hkv, D) shape, got "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    _, t, hkv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"query heads {h} not divisible by kv heads {hkv}")
    if s < 2:
        raise ValueError("flash_prefill is for S > 1; decode takes the "
                         "paged kernel")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {_MAX_HEAD_DIM} is not supported")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    code = _build.dtype_code(q.dtype)
    out = torch.empty_like(q)
    nsplit = prefill_splits(q.dtype, b * h, s, min(t, int(cur_len)),
                            q.device)
    scratch, ptrs = split_scratch(nsplit, b * s * h, d, q.device)
    fn = _build.bind("flash_prefill", "ptt_flash_prefill", _ARGTYPES)
    rc = fn(code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), *ptrs, b, s, t, h, hkv, d, int(cur_len) - s,
            nsplit, float(sm_scale), _build.stream_handle(q.device))
    _build.check(rc, "flash_prefill")
    _build.count(flash_prefill)
    return out


_build.counters(flash_prefill, "")
