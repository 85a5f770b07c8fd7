"""Flash attention for training: forward and backward.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``. Layout at this
level is ``(BH, S, D)``; :func:`flash_attention_bshd` takes Paddle's
``(B, S, H, D)``. GQA: q is ``(B*H, S, D)`` and k/v ``(B*Hkv, S, D)``, the
query heads of one kv head consecutive (query head h reads kv head
``h // (H // Hkv)``), and the kv is never expanded.

Three hand-written CUDA kernels in ``csrc/flash_attention.cu``, each behind
a wrapper with a launch counter and a plain PyTorch version:

  - :func:`flash_attention_fwd` -> ``(out, lse)``, the compact f32 lse
    (replaces ``_fwd_kernel`` and ``_fwd_kernel_compact``);
  - :func:`flash_attention_bwd_dq` (replaces ``_bwd_dq_kernel``);
  - :func:`flash_attention_bwd_dkv` (replaces ``_bwd_dkv_kernel``).

In bf16 all three run on the tensor cores (``mma.sync``, every sum in f32,
the softmax scale in f32 in the exponent; the forward's P·V operand as
bf16 hi + lo, the backward's P and dS rounded once to bf16); fp32 computes
on the CUDA cores in f32.

``_FlashAttention`` ties them into one ``torch.autograd.Function``: the
forward saves ``(q, k, v, out, lse)``; the backward computes
``delta = rowsum(dO * O)`` in f32 (outside the kernels, as the JAX
package does) and runs dq and dk/dv. A CUDA tensor always launches the
kernels (no block-size flags, no minimum length, no dense fallback: the
kernels take any S); a CPU tensor runs the plain versions.

Segment ids (varlen / packed sequences): ``seg_q`` ``(BH, Sq)`` and
``seg_kv`` ``(BHkv, Skv)``, int32; a query sees a key only within its
segment (and causally). Each kernel has a segment variant, counted apart
as ``<wrapper>_seg``. A row whose id no key carries emits zeros with
lse 0 and gets zero gradients. The bf16 kernels skip a whole tile whose
ids cannot meet the other side's, by the (min, max) id of every
``SEG_TILE`` rows (:func:`seg_tile_ranges`, built by their wrappers and
part of their cost).

:func:`flash_attention_with_lse` returns ``(out, lse)``, differentiable in
both (``_FlashAttentionLSE``): ring attention merges two partial results
in log space. The lse cotangent folds into the same dq and dk/dv launches
as ``delta := rowsum(dO * O) - dlse``: the lse is taken over the scaled
scores ``s``, ``d lse / d s = p``, and the kernels form ``ds = p * (dp -
delta)`` in that space too (the JAX package's ``_bwd_impl`` fold).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

_NEG_INF = -1e30
_MAX_HEAD_DIM = 128
_MAX_ROWS = 65535          # grid.y of the kernels: B*H (B*Hkv for dk/dv)
SEG_TILE = 64              # rows per id range (FB_SEG_TILE in the source)
_DKV_KEYS = 128            # keys a bf16 dk/dv block owns (FB_ROWS)
_DKV_MIN_PART = 8          # q tiles of 64 rows a part of its walk walks


def _scale(sm_scale: Optional[float], d: int) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _heads(n_heads: int, n_kv_heads: Optional[int], q, k) -> Tuple[int, int]:
    hkv = n_heads if n_kv_heads is None else n_kv_heads
    if n_heads % hkv:
        raise ValueError(f"n_heads {n_heads} not divisible by n_kv_heads "
                         f"{hkv}")
    if q.shape[0] * hkv != k.shape[0] * n_heads:
        raise ValueError(
            f"q rows {q.shape[0]} / k rows {k.shape[0]} inconsistent with "
            f"n_heads={n_heads}, n_kv_heads={hkv}: pass the head counts for "
            f"GQA inputs")
    return n_heads, hkv


# ------------------------------------------------------------ plain versions
def _dense(q, k, v, causal, sm_scale, h, hkv, seg_q=None, seg_kv=None):
    """f32 views ``(b, hkv, rep, sq, d)`` / ``(b, hkv, skv, d)`` and the
    masked scaled scores ``(b, hkv, rep, sq, skv)``: causal, and with
    segment ids only within a segment (JAX's ``flash_attention_ref``)."""
    bh, sq, d = q.shape
    b, rep, skv = bh // h, h // hkv, k.shape[1]
    qf = q.reshape(b, hkv, rep, sq, d).float() * sm_scale
    kf = k.reshape(b, hkv, skv, d).float()
    vf = v.reshape(b, hkv, skv, d).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        kv_pos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(kv_pos > q_pos, _NEG_INF)
    if seg_q is not None:
        same = (seg_q.reshape(b, hkv, rep, sq)[..., :, None]
                == seg_kv.reshape(b, hkv, skv)[:, :, None, None, :])
        s = s.masked_fill(~same, _NEG_INF)
    return qf, kf, vf, s


def flash_attention_fwd_ref(q, k, v, causal: bool = True,
                            sm_scale: Optional[float] = None,
                            n_heads: int = 1,
                            n_kv_heads: Optional[int] = None,
                            seg_q=None, seg_kv=None):
    """Plain version of :func:`flash_attention_fwd`: dense f32 softmax with
    the kernels' guards (a fully masked row takes max 0, ``l == 0`` reads
    as 1). Returns ``(out, lse)``, out in q's dtype, lse f32 ``(BH, S)``."""
    h, hkv = _heads(n_heads, n_kv_heads, q, k)
    sm_scale = _scale(sm_scale, q.shape[-1])
    _, _, vf, s = _dense(q, k, v, causal, sm_scale, h, hkv, seg_q, seg_kv)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m <= _NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p / l_safe, vf)
    lse = (m + torch.log(l_safe))[..., 0]
    return (out.reshape(q.shape).to(q.dtype),
            lse.reshape(q.shape[0], q.shape[1]))


def _bwd_dense(q, k, v, do, lse, delta, causal, sm_scale, h, hkv, seg_q,
               seg_kv):
    """p and ds of the FA-2 backward, recomputed from lse: masked scores
    give p = exp(-1e30 - lse) = 0."""
    bh, sq, d = q.shape
    b, rep = bh // h, h // hkv
    qf, kf, vf, s = _dense(q, k, v, causal, sm_scale, h, hkv, seg_q, seg_kv)
    lse5 = lse.reshape(b, hkv, rep, sq, 1)
    delta5 = delta.float().reshape(b, hkv, rep, sq, 1)
    p = torch.exp(s - lse5)
    dof = do.reshape(b, hkv, rep, sq, d).float()
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dof, vf)
    ds = p * (dp - delta5)
    return qf, kf, dof, p, ds


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool = True,
                               sm_scale: Optional[float] = None,
                               n_heads: int = 1,
                               n_kv_heads: Optional[int] = None,
                               seg_q=None, seg_kv=None):
    """Plain version of :func:`flash_attention_bwd_dq`:
    ``dq = sm_scale * (p * (dO V^T - delta)) K`` in f32, cast to q's
    dtype."""
    h, hkv = _heads(n_heads, n_kv_heads, q, k)
    sm_scale = _scale(sm_scale, q.shape[-1])
    _, kf, _, _, ds = _bwd_dense(q, k, v, do, lse, delta, causal, sm_scale,
                                 h, hkv, seg_q, seg_kv)
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, kf) * sm_scale
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool = True,
                                sm_scale: Optional[float] = None,
                                n_heads: int = 1,
                                n_kv_heads: Optional[int] = None,
                                seg_q=None, seg_kv=None):
    """Plain version of :func:`flash_attention_bwd_dkv`: ``dv = p^T dO`` and
    ``dk = ds^T (q * sm_scale)``, summed over each GQA group's query heads,
    in f32, cast to k's and v's dtype."""
    h, hkv = _heads(n_heads, n_kv_heads, q, k)
    sm_scale = _scale(sm_scale, q.shape[-1])
    qf, _, dof, p, ds = _bwd_dense(q, k, v, do, lse, delta, causal,
                                   sm_scale, h, hkv, seg_q, seg_kv)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p, dof)
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds, qf)
    return dk.reshape(k.shape).to(k.dtype), dv.reshape(v.shape).to(v.dtype)


def flash_attention_ref(q, k, v, segment_ids=None, kv_segment_ids=None,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        n_heads: int = 1, n_kv_heads: Optional[int] = None):
    """Dense composition of :func:`flash_attention`, differentiable by
    autograd: the parity oracle. Same layout, GQA convention, segment-id
    rules and fully-masked-row semantics (such rows emit zeros, not
    NaN)."""
    h, hkv = _heads(n_heads, n_kv_heads, q, k)
    seg_q, seg_kv = _segments(segment_ids, kv_segment_ids, h, hkv)
    return flash_attention_fwd_ref(q, k, v, causal, sm_scale, h, hkv, seg_q,
                                   seg_kv)[0]


def _segments(segment_ids, kv_segment_ids, h, hkv):
    """JAX's argument rules: ``kv_segment_ids`` defaults to
    ``segment_ids`` only when the head counts match (the q-side ids are
    ``(B*H, S)`` rows, the kv side's ``(B*Hkv, Skv)``); kv ids without q
    ids are an error (JAX ignores them)."""
    if segment_ids is None:
        if kv_segment_ids is not None:
            raise ValueError("kv_segment_ids given without segment_ids")
        return None, None
    if kv_segment_ids is None:
        if hkv != h:
            raise ValueError(
                "GQA flash_attention needs an explicit (B*n_kv_heads, Skv) "
                "kv_segment_ids (the q-side ids have a different leading "
                "dim)")
        kv_segment_ids = segment_ids
    return segment_ids, kv_segment_ids


# ----------------------------------------------------------------- wrappers
def _check_seg(name, q, k, seg_q, seg_kv):
    """Segment ids: both or neither, int32, contiguous, ``(BH, Sq)`` and
    ``(BHkv, Skv)`` on q's device. Returns the kernels' two pointers (0 for
    none) and the counter variant."""
    if seg_q is None and seg_kv is None:
        return 0, 0, ""
    if seg_q is None or seg_kv is None:
        raise ValueError(f"{name}: seg_q and seg_kv go together")
    for nm, t, shape in (("seg_q", seg_q, q.shape[:2]),
                         ("seg_kv", seg_kv, k.shape[:2])):
        if t.device != q.device or t.dtype != torch.int32:
            raise ValueError(f"{name}: {nm} must be int32 on {q.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
    return seg_q.data_ptr(), seg_kv.data_ptr(), "seg"


def seg_tile_ranges(ids):
    """``(rows, ceil(n / SEG_TILE), 2)`` int32: the (min, max) segment id of
    every ``SEG_TILE`` positions of each row of ``ids`` ``(rows, n)``. The
    bf16 kernels skip a tile pair whose ranges do not meet
    (:func:`seg_tiles_meet`): no id of one can equal an id of the other."""
    rows, n = ids.shape
    pad = -n % SEG_TILE
    if pad:  # the last id again: the last piece's range stays its own
        ids = torch.cat((ids, ids[:, -1:].expand(rows, pad)), dim=1)
    lo, hi = torch.aminmax(ids.view(rows, -1, SEG_TILE), dim=-1)
    return torch.stack((lo, hi), dim=-1)


def seg_tiles_meet(a, b):
    """Whether id ranges ``a`` and ``b`` (``(..., 2)``, broadcast) overlap:
    the kernels' test for a tile pair that may hold a visible pair."""
    return torch.maximum(a[..., 0], b[..., 0]) <= torch.minimum(a[..., 1],
                                                                 b[..., 1])


def _seg_ranges(q, seg_q, seg_kv):
    """The range tables' pointers for a bf16 segment call (kept alive by
    the returned tensors), else zeros."""
    if seg_q is None or q.dtype != torch.bfloat16:
        return (), 0, 0
    tables = (seg_tile_ranges(seg_q), seg_tile_ranges(seg_kv))
    return tables, tables[0].data_ptr(), tables[1].data_ptr()


def dkv_splits(dtype, kv_rows: int, skv: int, walk_tiles: int,
               device) -> int:
    """Parts each bf16 dk/dv block's walk is split into, for ``kv_rows``
    (batch x kv heads) of ``skv`` keys whose longest walk is
    ``walk_tiles`` q tiles (rep x 64-row tiles): when the blocks alone
    fill the card less than twice (one block an SM; a causal walk's first
    blocks are its longest), the largest power of two of parts that does,
    each part at least ``_DKV_MIN_PART`` tiles. fp32 never splits. A split
    leaves f32 partial sums that a second kernel of the same call merges
    in part order. (On the H100 at Llama-2-70B heads, S = 2048, 2 parts
    beat 3, 4 and 1: ``PERF.md``.)"""
    if dtype != torch.bfloat16:
        return 1
    blocks = kv_rows * -(-skv // _DKV_KEYS)
    want = min(-(-2 * _build.sm_count(device.index or 0) // blocks),
               walk_tiles // _DKV_MIN_PART)
    return 1 << max(want, 1).bit_length() - 1


def _check_cuda(name, q, k, v, extra=()):
    """The kernels' contract: one CUDA device, float32 or bfloat16,
    contiguous, D <= 128, at most 65535 (batch * head) rows."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"{name}: q (BH, S, D) and k/v (BHkv, S, D) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: head dims differ ({q.shape[2]} vs "
                         f"{k.shape[2]})")
    if q.shape[2] > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {q.shape[2]} > {_MAX_HEAD_DIM} "
                         f"is not supported")
    if max(q.shape[0], k.shape[0]) > _MAX_ROWS:
        raise ValueError(f"{name}: more than {_MAX_ROWS} (batch * head) "
                         f"rows")
    _build.dtype_code(q.dtype)
    for nm, x, dtype in (("q", q, q.dtype), ("k", k, q.dtype),
                         ("v", v, q.dtype)) + tuple(extra):
        if x.device != q.device or x.dtype != dtype:
            raise ValueError(f"{name}: {nm} must be {dtype} on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")


# each entry: dtype, q, k, v, seg_q, seg_kv, the two range tables, its
# tensors, 7 ints, scale, stream; dk/dv also the split count and its
# scratch after dv
_FWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
_DQ_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                 + [ctypes.c_int, ctypes.c_void_p]
                 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_fwd(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None, n_heads: int = 1,
                        n_kv_heads: Optional[int] = None, seg_q=None,
                        seg_kv=None):
    """Forward attention without materialising the scores. Returns
    ``(out, lse)``: out ``(BH, S, D)`` in q's dtype, lse ``(BH, S)`` f32.
    ``seg_q``/``seg_kv``: int32 segment ids ``(BH, Sq)``/``(BHkv, Skv)``,
    both or neither.

    CPU tensors take :func:`flash_attention_fwd_ref`. CUDA tensors launch
    the kernel (float32 or bfloat16, contiguous, D <= 128, any S; bf16 on
    the tensor cores); a tensor it does not take raises."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, sm_scale, n_heads,
                                       n_kv_heads, seg_q, seg_kv)
    _check_cuda("flash_attention_fwd", q, k, v)
    sq_ptr, skv_ptr, variant = _check_seg("flash_attention_fwd", q, k,
                                          seg_q, seg_kv)
    h, hkv = _heads(n_heads, n_kv_heads, q, k)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), device=q.device, dtype=torch.float32)
    _tables, rq_ptr, rkv_ptr = _seg_ranges(q, seg_q, seg_kv)
    fn = _build.bind("flash_attention", "ptt_flash_attention_fwd",
                     _FWD_ARGTYPES)
    rc = fn(_build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), sq_ptr, skv_ptr, rq_ptr, rkv_ptr, out.data_ptr(),
            lse.data_ptr(), bh, sq, k.shape[1], h, hkv, d, int(bool(causal)),
            _scale(sm_scale, d), _build.stream_handle(q.device))
    _build.check(rc, "flash_attention_fwd")
    _build.count(flash_attention_fwd, variant)
    return out, lse


def _stats_extra(q, lse, delta, do):
    f32 = torch.float32
    if lse.shape != q.shape[:2] or delta.shape != q.shape[:2]:
        raise ValueError(f"lse/delta must be (BH, S) = {tuple(q.shape[:2])}")
    return (("do", do, q.dtype), ("lse", lse, f32), ("delta", delta, f32))


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           n_heads: int = 1,
                           n_kv_heads: Optional[int] = None, seg_q=None,
                           seg_kv=None):
    """dq of the FA-2 backward from the saved lse and ``delta =
    rowsum(dO * O)`` (both f32 ``(BH, S)``). CPU tensors take
    :func:`flash_attention_bwd_dq_ref`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal,
                                          sm_scale, n_heads, n_kv_heads,
                                          seg_q, seg_kv)
    _check_cuda("flash_attention_bwd_dq", q, k, v,
                _stats_extra(q, lse, delta, do))
    sq_ptr, skv_ptr, variant = _check_seg("flash_attention_bwd_dq", q, k,
                                          seg_q, seg_kv)
    h, hkv = _heads(n_heads, n_kv_heads, q, k)
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    _tables, rq_ptr, rkv_ptr = _seg_ranges(q, seg_q, seg_kv)
    fn = _build.bind("flash_attention", "ptt_flash_attention_bwd_dq",
                     _DQ_ARGTYPES)
    rc = fn(_build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), sq_ptr, skv_ptr, rq_ptr, rkv_ptr, do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq,
            k.shape[1], h, hkv, d, int(bool(causal)), _scale(sm_scale, d),
            _build.stream_handle(q.device))
    _build.check(rc, "flash_attention_bwd_dq")
    _build.count(flash_attention_bwd_dq, variant)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            sm_scale: Optional[float] = None,
                            n_heads: int = 1,
                            n_kv_heads: Optional[int] = None, seg_q=None,
                            seg_kv=None):
    """(dk, dv) of the FA-2 backward; every query head of a GQA group adds
    into its kv head. CPU tensors take :func:`flash_attention_bwd_dkv_ref`;
    CUDA tensors launch the kernel, which uses no atomics (gradients repeat
    bit for bit); in bf16 it may split its walk (:func:`dkv_splits`) and
    merge the parts in the same launch."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal,
                                           sm_scale, n_heads, n_kv_heads,
                                           seg_q, seg_kv)
    _check_cuda("flash_attention_bwd_dkv", q, k, v,
                _stats_extra(q, lse, delta, do))
    sq_ptr, skv_ptr, variant = _check_seg("flash_attention_bwd_dkv", q, k,
                                          seg_q, seg_kv)
    h, hkv = _heads(n_heads, n_kv_heads, q, k)
    bh, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _tables, rq_ptr, rkv_ptr = _seg_ranges(q, seg_q, seg_kv)
    nsplit = dkv_splits(q.dtype, k.shape[0], k.shape[1],
                        h // hkv * -(-sq // SEG_TILE), q.device)
    part = (torch.empty((nsplit, 2) + tuple(k.shape), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    fn = _build.bind("flash_attention", "ptt_flash_attention_bwd_dkv",
                     _DKV_ARGTYPES)
    rc = fn(_build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), sq_ptr, skv_ptr, rq_ptr, rkv_ptr, do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            nsplit, 0 if part is None else part.data_ptr(), k.shape[0], sq,
            k.shape[1], h, hkv, d, int(bool(causal)), _scale(sm_scale, d),
            _build.stream_handle(q.device))
    _build.check(rc, "flash_attention_bwd_dkv")
    _build.count(flash_attention_bwd_dkv, variant)
    return dk, dv


_build.counters(flash_attention_fwd, "", "seg")
_build.counters(flash_attention_bwd_dq, "", "seg")
_build.counters(flash_attention_bwd_dkv, "", "seg")


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, and the dq and dk/dv kernels as its backward;
    segment ids ride along to the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, h, hkv, seg_q, seg_kv):
        out, lse = flash_attention_fwd(q, k, v, causal, sm_scale, h, hkv,
                                       seg_q, seg_kv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, h, hkv, seg_q, seg_kv)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (out.float() * do.float()).sum(dim=-1)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, *ctx.args)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, segment_ids=None, kv_segment_ids=None,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    n_heads: int = 1, n_kv_heads: Optional[int] = None):
    """``(BH, S, D)``-layout flash attention, differentiable. GQA: q as
    ``(B*n_heads, S, D)``, k/v as ``(B*n_kv_heads, Skv, D)``; the kernels
    read the unexpanded kv and add dk/dv over each group's query heads.
    ``segment_ids`` ``(BH, S)`` int: rows attend only within their segment
    (packed sequences); ``kv_segment_ids`` ``(BHkv, Skv)`` defaults to it
    when the head counts match."""
    h, hkv = _heads(n_heads, n_kv_heads, q, k)
    seg_q, seg_kv = _segments(segment_ids, kv_segment_ids, h, hkv)
    if seg_q is not None:
        seg_q = seg_q.to(device=q.device, dtype=torch.int32).contiguous()
        seg_kv = seg_kv.to(device=q.device, dtype=torch.int32).contiguous()
    sm_scale = _scale(sm_scale, q.shape[-1])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal), sm_scale, h,
                                 hkv, seg_q, seg_kv)


class _FlashAttentionLSE(torch.autograd.Function):
    """``(out, lse)`` from the forward kernel; the backward runs the dq and
    dk/dv kernels once, with the lse cotangent folded into ``delta``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, h, hkv):
        out, lse = flash_attention_fwd(q, k, v, causal, sm_scale, h, hkv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, h, hkv)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        do = do.contiguous()
        delta = (out.float() * do.float()).sum(dim=-1)
        if dlse is not None:
            # d lse / d s = p: ds = p * (dp - delta + dlse). A fully
            # masked row has p = 0 and keeps zero gradients
            delta = delta - dlse.float()
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, *ctx.args)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             sm_scale: Optional[float] = None,
                             n_heads: int = 1,
                             n_kv_heads: Optional[int] = None):
    """``(BH, S, D)`` flash attention returning ``(out, lse)``, lse f32
    ``(BH, S)`` over the scaled scores (a fully masked row: 0): the form
    ring attention merges. Differentiable in both outputs; GQA as in
    :func:`flash_attention`. CPU tensors run the plain versions."""
    h, hkv = _heads(n_heads, n_kv_heads, q, k)
    return _FlashAttentionLSE.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), bool(causal),
                                    _scale(sm_scale, q.shape[-1]), h, hkv)


def flash_attention_bshd(q, k, v, segment_ids=None, kv_segment_ids=None,
                         causal: bool = True,
                         sm_scale: Optional[float] = None):
    """Paddle-convention ``(B, S, H, D)`` wrapper. GQA: k/v may carry fewer
    heads (Hkv | H), never expanded. ``segment_ids`` ``(B, S)``;
    ``kv_segment_ids`` ``(B, Skv)`` defaults to it when the lengths match.
    Each row's ids serve all its heads."""
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if segment_ids is not None and kv_segment_ids is None:
        if s != skv:
            raise ValueError(
                "kv_segment_ids required when q and kv lengths differ")
        kv_segment_ids = segment_ids
    seg_q, seg_kv = (None if ids is None else ids.repeat_interleave(n, dim=0)
                     for ids, n in ((segment_ids, h), (kv_segment_ids, hkv)))

    def to_bhsd(t, sl, nh):
        return t.transpose(1, 2).reshape(b * nh, sl, d)

    out = flash_attention(to_bhsd(q, s, h), to_bhsd(k, skv, hkv),
                          to_bhsd(v, skv, hkv), seg_q, seg_kv, causal=causal,
                          sm_scale=sm_scale, n_heads=h, n_kv_heads=hkv)
    return out.reshape(b, h, s, d).transpose(1, 2)
