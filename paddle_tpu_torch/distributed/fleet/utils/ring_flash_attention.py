"""Long-context attention over the ``sep`` axis: ring attention and
Ulysses (counterpart of
``paddle_tpu/distributed/fleet/utils/ring_flash_attention.py``).

The reference is single-controller: its per-shard bodies run inside
``jax.shard_map``, ``ppermute`` rotates the kv chunk, autodiff transposes
it into the backward ring, and the zigzag reorder is a ``jnp.take`` on
global arrays that GSPMD turns into an exchange. Here each rank is a
process holding its own chunk, every move is an explicit transfer with an
autograd rule, and rank r's result equals slice r of the reference's
global result.

- Ring: each of the P steps runs one chunk-against-chunk attention through
  :func:`_chunk_attn` (``flash_attention_with_lse``: the flash forward,
  and the dq and dk/dv kernels in the backward, lse cotangent folded in;
  plain versions on CPU tensors; GQA kv unexpanded), merged in f32 in
  log space in the reference's order. The skip / full / causal choice of
  a unit is Python on the rank index; a skipped unit launches nothing (the
  kernel reads a fully masked row's lse as 0, which would merge wrongly).
  k and v rotate as ONE stacked tensor through :class:`_Rotate` (forward:
  to rank r + 1, from r - 1, one ``batch_isend_irecv``; backward: the other
  way): the ranks' graphs differ (rank 0 skips units rank P - 1 runs), and
  one chain of rotations keeps every rank's backward transfers in one
  order, where two chains could interleave differently and deadlock, and
  :class:`_Tie` keeps the whole chain in every rank's graph.
- Ulysses: the tiled all-to-alls (``mp_ops._all_to_all``, inverse
  exchange backward) turn sequence chunks into head slices of the whole
  sequence; kv heads too few to split are all-gathered whole (adjoint: a
  reduce-scatter, since every rank's heads read all of them).
- :func:`sep_scaled_dot_product_attention` takes the rank's CONTIGUOUS
  chunk ``(B, S/P, H, D)`` (the reference's ``P(None, "sep")`` slice).
  Under causal ring attention it moves the half-chunks into zigzag order
  (rank r ends with pieces r and 2P - 1 - r), runs the ring and moves the
  output back, both through :class:`_Pieces` (a differentiable exchange).

Transfers go through ``pp_utils``' :class:`Wire`: under gloo a CUDA tensor
is staged through pinned host memory (``p2p_host_staged``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..layers.mpu.mp_ops import _all_gather, _all_to_all

_NEG_INF = -1e30


def _sep_group(group):
    """``group`` as a Group: a Group, an hcg (its sep group), or None (the
    live topology's sep group; None without one)."""
    if group is None:
        from ..base_topology import try_get_hybrid_communicate_group
        group = try_get_hybrid_communicate_group()
        if group is None:
            return None
    if hasattr(group, "get_sep_parallel_group"):
        return group.get_sep_parallel_group()
    return group


def _wire(group, device):
    from ..meta_parallel.pp_utils.p2p_communication import Wire
    return Wire(group, device)


# ------------------------------------------------------------ ring attention
def _chunk_attn(q, k, v, causal, sm_scale, h, hkv):
    """One ring unit: ``(B, Cq, H, D)`` x ``(B, Ck, Hkv, D)`` -> ``(out (B,
    Cq, H, D), lse (B, H, Cq) f32)``, the mergeable pair, through the flash
    kernels (unexpanded GQA kv). No dense fallback: a CUDA tensor launches
    the kernel or raises."""
    from ....kernels.flash_attention import flash_attention_with_lse
    b, cq, _, d = q.shape
    ck = k.shape[1]
    qf = q.transpose(1, 2).reshape(b * h, cq, d)
    kf = k.transpose(1, 2).reshape(b * hkv, ck, d)
    vf = v.transpose(1, 2).reshape(b * hkv, ck, d)
    out, lse = flash_attention_with_lse(qf, kf, vf, causal=causal,
                                        sm_scale=sm_scale, n_heads=h,
                                        n_kv_heads=hkv)
    return (out.reshape(b, h, cq, d).transpose(1, 2),
            lse.reshape(b, h, cq))


def _merge(o1, lse1, o2, lse2):
    """Two partial softmax results combined in log space: out ``(B, C, H,
    D)`` in f32 (the ring's accumulator), lse ``(B, H, C)``. An empty
    partial (lse -1e30) contributes 0."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(m <= _NEG_INF / 2, torch.zeros_like(m), m)
    w1 = torch.exp(lse1 - m_safe)
    w2 = torch.exp(lse2 - m_safe)
    den = w1 + w2
    den_safe = torch.where(den == 0.0, torch.ones_like(den), den)
    lse = torch.where(den == 0.0, torch.full_like(den, _NEG_INF),
                      m_safe + torch.log(den_safe))

    def wt(w):
        return (w / den_safe).transpose(1, 2)[..., None]

    return o1.float() * wt(w1) + o2.float() * wt(w2), lse


def _empty_partial(b, c, h, d, device):
    return (torch.zeros((b, c, h, d), dtype=torch.float32, device=device),
            torch.full((b, h, c), _NEG_INF, dtype=torch.float32,
                       device=device))


class _Rotate(torch.autograd.Function):
    """The stacked kv chunk to the next rank of the ring, from the
    previous one; the backward sends the cotangent the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _Tie(torch.autograd.Function):
    """``o`` unchanged, with the last rotated kv as a second input whose
    gradient is zero: every rank's backward then walks its whole chain of
    rotations, also where its last units were skipped (a rank that left
    its last rotations out of the graph would leave its neighbours
    waiting)."""

    @staticmethod
    def forward(ctx, o, kv):
        ctx.like = (kv.shape, kv.dtype, kv.device)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _shift(x, group, step):
    n, r = group.nranks, group.rank
    out = torch.empty_like(x)
    _wire(group, x.device).exchange(
        sends=[(x, group.ranks[(r + step) % n])],
        recvs=[(out, group.ranks[(r - step) % n])])
    return out


def ring_flash_attention(q, k, v, group=None, causal: bool = True,
                         sm_scale: Optional[float] = None,
                         zigzag: bool = False):
    """This rank's ring attention. q/k/v: ``(B, C, H(kv), D)``, the rank's
    chunk of the global ``(B, S, H, D)`` arrays, ``C = S / P``; GQA kv rides
    the ring unexpanded. Returns ``(B, C, H, D)``.

    ``zigzag``: the chunks are in zigzag order (rank r holds pieces r and
    2P - 1 - r, half a chunk each; :func:`sep_scaled_dot_product_attention`
    reorders), which balances causal work: per rotation every rank runs
    the same count of full half-blocks plus the two diagonal halves."""
    group = _sep_group(group)
    p = 1 if group is None else group.nranks
    idx = 0 if group is None else group.rank
    b, c, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} not divisible by kv heads {hkv}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    attn = functools.partial(_chunk_attn, sm_scale=sm_scale, h=h, hkv=hkv)
    kv = torch.stack([k, v])

    def rotate(kv, i):
        return _Rotate.apply(kv, group) if i < p - 1 else kv

    def tie(o, kv):
        return _Tie.apply(o, kv) if p > 1 and torch.is_grad_enabled() \
            and kv.requires_grad else o

    if not zigzag:
        # causal contiguous: rank r attends chunks src < r fully, its own
        # causally, later ones not at all
        o, lse = _empty_partial(b, c, h, d, q.device)
        for i in range(p):
            src = (idx - i) % p
            if not causal or src <= idx:
                o, lse = _merge(o, lse, *attn(q, kv[0], kv[1],
                                              causal and src == idx))
            kv = rotate(kv, i)
        return tie(o, kv).to(q.dtype)

    if not causal:
        raise ValueError("zigzag layout only applies to causal attention")
    if c % 2:
        raise ValueError(f"zigzag ring needs an even local chunk, got {c}")
    half = c // 2
    qa, qb = q[:, :half], q[:, half:]
    oa, la = _empty_partial(b, half, h, d, q.device)
    ob, lb = _empty_partial(b, half, h, d, q.device)
    for i in range(p):
        src = (idx - i) % p
        ka, kb = kv[0][:, :half], kv[0][:, half:]
        va, vb = kv[1][:, :half], kv[1][:, half:]
        # pieces: qa = idx, qb = 2P-1-idx, ka = src, kb = 2P-1-src
        if src <= idx:
            oa, la = _merge(oa, la, *attn(qa, ka, va, src == idx))
        # piece(ka) <= P - 1 < piece(qb): always full
        ob, lb = _merge(ob, lb, *attn(qb, ka, va, False))
        if src >= idx:
            ob, lb = _merge(ob, lb, *attn(qb, kb, vb, src == idx))
        kv = rotate(kv, i)
    return tie(torch.cat([oa, ob], dim=1), kv).to(q.dtype)


def zigzag_order(S: int, p: int):
    """The balanced ring's global sequence permutation: rank r's chunk is
    ``[piece r, piece 2P-1-r]`` of 2P equal pieces. Returns ``(order,
    inverse)`` index arrays, or None when S does not split into 2P
    pieces."""
    if S % (2 * p):
        return None
    piece = S // (2 * p)
    order = np.concatenate([
        np.r_[r * piece:(r + 1) * piece,
              (2 * p - 1 - r) * piece:(2 * p - r) * piece]
        for r in range(p)])
    inv = np.argsort(order)
    return order, inv


def _zigzag_pieces(p: int):
    """(contiguous, zigzag): each rank's two pieces of 2P, in its order."""
    return ([[2 * r, 2 * r + 1] for r in range(p)],
            [[r, 2 * p - 1 - r] for r in range(p)])


def _move_pieces(x, group, have: Sequence[Sequence[int]],
                 want: Sequence[Sequence[int]]):
    """Rank r holds pieces ``have[r]`` (equal parts of dim 1, in order) and
    ends with pieces ``want[r]``: one message to each other rank that
    wants a piece of mine (its pieces in ascending order), one from each
    rank holding a piece I want, as one ``batch_isend_irecv``."""
    n, r = group.nranks, group.rank
    parts = list(x.chunk(len(have[r]), dim=1))
    mine = dict(zip(have[r], parts))
    owner = {j: q for q in range(n) for j in have[q]}
    sends, recvs, got = [], [], {}
    for q in range(n):
        if q == r:
            continue
        out = sorted(j for j in want[q] if owner[j] == r)
        if out:
            sends.append((torch.cat([mine[j] for j in out], dim=1),
                          group.ranks[q]))
        inc = sorted(j for j in want[r] if owner[j] == q)
        if inc:
            buf = torch.empty((x.shape[0], parts[0].shape[1] * len(inc))
                              + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            recvs.append((buf, group.ranks[q]))
            got.update(zip(inc, buf.chunk(len(inc), dim=1)))
    _wire(group, x.device).exchange(sends, recvs)
    return torch.cat([mine[j] if owner[j] == r else got[j]
                      for j in want[r]], dim=1)


class _Pieces(torch.autograd.Function):
    """:func:`_move_pieces` from ``have`` to ``want``; the backward moves
    the cotangent from ``want`` back to ``have``."""

    @staticmethod
    def forward(ctx, x, group, have, want):
        ctx.group, ctx.have, ctx.want = group, have, want
        return _move_pieces(x, group, have, want)

    @staticmethod
    def backward(ctx, g):
        return (_move_pieces(g.contiguous(), ctx.group, ctx.want, ctx.have),
                None, None, None)


# --------------------------------------------------------- ulysses attention
def _dense_sdpa(q, k, v, causal, sm_scale):
    """``(B, S, H, D)`` attention in f32 PyTorch ops (the reference's
    ``_dense_sdpa``, outside any kernel there too); the result in q's
    dtype."""
    qf = q.transpose(1, 2).float() * sm_scale
    kf = k.transpose(1, 2).float()
    vf = v.transpose(1, 2).float()
    s = qf @ kf.transpose(-1, -2)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(sk, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    o = torch.softmax(s, dim=-1) @ vf
    return o.to(q.dtype).transpose(1, 2)


def ulysses_attention(q, k, v, group=None, causal: bool = True,
                      sm_scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None,
                      attn_fn_gqa: bool = False):
    """This rank's Ulysses attention. q/k/v: ``(B, C, H(kv), D)`` sequence
    chunks; H must divide by P. Two all-to-alls give each rank the whole
    sequence for H/P heads, ``attn_fn`` (default: dense attention) runs on
    them, and the inverse all-to-all restores the chunks.

    GQA: kv heads divisible by P split like q heads (expanded to the local
    q heads first unless ``attn_fn_gqa`` says ``attn_fn`` takes grouped
    kv). Fewer kv heads are all-gathered whole along the sequence, and
    each rank selects the kv heads its q heads read: one kv head when
    ``attn_fn_gqa`` and the whole local q slice lies in one kv group."""
    group = _sep_group(group)
    p = 1 if group is None else group.nranks
    r = 0 if group is None else group.rank
    b, c, h, d = q.shape
    hkv = k.shape[2]
    if h % p:
        raise ValueError(f"num heads {h} not divisible by sep degree {p}")
    if h % hkv:
        raise ValueError(f"q heads {h} not divisible by kv heads {hkv}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)

    def seq_gather(t):    # (B, C, Hx, D) -> (B, C*P, Hx/P, D)
        return _all_to_all(t, group, 2, 1) if p > 1 else t

    def seq_scatter(t):   # (B, C*P, H/P, D) -> (B, C, H, D)
        return _all_to_all(t, group, 1, 2) if p > 1 else t

    qg = seq_gather(q)
    fn = attn_fn or functools.partial(_dense_sdpa, causal=causal,
                                      sm_scale=sm_scale)
    gqa_fn = attn_fn is not None and attn_fn_gqa
    if hkv == h or hkv % p == 0:
        kg, vg = seq_gather(k), seq_gather(v)
        if hkv != h and not gqa_fn:
            rep = (h // p) // (hkv // p)
            kg = kg.repeat_interleave(rep, dim=2)
            vg = vg.repeat_interleave(rep, dim=2)
        out = fn(qg, kg, vg)
    else:
        kg = _all_gather(k, group, 1) if p > 1 else k
        vg = _all_gather(v, group, 1) if p > 1 else v
        rep = h // hkv
        hq_l = h // p
        if gqa_fn and rep % hq_l == 0:
            # the whole local q slice reads one kv head
            sel = torch.tensor([r * hq_l // rep], device=q.device)
        else:
            sel = (r * hq_l + torch.arange(hq_l, device=q.device)) // rep
        out = fn(qg, kg.index_select(2, sel), vg.index_select(2, sel))
    return seq_scatter(out)


# ------------------------------------------------------------ the entry point
def sep_scaled_dot_product_attention(q, k, v, group=None,
                                     method: str = "ring",
                                     causal: bool = True,
                                     sm_scale: Optional[float] = None):
    """Context-parallel attention on this rank's CONTIGUOUS chunk ``(B,
    S/P, H, D)`` of q/k/v over ``group`` (a Group, an hcg, or None: the
    live topology's sep group). One rank (or none) takes the dense path on
    the whole sequence (GQA kv expanded), as the reference's mesh without
    a sep axis does. Causal ring attention runs in zigzag order when S
    splits into 2P pieces."""
    group = _sep_group(group)
    if group is None or group.nranks <= 1:
        if k.shape[2] != q.shape[2]:
            rep = q.shape[2] // k.shape[2]
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        return _dense_sdpa(q, k, v, causal,
                           sm_scale or 1.0 / math.sqrt(q.shape[-1]))
    if method not in ("ring", "ulysses"):
        raise KeyError(method)
    p = group.nranks
    if method == "ulysses":
        return ulysses_attention(q, k, v, group, causal, sm_scale)
    if not causal or zigzag_order(q.shape[1] * p, p) is None:
        return ring_flash_attention(q, k, v, group, causal, sm_scale)
    have, want = _zigzag_pieces(p)
    h = q.shape[2]
    hkv = k.shape[2]
    qkv = _Pieces.apply(torch.cat([q, k, v], dim=2), group, have, want)
    out = ring_flash_attention(qkv[:, :, :h], qkv[:, :, h:h + hkv],
                               qkv[:, :, h + hkv:], group, True, sm_scale,
                               zigzag=True)
    return _Pieces.apply(out, group, want, have)
