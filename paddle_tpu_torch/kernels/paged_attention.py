"""Paged KV cache (block tables) for serving.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``: the KV cache
lives in fixed-size pages drawn from a shared pool per layer, each sequence
owns a block table of page ids, and freed pages recycle across requests.
:func:`paged_attention` is the one-token decode attention through the block
tables, the hand-written split-KV CUDA kernel in
``csrc/paged_attention.cu`` (on ``csrc/decode_split.cuh``);
:func:`paged_chunk_attention` is the chunked-prefill attention of an
S-token chunk against the pool prefix plus itself, read through the block
table by the CUDA kernel in ``csrc/paged_chunk_attention.cu``.

A pool half is either a native tensor in the activation dtype or, for
``kv_dtype="int8"``, a :class:`QuantizedPages` (int8 payload plus one f32
scale per token row); every reader takes both, and the kernels dequantize
each element as they read it. Unlike the JAX package, whose arrays are
immutable, the page writes here update the pool tensors in place (no
pool-sized copy per token) and return the same pool objects.

:class:`PagedKVCache` keeps per-page reference counts (a prompt prefix may
be shared read-only by several sequences and a prefix cache), the pool
ledger, and a host-memory tier: :meth:`PagedKVCache.spill_page` copies one
page of every layer to a :class:`HostPage` and
:meth:`PagedKVCache.restore_page` writes it back into any free page, in
place, so CUDA graphs captured over the pools stay valid.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import _build
from .decode_attention import prefill_splits, split_scratch

_NEG_INF = -1e30


# ------------------------------------------------------- quantized pools
class QuantizedPages(NamedTuple):
    """One pool half stored int8 with a per-token-row f32 scale: ``q`` is
    the payload, ``scale[h, p, t, 0]`` dequantizes row ``t`` of page ``p``
    for kv head ``h`` (``q.float() * scale``). The scale is per row, so a
    row's stored bits are a function of that row's own k/v vector and do
    not depend on the order the rows were written in (a chunk at once or
    token by token). ``shape``, ``dtype`` and ``device`` are the
    payload's, so geometry probes (``k_pages.shape[2]``) keep working."""
    q: torch.Tensor       # int8 (Hkv, num_pages, page_size, D)
    scale: torch.Tensor   # f32  (Hkv, num_pages, page_size, 1)

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self):
        return self.q.device


def shard_pool(pages, shard: int, tp: int):
    """Shard ``shard`` of ``tp``'s partition of a pool half over its kv
    heads: the contiguous view ``pages[shard*Hkv/tp:(shard+1)*Hkv/tp]``
    (payload and scale band together for :class:`QuantizedPages`). A view:
    writes through it land in the pool, and a kernel takes its pointer as
    is (a leading-axis slice of a contiguous tensor is contiguous)."""
    hkv = pages.shape[0]
    if hkv % tp:
        raise ValueError(f"{hkv} kv heads do not split over tp={tp}")
    lo, hi = shard * hkv // tp, (shard + 1) * hkv // tp
    if isinstance(pages, QuantizedPages):
        return QuantizedPages(pages.q[lo:hi], pages.scale[lo:hi])
    return pages[lo:hi]


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over the trailing (head_dim)
    axis: returns ``(q, scale)`` with ``q.float() * scale`` the dequantized
    value. ``scale`` is the raw ``amax / 127`` (0 for an all-zero row);
    the division uses 1 there. Rounds half to even, as ``jnp.round``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = amax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x32 / safe), -127, 127).to(torch.int8)
    return q, scale


def _gathered_pool(pages, idx: torch.Tensor) -> torch.Tensor:
    """Pool pages gathered by an index tensor (B, ...), batch leading, in
    f32: ``(B, Hkv, *idx.shape[1:], page, D)``. A quantized pool is
    dequantized on the gathered view, so no reader branches on storage."""
    if isinstance(pages, QuantizedPages):
        return (pages.q[:, idx].movedim(1, 0).float()
                * pages.scale[:, idx].movedim(1, 0))
    return pages[:, idx].movedim(1, 0).float()


def _parts(pages) -> Tuple[torch.Tensor, ...]:
    """The tensors a pool half stores: (payload, scale) or (pool,)."""
    return tuple(pages) if isinstance(pages, QuantizedPages) else (pages,)


def _stored(pages, new: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``new`` (..., D) as the pool half stores it, one tensor per part:
    quantized rows (payload, scale), or a cast to the pool's dtype."""
    if isinstance(pages, QuantizedPages):
        return quantize_kv_rows(new)
    return (new.to(pages.dtype),)


class PagedDecodeState(NamedTuple):
    """One layer's paged cache as it rides a decode or prefill step: the
    pool pair (native tensors or :class:`QuantizedPages`), the block tables
    and the per-sequence written counts."""
    k_pages: torch.Tensor       # (Hkv, num_pages, page_size, D)
    v_pages: torch.Tensor
    block_tables: torch.Tensor  # (B, max_pages) int32
    seq_lens: torch.Tensor      # (B,) int32


class PagedChunkState(NamedTuple):
    """The chunked-prefill twin of :class:`PagedDecodeState`: same fields,
    but its type routes S > 1 attention onto the cache-reading prefill
    path: the query chunk lands at positions ``seq_lens .. seq_lens+S-1``
    and attends to the already-written prefix plus itself, causally,
    instead of requiring empty sequences. Decode (S == 1) behaves as
    under :class:`PagedDecodeState`.

    Length contract: the returned state's ``seq_lens`` advance by the full
    chunk width S, so a padded final chunk overcounts by its pad tail. The
    driver owns the true lengths (it knows how many fed tokens were real)
    and keeps them on the host, as ``ServingEngine`` does."""
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_tables: torch.Tensor
    seq_lens: torch.Tensor


def is_paged_state(entry) -> bool:
    """Whether ``entry`` is either paged-cache state type: the test the
    models use to route attention onto the paged path."""
    return isinstance(entry, (PagedDecodeState, PagedChunkState))


def paged_position_ids(s: int, offset, state: PagedDecodeState
                       ) -> torch.Tensor:
    """Decode position ids for a paged cache entry. ``offset`` is a host
    int that broadcasts (whole-prompt prefill: 0), or a device tensor of
    one start per row or a single start (the chunk program's cursor: it
    broadcasts on the device, with no read back to the host, so a CUDA
    graph replays it with the value of each call); ``offset=None`` gives
    each row its own written length."""
    base = torch.arange(s, dtype=torch.int64,
                        device=state.block_tables.device).unsqueeze(0)
    if offset is None:
        return base + state.seq_lens.to(torch.int64).unsqueeze(1)
    if isinstance(offset, torch.Tensor):
        return base + offset.to(torch.int64).reshape(-1, 1)
    return base + int(offset)


# ------------------------------------------------------------ attention
def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        seq_lens: torch.Tensor,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`paged_attention`: gathers each sequence's
    contiguous view (dequantized for an int8 pool), then masked attention
    in f32. A sequence with no tokens reads zeros, as the kernel (and the
    Pallas kernel) emits."""
    b, h, d = q.shape
    hkv, _, page_size, _ = k_pages.shape
    rep = h // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    t = bt.shape[1] * page_size
    # (B, Hkv, max_pages, page, D) -> (B, Hkv, T, D)
    k = _gathered_pool(k_pages, bt).reshape(b, hkv, t, d)
    v = _gathered_pool(v_pages, bt).reshape(b, hkv, t, d)
    qg = q.reshape(b, hkv, rep, d).float()
    s = torch.einsum("bhrd,bhtd->bhrt", qg, k) * sm_scale
    mask = torch.arange(t, device=q.device)[None, :] < seq_lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1) * (seq_lens > 0)[:, None, None, None]
    out = torch.einsum("bhrt,bhtd->bhrd", p, v)
    return out.reshape(b, h, d).to(q.dtype)


def _check_pools(k_pages, v_pages, device, dtype=None) -> bool:
    """Check a layer's pool pair and return whether it is quantized. A
    native pair: two contiguous (Hkv, P, page, D) tensors on ``device``,
    of ``dtype`` (the activation dtype) when given. A quantized pair: two
    :class:`QuantizedPages`, each a contiguous int8 payload and a
    contiguous f32 scale of shape (Hkv, P, page, 1) on ``device``; the
    activation dtype is the caller's, not the pool's."""
    quant = isinstance(k_pages, QuantizedPages)
    if quant != isinstance(v_pages, QuantizedPages):
        raise ValueError("k/v pools must both be native or both quantized")
    if not quant and not (isinstance(k_pages, torch.Tensor)
                          and isinstance(v_pages, torch.Tensor)):
        raise TypeError("k/v pools must be tensors or QuantizedPages")
    if (k_pages.q if quant else k_pages).dim() != 4:
        raise ValueError(f"k/v pools must be (Hkv, P, page, D), got "
                         f"{tuple(k_pages.shape)}")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pools must share a (Hkv, P, page, D) shape, "
                         f"got {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    if quant:
        want = [(torch.int8, tuple(k_pages.shape)),
                (torch.float32, tuple(k_pages.shape[:3]) + (1,))] * 2
        parts = (("k_pages.q", k_pages.q), ("k_pages.scale", k_pages.scale),
                 ("v_pages.q", v_pages.q), ("v_pages.scale", v_pages.scale))
    else:
        want = [(dtype or k_pages.dtype, tuple(k_pages.shape))] * 2
        parts = (("k_pages", k_pages), ("v_pages", v_pages))
    for (name, x), (dt, shape) in zip(parts, want):
        if x.device != device or x.dtype != dt:
            raise ValueError(f"{name} must be {dt} on {device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return quant


def _pool_ptrs(k_pages, v_pages, quant: bool) -> list:
    """Device addresses (k, v, k-scale, v-scale) of a checked pool pair;
    a native pair has no scales (0)."""
    if quant:
        return [k_pages.q.data_ptr(), v_pages.q.data_ptr(),
                k_pages.scale.data_ptr(), v_pages.scale.data_ptr()]
    return [k_pages.data_ptr(), v_pages.data_ptr(), 0, 0]


def _check_index(name, x, shape, device):
    if x.device != device or x.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 on {device}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         f"tensor, got {tuple(x.shape)}")


_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
             + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
_MAX_HEAD_DIM = 128
# the split-KV decode walk: keys a part covers (about), the fewest a part
# covers when parts are cut smaller to fill the card, and the blocks an SM
# the cut aims for
_SPLIT_KEYS, _MIN_SPLIT_KEYS, _SPLIT_BLOCKS_PER_SM = 256, 64, 4


def decode_splits(blocks: int, maxp: int, page: int, sms: int
                  ) -> Tuple[int, int]:
    """``(part_pages, nsplit)`` of the split-KV decode walk over a block
    table ``maxp`` pages wide, for ``blocks`` (batch rows x kv heads x head
    groups) blocks a part and a card of ``sms`` SMs: parts of about
    ``_SPLIT_KEYS`` keys, halved (down to ``_MIN_SPLIT_KEYS``, at least
    one page) while the whole table's parts would give the card fewer
    than ``_SPLIT_BLOCKS_PER_SM`` blocks an SM (a table's rows are seldom
    all full, and a part past a row's length exits at once). A function of
    the shapes only: the lengths stay on the device, so the host never
    waits for them. (On the H100 at chip_smoke's decode shapes: 128-key
    parts at B = 4 x 1024 keys, 256 at 4 x 4096; ``PERF.md``.)"""
    part = max(1, _SPLIT_KEYS // page)
    least = max(1, _MIN_SPLIT_KEYS // page)
    while (part > least
           and blocks * -(-maxp // part) < _SPLIT_BLOCKS_PER_SM * sms):
        part = max(least, part // 2)
    return part, -(-maxp // part)


def decode_split_plan(b: int, h: int, hkv: int, maxp: int, page: int,
                      sms: int) -> Tuple[int, int]:
    """``(part_pages, nsplit)`` for one-token attention of ``b`` rows of
    ``h`` query heads over ``hkv`` kv heads: :func:`decode_splits` over
    the routine's blocks (a block serves up to 8 query heads of its kv
    head, ``csrc/decode_split.cuh``). :func:`paged_attention` and the
    fused decode kernels' attention phase both take their parts from it."""
    return decode_splits(b * hkv * -(-(h // hkv) // 8), maxp, page, sms)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention against a paged pool.

    q: (B, H, D); k/v_pages: (Hkv, num_pages, page_size, D) native pools
    in q's dtype or :class:`QuantizedPages`; block_tables: (B, max_pages)
    int32 (entries past the used count are ignored, keep them 0);
    seq_lens: (B,) int32 valid tokens per sequence. Returns (B, H, D) in
    q's dtype. CPU tensors take :func:`paged_attention_ref`; CUDA tensors
    launch the split-KV kernel (its int8 entry for a quantized pool; D <=
    128), its walk cut by :func:`decode_splits`."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   seq_lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, "
                         f"got {q.device}")
    b, h, d = q.shape
    quant = _check_pools(k_pages, v_pages, q.device, q.dtype)
    hkv, num_pages, page, dk = k_pages.shape
    if dk != d or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pages.shape)}")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head_dim {d} > {_MAX_HEAD_DIM} "
                         f"is not supported")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    maxp = block_tables.shape[1]
    _check_index("block_tables", block_tables, (b, maxp), q.device)
    _check_index("seq_lens", seq_lens, (b,), q.device)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    part_pages, nsplit = decode_split_plan(
        b, h, hkv, maxp, page, _build.sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    _scratch, ptrs = split_scratch(nsplit, b * h, d, q.device)
    fn = _build.bind("paged_attention", "ptt_paged_attention", _ARGTYPES)
    rc = fn(_build.dtype_code(q.dtype), _build.kv_code(quant), q.data_ptr(),
            *_pool_ptrs(k_pages, v_pages, quant), block_tables.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), *ptrs, b, h, hkv, d,
            num_pages, page, maxp, part_pages, nsplit, float(sm_scale),
            _build.stream_handle(q.device))
    _build.check(rc, "paged_attention")
    _build.count(paged_attention, "int8" if quant else "")
    return out


_build.counters(paged_attention, "", "int8")


# ------------------------------------------------ chunked-prefill attention
# pages per step of the plain version's loop, ~128 keys a step, as in the
# JAX package's XLA twin: a fixed-size page-group block, never the gathered
# (B, T, Hkv, D) view
_CHUNK_GROUP_KEYS = 128


def paged_chunk_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              start: torch.Tensor,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Plain version of :func:`paged_chunk_attention`, the copy-free loop
    of the JAX package's ``paged_chunk_attention_xla``: over groups of
    pages of the block table, with an online softmax in f32. Pages past a
    sequence's written count are read (their table entries are 0) but
    masked by position."""
    b, s, h, d = q.shape
    hkv, _, page_size, _ = k_pages.shape
    if h % hkv:
        raise ValueError(f"query heads {h} not divisible by kv heads {hkv}")
    rep = h // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    max_pages = bt.shape[1]
    grp = min(max_pages, max(1, _CHUNK_GROUP_KEYS // page_size))
    n_groups = -(-max_pages // grp)
    if n_groups * grp != max_pages:
        # pad with page 0: its positions lie past every query's position
        bt = torch.nn.functional.pad(bt, (0, n_groups * grp - max_pages))
    keys = grp * page_size
    qg = (q.float() * sm_scale).permute(0, 2, 1, 3).reshape(b, hkv, rep, s, d)
    q_pos = (start.long()[:, None]
             + torch.arange(s, device=q.device)[None, :])       # (B, S)
    acc = torch.zeros((b, hkv, rep, s, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, hkv, rep, s), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, rep, s), dtype=torch.float32, device=q.device)
    for j in range(n_groups):
        pages = bt[:, j * grp:(j + 1) * grp]                     # (B, G)
        # (B, Hkv, G, page, D) -> (B, Hkv, G * page, D)
        kb = _gathered_pool(k_pages, pages).reshape(b, hkv, keys, d)
        vb = _gathered_pool(v_pages, pages).reshape(b, hkv, keys, d)
        sc = torch.einsum("bhrsd,bhpd->bhrsp", qg, kb)
        kv_pos = j * keys + torch.arange(keys, device=q.device)
        vis = kv_pos[None, None, :] <= q_pos[:, :, None]         # (B, S, P)
        sc = sc.masked_fill(~vis[:, None, None], _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        m_new = torch.where(m_new <= _NEG_INF / 2,
                            torch.zeros_like(m_new), m_new)
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhrsp,bhpd->bhrsd",
                                                    p, vb)
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h, d).to(q.dtype)


_CHUNK_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          start: torch.Tensor,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill attention read straight through the block table.

    The S-token query chunk sits at absolute positions ``start ..
    start+S-1`` and attends causally to the pool's already-written prefix
    plus its own tokens, which the caller has written first
    (:func:`write_paged_prompt_at`). q: (B, S, H, D); k/v_pages: (Hkv,
    num_pages, page_size, D), native or :class:`QuantizedPages`;
    block_tables: (B, max_pages) int32; start:
    (B,) int32, the written length before this chunk, read on the device.
    Returns (B, S, H, D) in q's dtype; rows past the real prompt tail (a
    padded final chunk) emit values the caller discards. CPU tensors take
    :func:`paged_chunk_attention_ref`; CUDA tensors launch the kernel
    (float32 or bfloat16, D <= 128)."""
    if q.device.type == "cpu":
        return paged_chunk_attention_ref(q, k_pages, v_pages, block_tables,
                                         start, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_chunk_attention runs on cuda or cpu, "
                         f"got {q.device}")
    b, s, h, d = q.shape
    quant = _check_pools(k_pages, v_pages, q.device, q.dtype)
    hkv, num_pages, page, dk = k_pages.shape
    if dk != d or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pages.shape)}")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {_MAX_HEAD_DIM} is not supported")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    maxp = block_tables.shape[1]
    _check_index("block_tables", block_tables, (b, maxp), q.device)
    _check_index("start", start, (b,), q.device)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    # start lives on the device: split by the table's width
    nsplit = prefill_splits(q.dtype, b * h, s, maxp * page, q.device)
    scratch, ptrs = split_scratch(nsplit, b * s * h, d, q.device)
    fn = _build.bind("paged_chunk_attention", "ptt_paged_chunk_attention",
                     _CHUNK_ARGTYPES)
    rc = fn(_build.dtype_code(q.dtype), _build.kv_code(quant), q.data_ptr(),
            *_pool_ptrs(k_pages, v_pages, quant), block_tables.data_ptr(),
            start.data_ptr(), out.data_ptr(), *ptrs, b, s, h, hkv, d,
            num_pages, page, maxp, nsplit, float(sm_scale),
            _build.stream_handle(q.device))
    _build.check(rc, "paged_chunk_attention")
    _build.count(paged_chunk_attention, "int8" if quant else "")
    return out


_build.counters(paged_chunk_attention, "", "int8")


# ------------------------------------------------------- pool writes
def write_paged_kv(k_pages, v_pages, k_new, v_new, block_tables, positions):
    """Write one token per sequence into the pools at absolute sequence
    ``positions`` ((B,) int). k_new/v_new: (B, Hkv, D), cast to a native
    pool's dtype or quantized per row for an int8 pool. Updates the pools
    in place and returns them."""
    _check_pools(k_pages, v_pages, k_pages.device)
    page_size = k_pages.shape[2]
    pos = positions.long()
    page_of = block_tables.long().gather(1, (pos // page_size)[:, None])[:, 0]
    off = pos % page_size
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        for dst, val in zip(_parts(pool), _stored(pool, new)):
            dst[:, page_of, off] = val.movedim(0, 1)
    return k_pages, v_pages


def write_paged_prompt(k_pages, v_pages, k_new, v_new, block_tables):
    """Prefill write: k_new/v_new (B, S, Hkv, D) go to positions [0, S) of
    each sequence; positions past the block table's width are dropped.
    The ``start=0`` case of :func:`write_paged_prompt_at`, where the kept
    length is known from the shapes: a plain scatter, with no read of the
    slots it overwrites. Updates the pools in place and returns them."""
    _check_pools(k_pages, v_pages, k_pages.device)
    page_size = k_pages.shape[2]
    bt = block_tables.long()
    # the kept length is known from shapes: no mask, no device->host sync
    s = min(k_new.shape[1], bt.shape[1] * page_size)
    pos = torch.arange(s, device=bt.device)
    pages = bt[:, pos // page_size]                       # (B, s)
    off = (pos % page_size).expand_as(pages)
    for pool, new in ((k_pages, k_new[:, :s]), (v_pages, v_new[:, :s])):
        for dst, val in zip(_parts(pool), _stored(pool, new)):
            # (B, s, Hkv, *) -> (Hkv, B, s, *), the indexed pool view's
            # layout
            dst[:, pages, off] = val.permute(2, 0, 1, 3)
    return k_pages, v_pages


def write_paged_prompt_at(k_pages, v_pages, k_new, v_new, block_tables,
                          start):
    """Prefill write at an offset: k_new/v_new (B, S, Hkv, D) land at
    positions [start, start+S) of each sequence (``start`` (B,) int, the
    chunked-prefill cursor, read on the device). Positions past the block
    table's width are dropped, never clamped onto a live page: the final
    chunk of a prompt pads to the fixed chunk length. Updates the pools in
    place and returns them.

    The drop costs no device->host sync: a position past the table is sent
    to the slot of the table's last page that it would clamp onto, carrying
    the value that slot gets anyway (the chunk's own write there, or the
    pool's current content), so duplicate writes agree. An int8 pool's
    payload and scale both take this path."""
    _check_pools(k_pages, v_pages, k_pages.device)
    page_size = k_pages.shape[2]
    bt = block_tables.long()
    s = k_new.shape[1]
    width = bt.shape[1] * page_size
    rel = torch.arange(s, device=bt.device)
    pos = start.long()[:, None] + rel[None, :]                # (B, S)
    off = pos % page_size
    # in range: the position itself; past the table: the last page's slot
    tpos = torch.where(pos < width, pos, width - page_size + off)
    pages = bt.gather(1, tpos // page_size)                  # (B, S)
    src = tpos - start.long()[:, None]          # chunk row writing tpos
    from_chunk = (src >= 0)[..., None, None]
    rows = src.clamp(min=0)[..., None, None]
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        for dst, val in zip(_parts(pool), _stored(pool, new)):
            # (B, S, Hkv, *) -> (Hkv, B, S, *), the indexed pool view's
            # layout
            cur = torch.where(
                from_chunk, val.gather(1, rows.expand(-1, -1,
                                                      *val.shape[2:])),
                dst[:, pages, off].permute(1, 2, 0, 3))
            dst[:, pages, off] = cur.permute(2, 0, 1, 3)
    return k_pages, v_pages


# ------------------------------------------------------- pool management
def _torch_from_numpy(a) -> torch.Tensor:
    """A host array as a tensor; a bfloat16 array (numpy's extension
    dtype) through its 16-bit pattern."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _numpy_from_torch(t: torch.Tensor) -> np.ndarray:
    """A host tensor as a numpy copy; bfloat16 as ``ml_dtypes``'
    bfloat16 (the dtype JAX arrays convert to)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


class HostPage:
    """One KV page spilled to host memory: for K and V, one host tensor
    per stored part (the pool, or an int8 pool's payload and scale,
    verbatim), every layer's rows of the page stacked layer-major,
    ``(layers, Hkv, page, D | 1)``. Pinned when the pool is on the card, so
    the copy back runs on the stream in order with the steps. Owned by
    whoever orchestrates tiering (the serving ``PrefixCache``) or carried
    in a handoff bundle; the pool only counts a spilled one, so the
    ledger's ``pages_spilled`` stays true.

    The JAX package keeps one numpy array a layer instead (a
    ``(payload, scale)`` pair a layer for int8): :meth:`from_layers` and
    :meth:`to_layers` convert at that boundary, bit for bit."""

    __slots__ = ("k", "v", "nbytes")

    def __init__(self, k: Tuple[torch.Tensor, ...],
                 v: Tuple[torch.Tensor, ...], nbytes: int):
        self.k = k
        self.v = v
        self.nbytes = nbytes

    @classmethod
    def from_layers(cls, k, v, nbytes: int) -> "HostPage":
        """A page from the JAX package's layout: ``k`` and ``v`` each a
        list of per-layer arrays ``(Hkv, page, D)``, or of
        ``(payload, scale)`` pairs for an int8 pool, stacked into this
        layout (host tensors, not pinned)."""
        def stack(layers):
            if isinstance(layers[0], (tuple, list)):
                return tuple(_torch_from_numpy(np.stack(
                    [np.asarray(layer[j]) for layer in layers]))
                    for j in range(len(layers[0])))
            return (_torch_from_numpy(np.stack(
                [np.asarray(layer) for layer in layers])),)
        return cls(stack(k), stack(v), int(nbytes))

    def to_layers(self):
        """``(k, v)`` in the JAX package's layout: per-layer numpy arrays,
        or per-layer ``(payload, scale)`` tuples for an int8 pool."""
        def split(parts):
            arrays = [_numpy_from_torch(p.cpu()) for p in parts]
            if len(arrays) == 1:
                return list(arrays[0])
            return [tuple(a[i] for a in arrays)
                    for i in range(arrays[0].shape[0])]
        return split(self.k), split(self.v)


class PagedKVCache:
    """Host-side page-pool manager: one pool pair per layer on the device,
    a block table per batch slot (host numpy), and a free list that
    recycles pages across requests. Each page carries a reference count:
    a sequence's own page has 1, a prompt-prefix page shared read-only by
    several sequences and a prefix cache one per holder; a page returns to
    the free list when its last reference drops.

    ``kv_dtype``: the pool's storage. ``"native"`` keeps ``dtype`` tensors;
    ``"int8"`` keeps :class:`QuantizedPages` (int8 payload and one f32
    scale per token row, quantized at write time and dequantized by every
    reader). ``bytes_per_page`` bills the stored bytes of one page across
    all layers, K and V."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, max_batch: int,
                 max_seq_len: int, dtype: torch.dtype = torch.bfloat16,
                 reserve_null_page: bool = False, kv_dtype: str = "native",
                 device: DeviceLike = None):
        """``reserve_null_page`` keeps page 0 out of the free list: idle
        batch slots (all-zero block tables) write there, and no live
        sequence ever owns it."""
        if kv_dtype not in ("native", "int8"):
            raise ValueError(f"kv_dtype must be 'native' or 'int8', "
                             f"got {kv_dtype!r}")
        if page_size % 8:
            raise ValueError("page_size must be a multiple of 8")
        device = resolve_device(device)
        self.device = device
        self.kv_dtype = kv_dtype
        self.page_size = page_size
        self.num_pages = num_pages
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.max_pages_per_seq = -(-max_seq_len // page_size)
        self.reserved_null_page = bool(reserve_null_page)
        # the ledger's counters, kept on every transition (never a scan):
        # pages with more than one reference, a free-list mutation epoch
        # (fragmentation is recomputed only when it moved) and pages held
        # in the host tier
        self._free_epoch = 0
        shape = (num_kv_heads, num_pages, page_size, head_dim)
        rows = num_layers * 2 * num_kv_heads * page_size
        if kv_dtype == "int8":
            self.bytes_per_page = rows * (head_dim + 4)

            def pool():
                return QuantizedPages(
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                device=device))
        else:
            self.bytes_per_page = (rows * head_dim
                                   * torch.tensor([], dtype=dtype)
                                   .element_size())

            def pool():
                return torch.zeros(shape, dtype=dtype, device=device)
        self.k_pages: List[Optional[torch.Tensor]] = [
            pool() for _ in range(num_layers)]
        self.v_pages: List[Optional[torch.Tensor]] = [
            pool() for _ in range(num_layers)]
        self.block_tables = np.zeros((max_batch, self.max_pages_per_seq),
                                     np.int32)
        self.seq_lens = np.zeros((max_batch,), np.int32)
        self._pages_used = np.zeros((max_batch,), np.int32)
        self._page_rc = np.zeros((num_pages,), np.int32)
        # the pairs a step took (take_pools), until it installs its own: a
        # step that raised leaves them here for reset()
        self._detached: Optional[List[tuple]] = None
        self._fresh_allocator()

    def _fresh_allocator(self) -> None:
        """Every page free (but the null page), every slot empty."""
        self.block_tables[...] = 0
        self.seq_lens[...] = 0
        self._pages_used[...] = 0
        self._page_rc[...] = 0
        first = 1 if self.reserved_null_page else 0
        if self.reserved_null_page:
            self._page_rc[0] = np.int32(1 << 30)     # never freed
        self._free = list(range(self.num_pages - 1, first - 1, -1))
        self._shared_pages = 0
        self._spilled_pages = 0

    # -------------------------------------------------------------- admin
    def free_page_count(self) -> int:
        return len(self._free)

    def ledger(self, fragmentation: bool = True) -> dict:
        """Pages and bytes in use, free, shared (more than one reference)
        and spilled to the host tier, the free-list epoch and, unless
        ``fragmentation=False``, :meth:`free_list_fragmentation`."""
        usable = self.num_pages - (1 if self.reserved_null_page else 0)
        free = len(self._free)
        out = {
            "usable_pages": usable,
            "pages_in_use": usable - free,
            "pages_free": free,
            "pages_shared": self._shared_pages,
            "pages_spilled": self._spilled_pages,
            "bytes_per_page": self.bytes_per_page,
            "bytes_in_use": (usable - free) * self.bytes_per_page,
            "bytes_free": free * self.bytes_per_page,
            "bytes_spilled": self._spilled_pages * self.bytes_per_page,
            "epoch": self._free_epoch,
        }
        if fragmentation:
            out["fragmentation"] = self.free_list_fragmentation()
        return out

    def free_list_fragmentation(self) -> float:
        """1 - (largest run of consecutive free page ids / free pages):
        0.0 for an empty free list or one run."""
        n = len(self._free)
        if n <= 1:
            return 0.0
        ids = np.sort(np.asarray(self._free, np.int64))
        breaks = np.flatnonzero(np.diff(ids) != 1)
        runs = np.diff(np.concatenate(([-1], breaks, [n - 1])))
        return float(1.0 - int(runs.max()) / n)

    def ref_page(self, page_id: int) -> None:
        self._page_rc[page_id] += 1
        if self._page_rc[page_id] == 2:         # became shared
            self._shared_pages += 1

    def unref_page(self, page_id: int) -> bool:
        """Drop one reference; returns whether the page went back to the
        free list (its last reference)."""
        self._page_rc[page_id] -= 1
        if self._page_rc[page_id] == 1:         # stopped being shared
            self._shared_pages -= 1
        if self._page_rc[page_id] == 0:
            self._free.append(int(page_id))
            self._free_epoch += 1
            return True
        return False

    def adopt_shared(self, seq_idx: int, page_ids) -> None:
        """Put written pages (a cached prompt prefix) at the front of the
        empty slot ``seq_idx``'s block table, read-only (one more
        reference each). The caller sets ``seq_lens``, then allocates the
        rest; the sequence writes only past these pages."""
        if self._pages_used[seq_idx]:
            raise RuntimeError(f"adopt_shared: slot {seq_idx} is not empty")
        for i, pid in enumerate(page_ids):
            self.block_tables[seq_idx, i] = pid
            self.ref_page(pid)
        self._pages_used[seq_idx] = len(page_ids)

    def take_free_page(self) -> int:
        """Pop one free page with one reference (a restore's page); raises
        ``RuntimeError`` when the pool is exhausted."""
        if not self._free:
            raise RuntimeError("page pool exhausted")
        pid = self._free.pop()
        self._free_epoch += 1
        self._page_rc[pid] = 1
        return pid

    def allocate(self, seq_idx: int, n_tokens: int) -> None:
        """Ensure slot ``seq_idx`` has pages for ``n_tokens`` more tokens
        (each new page with one reference); raises RuntimeError when the
        pool is exhausted. Pages taken before that stay recorded in the
        slot, so freeing the slot returns them."""
        need = -(-(int(self.seq_lens[seq_idx]) + n_tokens) // self.page_size)
        if need > self.block_tables.shape[1]:
            raise RuntimeError(
                f"sequence {seq_idx} needs {need} pages > max_pages_per_seq "
                f"{self.block_tables.shape[1]}")
        for i in range(int(self._pages_used[seq_idx]), need):
            if not self._free:
                raise RuntimeError("page pool exhausted")
            pid = self._free.pop()
            self._free_epoch += 1
            self.block_tables[seq_idx, i] = pid
            self._page_rc[pid] = 1
            self._pages_used[seq_idx] = i + 1

    def move_sequence(self, src: int, dst: int) -> None:
        """Move slot ``src``'s block-table row, length and page count to the
        empty slot ``dst`` (the bucket ladder's shrink): host bookkeeping
        only, no page is copied and no reference count changes."""
        if self._pages_used[dst] or self.seq_lens[dst]:
            raise RuntimeError(
                f"move_sequence: destination slot {dst} is not empty")
        n = int(self._pages_used[src])
        self.block_tables[dst, :n] = self.block_tables[src, :n]
        self.block_tables[dst, n:] = 0
        self.seq_lens[dst] = self.seq_lens[src]
        self._pages_used[dst] = self._pages_used[src]
        self.block_tables[src, :n] = 0
        self.seq_lens[src] = 0
        self._pages_used[src] = 0

    def free_sequence(self, seq_idx: int) -> None:
        """Drop the slot's reference to each of its pages (a page shared
        with another holder stays) and clear the slot."""
        n = int(self._pages_used[seq_idx])
        for i in range(n):
            self.unref_page(int(self.block_tables[seq_idx, i]))
        self.block_tables[seq_idx, :n] = 0
        self._pages_used[seq_idx] = 0
        self.seq_lens[seq_idx] = 0

    # ---------------------------------------------------- host-memory tier
    # At scheduler time only, between steps, with the pools installed. On
    # the card every copy is queued on the current stream, the one the
    # steps run on: a spill reads the page after the last step's writes,
    # and a restore lands before the next step reads it.
    def _attached(self) -> None:
        if self.k_pages[0] is None:
            raise RuntimeError("the pools are detached (a step is in "
                               "flight): spill and restore run between "
                               "steps")

    def _page_to_host(self, pools, pid: int) -> Tuple[torch.Tensor, ...]:
        """Each stored part's rows of page ``pid``, every layer: one
        gather into a contiguous device tensor (a page is strided across
        the kv heads), then one copy to pinned host memory."""
        out = []
        for layers in zip(*(_parts(p) for p in pools)):
            stage = torch.stack([t[:, pid] for t in layers])
            if stage.is_cuda:
                host = torch.empty(stage.shape, dtype=stage.dtype,
                                   pin_memory=True)
                host.copy_(stage, non_blocking=True)
            else:
                host = stage
            out.append(host)
        return tuple(out)

    def spill_page(self, page_id: int) -> HostPage:
        """Copy page ``page_id`` of every layer, K and V, to a
        :class:`HostPage` and count it spilled. The caller still holds the
        page's reference: ``unref_page`` frees it (a failed spill then
        loses nothing)."""
        self._attached()
        pid = int(page_id)
        host = HostPage(self._page_to_host(self.k_pages, pid),
                        self._page_to_host(self.v_pages, pid),
                        self.bytes_per_page)
        self._spilled_pages += 1
        return host

    def restore_page(self, host: HostPage, page_id: int) -> None:
        """Write a page spilled from this pool back into page ``page_id``
        (one the caller just took from the free list) and retire it from
        the spilled count."""
        self.adopt_page(host, page_id)
        self._spilled_pages -= 1

    def adopt_page(self, host: HostPage, page_id: int) -> None:
        """Write a :class:`HostPage` (of this pool or one of the same
        geometry) into page ``page_id``, in place: the pool tensors keep
        their addresses. One copy to the device a part, then one copy a
        layer into the page's strided rows."""
        self._attached()
        pid = int(page_id)
        for pools, parts in ((self.k_pages, host.k), (self.v_pages, host.v)):
            for j, part in enumerate(parts):
                stage = part.to(self.device, non_blocking=True)
                for i, pool in enumerate(pools):
                    _parts(pool)[j][:, pid].copy_(stage[i])

    def forget_spilled(self, host: HostPage) -> None:
        """A spilled page is dropped for good (host-tier budget): retire
        it from the spilled count; nothing is written."""
        self._spilled_pages -= 1

    # ------------------------------------------------------ pool handoff
    def take_pools(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Detach and return the per-layer ``(k, v)`` pool pairs for one
        step; the step hands them back through :meth:`install_pools`. Until
        then the cache refuses a second detach."""
        if self.k_pages[0] is None:
            raise RuntimeError("take_pools: pools already detached")
        pairs = list(zip(self.k_pages, self.v_pages))
        n = len(pairs)
        self.k_pages = [None] * n
        self.v_pages = [None] * n
        self._detached = pairs
        return pairs

    def install_pools(self, pairs) -> None:
        self.k_pages = [k for k, _ in pairs]
        self.v_pages = [v for _, v in pairs]
        self._detached = None

    @torch.no_grad()
    def reset(self) -> None:
        """Return the cache to its state when made, in place: pools a failed
        step left detached are installed again, every pool tensor (an int8
        pool's payloads and scales) is zeroed at its address, and the
        allocator, reference counts, block tables, lengths and the host-tier
        count start fresh. Replay recovery's rebuild: a CUDA graph captured
        over these pools names their addresses, so it keeps replaying."""
        if self.k_pages[0] is None:
            self.install_pools(self._detached)
        for pools in (self.k_pages, self.v_pages):
            for pool in pools:
                for t in _parts(pool):
                    t.zero_()
        self._fresh_allocator()
        self._free_epoch += 1
