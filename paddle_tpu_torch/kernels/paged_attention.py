"""Paged KV cache (block tables) for serving.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``: the KV cache
lives in fixed-size pages drawn from a shared pool per layer, each sequence
owns a block table of page ids, and freed pages recycle across requests.
:func:`paged_attention` is the one-token decode attention through the block
tables, the hand-written CUDA kernel in ``csrc/paged_attention.cu``;
:func:`paged_chunk_attention` is the chunked-prefill attention of an
S-token chunk against the pool prefix plus itself, read through the block
table by the CUDA kernel in ``csrc/paged_chunk_attention.cu``.

Only the native pool is ported. int8 pools (``QuantizedPages``) and
host-RAM spill (``HostPage``) belong to later slices. Unlike the JAX
package, whose arrays are immutable, the page writes here update the pool
tensors in place (no pool-sized copy per token) and return the same
tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import _build

_NEG_INF = -1e30


class PagedDecodeState(NamedTuple):
    """One layer's paged cache as it rides a decode or prefill step: the
    pool pair, the block tables and the per-sequence written counts."""
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
    """Decode position ids for a paged cache entry: a scalar ``offset``
    broadcasts (a host int: the chunked-prefill cursor comes from the
    engine's host-side lengths, so no device value is read back);
    ``offset=None`` gives each row its own written length."""
    base = torch.arange(s, dtype=torch.int64,
                        device=state.block_tables.device).unsqueeze(0)
    if offset is not None:
        return base + int(offset)
    return base + state.seq_lens.to(torch.int64).unsqueeze(1)


# ------------------------------------------------------------ attention
def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        seq_lens: torch.Tensor,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`paged_attention`: gathers each sequence's
    contiguous view, then masked attention in f32. A sequence with no
    tokens reads zeros, as the kernel (and the Pallas kernel) emits."""
    b, h, d = q.shape
    hkv, _, page_size, _ = k_pages.shape
    rep = h // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    t = bt.shape[1] * page_size
    # (Hkv, B, max_pages, page, D) -> (B, Hkv, T, D)
    k = k_pages[:, bt].movedim(1, 0).reshape(b, hkv, t, d).float()
    v = v_pages[:, bt].movedim(1, 0).reshape(b, hkv, t, d).float()
    qg = q.reshape(b, hkv, rep, d).float()
    s = torch.einsum("bhrd,bhtd->bhrt", qg, k) * sm_scale
    mask = torch.arange(t, device=q.device)[None, :] < seq_lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1) * (seq_lens > 0)[:, None, None, None]
    out = torch.einsum("bhrt,bhtd->bhrd", p, v)
    return out.reshape(b, h, d).to(q.dtype)


def _check_pools(k_pages, v_pages, device, dtype):
    if not (isinstance(k_pages, torch.Tensor)
            and isinstance(v_pages, torch.Tensor)):
        raise NotImplementedError(
            "only native KV pools are ported; quantized pools come with the "
            "int8 slice")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pools must share a (Hkv, P, page, D) shape, "
                         f"got {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if x.device != device or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_index(name, x, shape, device):
    if x.device != device or x.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 on {device}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         f"tensor, got {tuple(x.shape)}")


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention against a paged pool.

    q: (B, H, D); k/v_pages: (Hkv, num_pages, page_size, D);
    block_tables: (B, max_pages) int32 (entries past the used count are
    ignored, keep them 0); seq_lens: (B,) int32 valid tokens per sequence.
    Returns (B, H, D) in q's dtype. CPU tensors take
    :func:`paged_attention_ref`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   seq_lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, "
                         f"got {q.device}")
    b, h, d = q.shape
    _check_pools(k_pages, v_pages, q.device, q.dtype)
    hkv, num_pages, page, dk = k_pages.shape
    if dk != d or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pages.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    maxp = block_tables.shape[1]
    _check_index("block_tables", block_tables, (b, maxp), q.device)
    _check_index("seq_lens", seq_lens, (b,), q.device)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _build.bind("paged_attention", "ptt_paged_attention", _ARGTYPES)
    rc = fn(_build.dtype_code(q.dtype), q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), b, h, hkv, d, num_pages, page, maxp,
            float(sm_scale), _build.stream_handle(q.device))
    _build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


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
        # (Hkv, B, G, page, D) -> (B, Hkv, G * page, D)
        kb = k_pages[:, pages].movedim(1, 0).reshape(b, hkv, keys, d).float()
        vb = v_pages[:, pages].movedim(1, 0).reshape(b, hkv, keys, d).float()
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


_MAX_HEAD_DIM = 128
_CHUNK_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          start: torch.Tensor,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill attention read straight through the block table.

    The S-token query chunk sits at absolute positions ``start ..
    start+S-1`` and attends causally to the pool's already-written prefix
    plus its own tokens, which the caller has written first
    (:func:`write_paged_prompt_at`). q: (B, S, H, D); k/v_pages: (Hkv,
    num_pages, page_size, D); block_tables: (B, max_pages) int32; start:
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
    _check_pools(k_pages, v_pages, q.device, q.dtype)
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
    fn = _build.bind("paged_chunk_attention", "ptt_paged_chunk_attention",
                     _CHUNK_ARGTYPES)
    rc = fn(_build.dtype_code(q.dtype), q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), start.data_ptr(),
            out.data_ptr(), b, s, h, hkv, d, num_pages, page, maxp,
            float(sm_scale), _build.stream_handle(q.device))
    _build.check(rc, "paged_chunk_attention")
    paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0


# ------------------------------------------------------- pool writes
def write_paged_kv(k_pages, v_pages, k_new, v_new, block_tables, positions):
    """Write one token per sequence into the pools at absolute sequence
    ``positions`` ((B,) int). k_new/v_new: (B, Hkv, D). Updates the pools
    in place and returns them."""
    _check_pools(k_pages, v_pages, k_pages.device, k_pages.dtype)
    page_size = k_pages.shape[2]
    pos = positions.long()
    page_of = block_tables.long().gather(1, (pos // page_size)[:, None])[:, 0]
    off = pos % page_size
    k_pages[:, page_of, off] = k_new.movedim(0, 1).to(k_pages.dtype)
    v_pages[:, page_of, off] = v_new.movedim(0, 1).to(v_pages.dtype)
    return k_pages, v_pages


def write_paged_prompt(k_pages, v_pages, k_new, v_new, block_tables):
    """Prefill write: k_new/v_new (B, S, Hkv, D) go to positions [0, S) of
    each sequence; positions past the block table's width are dropped.
    The ``start=0`` case of :func:`write_paged_prompt_at`, where the kept
    length is known from the shapes: a plain scatter, with no read of the
    slots it overwrites. Updates the pools in place and returns them."""
    _check_pools(k_pages, v_pages, k_pages.device, k_pages.dtype)
    page_size = k_pages.shape[2]
    bt = block_tables.long()
    # the kept length is known from shapes: no mask, no device->host sync
    s = min(k_new.shape[1], bt.shape[1] * page_size)
    pos = torch.arange(s, device=bt.device)
    pages = bt[:, pos // page_size]                       # (B, s)
    off = (pos % page_size).expand_as(pages)
    # (B, s, Hkv, D) -> (Hkv, B, s, D), the indexed pool view's layout
    k_pages[:, pages, off] = k_new[:, :s].permute(2, 0, 1, 3).to(
        k_pages.dtype)
    v_pages[:, pages, off] = v_new[:, :s].permute(2, 0, 1, 3).to(
        v_pages.dtype)
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
    pool's current content), so duplicate writes agree."""
    _check_pools(k_pages, v_pages, k_pages.device, k_pages.dtype)
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
        # (B, S, Hkv, D) -> (Hkv, B, S, D), the indexed pool view's layout
        val = torch.where(
            from_chunk,
            new.gather(1, rows.expand(-1, -1, *new.shape[2:])).to(pool.dtype),
            pool[:, pages, off].permute(1, 2, 0, 3))
        pool[:, pages, off] = val.permute(2, 0, 1, 3)
    return k_pages, v_pages


# ------------------------------------------------------- pool management
class PagedKVCache:
    """Host-side page-pool manager: one pool pair per layer on the device,
    a block table per batch slot (host numpy), and a free list that
    recycles pages across requests."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, max_batch: int,
                 max_seq_len: int, dtype: torch.dtype = torch.bfloat16,
                 reserve_null_page: bool = False, kv_dtype: str = "native",
                 device: DeviceLike = None):
        """``reserve_null_page`` keeps page 0 out of the free list: idle
        batch slots (all-zero block tables) write there, and no live
        sequence ever owns it."""
        if kv_dtype != "native":
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r}: only native pools are ported; int8 "
                "pools come with a later slice")
        if page_size % 8:
            raise ValueError("page_size must be a multiple of 8")
        device = resolve_device(device)
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_seq = -(-max_seq_len // page_size)
        shape = (num_kv_heads, num_pages, page_size, head_dim)
        self.k_pages: List[Optional[torch.Tensor]] = [
            torch.zeros(shape, dtype=dtype, device=device)
            for _ in range(num_layers)]
        self.v_pages: List[Optional[torch.Tensor]] = [
            torch.zeros(shape, dtype=dtype, device=device)
            for _ in range(num_layers)]
        self.block_tables = np.zeros((max_batch, self.max_pages_per_seq),
                                     np.int32)
        self.seq_lens = np.zeros((max_batch,), np.int32)
        self._pages_used = np.zeros((max_batch,), np.int32)
        first = 1 if reserve_null_page else 0
        self._free = list(range(num_pages - 1, first - 1, -1))

    def free_page_count(self) -> int:
        return len(self._free)

    def allocate(self, seq_idx: int, n_tokens: int) -> None:
        """Ensure slot ``seq_idx`` has pages for ``n_tokens`` more tokens;
        raises RuntimeError when the pool is exhausted."""
        need = -(-(int(self.seq_lens[seq_idx]) + n_tokens) // self.page_size)
        if need > self.block_tables.shape[1]:
            raise RuntimeError(
                f"sequence {seq_idx} needs {need} pages > max_pages_per_seq "
                f"{self.block_tables.shape[1]}")
        for i in range(int(self._pages_used[seq_idx]), need):
            if not self._free:
                raise RuntimeError("page pool exhausted")
            self.block_tables[seq_idx, i] = self._free.pop()
            self._pages_used[seq_idx] = i + 1

    def free_sequence(self, seq_idx: int) -> None:
        n = int(self._pages_used[seq_idx])
        self._free.extend(int(p) for p in self.block_tables[seq_idx, :n])
        self.block_tables[seq_idx, :n] = 0
        self._pages_used[seq_idx] = 0
        self.seq_lens[seq_idx] = 0

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
        return pairs

    def install_pools(self, pairs) -> None:
        self.k_pages = [k for k, _ in pairs]
        self.v_pages = [v for _, v in pairs]
