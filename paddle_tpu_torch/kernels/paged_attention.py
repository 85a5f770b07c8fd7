"""Paged KV cache (block tables) for serving.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``: the KV cache
lives in fixed-size pages drawn from a shared pool per layer, each sequence
owns a block table of page ids, and freed pages recycle across requests.
:func:`paged_attention` is the one-token decode attention through the block
tables, the hand-written CUDA kernel in ``csrc/paged_attention.cu``.

Only the native pool is ported. int8 pools (``QuantizedPages``), chunked
prefill state (``PagedChunkState``) and host-RAM spill (``HostPage``) belong
to later slices. Unlike the JAX package, whose arrays are immutable, the
page writes here update the pool tensors in place (no pool-sized copy per
token) and return the same tensors.
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


def paged_position_ids(s: int, offset, state: PagedDecodeState
                       ) -> torch.Tensor:
    """Decode position ids for a paged cache entry: a scalar ``offset``
    broadcasts; ``offset=None`` gives each row its own written length."""
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
    Updates the pools in place and returns them."""
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
