"""Fused transformer-block decode: one Llama layer, or a group of N
stacked layers, decoded per call.

Counterpart of ``paddle_tpu/kernels/fused_block_decode.py`` (native or
int8 pools, native or int4 stacked weights, and the tensor-parallel
entries :func:`shard_block_weights` and
:func:`fused_multi_block_decode_tp`).
:func:`fused_block_decode` runs rms -> q/k/v -> RoPE at each slot's
position -> the append of the new token's k/v to the pool -> paged
attention over ``seq_lens + 1`` -> o-proj + residual -> rms -> SwiGLU ->
down + residual. On a CUDA tensor it is one call of the C entry in
``csrc/fused_block_decode.cu``, which launches those phases in order with
hand-written GEMVs and the split-KV attention routine that
:func:`~.paged_attention.paged_attention` runs (its parts from
:func:`~.paged_attention.decode_split_plan`, a function of the shapes
only); on a CPU tensor it is :func:`fused_block_decode_ref`.
:func:`fused_multi_block_decode` runs that chain for a group of layers
whose weights :func:`stack_block_weights` stacked (q|k|v and gate|up
merged), one call of ``csrc/fused_multi_block_decode.cu`` per group; with
``weight_dtype="int4"`` the four stacked matrices are :class:`Int4Tiles`
(two int4 values a byte, one f32 scale per tile), unpacked inside the
kernel's GEMVs. On an int8 pool (:class:`QuantizedPages`) both kernels
quantize the new token's k/v row in the kernel, append payload and scale
to the pool and attend to its dequantized value.

Tensor parallelism: :func:`shard_block_weights` permutes a stacked group
into the Megatron shard layout and :func:`split_block_shards` cuts it into
the shards' own stacks; :func:`fused_multi_block_decode_tp` runs the
shards' chains in lockstep, each at its local head counts with its
kv-head partition of the pools, through
:func:`~.paged_attention.paged_attention` (the decode attention kernel)
and ``torch.matmul``, and two reductions a layer (the row-parallel exits
of ``wo`` and ``wd``). As in the reference, whose chain is XLA ops, no
fused kernel runs there.

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
from .paged_attention import (_MAX_HEAD_DIM, _check_index, _check_pools,
                              _pool_ptrs, decode_split_plan, paged_attention,
                              paged_attention_ref, write_paged_kv)

__all__ = ["BlockDecodeWeights", "Int4Tiles", "MultiBlockDecodeWeights",
           "fused_block_decode", "fused_block_decode_ref",
           "fused_multi_block_decode", "fused_multi_block_decode_ref",
           "fused_multi_block_decode_tp", "pack_int4_tiles",
           "shard_block_weights", "split_block_shards",
           "stack_block_weights", "unpack_int4_tiles"]


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
    f32 from the given inputs and cast to x's dtype at the end. The new
    k/v reach the pool in x's dtype, as the kernel emits them (an int8
    pool quantizes that value). The pools are updated in place. Returns
    ``(out, k_pages, v_pages)``."""
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
    write_paged_kv(k_pages, v_pages, k.to(x.dtype), v.to(x.dtype),
                   block_tables, seq_lens)
    attn = paged_attention_ref(q, k_pages, v_pages, block_tables,
                               seq_lens + 1, sm_scale)
    x2 = xf + attn.reshape(b, num_heads * d) @ w.wo
    h2 = _rms(x2, w.ln2, epsilon)
    f = F.silu(h2 @ w.wg) * (h2 @ w.wu)
    out = x2 + f @ w.wd
    return out.to(x.dtype), k_pages, v_pages


_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 19
             + [ctypes.c_int] * 11 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_SCRATCH_ARGTYPES = [ctypes.c_int] * 9
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
    """What both kernels take: even head_dim <= 128, widths that are
    multiples of 8 (16-byte weight rows), a contiguous float32 or bfloat16
    x."""
    if nh % nkv:
        raise ValueError(f"query heads {nh} not divisible by kv heads {nkv}")
    if d % 2 or any(n % 8 for n in (hidden, nh * d, nkv * d, inter)):
        raise ValueError(f"{what} needs even head_dim and widths that are "
                         "multiples of 8")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {d} > {_MAX_HEAD_DIM} is not "
                         "supported")
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
    (Hkv, num_pages, page, D), native in x's dtype or
    :class:`QuantizedPages`; block_tables: (B, max_pages) int32;
    seq_lens: (B,) int32 tokens already in the pool. Returns
    ``(out, k_pages, v_pages)`` with the new token appended to the pools in
    place. CPU tensors take :func:`fused_block_decode_ref`; CUDA tensors
    run the kernel (float32 or bfloat16, every width a multiple of 8,
    head_dim even and <= 128). The kernel writes nothing past a block
    table: a row whose table is full (``seq_lens == max_pages * page``,
    which the plain version does not take and the engine never sends) is
    not appended and attends to its table's tokens only."""
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
    quant = _check_pools(k_pages, v_pages, x.device, x.dtype)
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
    part_pages, nsplit = decode_split_plan(
        b, nh, nkv, maxp, page, _build.sm_count(x.device.index or 0))
    code = _build.dtype_code(x.dtype)
    size = _build.bind("fused_block_decode", "ptt_fused_block_decode_scratch",
                       _SCRATCH_ARGTYPES, ctypes.c_longlong)(
        code, 0, b, hidden, nh, nkv, d, inter, nsplit)
    scratch = torch.empty(size, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = _build.bind("fused_block_decode", "ptt_fused_block_decode",
                     _ARGTYPES)
    rc = fn(code, _build.kv_code(quant), x.data_ptr(),
            *(t.data_ptr() for t in weights),
            *_pool_ptrs(k_pages, v_pages, quant), block_tables.data_ptr(),
            seq_lens.data_ptr(), inv.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, hidden, nh, nkv, d, inter, num_pages,
            page, maxp, part_pages, nsplit, float(epsilon), float(sm_scale),
            _build.stream_handle(x.device))
    _build.check(rc, "fused_block_decode")
    _build.count(fused_block_decode, "int8" if quant else "")
    return out, k_pages, v_pages


_build.counters(fused_block_decode, "", "int8")


# ------------------------------------------------------ int4 weight tiles
def _tile(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= target, preferring multiples
    of 128; falls back to any divisor. (A copy of the JAX package's
    ``analysis.tile_geometry.tile``: the int4 tiling must be its.)"""
    if n <= target:
        return n
    for cand in range(target - target % 128, 0, -128):
        if n % cand == 0:
            return cand
    for cand in range(min(target, n), 0, -1):
        if n % cand == 0:
            return cand
    return n


class Int4Tiles(NamedTuple):
    """A stacked weight matrix packed two int4 values a byte with one f32
    amax scale per (tr, tc) tile. Within each row band of tr rows, payload
    row ``r*tr/2 + i`` holds tile rows ``i`` (low nibble) and ``i + tr/2``
    (high nibble). The tiling is derived from the two shapes (never
    stored); ``shape`` is the logical unpacked (n, R, C)."""
    q: torch.Tensor      # uint8 (n, R/2, C)
    scale: torch.Tensor  # f32   (n, R/tr, C/tc)

    @property
    def shape(self):
        return (self.q.shape[0], 2 * self.q.shape[1], self.q.shape[2])

    @property
    def tiles(self) -> Tuple[int, int]:
        """(tr, tc), the tile this matrix was packed with."""
        return (2 * self.q.shape[1] // self.scale.shape[1],
                self.q.shape[2] // self.scale.shape[2])


def pack_int4_tiles(w: torch.Tensor, tr: int, tc: int) -> Int4Tiles:
    """Quantize ``w`` (n, R, C) to symmetric int4 ([-7, 7]) with one amax
    scale per (tr, tc) tile, nibble-packing each tile's row halves (the
    layout of :class:`Int4Tiles`, the JAX package's bits)."""
    n, rows, cols = w.shape
    if tr % 2 or rows % tr or cols % tc:
        raise ValueError(f"int4 tile ({tr}, {tc}) must be even-rowed and "
                         f"divide ({rows}, {cols})")
    nr, nc = rows // tr, cols // tc
    t = w.float().reshape(n, nr, tr, nc, tc)
    amax = t.abs().amax(dim=(2, 4), keepdim=True)
    scale = amax / 7.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(t / safe), -7, 7).to(torch.int8)
    lo, hi = q[:, :, :tr // 2], q[:, :, tr // 2:]
    # & 0xF keeps a negative value's two's-complement nibble
    packed = ((lo & 0xF).to(torch.uint8)
              | ((hi & 0xF).to(torch.uint8) << 4))
    return Int4Tiles(packed.reshape(n, rows // 2, cols).contiguous(),
                     scale.reshape(n, nr, nc).contiguous())


def unpack_int4_tiles(t: Int4Tiles) -> torch.Tensor:
    """Dequantize back to f32 (n, R, C): each nibble sign-extended, times
    its tile's scale (the value the kernel's GEMV multiplies by)."""
    q, scale = t
    n, half_rows, cols = q.shape
    nr, nc = scale.shape[1], scale.shape[2]
    tr2, tc = half_rows // nr, cols // nc
    p = q.reshape(n, nr, tr2, nc, tc).to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    lo = torch.where(lo < 8, lo, lo - 16)
    hi = torch.where(hi < 8, hi, hi - 16)
    full = torch.cat([lo, hi], dim=2).float() * scale[:, :, None, :, None]
    return full.reshape(n, 2 * half_rows, cols)


def _int4_plan(hidden: int, qw: int, kvw: int, inter: int) -> dict:
    """The (tr, tc) tile of each stacked matrix: the JAX package's plan.
    wgu packs as one (n, H, 2I) matrix whose tc divides I."""
    plan = {
        "wqkv": (_tile(hidden, 512), _tile(qw + 2 * kvw, 256)),
        "wo": (_tile(qw, 512), _tile(hidden, 256)),
        "wgu": (_tile(hidden, 512), _tile(inter, 256)),
        "wd": (_tile(inter, 512), _tile(hidden, 256)),
    }
    for name, (tr, _tc) in plan.items():
        if tr % 2:
            raise ValueError(f"int4 weights need an even contraction "
                             f"tile; {name} got tr={tr}")
    return plan


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

    The four matrices are tensors in the activation dtype or, all four,
    :class:`Int4Tiles`. Built once per engine by
    :func:`stack_block_weights` (a device copy of the layer weights; the
    per-layer originals keep serving prefill)."""
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
    the output axis. ``weight_dtype="int4"`` packs the four matrices as
    :class:`Int4Tiles` on :func:`_int4_plan`'s tiling (the norms stay
    native); each layer is packed on its own, so no native stacked copy
    is made (a tile never spans two layers: the same bits)."""
    if weight_dtype not in ("native", "int4"):
        raise ValueError(f"weight_dtype must be 'native' or 'int4', "
                         f"got {weight_dtype!r}")
    ws = list(layers)
    merged = dict(
        wqkv=lambda w: torch.cat([w.wq, w.wk, w.wv], dim=1),
        wo=lambda w: w.wo,
        wgu=lambda w: torch.cat([w.wg, w.wu], dim=1),
        wd=lambda w: w.wd)
    if weight_dtype == "native":
        mats = {k: torch.stack([f(w) for w in ws]) for k, f in merged.items()}
    else:
        w0 = ws[0]
        plan = _int4_plan(w0.wq.shape[0], w0.wq.shape[1], w0.wk.shape[1],
                          w0.wg.shape[1])
        mats = {}
        for k, f in merged.items():
            packed = [pack_int4_tiles(f(w)[None], *plan[k]) for w in ws]
            mats[k] = Int4Tiles(torch.cat([t.q for t in packed]),
                                torch.cat([t.scale for t in packed]))
    return MultiBlockDecodeWeights(
        ln1=torch.stack([w.ln1 for w in ws]), wqkv=mats["wqkv"],
        wo=mats["wo"], ln2=torch.stack([w.ln2 for w in ws]),
        wgu=mats["wgu"], wd=mats["wd"])


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
    the result is the per-layer chain's bit for bit. :class:`Int4Tiles`
    matrices are unpacked up front (:func:`unpack_int4_tiles`: the values
    the kernel multiplies by). ``k_pages`` and ``v_pages`` are sequences of
    the group's per-layer pools, native or quantized, updated in place.
    Returns ``(out, k_pages, v_pages)`` (lists)."""
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
    w_qkv, w_o, w_gu, w_d = (
        unpack_int4_tiles(m) if isinstance(m, Int4Tiles) else m
        for m in (weights.wqkv, weights.wo, weights.wgu, weights.wd))
    kps, vps = list(k_pages), list(v_pages)
    for i in range(n):
        xf = x.float()
        h = _rms(xf, weights.ln1[i].float(), epsilon)
        qkv = h @ w_qkv[i].float()
        q = _rope_heads(qkv[:, :qw].reshape(b, nh, d), sin, cos)
        k = _rope_heads(qkv[:, qw:qw + kvw].reshape(b, nkv, d), sin, cos)
        v = qkv[:, qw + kvw:].reshape(b, nkv, d)
        write_paged_kv(kps[i], vps[i], k.to(x.dtype), v.to(x.dtype),
                       block_tables, seq_lens)
        attn = paged_attention_ref(q, kps[i], vps[i], block_tables,
                                   seq_lens + 1, sm_scale)
        x2 = xf + attn.reshape(b, qw) @ w_o[i].float()
        h2 = _rms(x2, weights.ln2[i].float(), epsilon)
        gu = h2 @ w_gu[i].float()
        f = F.silu(gu[:, :inter]) * gu[:, inter:]
        # the inter-layer cast: the next layer's f32 carry starts from x's
        # dtype, as one layer a call would leave it
        x = (x2 + f @ w_d[i].float()).to(x.dtype)
    return x, kps, vps


_MULTI_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 18
                   + [ctypes.c_int] * 12 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
_INT4_MATS = ("wqkv", "wo", "wgu", "wd")


def _check_int4(name, t, shape, device):
    """An :class:`Int4Tiles` matrix of logical ``shape`` (n, R, C) that the
    kernel takes: uint8 payload (n, R/2, C), f32 scales (n, R/tr, C/tc)
    with an even tr, both contiguous on ``device``. Returns (tr, tc)."""
    if not isinstance(t, Int4Tiles):
        raise ValueError(f"weights.{name} must be Int4Tiles like the "
                         "group's other matrices")
    n, rows, cols = shape
    q, sc = t
    if q.dtype != torch.uint8 or tuple(q.shape) != (n, rows // 2, cols):
        raise ValueError(f"weights.{name}.q must be uint8 "
                         f"{(n, rows // 2, cols)}, got {q.dtype} "
                         f"{tuple(q.shape)}")
    if (sc.dtype != torch.float32 or sc.dim() != 3 or sc.shape[0] != n
            or rows % sc.shape[1] or cols % sc.shape[2]):
        raise ValueError(f"weights.{name}.scale must be f32 (n, R/tr, C/tc),"
                         f" got {sc.dtype} {tuple(sc.shape)}")
    tr, tc = t.tiles
    if tr % 2:
        raise ValueError(f"weights.{name}: odd contraction tile {tr}")
    for part in (q, sc):
        if part.device != device or not part.is_contiguous() \
                or part.data_ptr() % 16:
            raise ValueError(f"weights.{name} must be contiguous and "
                             f"16-byte aligned on {device}")
    return tr, tc


def fused_multi_block_decode(x, weights: MultiBlockDecodeWeights, k_pages,
                             v_pages, block_tables, seq_lens, *,
                             num_heads: int, num_kv_heads: int,
                             rope_theta: float = 10000.0,
                             epsilon: float = 1e-6,
                             sm_scale: Optional[float] = None):
    """One decode step through a group of N stacked layers.

    x: (B, hidden); ``weights`` a :class:`MultiBlockDecodeWeights` group,
    native in x's dtype or with :class:`Int4Tiles` matrices; k/v_pages:
    sequences of the N layers' pools, each (Hkv, num_pages, page, D),
    native in x's dtype or :class:`QuantizedPages`; block_tables:
    (B, max_pages) int32; seq_lens: (B,) int32 tokens already in the
    pools. Returns ``(out, k_pages, v_pages)`` with each layer's new token
    appended to its pools in place. CPU tensors take
    :func:`fused_multi_block_decode_ref`; CUDA tensors run the kernel
    (float32 or bfloat16, every width a multiple of 8, head_dim even and
    <= 128), one launch a group, with the one-layer kernel's attention
    parts, so a group's step equals N :func:`fused_block_decode` calls bit
    for bit. As there, a row whose table is full is not appended and
    attends to its table's tokens only."""
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
    shapes = dict(
        ln1=(n, hidden), wqkv=(n, hidden, (nh + 2 * nkv) * d),
        wo=(n, nh * d, hidden), ln2=(n, hidden), wgu=(n, hidden, 2 * inter),
        wd=(n, inter, hidden))
    int4 = isinstance(weights.wqkv, Int4Tiles)
    tiles = [0] * 8
    scales = [0] * 4
    if int4:
        for i, name in enumerate(_INT4_MATS):
            t = getattr(weights, name)
            tiles[2 * i:2 * i + 2] = _check_int4(name, t, shapes.pop(name),
                                                 x.device)
            scales[i] = t.scale.data_ptr()
    _check_weights(weights, shapes, x.device, x.dtype)
    if len(k_pages) != n or len(v_pages) != n:
        raise ValueError(f"expected {n} per-layer pools, got "
                         f"{len(k_pages)}/{len(v_pages)}")
    quant = [_check_pools(kp, vp, x.device, x.dtype)
             for kp, vp in zip(k_pages, v_pages)]
    if len(set(quant)) != 1 or any(kp.shape != k_pages[0].shape
                                   for kp in k_pages):
        raise ValueError("the group's pools must share one shape and kind")
    quant = quant[0]
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
    part_pages, nsplit = decode_split_plan(
        b, nh, nkv, maxp, page, _build.sm_count(x.device.index or 0))
    # the 4N pool pointers (k0, v0, k-scale0, v-scale0, k1, ...; a native
    # pool's scales are 0) as a host array: the entry hands each layer's
    # four to that layer's attention launch
    pools = (ctypes.c_void_p * (4 * n))(
        *(a for kp, vp in zip(k_pages, v_pages)
          for a in _pool_ptrs(kp, vp, quant)))
    code = _build.dtype_code(x.dtype)
    size = _build.bind("fused_multi_block_decode",
                       "ptt_fused_multi_block_decode_scratch",
                       _SCRATCH_ARGTYPES, ctypes.c_longlong)(
        code, int(int4), b, hidden, nh, nkv, d, inter, nsplit)
    scratch = torch.empty(size, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    mats = [getattr(weights, k) for k in MultiBlockDecodeWeights._fields]
    fn = _build.bind("fused_multi_block_decode",
                     "ptt_fused_multi_block_decode", _MULTI_ARGTYPES)
    rc = fn(code, _build.kv_code(quant), int(int4), x.data_ptr(),
            *((t.q if int4 and isinstance(t, Int4Tiles) else t).data_ptr()
              for t in mats), *scales, (ctypes.c_int * 8)(*tiles),
            pools, block_tables.data_ptr(), seq_lens.data_ptr(),
            inv.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, b, hidden,
            nh, nkv, d, inter, num_pages, page, maxp, part_pages, nsplit,
            float(epsilon), float(sm_scale), _build.stream_handle(x.device))
    _build.check(rc, "fused_multi_block_decode")
    _build.count(fused_multi_block_decode,
                 "_".join(t for t, on in (("int8", quant), ("int4", int4))
                          if on))
    return out, list(k_pages), list(v_pages)


_build.counters(fused_multi_block_decode, "", "int8", "int4", "int8_int4")


# ------------------------------------------------------ tensor parallel
def shard_block_weights(weights: MultiBlockDecodeWeights, tp: int, *,
                        num_heads: int, num_kv_heads: int
                        ) -> MultiBlockDecodeWeights:
    """Permute a stacked group into the tensor-parallel (Megatron) shard
    layout: each of the ``tp`` shards owns a contiguous slice of heads and
    of the FFN intermediate, so an even split of the last axis of
    wqkv/wgu (and of the middle axis of wo/wd) hands every shard its own
    merged q|k|v and gate|up blocks. The merged matrices concatenate
    q|k|v (and gate|up) on columns, so the columns are reordered shard
    by shard, once, on the host side:

      wqkv  [q | k | v]        ->  [q_0|k_0|v_0 | q_1|k_1|v_1 | ...]
      wgu   [gate | up]        ->  [g_0|u_0 | g_1|u_1 | ...]

    wo (rows nh*d, head-major) and wd (rows I) are already shard-contiguous
    on their contraction axis, and the norms replicate. :class:`Int4Tiles`
    stacks are refused: the nibble row pairing and per-tile scales do not
    commute with the column permutation. A copy of the reference's
    function, bit for bit on the same stack."""
    if tp <= 1:
        return weights
    for name in ("wqkv", "wo", "wgu", "wd"):
        if isinstance(getattr(weights, name), Int4Tiles):
            raise ValueError(
                "shard_block_weights: int4-packed stacks cannot be "
                "resharded (pack after sharding instead); got Int4Tiles "
                f"for {name}")
    d = weights.wqkv.shape[2] // (num_heads + 2 * num_kv_heads)
    inter = weights.wd.shape[1]
    if num_heads % tp or num_kv_heads % tp or inter % tp:
        raise ValueError(
            f"shard_block_weights: heads/kv-heads/intermediate "
            f"({num_heads}/{num_kv_heads}/{inter}) must all divide "
            f"tp={tp}")
    qw = num_heads * d
    kvw = num_kv_heads * d
    cols = torch.arange(qw + 2 * kvw)
    q_cols = cols[:qw].reshape(tp, -1)
    k_cols = cols[qw:qw + kvw].reshape(tp, -1)
    v_cols = cols[qw + kvw:].reshape(tp, -1)
    qkv_perm = torch.cat([torch.cat([q_cols[s], k_cols[s], v_cols[s]])
                          for s in range(tp)])
    gu_cols = torch.arange(2 * inter)
    g_cols = gu_cols[:inter].reshape(tp, -1)
    u_cols = gu_cols[inter:].reshape(tp, -1)
    gu_perm = torch.cat([torch.cat([g_cols[s], u_cols[s]])
                         for s in range(tp)])
    dev = weights.wqkv.device
    return MultiBlockDecodeWeights(
        ln1=weights.ln1,
        wqkv=weights.wqkv[:, :, qkv_perm.to(dev)],
        wo=weights.wo,
        ln2=weights.ln2,
        wgu=weights.wgu[:, :, gu_perm.to(dev)],
        wd=weights.wd)


def split_block_shards(weights: MultiBlockDecodeWeights, tp: int
                       ) -> Tuple[MultiBlockDecodeWeights, ...]:
    """The ``tp`` shards' own stacks of a :func:`shard_block_weights`
    group: an even split of the last axis of wqkv/wgu and of the middle
    axis of wo/wd (contiguous copies), the norms shared."""
    def cut(t, dim):
        return [c.contiguous() for c in t.chunk(tp, dim=dim)]
    qkv, gu = cut(weights.wqkv, 2), cut(weights.wgu, 2)
    wo, wd = cut(weights.wo, 1), cut(weights.wd, 1)
    return tuple(MultiBlockDecodeWeights(
        ln1=weights.ln1, wqkv=qkv[s], wo=wo[s], ln2=weights.ln2,
        wgu=gu[s], wd=wd[s]) for s in range(tp))


def fused_multi_block_decode_tp(x, shards: Sequence[MultiBlockDecodeWeights],
                                k_pages, v_pages, block_tables, seq_lens, *,
                                num_heads: int, num_kv_heads: int,
                                rope_theta: float = 10000.0,
                                epsilon: float = 1e-6,
                                sm_scale: Optional[float] = None):
    """One decode step of a layer group, tensor-parallel over
    ``len(shards)`` shards on x's device.

    ``shards``: each shard's stack (:func:`split_block_shards`);
    ``num_heads`` / ``num_kv_heads``: the LOCAL (per-shard) head counts;
    ``k_pages[s]`` / ``v_pages[s]``: shard ``s``'s per-layer pools, its
    kv-head partition (:func:`~.paged_attention.shard_pool`), updated in
    place. Per layer and shard it is the chain of
    :func:`fused_multi_block_decode_ref` in x's dtype: rms, the local
    q|k|v product, RoPE, the append (:func:`write_paged_kv`), the decode
    attention kernel (:func:`paged_attention`) over ``seq_lens + 1``;
    the two row-parallel exits (``wo``, ``wd``) each end in one
    ``_mp_allreduce`` over the shards, so the residual ``x`` stays
    replicated. The reference's ``fused_multi_block_decode_tp`` with its
    ``psum`` pair. Returns ``(out, k_pages, v_pages)``."""
    from ..distributed.fleet.layers.mpu.mp_ops import _mp_allreduce

    tp = len(shards)
    n = shards[0].n_layers
    if len(k_pages) != tp or len(v_pages) != tp:
        raise ValueError(f"expected {tp} shards' pools, got "
                         f"{len(k_pages)}/{len(v_pages)}")
    if any(len(kp) != n or len(vp) != n for kp, vp in zip(k_pages, v_pages)):
        raise ValueError(f"expected {n} per-layer pools a shard")
    b, _ = x.shape
    nh, nkv = num_heads, num_kv_heads
    d = shards[0].wqkv.shape[2] // (nh + 2 * nkv)
    qw, kvw = nh * d, nkv * d
    inter = shards[0].wd.shape[1]
    sin, cos = _rope_tables(seq_lens, d, rope_theta)
    lens = seq_lens + 1
    for i in range(n):
        h = _rms(x, shards[0].ln1[i], epsilon)
        parts = []
        for s, w in enumerate(shards):
            qkv = h @ w.wqkv[i]
            q = _rope_heads(qkv[:, :qw].reshape(b, nh, d), sin, cos)
            k = _rope_heads(qkv[:, qw:qw + kvw].reshape(b, nkv, d), sin, cos)
            v = qkv[:, qw + kvw:].reshape(b, nkv, d)
            write_paged_kv(k_pages[s][i], v_pages[s][i], k, v, block_tables,
                           seq_lens)
            attn = paged_attention(q.contiguous(), k_pages[s][i],
                                   v_pages[s][i], block_tables, lens,
                                   sm_scale)
            parts.append(attn.reshape(b, qw) @ w.wo[i])
        x2 = x + _mp_allreduce(parts)[0]
        h2 = _rms(x2, shards[0].ln2[i], epsilon)
        parts = []
        for w in shards:
            gu = h2 @ w.wgu[i]
            parts.append((F.silu(gu[:, :inter]) * gu[:, inter:]) @ w.wd[i])
        x = x2 + _mp_allreduce(parts)[0]
    return x, k_pages, v_pages
