"""The numerics state that the port-vs-JAX parity tests depend on, pinned
for the length of a test, and the report such a test gives when it misses.

Under ``pytest -n N --dist loadfile`` test files share worker processes,
so a process-global setting that another file leaves behind reaches these
tests: JAX's default matmul precision, the JAX package's flash flags
(block sizes, stats layout, dispatch table, Pallas on/off) and torch's
float32 matmul precision on the CPU (at ``medium`` oneDNN runs f32
products in bf16 on a CPU with AMX, ~1e-4 off at these sizes).
:func:`pinned` sets exactly these for one test and puts back what was
there; :func:`assert_close` says, when a comparison misses, where the
largest error lies, how far each side is from a float64 reference, and
what that state was.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import torch

from paddle_tpu import flags as pflags
from paddle_tpu.kernels import flash_attention as jfa

PINNED_FLAGS = tuple(jfa._FLASH_FLAGS) + ("tpu_matmul_precision",)


def state() -> dict:
    """The process-global settings the comparison depends on."""
    mkldnn = getattr(getattr(torch.backends, "mkldnn", None), "matmul", None)
    return dict(
        jax_default_matmul_precision=jax.config.jax_default_matmul_precision,
        torch_float32_matmul_precision=torch.get_float32_matmul_precision(),
        torch_mkldnn_matmul_fp32_precision=getattr(mkldnn, "fp32_precision",
                                                   None),
        torch_threads=torch.get_num_threads(),
        flags=dict(pflags.snapshot(PINNED_FLAGS).as_tuple()))


@contextlib.contextmanager
def pinned(**flag_values):
    """JAX at ``highest``, torch's f32 matmuls at ``highest``, the flash
    flags at their registered defaults (``flag_values`` overriding), for
    the body; the previous values (a flag's set/unset state included)
    afterwards."""
    reg = pflags._registry._flags
    saved_flags = {n: (reg[n].value, reg[n].is_set) for n in PINNED_FLAGS}
    saved_jax = jax.config.jax_default_matmul_precision
    saved_torch = torch.get_float32_matmul_precision()
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_float32_matmul_precision("highest")
    pflags.set_flags({n: reg[n].default for n in PINNED_FLAGS})
    pflags.set_flags(flag_values)
    try:
        yield
    finally:
        for n, (value, is_set) in saved_flags.items():
            reg[n].value, reg[n].is_set = value, is_set
        jax.config.update("jax_default_matmul_precision", saved_jax)
        torch.set_float32_matmul_precision(saved_torch)


def attention_f64(q, k, v, causal, h, hkv, seg_q=None, seg_kv=None):
    """Dense float64 attention of (BH, S, D) q against (BHkv, S, D) k/v,
    query head h reading kv head h // (H // Hkv); a row that sees no key
    emits zeros."""
    bh, sq, d = q.shape
    rows = np.arange(bh)
    kv_rows = (rows // h) * hkv + (rows % h) // (h // hkv)
    qf = np.asarray(q, np.float64)
    kf, vf = (np.asarray(x, np.float64)[kv_rows] for x in (k, v))
    sc = qf @ kf.transpose(0, 2, 1) / np.sqrt(d)
    vis = np.ones(sc.shape, bool)
    if causal:
        vis &= np.tril(np.ones((sq, kf.shape[1]), bool))
    if seg_q is not None:
        vis &= (np.asarray(seg_q)[:, :, None]
                == np.asarray(seg_kv)[kv_rows][:, None, :])
    sc = np.where(vis, sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    p = np.exp(sc - np.where(np.isfinite(m), m, 0.0))
    l = p.sum(-1, keepdims=True)
    return (p / np.where(l == 0, 1.0, l)) @ vf


def assert_close(got, want, tol, what="out", ref=None):
    """max |got - want| <= tol; on a miss the message gives the index of
    the largest error, both values there, each side's largest error
    against ``ref`` (float64, when given) and :func:`state`."""
    got64, want64 = (np.asarray(x, np.float64) for x in (got, want))
    diff = np.abs(got64 - want64)
    err = float(diff.max())
    if err <= tol:
        return
    at = np.unravel_index(int(diff.argmax()), diff.shape)
    lines = [f"{what}: max err {err} > {tol} at {tuple(int(i) for i in at)}"
             f" (port {got64[at]!r}, jax {want64[at]!r})"]
    if ref is not None:
        ref = np.asarray(ref, np.float64)
        lines.append(f"vs float64: port {float(np.abs(got64 - ref).max())},"
                     f" jax {float(np.abs(want64 - ref).max())}; there "
                     f"{ref[at]!r}")
    lines.append(f"state: {state()}")
    raise AssertionError("\n".join(lines))


# ------------------------------------------ the bf16 flash backward's roundings
BWD_SCHEMES = ("f32", "bf16", "hilo", "prescaled_q")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def flash_bwd_emulated(q, k, v, do, lse, delta, causal, h, hkv, sm_scale,
                       scheme="bf16"):
    """dq, dk, dv as the bf16 tensor-core backward computes them, in f32 on
    the CPU. Inputs are f32 tensors holding bf16 values, q ``(BH, Sq, D)``,
    k/v ``(BHkv, Skv, D)``, lse/delta ``(BH, Sq)``. Every product of bf16
    operands is exact in f32 and sums in f32, as the m16n8k16 mma does, so
    only the roundings of its operands matter:

    - ``f32``: no operand rounded (the plain versions' arithmetic);
    - ``bf16``: P (for Pᵀ·dO) and dS (for dS·K and dSᵀ·Q) rounded once to
      bf16; the scale enters in f32, in the exponent,
      ``p = 2^(s·scale·log2 e − lse·log2 e)``, and dk's and dq's scale is
      applied to the f32 sums;
    - ``hilo``: P and dS as bf16 hi + bf16 lo (two mmas each);
    - ``prescaled_q``: as ``bf16``, with q·scale rounded to bf16 first (S
      from the rounded q; dk from it too).

    Returns f32 ``(dq, dk, dv)`` in the input layouts."""
    bh, sq, d = q.shape
    b, rep, skv = bh // h, h // hkv, k.shape[1]
    log2e = 1.4426950408889634
    q5 = q.reshape(b, hkv, rep, sq, d)
    k4, v4 = k.reshape(b, hkv, skv, d), v.reshape(b, hkv, skv, d)
    do5 = do.reshape(b, hkv, rep, sq, d)
    lse5 = lse.reshape(b, hkv, rep, sq, 1)
    delta5 = delta.reshape(b, hkv, rep, sq, 1)
    qs = _bf16(q5 * sm_scale) if scheme == "prescaled_q" else None
    s = torch.einsum("bgrqd,bgkd->bgrqk", q5 if qs is None else qs, k4)
    sc = 1.0 if qs is not None else sm_scale
    p = torch.exp2(s * (sc * log2e) - lse5 * log2e)
    vis = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        vis = torch.tril(vis)
    p = torch.where(vis, p, torch.zeros(()))
    dp = torch.einsum("bgrqd,bgkd->bgrqk", do5, v4)
    ds = p * (dp - delta5)

    def rounded(x):
        if scheme == "f32":
            return x
        if scheme == "hilo":
            hi = _bf16(x)
            return hi + _bf16(x - hi)
        return _bf16(x)

    pr, dsr = rounded(p), rounded(ds)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", pr, do5)
    if qs is None:
        dk = torch.einsum("bgrqk,bgrqd->bgkd", dsr, q5) * sm_scale
    else:
        dk = torch.einsum("bgrqk,bgrqd->bgkd", dsr, qs)
    dq = torch.einsum("bgrqk,bgkd->bgrqd", dsr, k4) * sm_scale
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)


def rel_to_max(a, b) -> float:
    """max |a - b| / max |b| (chip_smoke.py's gradient check)."""
    a, b = (torch.as_tensor(x).double() for x in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# ------------------------------------------ the bf16 flash forward's roundings
FWD_SCHEMES = ("f32", "bf16", "hilo")


def flash_fwd_emulated(q, k, v, causal, h, hkv, sm_scale, scheme="hilo",
                       seg_q=None, seg_kv=None):
    """(out, lse) as the bf16 tensor-core forward computes them, in f32 on
    the CPU; out before its rounding to bf16. Inputs are f32 tensors holding
    bf16 values, q ``(BH, Sq, D)``, k/v ``(BHkv, Skv, D)``, segment ids
    ``(BH, Sq)`` / ``(BHkv, Skv)`` or None. S = Q Kᵀ is exact products
    summed in f32 (the mma); the scale enters in f32, in the exponent,
    ``p = 2^(s·scale·log2 e − m·scale·log2 e)``; l sums the unrounded f32
    p; the P·V operand P is

    - ``f32``: unrounded (the plain version's arithmetic);
    - ``bf16``: rounded once to bf16 (one mma a k-step);
    - ``hilo``: bf16 hi + bf16 lo (two mmas a k-step).

    The kernel rounds p against its running max, not the row's final one;
    a rounding's relative error does not depend on that scale, so the
    row's max stands in for it. A row that sees no key takes max 0 and
    l = 1: zeros, lse 0 (JAX's guards)."""
    bh, sq, d = q.shape
    b, rep, skv = bh // h, h // hkv, k.shape[1]
    log2e = 1.4426950408889634
    q5 = q.reshape(b, hkv, rep, sq, d)
    k4, v4 = k.reshape(b, hkv, skv, d), v.reshape(b, hkv, skv, d)
    s = torch.einsum("bgrqd,bgkd->bgrqk", q5, k4)
    vis = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        vis = torch.tril(vis)
    vis = vis.expand(s.shape)
    if seg_q is not None:
        vis = vis & (seg_q.reshape(b, hkv, rep, sq)[..., :, None]
                     == seg_kv.reshape(b, hkv, skv)[:, :, None, None, :])
    s = s.masked_fill(~vis, -1e30)
    m = s.amax(-1, keepdim=True)
    m = torch.where(m <= -1e30 / 2, torch.zeros_like(m), m)
    p = torch.exp2(s * (sm_scale * log2e) - m * (sm_scale * log2e))
    p = torch.where(vis, p, torch.zeros(()))
    l = p.sum(-1, keepdim=True)
    if scheme == "bf16":
        p = _bf16(p)
    elif scheme == "hilo":
        hi = _bf16(p)
        p = hi + _bf16(p - hi)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v4) / l_safe
    lse = (m * sm_scale + torch.log(l_safe))[..., 0]
    return out.reshape(q.shape), lse.reshape(bh, sq)


def out_excess(got, want, rtol) -> float:
    """The largest amount by which |got - want| exceeds rtol |want|
    (chip_smoke.py's elementwise forward check against its atol)."""
    got, want = (torch.as_tensor(x).double() for x in (got, want))
    return float(((got - want).abs() - rtol * want.abs()).max())


# ------------------------------------------- the split-KV decode's partition
SPLIT_HALF_WARPS = 8     # DS_ROWS: half-warps a decode_split block holds


def _merge_log2(states):
    """(O, m, l) states (m in log2 units) merged: M over the states that
    saw a key (l > 0), each rescaled by 2^(m - M); None when none did."""
    live = [s for s in states if s is not None and bool((s[2] > 0).all())]
    if not live:
        return None
    m = torch.stack([s[1] for s in live]).amax(0)
    o = sum(torch.exp2(s[1] - m)[..., None] * s[0] for s in live)
    l = sum(torch.exp2(s[1] - m) * s[2] for s in live)
    return o, m, l


def _split_walk(qs, k, v, lens, part_pages, page, nsplit):
    """The split kernel's partition and merge over gathered pools: qs (B,
    Hkv, rep, D) pre-scaled by scale · log2 e; k, v (B, Hkv, T, D) f32;
    row b's first lens[b] keys. See paged_attention_split_emulated."""
    b, hkv, rep, d = qs.shape
    out = torch.zeros(b, hkv, rep, d)
    part_keys = part_pages * page
    for row in range(b):
        n = int(lens[row])
        parts = []
        for s in range(nsplit):
            k0 = s * part_keys
            if k0 >= n:
                continue
            k1 = min(n, k0 + part_keys)
            halves = []
            for w in range(SPLIT_HALF_WARPS):
                idx = torch.arange(k0 + w, max(k1, k0 + w),
                                   SPLIT_HALF_WARPS)
                if not len(idx):
                    halves.append(None)
                    continue
                sc = torch.einsum("grd,gtd->grt", qs[row], k[row][:, idx])
                m = sc.amax(-1)
                p = torch.exp2(sc - m[..., None])
                halves.append((torch.einsum("grt,gtd->grd", p,
                                            v[row][:, idx]), m, p.sum(-1)))
            parts.append(_merge_log2(halves))
        merged = _merge_log2(parts)
        if merged is not None:
            out[row] = merged[0] / merged[2][..., None]
    return out.reshape(b, hkv * rep, d)


def _gathered(q, k_pages, v_pages, block_tables, sm_scale):
    from paddle_tpu_torch.kernels.paged_attention import _gathered_pool
    b, h, d = q.shape
    hkv, _, page, _ = k_pages.shape
    maxp = block_tables.shape[1]
    bt = block_tables.long()
    k = _gathered_pool(k_pages, bt).reshape(b, hkv, maxp * page, d)
    v = _gathered_pool(v_pages, bt).reshape(b, hkv, maxp * page, d)
    qs = q.float().reshape(b, hkv, h // hkv, d) * (sm_scale
                                                    * 1.4426950408889634)
    return qs, k, v


def paged_attention_split_emulated(q, k_pages, v_pages, block_tables,
                                   seq_lens, sm_scale, part_pages, nsplit):
    """``paged_attention`` as the split-KV kernel (``csrc/decode_split.cuh``)
    partitions and merges it, in f32 on the CPU. Row b's keys (its first
    ``min(len, maxp * page)`` table positions) are cut into ``nsplit``
    parts of ``part_pages`` pages; a part starting at or past the length
    does not run. Inside a part, half-warp w takes the keys t with
    t % 8 == w; each leaves (O, m, l) with q pre-scaled by
    scale · log2 e, the block merges its half-warps, and the parts merge in
    part order over those that ran; a row with none emits zeros. Pools as
    ``paged_attention_ref`` takes them (native or ``QuantizedPages``)."""
    page, maxp = k_pages.shape[2], block_tables.shape[1]
    assert nsplit * part_pages >= maxp
    qs, k, v = _gathered(q, k_pages, v_pages, block_tables, sm_scale)
    lens = [min(int(n), maxp * page) for n in seq_lens]
    return _split_walk(qs, k, v, lens, part_pages, page, nsplit)


def fused_attention_split_emulated(q, k_pages, v_pages, block_tables,
                                   seq_lens, k_own, v_own, sm_scale,
                                   part_pages, nsplit):
    """The fused decode kernels' attention phase (``csrc/block_decode.cuh``
    phase 2) in f32 on the CPU, after the append of the step's k/v rows to
    the pools at ``seq_lens``: the split walk of
    :func:`paged_attention_split_emulated` over ``seq_lens + 1`` (clamped
    to the table), with the key and value at position ``seq_lens[b]`` the
    row's own ``k_own``/``v_own`` (B, Hkv, D) as the pool stores them (cast
    to a native pool's dtype, or quantized per row), read from the append
    kernel's scratch row and not from the pool."""
    from paddle_tpu_torch.kernels.paged_attention import (QuantizedPages,
                                                          _stored)
    page, maxp = k_pages.shape[2], block_tables.shape[1]
    assert nsplit * part_pages >= maxp
    qs, k, v = _gathered(q, k_pages, v_pages, block_tables, sm_scale)
    for full, pool, own in ((k, k_pages, k_own), (v, v_pages, v_own)):
        parts = _stored(pool, own)
        val = (parts[0].float() * parts[1] if isinstance(pool, QuantizedPages)
               else parts[0].float())
        for row, n in enumerate(seq_lens):
            if int(n) < maxp * page:
                full[row, :, int(n)] = val[row]
    lens = [min(int(n) + 1, maxp * page) for n in seq_lens]
    return _split_walk(qs, k, v, lens, part_pages, page, nsplit)
