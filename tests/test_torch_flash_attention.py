"""The port's flash attention (CPU path: the plain versions behind the
kernel wrappers, tied by the autograd Function) against the JAX package's.

Inputs come from one numpy generator and go into both packages, fp32, with
the JAX side at ``jax_default_matmul_precision=highest`` (conftest). At
S = 128 and 256 the reference is JAX's Pallas ``flash_attention`` in
interpret mode, with ``FLAGS_flash_compact_stats`` on (``_fwd_kernel_compact``)
and off (``_fwd_kernel``): out within 2e-5, dq/dk/dv (``jax.vjp``) within
5e-5. At a ragged S = 200 the reference is ``flash_attention_ref`` and its
``jax.vjp``. Both sum in f32 in another order, hence the tolerances.

The bf16 backward's precision is decided here too: its kernels' operand
roundings, emulated in f32 (``torch_numerics.flash_bwd_emulated``), stay
within the card's bf16 gradient tolerance at a peaked q; and the segment
id ranges by which they skip tiles never skip a pair with equal ids.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as fa
from torch_numerics import (assert_close, attention_f64, flash_bwd_emulated,
                            pinned, rel_to_max)

B, H, D = 2, 4, 32
OUT_TOL, GRAD_TOL = 2e-5, 5e-5


def _inputs(seed, s, hkv):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B * H, s, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B * hkv, s, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B * hkv, s, D)) * 0.5).astype(np.float32)
    do = rng.standard_normal((B * H, s, D)).astype(np.float32)
    return q, k, v, do


def _port(q, k, v, do, causal, hkv):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, n_heads=H,
                             n_kv_heads=hkv)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.fixture(params=[True, False], ids=["compact", "replicated"])
def stats_layout(request):
    """The stats layout, with every other setting the comparison depends
    on pinned (torch_numerics.pinned) and restored afterwards."""
    with pinned(flash_compact_stats=request.param):
        yield request.param


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_matches_jax_pallas_flash(stats_layout, s, hkv, causal):
    q, k, v, do = _inputs(s + hkv, s, hkv)
    want, want_g = _jax(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, n_heads=H, n_kv_heads=hkv), q, k, v, do)
    got, got_g = _port(q, k, v, do, causal, hkv)
    assert got.shape == want.shape
    assert_close(got, want, OUT_TOL,
                 ref=attention_f64(q, k, v, causal, H, hkv))
    for name, g, w in zip("qkv", got_g, want_g):
        assert g.shape == w.shape
        assert_close(g, w, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ragged_length_matches_jax_reference(hkv, causal):
    q, k, v, do = _inputs(7 + hkv, 200, hkv)
    want, want_g = _jax(lambda a, b, c: jfa.flash_attention_ref(
        a, b, c, causal=causal, n_heads=H, n_kv_heads=hkv), q, k, v, do)
    got, got_g = _port(q, k, v, do, causal, hkv)
    assert _err(got, want) <= OUT_TOL
    for name, g, w in zip("qkv", got_g, want_g):
        assert _err(g, w) <= GRAD_TOL, f"d{name}"


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_forward_lse_matches_jax_compact_stats(hkv):
    """The forward's compact lse is the one JAX's compact kernel emits."""
    q, k, v, _ = _inputs(11, 128, hkv)
    _, want = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                       None, True, 1.0 / np.sqrt(D), 128, 128, H, hkv, True)
    _, got = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), True, None, H, hkv)
    assert got.dtype == torch.float32 and got.shape == (B * H, 128)
    assert _err(got.numpy(), np.asarray(want)) <= OUT_TOL


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_bshd_layout_matches_jax(hkv):
    rng = np.random.default_rng(3)
    s = 128
    q = (rng.standard_normal((B, s, H, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, s, hkv, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, s, hkv, D)) * 0.5).astype(np.float32)
    do = rng.standard_normal((B, s, H, D)).astype(np.float32)
    want, want_g = _jax(lambda a, b, c: jfa.flash_attention_bshd(
        a, b, c, causal=True), q, k, v, do)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention_bshd(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert out.shape == (B, s, H, D)
    assert _err(out.detach().numpy(), want) <= OUT_TOL
    for name, g, w in zip("qkv", grads, want_g):
        assert _err(g.numpy(), w) <= GRAD_TOL, f"d{name}"


def test_cpu_path_launches_no_kernel():
    q, k, v, do = _inputs(1, 64, 2)
    kernels.reset_launches()
    _port(q, k, v, do, True, 2)
    counts = kernels.launch_counts()
    assert counts["flash_attention_fwd"] == 0
    assert counts["flash_attention_bwd_dq"] == 0
    assert counts["flash_attention_bwd_dkv"] == 0


@pytest.mark.parametrize("call", [
    lambda t: fa.flash_attention_with_lse(t, t, t),
], ids=["with_lse"])
def test_unported_options_raise(call):
    """``flash_attention_with_lse``, once refused, is ported: it returns
    ``(out, lse)`` (held to JAX's in tests/test_torch_with_lse.py)."""
    out, lse = call(torch.zeros(4, 8, 16))
    assert out.shape == (4, 8, 16) and lse.shape == (4, 8)


# ----------------------------------- the bf16 backward's numerics, emulated
BF16_GRAD_TOL = 2e-2     # chip_smoke.py's GRAD_TOL[bf16]: max|a-b| / max|b|


def _bf16_inputs(seed, s, h, hkv, qscale):
    """bf16-valued f32 inputs (the kernels' operands) and the plain
    forward's lse and delta from its output rounded to bf16."""
    rng = np.random.default_rng(seed)

    def rnd(rows, scale=1.0):
        a = (rng.standard_normal((rows, s, D)) * scale).astype(np.float32)
        return torch.from_numpy(a).to(torch.bfloat16).float()

    q, k, v, do = rnd(B * h, qscale), rnd(B * hkv), rnd(B * hkv), rnd(B * h)
    out, lse = fa.flash_attention_fwd_ref(q, k, v, True, None, h, hkv)
    delta = (out.to(torch.bfloat16).float() * do).sum(-1)
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("hkv", [4, 1], ids=["mha", "gqa"])
def test_bwd_emulation_in_f32_is_the_plain_backward(hkv):
    """The emulation with no rounding is the plain dq and dk/dv: it models
    the kernels' arithmetic (scale in the exponent, f32 sums) faithfully."""
    q, k, v, do, lse, delta = _bf16_inputs(21, 200, H, hkv, 1.0)
    kw = dict(causal=True, n_heads=H, n_kv_heads=hkv)
    want = (fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw),
            *fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, **kw))
    got = flash_bwd_emulated(q, k, v, do, lse, delta, True, H, hkv,
                             1.0 / np.sqrt(D), "f32")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert rel_to_max(g, w) <= 1e-5, name


@pytest.mark.parametrize("qscale", [1.0, 8.0], ids=["spread", "peaked"])
@pytest.mark.parametrize("hkv", [4, 1], ids=["mha", "gqa"])
def test_bf16_backward_roundings_hold_the_card_tolerance(hkv, qscale):
    """The bf16 tensor-core backward's roundings (P and dS once to bf16,
    the scale in f32 in the exponent, f32 sums), emulated, against autograd
    of the dense f32 reference: within chip_smoke's bf16 gradient
    tolerance, a peaked q included."""
    s = 256
    q, k, v, do, lse, delta = _bf16_inputs(int(qscale) + hkv, s, H, hkv,
                                           qscale)
    kw = dict(causal=True, n_heads=H, n_kv_heads=hkv)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_ref(*leaves, **kw), leaves,
                               do)
    got = flash_bwd_emulated(q, k, v, do, lse, delta, True, H, hkv,
                             1.0 / np.sqrt(D), "bf16")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert rel_to_max(g, w) <= BF16_GRAD_TOL, name


def _pairs_meet_where_ids_do(seg_q, seg_kv, q_rows, kv_rows):
    """Every (q piece of q_rows, kv piece of kv_rows) holding two equal ids
    has meeting ranges; returns how many pieces' pairs would be skipped.
    Pieces of more than SEG_TILE rows combine their ranges as the kernels'
    blocks do (min of the mins, max of the maxes)."""
    def pieces(ids, rows):
        r = fa.seg_tile_ranges(ids)
        per = rows // fa.SEG_TILE
        n = r.shape[1]
        out = []
        for i in range(0, n, per):
            part = r[:, i:i + per]
            out.append(torch.stack((part[..., 0].amin(1),
                                    part[..., 1].amax(1)), -1))
        return torch.stack(out, 1)          # (rows, pieces, 2)

    rq, rk = pieces(seg_q, q_rows), pieces(seg_kv, kv_rows)
    meet = fa.seg_tiles_meet(rq[:, :, None], rk[:, None, :])
    skipped = 0
    for i in range(rq.shape[1]):
        a = seg_q[:, i * q_rows:(i + 1) * q_rows]
        for j in range(rk.shape[1]):
            c = seg_kv[:, j * kv_rows:(j + 1) * kv_rows]
            share = (a[:, :, None] == c[:, None, :]).flatten(1).any(1)
            assert not (share & ~meet[:, i, j]).any(), (i, j)
            skipped += int((~meet[:, i, j]).sum())
    return skipped


@pytest.mark.parametrize("n,alphabet,seed", [
    (1000, 3, 0), (257, 50, 1), (64, 2, 2), (640, 7, 3), (129, 1000, 4),
])
def test_seg_tile_ranges_never_skip_a_visible_pair(n, alphabet, seed):
    """Random, non-monotone ids (any the public entry accepts): a tile pair
    whose ranges do not meet never holds a pair with equal ids, for the
    dq kernel's (128 q rows, 64 kv rows) and dk/dv's (64, 128) tiles."""
    rng = np.random.default_rng(seed)
    seg_q = torch.from_numpy(rng.integers(-alphabet, alphabet, (3, n))
                             ).to(torch.int32)
    seg_kv = torch.from_numpy(rng.integers(-alphabet, alphabet, (3, n))
                              ).to(torch.int32)
    for q_rows, kv_rows in ((128, 64), (64, 128)):
        _pairs_meet_where_ids_do(seg_q, seg_kv, q_rows, kv_rows)


def test_seg_tile_ranges_skip_between_documents():
    """A pack of documents (ids rising along the row, a padding id at the
    end): the ranges skip the tile pairs between documents."""
    lens = (300, 130, 17, 450, 100)
    ids = torch.repeat_interleave(torch.arange(1, 6, dtype=torch.int32),
                                  torch.tensor(lens))[None]
    ids = torch.cat((ids, torch.full((1, 27), 99, dtype=torch.int32)), 1)
    r = fa.seg_tile_ranges(ids)
    assert r.shape == (1, -(-ids.shape[1] // fa.SEG_TILE), 2)
    assert r.dtype == torch.int32
    assert _pairs_meet_where_ids_do(ids, ids, 128, 64) > 0
    assert _pairs_meet_where_ids_do(ids, ids, 64, 128) > 0
