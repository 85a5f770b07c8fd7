"""Segment ids (varlen / packed sequences) in the port's flash attention and
its varlen entry points (CPU path: the plain versions behind the kernel
wrappers) against the JAX package's.

Inputs and segment ids come from one numpy generator and go into both
packages, fp32, the JAX side at ``jax_default_matmul_precision=highest``
(conftest). At S = 128 and 256 the reference is JAX's Pallas
``flash_attention`` with segment ids in interpret mode, with
``FLAGS_flash_compact_stats`` on and off; at a ragged S = 200 it is
``flash_attention_ref``; dq/dk/dv through ``jax.vjp``. Out within 2e-5,
grads within 5e-5, as in ``test_torch_flash_attention.py``: both sum in f32
in another order. ``flash_attn_unpadded`` and
``variable_length_memory_efficient_attention`` are held to the JAX
package's (its dense route off the TPU for the first, its Pallas kernel
in interpret mode for the second), gradients through its autograd.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import kernels
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn import functional as F
from torch_numerics import assert_close, attention_f64, pinned

B, H, D = 2, 4, 32
OUT_TOL, GRAD_TOL = 2e-5, 5e-5


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _ids(rng, s, pad=0):
    """(B, S) ids of documents of random lengths packed along each row;
    the last ``pad`` positions of each row carry an id no other position
    has on the kv side (returned apart)."""
    ids = np.zeros((B, s), np.int32)
    for row in range(B):
        cuts = np.sort(rng.choice(np.arange(1, s), size=3, replace=False))
        ids[row] = np.searchsorted(cuts, np.arange(s), side="right")
    kv = ids.copy()
    if pad:
        ids[:, s - pad:] = 7
        kv[:, s - pad:] = 8
    return ids, kv


def _inputs(seed, s, hkv, pad=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B * H, s, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B * hkv, s, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B * hkv, s, D)) * 0.5).astype(np.float32)
    do = rng.standard_normal((B * H, s, D)).astype(np.float32)
    ids_q, ids_kv = _ids(rng, s, pad)
    seg_q = np.repeat(ids_q, H, axis=0)
    seg_kv = np.repeat(ids_kv, hkv, axis=0)
    return q, k, v, do, seg_q, seg_kv


def _port(q, k, v, do, seg_q, seg_kv, causal, hkv):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, torch.from_numpy(seg_q),
                             torch.from_numpy(seg_kv), causal=causal,
                             n_heads=H, n_kv_heads=hkv)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _check(got, got_g, want, want_g, ref=None):
    assert got.shape == want.shape
    assert_close(got, want, OUT_TOL, ref=ref)
    for name, g, w in zip("qkv", got_g, want_g):
        assert_close(g, w, GRAD_TOL, f"d{name}")


@pytest.fixture(params=[True, False], ids=["compact", "replicated"])
def stats_layout(request):
    """The stats layout, with every other setting the comparison depends
    on pinned (torch_numerics.pinned) and restored afterwards."""
    with pinned(flash_compact_stats=request.param):
        yield request.param


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_segment_ids_match_jax_pallas_flash(stats_layout, s, hkv, causal):
    q, k, v, do, seg_q, seg_kv = _inputs(s + hkv, s, hkv)
    jq, jkv = jnp.asarray(seg_q), jnp.asarray(seg_kv)
    want, want_g = _jax(lambda a, b, c: jfa.flash_attention(
        a, b, c, jq, jkv, causal=causal, n_heads=H, n_kv_heads=hkv),
        q, k, v, do)
    _check(*_port(q, k, v, do, seg_q, seg_kv, causal, hkv), want, want_g,
           attention_f64(q, k, v, causal, H, hkv, seg_q, seg_kv))


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ragged_segment_ids_match_jax_reference(hkv, causal):
    q, k, v, do, seg_q, seg_kv = _inputs(5 + hkv, 200, hkv)
    jq, jkv = jnp.asarray(seg_q), jnp.asarray(seg_kv)
    want, want_g = _jax(lambda a, b, c: jfa.flash_attention_ref(
        a, b, c, jq, jkv, causal=causal, n_heads=H, n_kv_heads=hkv),
        q, k, v, do)
    _check(*_port(q, k, v, do, seg_q, seg_kv, causal, hkv), want, want_g)


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_rows_no_key_shares_emit_zeros_and_zero_grads(hkv):
    """A padding id on the q side that no kv position carries: those rows
    emit zeros with lse 0 and get zero dq, as in the JAX kernels."""
    pad = 20
    q, k, v, do, seg_q, seg_kv = _inputs(3, 128, hkv, pad=pad)
    jq, jkv = jnp.asarray(seg_q), jnp.asarray(seg_kv)
    want, want_g = _jax(lambda a, b, c: jfa.flash_attention(
        a, b, c, jq, jkv, causal=True, n_heads=H, n_kv_heads=hkv),
        q, k, v, do)
    got, got_g = _port(q, k, v, do, seg_q, seg_kv, True, hkv)
    _check(got, got_g, want, want_g)
    assert not got[:, -pad:].any() and not got_g[0][:, -pad:].any()
    _, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), True, None, H, hkv,
        torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    assert not lse[:, -pad:].any()


def test_kv_ids_default_to_the_q_ids_and_gqa_needs_them():
    q, k, v, do, seg_q, seg_kv = _inputs(2, 64, 4)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    ids = torch.from_numpy(seg_q)
    same = fa.flash_attention(tq, tk, tv, ids, ids, n_heads=H)
    assert torch.equal(fa.flash_attention(tq, tk, tv, ids, n_heads=H), same)
    with pytest.raises(ValueError):
        fa.flash_attention(tq, tk[:B * 2], tv[:B * 2], ids, n_heads=H,
                           n_kv_heads=2)
    with pytest.raises(ValueError):
        fa.flash_attention(tq, tk, tv, kv_segment_ids=ids, n_heads=H)


@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_bshd_segment_ids_match_jax(hkv):
    rng = np.random.default_rng(13)
    s = 128
    q = (rng.standard_normal((B, s, H, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, s, hkv, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, s, hkv, D)) * 0.5).astype(np.float32)
    do = rng.standard_normal((B, s, H, D)).astype(np.float32)
    ids, _ = _ids(rng, s)
    jids = jnp.asarray(ids)
    want, want_g = _jax(lambda a, b, c: jfa.flash_attention_bshd(
        a, b, c, segment_ids=jids, causal=True), q, k, v, do)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention_bshd(*leaves, segment_ids=torch.from_numpy(ids),
                                  causal=True)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert out.shape == (B, s, H, D)
    _check(out.detach().numpy(), [g.numpy() for g in grads], want, want_g)


def _pack(rng, lens_q, lens_k, h, hkv):
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    q = (rng.standard_normal((cu_q[-1], h, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((cu_k[-1], hkv, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((cu_k[-1], hkv, D)) * 0.5).astype(np.float32)
    do = rng.standard_normal((cu_q[-1], h, D)).astype(np.float32)
    return cu_q, cu_k, q, k, v, do


@pytest.mark.parametrize("route", ["self-causal", "self-full", "cross-full",
                                   "cross-causal"])
@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_flash_attn_unpadded_matches_jax(route, hkv):
    """A self-attention pack and a cross pack (other kv boundaries), causal
    or not, with gradients; the causal cross pack takes the dense route
    with local positions in both packages."""
    rng = np.random.default_rng(len(route) + hkv)
    lens_q = (40, 1, 70, 17)
    lens_k = lens_q if route.startswith("self") else (25, 6, 90, 30)
    cu_q, cu_k, q, k, v, do = _pack(rng, lens_q, lens_k, H, hkv)
    causal = route.endswith("causal")
    jleaves = [paddle.to_tensor(x, stop_gradient=False) for x in (q, k, v)]
    jout, none = JF.flash_attn_unpadded(
        *jleaves, paddle.to_tensor(cu_q), paddle.to_tensor(cu_k),
        max(lens_q), max(lens_k), causal=causal)
    assert none is None
    (jout * paddle.to_tensor(do)).sum().backward()
    kernels.reset_launches()
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out, none = F.flash_attn_unpadded(
        *leaves, torch.from_numpy(cu_q), torch.from_numpy(cu_k),
        max(lens_q), max(lens_k), causal=causal)
    assert none is None and out.shape == q.shape
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    _check(out.detach().numpy(), [g.numpy() for g in grads], jout.numpy(),
           [t.grad.numpy() for t in jleaves])
    assert set(kernels.launch_counts().values()) == {0}


def test_flash_attn_unpadded_routes_by_layout(monkeypatch):
    """Self packs and non-causal packs go through the flash path (the
    kernels' segment variant on a card); only a causal cross pack takes
    the dense route."""
    rng = np.random.default_rng(1)
    calls = []
    real = F.flash_attention_bshd

    def spy(*a, **kw):
        calls.append(kw.get("causal"))
        return real(*a, **kw)

    monkeypatch.setattr(F, "flash_attention_bshd", spy)
    for lens_k, causal, want in (((40, 1, 70, 17), True, 1),
                                 ((25, 6, 90, 30), False, 1),
                                 ((25, 6, 90, 30), True, 0)):
        calls.clear()
        cu_q, cu_k, q, k, v, _ = _pack(rng, (40, 1, 70, 17), lens_k, H, H)
        F.flash_attn_unpadded(*(torch.from_numpy(x) for x in (q, k, v)),
                              torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                              70, 90, causal=causal)
        assert len(calls) == want


@pytest.mark.parametrize("kw", [dict(return_softmax=True),
                                dict(dropout=0.1)],
                         ids=["return_softmax", "dropout"])
def test_varlen_entries_refuse_like_jax(kw):
    t = torch.zeros(8, 2, 16)
    cu = torch.tensor([0, 8])
    with pytest.raises(NotImplementedError):
        F.flash_attn_unpadded(t, t, t, cu, cu, 8, 8, **kw)
    with pytest.raises(NotImplementedError):
        F.flash_attention(t[None], t[None], t[None], **kw)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_nn_flash_attention_matches_jax(causal):
    rng = np.random.default_rng(21)
    q, k, v = ((rng.standard_normal((B, 128, H, D)) * 0.5)
               .astype(np.float32) for _ in range(3))
    want, _ = JF.flash_attention(*(paddle.to_tensor(x) for x in (q, k, v)),
                                 causal=causal)
    got, none = F.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=causal)
    assert none is None
    assert _err(got.numpy(), want.numpy()) <= OUT_TOL


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_variable_length_attention_matches_jax(causal):
    rng = np.random.default_rng(22)
    q, k, v = ((rng.standard_normal((B, H, 128, D)) * 0.5)
               .astype(np.float32) for _ in range(3))
    lens = np.array([128, 45], np.int32)
    want = JIF.variable_length_memory_efficient_attention(
        *(paddle.to_tensor(x) for x in (q, k, v)), paddle.to_tensor(lens),
        causal=causal).numpy()
    got = IF.variable_length_memory_efficient_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(lens),
        causal=causal)
    assert got.shape == (B, H, 128, D)
    assert _err(got.numpy(), want) <= OUT_TOL


@pytest.mark.parametrize("kw", [dict(kv_seq_lens=np.array([4])),
                                dict(mask=np.zeros((1, 1, 4, 4))),
                                dict(pre_cache_length=2)],
                         ids=["kv_seq_lens", "mask", "pre_cache_length"])
def test_variable_length_attention_refuses_what_it_does_not_port(kw):
    t = torch.zeros(1, 2, 4, 16)
    with pytest.raises(NotImplementedError):
        IF.variable_length_memory_efficient_attention(t, t, t, **kw)


def test_cpu_path_launches_no_kernel():
    q, k, v, do, seg_q, seg_kv = _inputs(1, 64, 2)
    kernels.reset_launches()
    _port(q, k, v, do, seg_q, seg_kv, True, 2)
    assert set(kernels.launch_counts().values()) == {0}
