"""The port's flash attention (CPU path: the plain versions behind the
kernel wrappers, tied by the autograd Function) against the JAX package's.

Inputs come from one numpy generator and go into both packages, fp32, with
the JAX side at ``jax_default_matmul_precision=highest`` (conftest). At
S = 128 and 256 the reference is JAX's Pallas ``flash_attention`` in
interpret mode, with ``FLAGS_flash_compact_stats`` on (``_fwd_kernel_compact``)
and off (``_fwd_kernel``): out within 2e-5, dq/dk/dv (``jax.vjp``) within
5e-5. At a ragged S = 200 the reference is ``flash_attention_ref`` and its
``jax.vjp``. Both sum in f32 in another order, hence the tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as fa
from torch_numerics import assert_close, attention_f64, pinned

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
    with pytest.raises(NotImplementedError):
        call(torch.zeros(4, 8, 16))
