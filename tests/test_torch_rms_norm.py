"""The port's fused RMSNorm (CPU path: the plain twins behind the kernel
wrappers, tied by the autograd Function) against the JAX package's.

Inputs come from one numpy generator and go into both packages. The JAX
side is ``rms_norm_pallas`` in Pallas interpret mode (as
``tests/test_rms_norm_kernel.py`` runs it; at 300 rows it pads to its
256-row block) and its oracle ``rms_norm_ref``: in fp32 out within 1e-6
and dx (``jax.vjp``) within 1e-5, both summing in f32 in another order;
dw, a sum over all rows of terms of order 1, within 1e-5 of its largest
element; in bf16 the outputs equal or one bf16 ulp apart (the f32 values
before the single rounding differ in the last bits). ``fused_rms_norm``
is held to the JAX package's in fp32, where its TPU route (one rounding)
and its ``nn.functional.rms_norm`` route (two) agree; a bf16 test pins the
designed difference: the port computes the kernel's value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.kernels import rms_norm as jrn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import kernels
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.kernels import rms_norm as rn

OUT_TOL, GRAD_TOL = 1e-6, 1e-5
SHAPES = [(300, 512), (4, 128, 256), (8, 64)]


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, w, g


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rel(a, b):
    """max |a - b| over max |b|: for dw, a sum over every row."""
    return _err(a, b) / float(np.max(np.abs(np.asarray(b, np.float64))))


def _port(x, w, g, eps=1e-6):
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    out = rn.rms_norm(tx, tw, eps)
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(g))
    return out.detach().numpy(), dx.numpy(), dw.numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=["300x512", "4x128x256",
                                               "8x64"])
def test_matches_jax_pallas_and_its_grads(shape):
    x, w, g = _inputs(sum(shape), shape)
    want, vjp = jax.vjp(jrn.rms_norm_pallas, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    got, dx, dw = _port(x, w, g)
    assert got.shape == shape and dx.shape == shape and dw.shape == w.shape
    assert _err(got, want) <= OUT_TOL
    assert _err(got, jrn.rms_norm_ref(jnp.asarray(x),
                                      jnp.asarray(w))) <= OUT_TOL
    assert _err(dx, want_dx) <= GRAD_TOL
    assert _rel(dw, want_dw) <= GRAD_TOL


@pytest.mark.parametrize("shape", SHAPES, ids=["300x512", "4x128x256",
                                               "8x64"])
def test_bf16_within_one_ulp_of_jax_pallas(shape):
    x, w, _ = _inputs(sum(shape) + 1, shape)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    got = rn.rms_norm(xb, wb).float().numpy()
    want = np.asarray(jrn.rms_norm_pallas(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(wb.float().numpy(), jnp.bfloat16)), np.float32)
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(got - want) <= ulp)


def test_bf16_is_the_kernel_value_not_nn_functional_rms_norm():
    """The designed difference: one rounding (the Pallas kernel's), not
    ``nn.functional.rms_norm``'s two (x * r rounded before the weight)."""
    x, w, _ = _inputs(5, (64, 256))
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    pallas = np.asarray(jrn.rms_norm_pallas(xb, wb), np.float32)
    two_roundings = np.asarray(JF.rms_norm(paddle.to_tensor(xb),
                                           paddle.to_tensor(wb)).numpy(),
                               np.float32)
    got = IF.fused_rms_norm(torch.from_numpy(np.asarray(xb, np.float32))
                            .bfloat16(),
                            torch.from_numpy(np.asarray(wb, np.float32))
                            .bfloat16()).float().numpy()
    assert np.all(np.abs(got - pallas) <= np.abs(pallas) * 2.0 ** -7)
    assert np.mean(got == pallas) > 0.99
    assert np.any(pallas != two_roundings)
    assert np.mean(got == two_roundings) < np.mean(got == pallas)


def test_plain_twins_match_autograd_of_the_reference():
    x, w, g = _inputs(9, (37, 300))
    tx, tw, tg = (torch.from_numpy(a) for a in (x, w, g))
    y, r = rn.rms_norm_fwd_ref(tx, tw, 1e-5)
    assert y.dtype == torch.float32 and r.shape == (37, 1)
    leaves = [t.clone().requires_grad_(True) for t in (tx, tw)]
    want = rn.rms_norm_ref(*leaves, 1e-5)
    want_dx, _ = torch.autograd.grad(want, leaves, tg)
    assert _err(y.numpy(), want.detach().numpy()) <= OUT_TOL
    assert _err(rn.rms_norm_bwd_dx_ref(tx, tw, tg, r).numpy(),
                want_dx.numpy()) <= GRAD_TOL


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
def test_fused_rms_norm_matches_jax(with_bias):
    rng = np.random.default_rng(4)
    shape = (2, 16, 128)
    x, res, bias, nbias = (rng.standard_normal(s).astype(np.float32)
                           for s in (shape, shape, shape[-1:], shape[-1:]))
    w = (rng.standard_normal(128) * 0.1 + 1.0).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    kw = dict(epsilon=1e-5)
    if with_bias:
        kw.update(bias=bias, norm_bias=nbias)

    def jt(a, grad=False):
        return paddle.to_tensor(a, stop_gradient=not grad)

    jx, jres, jw = jt(x, True), jt(res, True), jt(w, True)
    jout, jh = JIF.fused_rms_norm(jx, jw, residual=jres,
                                  **{k: jt(v) if isinstance(v, np.ndarray)
                                     else v for k, v in kw.items()})
    (jout * jt(g)).sum().backward()
    tx, tres, tw = (torch.from_numpy(a).requires_grad_(True)
                    for a in (x, res, w))
    tout, th = IF.fused_rms_norm(tx, tw, residual=tres,
                                 **{k: torch.from_numpy(v)
                                    if isinstance(v, np.ndarray) else v
                                    for k, v in kw.items()})
    (tout * torch.from_numpy(g)).sum().backward()
    assert _err(tout.detach().numpy(), jout.numpy()) <= OUT_TOL
    assert _err(th.detach().numpy(), jh.numpy()) <= OUT_TOL
    for t, j in ((tx, jx), (tres, jres)):
        assert _err(t.grad.numpy(), j.grad.numpy()) <= GRAD_TOL
    assert _rel(tw.grad.numpy(), jw.grad.numpy()) <= GRAD_TOL


def test_fused_rms_norm_without_weight_or_residual_matches_jax():
    x, _, _ = _inputs(6, (8, 96))
    want = JIF.fused_rms_norm(paddle.to_tensor(x), epsilon=1e-6).numpy()
    got = IF.fused_rms_norm(torch.from_numpy(x), epsilon=1e-6)
    assert isinstance(got, torch.Tensor)
    assert _err(got.numpy(), want) <= OUT_TOL


@pytest.mark.parametrize("kw", [dict(begin_norm_axis=1),
                                dict(quant_scale=0.5)],
                         ids=["begin_norm_axis", "quant_scale"])
def test_fused_rms_norm_refuses_what_it_does_not_port(kw):
    x = torch.zeros(2, 4, 8)
    with pytest.raises(NotImplementedError):
        IF.fused_rms_norm(x, torch.ones(8), **kw)


def test_cpu_path_launches_no_kernel():
    x, w, g = _inputs(2, (16, 64))
    kernels.reset_launches()
    _port(x, w, g)
    counts = kernels.launch_counts()
    assert counts["rms_norm_fwd"] == 0 and counts["rms_norm_bwd_dx"] == 0
