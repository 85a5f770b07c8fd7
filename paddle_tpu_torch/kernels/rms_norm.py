"""Fused RMSNorm, forward and backward.

Counterpart of ``paddle_tpu/kernels/rms_norm.py``:

    forward   r = rsqrt(mean(x^2) + eps);  y = x * r * w   (saves r)
    backward  dx = r * g*w - x * r^3 / H * sum(g*w*x)
              dw = sum_rows(g * x * r)

Two hand-written CUDA kernels in ``csrc/rms_norm.cu``, each behind a
wrapper with a launch counter and a plain PyTorch twin:

  - :func:`rms_norm_fwd` -> ``(y, r)`` (replaces ``_fwd_kernel``);
  - :func:`rms_norm_bwd_dx` (replaces ``_bwd_kernel``).

``_RMSNorm`` ties them into one ``torch.autograd.Function``; dw is a
PyTorch reduction, as JAX computes it with an einsum outside the Pallas
kernel. Every value is computed in f32 and rounded once to x's dtype (the
TPU kernel's single rounding; ``nn.functional.rms_norm`` rounds ``x * r``
before the weight, as the JAX package's does). The kernels take any
width and any row count: the JAX path pads rows to its row block and runs
its plain composition above H = 32768. A CUDA tensor always launches the
kernels; a CPU tensor runs the plain twins.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


# ------------------------------------------------------------ plain versions
def rms_norm_fwd_ref(x2: torch.Tensor, w: torch.Tensor, eps: float):
    """Plain twin of :func:`rms_norm_fwd`: ``(y, r)``, y in x's dtype, r the
    f32 ``(N, 1)`` reciprocal RMS (any leading shape: r keeps it)."""
    xf = x2.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + float(eps))
    return (xf * r * w.float().reshape(-1)).to(x2.dtype), r


def rms_norm_bwd_dx_ref(x2: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                        r: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`rms_norm_bwd_dx`:
    ``dx = r * g*w - x * r^3 * (sum(g*w*x) / H)`` in f32, cast to x's
    dtype."""
    xf, gw = x2.float(), g.float() * w.float().reshape(1, -1)
    dot = (gw * xf).sum(dim=-1, keepdim=True)
    dx = r * gw - xf * (r * r * r) * (dot / x2.shape[-1])
    return dx.to(x2.dtype)


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                 epsilon: float = 1e-6) -> torch.Tensor:
    """Dense twin of :func:`rms_norm` over the last axis, any leading
    shape, differentiable by autograd: the parity oracle."""
    return rms_norm_fwd_ref(x, weight, epsilon)[0]


# ----------------------------------------------------------------- wrappers
def _check_cuda(name, x2, w, extra=()):
    """The kernels' contract: one CUDA device, float32 or bfloat16, x and
    the extra row tensors contiguous ``(N, H)``, the weight ``H`` elements,
    r f32 ``(N, 1)``."""
    if x2.dim() != 2:
        raise ValueError(f"{name}: x must be (N, H), got {tuple(x2.shape)}")
    if w.numel() != x2.shape[1]:
        raise ValueError(f"{name}: weight has {w.numel()} elements for "
                         f"H = {x2.shape[1]}")
    _build.dtype_code(x2.dtype)
    for nm, t, dtype, shape in (("x", x2, x2.dtype, x2.shape),
                                ("weight", w, x2.dtype, w.shape)) + extra:
        if t.device != x2.device or t.dtype != dtype:
            raise ValueError(f"{name}: {nm} must be {dtype} on {x2.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {nm} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")


_FWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def rms_norm_fwd(x2: torch.Tensor, w: torch.Tensor, eps: float):
    """RMSNorm of the rows of ``x2`` ``(N, H)`` with weight ``w`` (H
    elements). Returns ``(y, r)``: y ``(N, H)`` in x's dtype, r ``(N, 1)``
    f32. CPU tensors take :func:`rms_norm_fwd_ref`; CUDA tensors launch the
    kernel (float32 or bfloat16, contiguous, any N and H)."""
    if x2.device.type == "cpu":
        return rms_norm_fwd_ref(x2, w, eps)
    _check_cuda("rms_norm_fwd", x2, w)
    n, h = x2.shape
    y = torch.empty_like(x2)
    r = torch.empty((n, 1), device=x2.device, dtype=torch.float32)
    if n == 0:
        return y, r
    fn = _build.bind("rms_norm", "ptt_rms_norm_fwd", _FWD_ARGTYPES)
    rc = fn(_build.dtype_code(x2.dtype), x2.data_ptr(), w.data_ptr(),
            y.data_ptr(), r.data_ptr(), n, h, float(eps),
            _build.stream_handle(x2.device))
    _build.check(rc, "rms_norm_fwd")
    _build.count(rms_norm_fwd)
    return y, r


def rms_norm_bwd_dx(x2: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """dx of RMSNorm from the saved r ``(N, 1)`` f32 and the output
    gradient ``g`` ``(N, H)``. CPU tensors take :func:`rms_norm_bwd_dx_ref`;
    CUDA tensors launch the kernel."""
    if x2.device.type == "cpu":
        return rms_norm_bwd_dx_ref(x2, w, g, r)
    n = x2.shape[0]
    _check_cuda("rms_norm_bwd_dx", x2, w,
                (("g", g, x2.dtype, x2.shape),
                 ("r", r, torch.float32, (n, 1))))
    dx = torch.empty_like(x2)
    if n == 0:
        return dx
    fn = _build.bind("rms_norm", "ptt_rms_norm_bwd_dx", _BWD_ARGTYPES)
    rc = fn(_build.dtype_code(x2.dtype), x2.data_ptr(), w.data_ptr(),
            g.data_ptr(), r.data_ptr(), dx.data_ptr(), n, x2.shape[1],
            _build.stream_handle(x2.device))
    _build.check(rc, "rms_norm_bwd_dx")
    _build.count(rms_norm_bwd_dx)
    return dx


_build.counters(rms_norm_fwd, "")
_build.counters(rms_norm_bwd_dx, "")


class _RMSNorm(torch.autograd.Function):
    """The forward kernel, and the dx kernel plus dw as its backward."""

    @staticmethod
    def forward(ctx, x2, w, eps):
        y, r = rms_norm_fwd(x2, w, eps)
        ctx.save_for_backward(x2, w, r)
        return y

    @staticmethod
    def backward(ctx, g):
        x2, w, r = ctx.saved_tensors
        g = g.contiguous()
        dx = rms_norm_bwd_dx(x2, w, g, r)
        dw = torch.einsum("nh,nh->h", g.float(), x2.float() * r)
        return dx, dw.to(w.dtype).reshape(w.shape), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """Normalize over the last axis, any leading shape; differentiable in x
    and weight (the counterpart of ``rms_norm_pallas``)."""
    h = x.shape[-1]
    y = _RMSNorm.apply(x.reshape(-1, h).contiguous(), weight.contiguous(),
                       float(epsilon))
    return y.reshape(x.shape)
