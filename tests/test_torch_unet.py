"""The port's SD-style UNet (``models/unet.py``) and the functions and
layers it brought (``conv2d``, ``group_norm``, ``silu``, ``tanh``,
``mse_loss``, nearest ``interpolate``, ``Conv2D``, ``GroupNorm``,
``KaimingUniform``) against the JAX package on the CPU, on the same seeded
numpy weights and inputs (JAX's ``raw_state()`` through
``load_numpy_state``).

Tolerances (fp32; JAX at ``jax_default_matmul_precision=highest``):
  - the functions within 1e-5 (``conv2d`` relative to its largest output:
    the two libraries sum a window in another order); ``interpolate`` and
    ``mse_loss(reduction="none")`` equal;
  - bf16 ``group_norm`` equal to JAX's (both round the f32 normalized value
    to bf16, then apply the weight and bias in bf16), where PyTorch's own
    ``group_norm`` differs;
  - ``UNet2DConditionModel(tiny)`` (208 parameters, 77 context tokens):
    the output within 1e-5 of its largest element, the loss within 1e-6,
    every gradient within 1e-4 of its largest element;
  - 3 ``TrainStep`` AdamW steps: losses within 1e-6; over the elements
    whose first gradient is at least 100 Adam eps, each parameter within
    1e-4 of its update in L2; every element within 2 lr a step (Adam
    turns the rounding of gradients near eps into steps of about lr).
Also the SD-1.5 parameter count (built on the meta device), the attention
through the flash wrappers (not causal, the cross-attention against 77
keys), and the refusals.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu.jit import functional_call
from paddle_tpu.models import UNetConfig as JUNetConfig
from paddle_tpu.models.unet import UNet2DConditionModel as JUNet
from paddle_tpu.models.unet import UNetDenoiseLoss as JUNetDenoiseLoss
from paddle_tpu.nn import initializer as jinit
from paddle_tpu_torch.device import seed
from paddle_tpu_torch.hapi import TrainStep
from paddle_tpu_torch.models import (UNet2DConditionModel, UNetConfig,
                                     UNetDenoiseLoss)
from paddle_tpu_torch.nn import Conv2D, GroupNorm, initializer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

TOL = 1e-5
LOSS_TOL = 1e-6
GRAD_RTOL = 1e-4
LR = 1e-3
ADAM_FLOOR = 1e-6
STEP_RTOL = 1e-4
CONTEXT = 77


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return _err(a, b) / max(float(np.max(np.abs(b))), 1e-30)


def _np(t):
    return t.detach().float().numpy()


# -------------------------------------------------------------- functions
@pytest.mark.parametrize("stride,padding,dilation,groups,fmt", [
    (1, 1, 1, 1, "NCHW"),
    (2, 1, 1, 1, "NCHW"),                    # SD's downsample
    (1, [1, 2], 1, 1, "NCHW"),
    (1, [(1, 0), (2, 1)], 1, 1, "NCHW"),     # asymmetric pairs
    (2, [0, 1, 1, 0], 1, 1, "NCHW"),         # [top, bottom, left, right]
    (2, "SAME", 1, 1, "NCHW"),               # XLA's SAME at stride 2
    (1, "VALID", 2, 1, "NCHW"),
    (1, 1, 1, 2, "NCHW"),                    # groups
    (2, 1, 1, 2, "NHWC"),
], ids=["p1", "s2", "ph-pw", "pairs", "four", "same-s2", "valid-dil",
        "groups", "nhwc"])
def test_conv2d_matches_jax(stride, padding, dilation, groups, fmt):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 9, 8)).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = rng.standard_normal((6, 4 // groups, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=fmt)
    want = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                     paddle.to_tensor(b), **kw).numpy()
    got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), **kw).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("fmt,affine", [("NCHW", True), ("NHWC", True),
                                        ("NCHW", False)])
def test_group_norm_matches_jax(fmt, affine):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 8, 5, 6)) * 3 + 1).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = rng.standard_normal(8).astype(np.float32) if affine else None
    b = rng.standard_normal(8).astype(np.float32) if affine else None
    jt = (lambda a: None if a is None else paddle.to_tensor(a))
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    want = JF.group_norm(paddle.to_tensor(x), 4, jt(w), jt(b), 1e-5,
                         fmt).numpy()
    got = F.group_norm(torch.from_numpy(x), 4, tt(w), tt(b), 1e-5,
                       fmt).numpy()
    assert _err(got, want) <= TOL


def test_group_norm_bf16_rounds_before_the_affine_as_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 64, 4, 4)) * 3 + 1).astype(np.float32)
    w = (rng.standard_normal(64) * 2).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(JF.group_norm(
        paddle.to_tensor(x).astype("bfloat16"), 8,
        paddle.to_tensor(w).astype("bfloat16"),
        paddle.to_tensor(b).astype("bfloat16")).numpy(), np.float32)
    xt, wt, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    got = F.group_norm(xt, 8, wt, bt)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got), want)
    # PyTorch's group_norm applies the affine before it rounds: another
    # value on some elements
    plain = torch.nn.functional.group_norm(xt, 8, wt, bt, 1e-5)
    assert not torch.equal(plain, got)


def test_activations_and_mse_match_jax():
    x = np.linspace(-6, 6, 301).astype(np.float32)
    for jfn, tfn in ((JF.silu, F.silu), (JF.tanh, F.tanh)):
        want = jfn(paddle.to_tensor(x)).numpy()
        assert _err(tfn(torch.from_numpy(x)).numpy(), want) <= TOL
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((3, 4, 5)).astype(np.float32)
            for _ in range(2))
    for red in ("mean", "sum", "none"):
        want = JF.mse_loss(paddle.to_tensor(a), paddle.to_tensor(b),
                           reduction=red).numpy()
        got = F.mse_loss(torch.from_numpy(a), torch.from_numpy(b),
                         reduction=red).numpy()
        if red == "none":
            assert np.array_equal(got, want)
        else:
            assert _err(got, want) <= TOL * max(1.0, abs(float(want)))


@pytest.mark.parametrize("size,scale,fmt", [
    (None, 2, "NCHW"),                       # SD's Upsample2D
    ((5, 7), None, "NCHW"),                  # 3 -> 5, 4 -> 7: half-pixel
    ((2, 3), None, "NCHW"),                  # shrinking
    (None, 1.5, "NHWC"),
], ids=["x2", "grow-odd", "shrink", "nhwc-1.5"])
def test_interpolate_nearest_matches_jax(size, scale, fmt):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    kw = dict(size=size, scale_factor=scale, mode="nearest", data_format=fmt)
    want = JF.interpolate(paddle.to_tensor(x), **kw).numpy()
    got = F.interpolate(torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_interpolate_is_nearest_exact_not_nearest():
    """3 -> 5: JAX samples at half-pixel centres (0 0 1 2 2), PyTorch's
    "nearest" at floor(i * 3 / 5) (0 0 1 1 2)."""
    x = torch.arange(3.0).reshape(1, 1, 1, 3)
    got = F.interpolate(x, size=(1, 5))
    assert got.flatten().tolist() == [0, 0, 1, 2, 2]
    plain = torch.nn.functional.interpolate(x, size=(1, 5), mode="nearest")
    assert plain.flatten().tolist() == [0, 0, 1, 1, 2]


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "linear", "area"])
def test_interpolate_other_modes_raise(mode):
    with pytest.raises(NotImplementedError):
        F.interpolate(torch.zeros(1, 1, 4, 4), scale_factor=2, mode=mode)


# ----------------------------------------------------------------- layers
def test_kaiming_uniform_bounds_match_jax():
    """limit = gain sqrt(3 / fan_in), gain sqrt(2) for relu: the JAX draw
    and the port's stay inside it and reach near it."""
    fan_in = 4 * 3 * 3
    limit = np.sqrt(6.0 / fan_in)
    jw = np.asarray(jinit.KaimingUniform(fan_in=fan_in)((64, 4, 3, 3),
                                                        "float32"))
    tw = initializer.KaimingUniform(fan_in=fan_in)(
        (64, 4, 3, 3), "cpu", torch.float32, seed(1))
    for w in (jw, tw.numpy()):
        assert np.abs(w).max() <= limit
        assert np.abs(w).max() > 0.95 * limit
    # fan-in from the shape, and leaky_relu's gain
    t = initializer.KaimingUniform(negative_slope=1.0,
                                   nonlinearity="leaky_relu")(
        (16, 8, 1, 1), "cpu", torch.float32, seed(2))
    assert float(t.abs().max()) <= np.sqrt(3.0 / 8)


def test_conv2d_and_group_norm_layers():
    conv = Conv2D(4, 8, 3, stride=2, padding=1, device="cpu",
                  generator=seed(3))
    assert conv.weight.shape == (8, 4, 3, 3) and conv.bias.shape == (8,)
    assert float(conv.weight.detach().abs().max()) <= np.sqrt(6.0 / 36)
    assert float(conv.bias.detach().abs().max()) <= 1 / np.sqrt(36)
    assert conv(torch.zeros(1, 4, 9, 9)).shape == (1, 8, 5, 5)
    assert Conv2D(4, 8, 1, bias_attr=False, device="cpu").bias is None
    a = Conv2D(4, 8, 3, device="cpu", generator=seed(4))
    b = Conv2D(4, 8, 3, device="cpu", generator=seed(4))
    assert torch.equal(a.weight, b.weight)
    gn = GroupNorm(2, 8, device="cpu")
    assert torch.equal(gn.weight, torch.ones(8))
    assert torch.equal(gn.bias, torch.zeros(8))
    assert GroupNorm(2, 8, weight_attr=False, device="cpu").weight is None
    with pytest.raises(NotImplementedError):
        Conv2D(4, 8, 3, padding_mode="reflect", device="cpu")


# ------------------------------------------------------------------- UNet
@pytest.fixture(scope="module")
def junet():
    """The JAX tiny UNet (built lazily) and seeded numpy weights for it:
    matrices and kernels N(0, 1 / fan_in), the norms' scales 1 + N(0,
    0.1), every bias N(0, 0.1)."""
    with paddle.LazyGuard():
        jm = JUNet(JUNetConfig.tiny())
    rng = np.random.default_rng(41)
    params = {}
    for name, spec in jm.raw_state()[0].items():
        shape = tuple(spec.shape)
        w = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 4:                      # (out, in, kh, kw)
            w /= np.sqrt(np.prod(shape[1:]))
        elif len(shape) == 2:                    # (in, out)
            w /= np.sqrt(shape[0])
        elif "norm" in name and name.endswith("weight"):
            w = 1.0 + 0.1 * w
        else:
            w *= 0.1
        params[name] = w
    return jm, params


def _unets(junet):
    jm, params = junet
    jm.load_raw_state({k: jnp.asarray(v) for k, v in params.items()})
    tm = UNet2DConditionModel(UNetConfig.tiny(), device="cpu")
    tm.load_numpy_state(params)
    return jm, tm, params


def _batch(seed_value, b=2):
    cfg = UNetConfig.tiny()
    rng = np.random.default_rng(seed_value)
    lat = rng.standard_normal((b, cfg.in_channels, cfg.sample_size,
                               cfg.sample_size)).astype(np.float32)
    t = rng.integers(0, 1000, (b,))
    ctx = rng.standard_normal((b, CONTEXT, cfg.cross_attention_dim)
                              ).astype(np.float32)
    noise = rng.standard_normal(lat.shape).astype(np.float32)
    return lat, t, ctx, noise


def _jargs(lat, t, ctx, noise):
    return (jnp.asarray(lat), jnp.asarray(t.astype(np.int32)),
            jnp.asarray(ctx), jnp.asarray(noise))


def _targs(lat, t, ctx, noise):
    return (torch.from_numpy(lat), torch.from_numpy(t),
            torch.from_numpy(ctx), torch.from_numpy(noise))


def test_unet_names_and_shapes_match_jax(junet):
    jm, tm, params = _unets(junet)
    assert len(params) == 208
    assert {k: tuple(v.shape) for k, v in tm.named_parameters()} == {
        k: v.shape for k, v in params.items()}


def test_unet_output_loss_and_grads_match_jax(junet):
    jm, tm, params = _unets(junet)
    lat, t, ctx, noise = _batch(7)
    ja = _jargs(lat, t, ctx, noise)

    def jloss_fn(p):
        pred = functional_call(jm, p, *ja[:3])
        return jnp.mean((pred - ja[3]) ** 2), pred

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))({k: jnp.asarray(v)
                                  for k, v in params.items()})
    ta = _targs(lat, t, ctx, noise)
    out = tm(*ta[:3])
    assert out.shape == lat.shape
    assert _rel(_np(out), jout) <= TOL
    loss = F.mse_loss(out, ta[3])
    loss.backward()
    assert _err(float(loss.detach()), float(jloss)) <= LOSS_TOL
    for name, p in tm.named_parameters():
        assert _rel(_np(p.grad), np.asarray(jgrads[name])) <= GRAD_RTOL, name


def test_unet_train_steps_match_jax(junet):
    """Parameters after 3 AdamW steps of the denoising loss. Adam divides
    each gradient by its own running size, so an element whose gradient is
    within a few orders of eps (1e-8) turns rounding into a step of about
    lr in either package, in either direction (a few per mille of the 1x1
    projections' elements here). Held: the elements whose first gradient
    is at least ``ADAM_FLOOR`` (100 eps), each parameter's L2 distance from
    JAX's within 1e-4 of the L2 of JAX's update (measured: at most 2.6e-5);
    every element within 2 lr a step of JAX's."""
    jm, tm, init = _unets(junet)
    batches = [_batch(20 + i) for i in range(3)]
    jstep = JTrainStep(JUNetDenoiseLoss(jm), paddle.optimizer.AdamW(
        LR, parameters=jm.parameters(), weight_decay=0.01))
    jl = [float(jstep(*(paddle.to_tensor(np.asarray(a))
                        for a in _jargs(*bt)))) for bt in batches]
    jstep.sync_to_model()
    jp = {k: np.asarray(v, np.float64) for k, v in jm.raw_state()[0].items()}
    UNetDenoiseLoss(tm)(*_targs(*batches[0])).backward()
    first = {k: p.grad.abs().numpy() for k, p in tm.named_parameters()}
    step = TrainStep(UNetDenoiseLoss(tm), AdamW(
        LR, parameters=tm.named_parameters(), weight_decay=0.01))
    tl = [float(step(*_targs(*bt))) for bt in batches]
    assert _err(tl, jl) <= LOSS_TOL, (tl, jl)
    for name, p in tm.named_parameters():
        got, want = p.detach().double().numpy(), jp[name]
        assert np.abs(got - want).max() <= 2 * LR * len(batches), name
        keep = first[name] >= ADAM_FLOOR
        moved = np.linalg.norm((want - init[name])[keep])
        assert np.linalg.norm((got - want)[keep]) <= STEP_RTOL * moved, name


def test_unet_attention_runs_the_flash_wrappers(monkeypatch):
    """Every transformer's self- and cross-attention goes through the
    flash kernels' wrappers (on CPU tensors their plain versions, which the
    spies record), not causal; cross-attention reads the 77 context
    tokens."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    calls = []
    real = fa.flash_attention_fwd_ref

    def spy(q, k, v, causal, *a, **kw):
        calls.append((q.shape[1], k.shape[1], q.shape[2], causal))
        return real(q, k, v, causal, *a, **kw)

    monkeypatch.setattr(fa, "flash_attention_fwd_ref", spy)
    tm = UNet2DConditionModel(UNetConfig.tiny(), device="cpu",
                              generator=seed(5))
    lat, t, ctx, _ = _targs(*_batch(8))
    tm(lat, t, ctx)
    # tiny: one transformer in down block 0 (16 x 16, 4 heads of 8), the
    # mid block's (8 x 8, 4 heads of 16), two in the last up block
    assert sorted(calls) == sorted(
        [(256, 256, 8, False), (256, CONTEXT, 8, False)] * 3
        + [(64, 64, 16, False), (64, CONTEXT, 16, False)])


def test_unet_weights_come_from_the_generator():
    cfg = UNetConfig.tiny()
    a = UNet2DConditionModel(cfg, device="cpu", generator=seed(6))
    b = UNet2DConditionModel(cfg, device="cpu", generator=seed(6))
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
    # Linear takes the JAX Linear's XavierNormal scale
    w = a.time_embedding[1].weight
    std = float(w.detach().std())
    assert abs(std - np.sqrt(2.0 / (128 + 128))) < 0.1 * std


def test_sd15_parameter_count():
    """SD-1.5 at full width (built on the meta device: shapes only): the
    JAX package's count, 859,520,964 parameters in 686 tensors."""
    m = UNet2DConditionModel(UNetConfig.sd15(), device="meta",
                             generator=seed(0))
    params = list(m.parameters())
    assert len(params) == 686
    assert sum(p.numel() for p in params) == 859_520_964
    heads = {blk.attn1.head_dim for blk in (
        mod for mod in m.modules() if hasattr(mod, "attn1"))}
    assert heads == {40, 80, 160}
