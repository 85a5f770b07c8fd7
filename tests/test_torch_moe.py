"""The port's mixture of experts and MoE-GPT against the JAX package's, on
the CPU, on the same seeded numpy weights and inputs.

Tolerances (fp32; JAX at ``jax_default_matmul_precision=highest``):
  - ``top_k_dispatch``: combine and the aux loss within 1e-6, dispatch
    equal, for k = 1 and 2, with tokens dropped at capacity and with
    planted ties (rows of equal logits: ``jax.lax.top_k`` takes the lower
    expert first, and so must the port);
  - ``MoELayer`` (each gate, stacked and list experts, one layer dropping
    tokens): the output within 1e-5, every gradient of
    ``sum(out * r) + aux`` within 1e-4 of its largest element;
  - ``MoEGPTForCausalLM`` (tiny, 2 layers): the loss within 1e-5, every
    gradient within 1e-4 relative, and 3 ``TrainStep`` AdamW steps: losses
    within 1e-5, each parameter within 1e-3 of its update in L2 (Adam
    scales small gradients' rounding up to its step; the attention key
    bias, whose exact gradient is 0, held at rounding level instead);
  - bf16: the layer's output within 2e-2 of JAX's relative to its largest
    element, and the combine weights rounded to bf16 before the product.
Also the gate's loss cleared by every step, memwatch's ``train_step`` row,
the initializers' fans, and the refusals.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.jit import functional_call
from paddle_tpu.models.moe_gpt import MoEGPTConfig as JMoEGPTConfig
from paddle_tpu.models.moe_gpt import MoEGPTForCausalLM as JMoEGPT
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.nn.layer import Layer as JLayer
from paddle_tpu.nn.layers.common import Linear as JLinear
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.convert import load_state
from paddle_tpu_torch.device import seed
from paddle_tpu_torch.generation.program_cache import model_signature
from paddle_tpu_torch.hapi import TrainStep
from paddle_tpu_torch.incubate.distributed.models import moe
from paddle_tpu_torch.models import MoEGPTConfig, MoEGPTForCausalLM
from paddle_tpu_torch.nn import Linear, initializer
from paddle_tpu_torch.observability import memory as tmem
from paddle_tpu_torch.optimizer import AdamW

DISPATCH_TOL = 1e-6
TOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_RTOL = 1e-3
BF16_RTOL = 2e-2


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return _err(a, b) / max(float(np.max(np.abs(b))), 1e-30)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------- dispatch
def _logits(case, t=24, e=4):
    rng = np.random.default_rng({"random": 1, "ties": 2, "overflow": 3}[case])
    if case == "ties":
        # a coarse grid: most rows hold equal logits, a few all equal
        lg = rng.integers(0, 3, (t, e)).astype(np.float32)
        lg[::5] = 1.0
        return lg
    if case == "overflow":
        # most tokens prefer expert 0: it overflows its capacity
        lg = rng.standard_normal((t, e)).astype(np.float32)
        lg[:, 0] += 3.0
        return lg
    return rng.standard_normal((t, e)).astype(np.float32)


@pytest.mark.parametrize("k,case,capacity,aux", [
    (1, "random", 12, "switch"), (2, "random", 14, "gshard"),
    (1, "overflow", 6, "switch"), (2, "overflow", 6, "gshard"),
    (1, "ties", 8, "gshard"), (2, "ties", 9, "gshard"),
    (2, "random", 4, None)])
def test_top_k_dispatch_matches_jax(k, case, capacity, aux):
    lg = _logits(case)
    jc, jd, ja = jmoe.top_k_dispatch(jnp.asarray(lg), k, capacity, aux)
    tc, td, ta = moe.top_k_dispatch(torch.from_numpy(lg), k, capacity, aux)
    assert tc.shape == (lg.shape[0], lg.shape[1], capacity)
    assert _err(_np(tc), jc) <= DISPATCH_TOL
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert _err(float(ta), float(ja)) <= DISPATCH_TOL
    if case in ("overflow", "ties") and k == 2:
        # tokens were dropped: some rows keep fewer than k choices
        assert (td.sum(dim=(1, 2)) < k).any()


def test_ties_take_the_lower_expert():
    lg = np.zeros((6, 4), np.float32)
    combine, _, _ = moe.top_k_dispatch(torch.from_numpy(lg), 2, 8)
    chosen = (combine.sum(dim=2) > 0).numpy()
    assert chosen[:, :2].all() and not chosen[:, 2:].any()


# ----------------------------------------------------------------- MoELayer
class _JFFN(JLayer):
    def __init__(self, d, h):
        super().__init__()
        self.fc1 = JLinear(d, h)
        self.fc2 = JLinear(h, d)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


class _TFFN(torch.nn.Module):
    def __init__(self, d, h):
        super().__init__()
        self.fc1 = Linear(d, h, device="cpu")
        self.fc2 = Linear(h, d, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


D, H, E = 8, 16, 4


def _layers(gate, experts, capacity_factor, dtype="float32"):
    """The JAX MoELayer (built lazily) and the port's, both given seeded
    numpy weights of N(0, 0.3)."""
    kw = dict(gate=gate, top_k=1 if gate == "switch" else 2,
              capacity_factor=capacity_factor)
    with paddle.LazyGuard():
        if experts == "list":
            jl = jmoe.MoELayer(D, experts=[_JFFN(D, H) for _ in range(E)],
                               **kw)
        else:
            jl = jmoe.MoELayer(D, num_expert=E, d_hidden=H, **kw)
    if experts == "list":
        tl = moe.MoELayer(D, experts=[_TFFN(D, H) for _ in range(E)],
                          device="cpu", **kw)
    else:
        tl = moe.MoELayer(D, num_expert=E, d_hidden=H, device="cpu", **kw)
    rng = np.random.default_rng(11)
    named = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
             for k, v in jl.raw_state()[0].items()}
    assert sorted(named) == sorted(dict(tl.named_parameters()))
    jl.load_raw_state({k: jnp.asarray(v) for k, v in named.items()})
    load_state(tl, named)
    if dtype == "bfloat16":
        jl.to(dtype="bfloat16")
        tl.to(torch.bfloat16)
    return jl, tl, {k: jnp.asarray(v) for k, v in jl.raw_state()[0].items()}


def _jax_layer_grads(jl, params, x, r):
    def loss(p):
        out = functional_call(jl, p, jnp.asarray(x))
        aux = jl.gate.get_loss()
        aux = aux._value if hasattr(aux, "_value") else aux
        return jnp.sum(out * r) + aux, out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        dict(params))
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("gate,experts,cf", [
    ("naive", "stacked", 2.0), ("gshard", "stacked", 1.2),
    ("switch", "stacked", 1.2), ("gshard", "stacked", 0.5),
    ("naive", "list", 2.0)],
    ids=["naive", "gshard", "switch", "gshard-drops", "list-experts"])
def test_moe_layer_matches_jax(gate, experts, cf):
    jl, tl, params = _layers(gate, experts, cf)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    r = rng.standard_normal((2, 12, D)).astype(np.float32)
    jout, jgrads = _jax_layer_grads(jl, params, x, r)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tl(xt)
    loss = (out * torch.from_numpy(r)).sum() + tl.gate.get_loss()
    loss.backward()
    assert tl.gate.get_loss() is None
    assert _err(_np(out), jout) <= TOL
    for name, p in tl.named_parameters():
        assert _rel(_np(p.grad), jgrads[name]) <= GRAD_RTOL, name
    if cf < 1.0:
        cap = tl.capacity(24)
        assert cap == 6
        combine, _, _ = moe.top_k_dispatch(tl.gate(xt.reshape(-1, D)), 2, cap)
        assert ((combine > 0).sum(dim=(1, 2)) < 2).any()


def test_moe_layer_bf16_matches_jax_and_rounds_combine_first():
    jl, tl, params = _layers("gshard", "stacked", 1.2, "bfloat16")
    x = np.random.default_rng(13).standard_normal((2, 12, D)).astype(
        np.float32)
    jout = np.asarray(jax.jit(lambda p, a: functional_call(jl, p, a))(
        params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out = tl(xt)
    assert out.dtype == torch.bfloat16
    assert _rel(_np(out), jout) <= BF16_RTOL
    # the combine weights round to bf16 before the product, as the JAX
    # package casts them (the f32 product, rounded after, is another value)
    xf = xt.reshape(-1, D)
    cap = tl.capacity(24)
    combine, dispatch, _ = moe.top_k_dispatch(tl.gate(xf), 2, cap)
    disp = (dispatch.reshape(24, -1).to(xf.dtype).T @ xf).reshape(E, cap, D)
    eo = tl.experts(disp)
    want = combine.reshape(24, -1).to(torch.bfloat16) @ eo.reshape(-1, D)
    assert torch.equal(out.reshape(-1, D), want)


# ------------------------------------------------------------------ MoE-GPT
CFG = dict(num_hidden_layers=2)


@pytest.fixture(scope="module")
def jgpt():
    """The JAX tiny MoE-GPT (built lazily) and seeded numpy weights for it:
    N(0, 0.05) everywhere, the LayerNorm scales 1 + N(0, 0.05)."""
    with paddle.LazyGuard():
        jm = JMoEGPT(JMoEGPTConfig.tiny(**CFG))
    rng = np.random.default_rng(41)
    params = {}
    for name, spec in jm.raw_state()[0].items():
        w = rng.standard_normal(spec.shape).astype(np.float32) * 0.05
        is_scale = "ln_" in name and name.endswith("weight")
        params[name] = w + 1.0 if is_scale else w
    return jm, params


def _gpts(jgpt):
    """The JAX model at its initial weights and the port's copy."""
    jm, params = jgpt
    jm.load_raw_state({k: jnp.asarray(v) for k, v in params.items()})
    tm = MoEGPTForCausalLM(MoEGPTConfig.tiny(**CFG), device="cpu")
    tm.load_numpy_state(params)
    return jm, tm, params


def _batches(n, b=2, s=16, vocab=512):
    rng = np.random.default_rng(31)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, s + 1))
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def test_moe_gpt_loss_and_grads_match_jax(jgpt):
    jm, tm, params = _gpts(jgpt)
    x, y = _batches(1)[0]
    jx, jy = jnp.asarray(x.astype(np.int32)), jnp.asarray(y.astype(np.int32))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: functional_call(jm, p, jx, jy)))(dict(params))
    loss = tm(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert _err(float(loss), float(jloss)) <= TOL
    assert sorted(jgrads) == sorted(dict(tm.named_parameters()))
    for name, p in tm.named_parameters():
        assert _rel(_np(p.grad), np.asarray(jgrads[name])) <= GRAD_RTOL, name
        kb = _key_bias(name)
        if kb is not None:
            # no exact gradient: rounding level in both frameworks
            for g in (_np(p.grad), np.asarray(jgrads[name])):
                assert np.abs(g[kb]).max() <= 1e-6 * np.abs(g).max()
    # every gate's loss was collected and cleared by the forward
    assert tm.total_aux_loss() is None


def _key_bias(name):
    """The attention key bias's third of ``qkv_proj.bias``, else None."""
    if name.endswith("qkv_proj.bias"):
        h = MoEGPTConfig.tiny(**CFG).hidden_size
        return slice(h, 2 * h)
    return None


def test_moe_gpt_train_steps_match_jax(jgpt):
    """Parameters after 3 AdamW steps: each one's L2 distance from JAX's
    within 1e-3 of the L2 of JAX's update (measured: 2e-5 to 2e-4). Adam
    divides a gradient by its own running size, so an element whose
    gradient is within a few orders of eps (1e-8) turns its rounding
    difference into a visible share of a step; one whose gradient is at
    rounding level moves about lr a step in either framework, in any
    direction. The attention key bias is such (its exact gradient is 0,
    softmax being invariant to it; the grads test holds it at rounding
    level), and is left out."""
    jm, tm, init = _gpts(jgpt)
    batches = _batches(3)
    jopt = paddle.optimizer.AdamW(1e-2, parameters=jm.parameters(),
                                  weight_decay=0.01)
    jstep = JTrainStep(jm, jopt)
    jl = [float(jstep(paddle.to_tensor(x.astype(np.int32)),
                      paddle.to_tensor(y.astype(np.int32))))
          for x, y in batches]
    jstep.sync_to_model()
    jp = {k: np.asarray(v, np.float64) for k, v in jm.raw_state()[0].items()}
    step = TrainStep(tm, AdamW(1e-2, parameters=tm.named_parameters(),
                               weight_decay=0.01))
    tl = []
    for x, y in batches:
        tl.append(float(step(torch.from_numpy(x), torch.from_numpy(y))))
        # the step collected every gate's loss: no graph survives it
        assert all(not b.moe.gate.has_loss for b in tm.h if hasattr(b, "moe"))
    assert _err(tl, jl) <= TOL, (tl, jl)
    for name, p in tm.named_parameters():
        got = p.detach().double().numpy()
        want, start = jp[name], np.asarray(init[name], np.float64)
        kb = _key_bias(name)
        if kb is not None:
            keep = np.ones(got.shape, bool)
            keep[kb] = False
            got, want, start = got[keep], want[keep], start[keep]
        moved = np.linalg.norm(want - start)
        assert np.linalg.norm(got - want) <= PARAM_RTOL * moved, name


class _AuxLoss:
    """``Model.prepare``'s loss for MoE-GPT: cross entropy over the logits
    plus ``aux_loss_weight`` x the gates' losses, collected (and cleared)
    through ``total_aux_loss`` as the model's own labelled forward does."""

    def __init__(self, model, ce, weight):
        self.model, self.ce, self.weight = model, ce, weight

    def __call__(self, logits, labels):
        loss = self.ce(logits.reshape([-1, logits.shape[-1]]),
                       labels.reshape([-1]))
        return loss + self.weight * self.model.total_aux_loss()


def test_moe_gpt_fit_matches_jax(jgpt):
    """``Model.fit`` (3 steps, the loss read every step) with the gates'
    loss in the user's loss: losses within 1e-5 of the JAX package's fit
    over the same batches, every gate's loss cleared by each step."""
    import paddle_tpu.io as jio
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.hapi import Model as JModel
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.nn import functional as F

    jm, tm, _ = _gpts(jgpt)
    ids = np.random.default_rng(33).integers(0, 512, (6, 17))
    x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)
    weight = MoEGPTConfig.tiny().aux_loss_weight
    jfit = JModel(jm)
    jfit.prepare(paddle.optimizer.AdamW(1e-2, parameters=jm.parameters()),
                 loss=_AuxLoss(jm, JF.cross_entropy, weight))
    jlosses = []

    class JRec(paddle.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            jlosses.append(logs["loss"])

    jfit.fit(jio.DataLoader(jio.TensorDataset([x, y]), batch_size=2,
                            shuffle=False, use_shared_memory=False,
                            use_buffer_reader=False),
             verbose=0, metrics_every=1, callbacks=[JRec()])
    tlosses = []

    class TRec(Callback):
        def on_train_batch_end(self, step, logs=None):
            tlosses.append(logs["loss"])
            assert all(not b.moe.gate.has_loss for b in tm.h
                       if hasattr(b, "moe"))

    tfit = Model(tm)
    tfit.prepare(AdamW(1e-2, parameters=tm.named_parameters()),
                 loss=_AuxLoss(tm, F.cross_entropy, weight))
    tfit.fit(tio.TensorDataset([torch.from_numpy(x).long(),
                                torch.from_numpy(y).long()]),
             batch_size=2, shuffle=False, verbose=0, metrics_every=1,
             callbacks=[TRec()])
    assert len(tlosses) == len(jlosses) == 3
    assert _err(tlosses, jlosses) <= TOL, (tlosses, jlosses)


def test_memwatch_row_captures_moe_gpt():
    tflags.set_flags({"telemetry": True, "memwatch": True})
    tmem.clear_program_table()
    try:
        tm = MoEGPTForCausalLM(MoEGPTConfig.tiny(**CFG), device="cpu",
                               generator=seed(3))
        step = TrainStep(tm, AdamW(1e-3, parameters=tm.named_parameters()))
        x, y = _batches(1)[0]
        step(torch.from_numpy(x), torch.from_numpy(y))
        step(torch.from_numpy(x), torch.from_numpy(y))
        sig = model_signature(tm)[:8]
        rows = [r for r in tmem.program_table()
                if r["kind"] == "train_step" and r["model"] == sig]
        assert len(rows) == 1 and rows[0]["captures"] == 1
        assert rows[0]["bucket"] == 2
        nbytes = sum(p.numel() * 4 for p in tm.parameters())
        assert rows[0]["argument"] > nbytes and rows[0]["alias"] > nbytes
    finally:
        tflags.reset_flags()
        tmem.clear_program_table()


def test_moe_gpt_weights_come_from_the_generator():
    cfg = MoEGPTConfig.tiny(**CFG)
    a = MoEGPTForCausalLM(cfg, device="cpu", generator=seed(5))
    b = MoEGPTForCausalLM(cfg, device="cpu", generator=seed(5))
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
    w1 = a.h[1].moe.experts.w1
    # XavierUniform at the JAX package's 3-D fans: fan-in d*h, fan-out E*h
    limit = np.sqrt(6.0 / (64 * 256 + 4 * 256))
    assert float(w1.abs().max()) <= limit
    assert float(w1.abs().max()) > 0.9 * limit


# -------------------------------------------------------------- initializers
@pytest.mark.parametrize("shape", [(5,), (3, 4), (8, 64, 256), (2, 3, 4, 5)])
def test_fans_match_jax(shape):
    assert initializer._fans(shape) == jinit._fans(shape)


def test_initializers_draw_from_the_generator():
    def draw(init, g):
        return init((64, 32), "cpu", torch.float32, g)

    for init in (initializer.XavierNormal(), initializer.XavierUniform(),
                 initializer.Uniform(-0.5, 0.5)):
        a, b = draw(init, seed(1)), draw(init, seed(1))
        assert torch.equal(a, b) and not torch.equal(a, draw(init, seed(2)))
    assert torch.equal(initializer.Constant(0.5)((2, 3), "cpu",
                                                 torch.float32),
                       torch.full((2, 3), 0.5))
    std = float(draw(initializer.XavierNormal(gain=2.0), seed(3)).std())
    assert abs(std - 2.0 * np.sqrt(2.0 / 96)) < 0.05 * std


# ------------------------------------------------------------------ refusals
class _DpGroup:
    axis_name = "dp"


def _experts_on_dp(m):
    ex = getattr(m, "experts", m)
    return all(p.dist_attr == ("dp", None, None) for p in ex.parameters())


# expert parallelism is ported: moe_group / expert_axis / a gate's group
# build and declare the axis (the step cuts the stacks, the gate stores
# its group, as the reference's); mp_group and recompute_interval, which
# the reference stores and ignores, still raise
@pytest.mark.parametrize("build,accepted", [
    (lambda: moe.MoELayer(8, num_expert=2, d_hidden=8, moe_group=_DpGroup(),
                          device="cpu"), _experts_on_dp),
    (lambda: moe.MoELayer(8, num_expert=2, d_hidden=8, mp_group=object(),
                          device="cpu"), None),
    (lambda: moe.MoELayer(8, num_expert=2, d_hidden=8, expert_axis="dp",
                          device="cpu"), _experts_on_dp),
    (lambda: moe.MoELayer(8, num_expert=2, d_hidden=8, recompute_interval=1,
                          device="cpu"), None),
    (lambda: moe.Experts(2, 8, 8, expert_axis="dp", device="cpu"),
     _experts_on_dp),
    (lambda: moe.GShardGate(8, 2, group=_DpGroup, device="cpu"),
     lambda g: g.group is _DpGroup),
    (lambda: moe.SwitchGate(8, 2, group=_DpGroup, device="cpu"),
     lambda g: g.group is _DpGroup),
    (lambda: MoEGPTForCausalLM(dataclasses.replace(
        MoEGPTConfig.tiny(**CFG), expert_axis="dp"), device="cpu"),
     lambda m: _experts_on_dp(m.h[1].moe)),
], ids=["moe_group", "mp_group", "expert_axis", "recompute_interval",
        "experts-expert_axis", "gshard-group", "switch-group",
        "moe_gpt-expert_axis"])
def test_expert_parallelism_is_refused(build, accepted):
    if accepted is None:
        with pytest.raises(NotImplementedError):
            build()
    else:
        assert accepted(build())


def test_gates_keep_the_reference_options():
    g = moe.GShardGate(8, 4, random_routing=False, device="cpu")
    assert g.random_routing is False and g.capacity_factor == (1.2, 2.4)
    s = moe.SwitchGate(8, 4, switch_eps=0.2, device="cpu")
    assert s.top_k == 1 and s.switch_eps == 0.2
    assert moe.MoELayer(8, num_expert=4, d_hidden=8, gate={"type": "naive"},
                        device="cpu").gate.aux_loss_mode is None
    assert moe.MoELayer(8, num_expert=4, d_hidden=8,
                        device="cpu").capacity(2) == 4


def test_moe_gpt_attention_runs_the_flash_wrappers(monkeypatch):
    """Every block's attention goes through the flash kernels' wrappers
    (on CPU tensors their plain versions, which the spies count): forward,
    dq and dk/dv once a layer, causal."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    calls = []
    # the causal flag's position: after q, k, v (forward) or after q, k,
    # v, dO, lse, delta (backward)
    for name, at in (("flash_attention_fwd_ref", 3),
                     ("flash_attention_bwd_dq_ref", 6),
                     ("flash_attention_bwd_dkv_ref", 6)):
        real = getattr(fa, name)

        def spy(*a, _real=real, _name=name, _at=at, **k):
            calls.append((_name, a[_at]))
            return _real(*a, **k)
        monkeypatch.setattr(fa, name, spy)
    tm = MoEGPTForCausalLM(MoEGPTConfig.tiny(**CFG), device="cpu",
                           generator=seed(4))
    x, y = (torch.from_numpy(v) for v in _batches(1)[0])
    tm(x, y).backward()
    names = sorted(n for n, _ in calls)
    assert names == sorted(["flash_attention_fwd_ref"] * 2
                           + ["flash_attention_bwd_dq_ref"] * 2
                           + ["flash_attention_bwd_dkv_ref"] * 2)
    assert all(c is True for _, c in calls)
