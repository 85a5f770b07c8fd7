"""The port's training path against the JAX package's, on shared weights.

A tiny GQA Llama is built by the JAX package from a seed; its
``raw_state()`` carries into the port. The same numpy batches go through
JAX's jitted ``TrainStep`` and the port's eager one, both with AdamW,
global-norm clipping and ``LinearWarmup(CosineAnnealingDecay)``:
  - fp32 (JAX at ``jax_default_matmul_precision=highest``, conftest):
    losses and parameters after 3 steps within 1e-5, with and without
    ``grad_accum_steps=2``;
  - bf16 with ``multi_precision=True``: losses within 2e-3 and each f32
    master's update within 10% (L2) of JAX's (the two frameworks round
    bf16 at other places: JAX's CPU path runs dense bf16 attention, the
    port f32 flash);
  - ``fused_linear_cross_entropy`` loss and grads, chunked below the token
    count with ignored labels, within 1e-5 in fp32; in bf16 the loss
    within 1e-4 (f32 logits) and the bf16 grads within 1e-2 relative;
  - ``forward(ids, labels)``, the LR schedules (exactly), one Adam/AdamW
    update, and the ``TrainStep`` options the port refuses.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu.core.tensor import Parameter
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.hapi import TrainStep
from paddle_tpu_torch.incubate.nn import functional as FF
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr

TOL = 1e-5
LR, T_MAX, WARMUP = 1e-2, 10, 2


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _pair(seed, dtype=None):
    """A JAX tiny Llama and the port's copy of it on the CPU."""
    paddle.seed(seed)
    jmodel = JLlamaForCausalLM(JLlamaConfig.tiny())
    tdtype = torch.float32
    if dtype == "bfloat16":
        jmodel.to(dtype="bfloat16")
        tdtype = torch.bfloat16
    params, _ = jmodel.raw_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", dtype=tdtype)
    model.load_numpy_state({k: np.asarray(v) for k, v in params.items()})
    return jmodel, model


def _batches(n, b=4, s=16, vocab=256):
    rng = np.random.default_rng(n)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, s + 1))
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def _jax_run(jmodel, batches, accum, multi_precision=False, lr=LR):
    sched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(lr, T_max=T_MAX),
                             WARMUP, lr / 10, lr)
    opt = paddle.optimizer.AdamW(
        sched, parameters=jmodel.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
        multi_precision=multi_precision)
    step = JTrainStep(jmodel, opt, grad_accum_steps=accum)
    losses = [float(step(paddle.to_tensor(x.astype(np.int32)),
                         paddle.to_tensor(y.astype(np.int32))))
              for x, y in batches]
    step.sync_to_model()
    params = {k: np.asarray(v, np.float32)
              for k, v in jmodel.raw_state()[0].items()}
    master = step.opt_state.get("master")
    master = ({k: np.asarray(v) for k, v in master.items()}
              if master is not None else None)
    return losses, params, master


def _port_run(model, batches, accum, multi_precision=False, lr=LR):
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(lr, T_max=T_MAX),
                             WARMUP, lr / 10, lr)
    opt = AdamW(sched, parameters=model.named_parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0),
                multi_precision=multi_precision)
    step = TrainStep(model, opt, grad_accum_steps=accum)
    losses = []
    for x, y in batches:
        loss = step(torch.from_numpy(x), torch.from_numpy(y))
        assert loss.requires_grad is False and loss.dim() == 0
        losses.append(loss)
    losses = [float(v) for v in losses]
    assert step.sync() == losses[-1]
    params = {k: p.detach().float().numpy()
              for k, p in model.named_parameters()}
    return losses, params, opt


@pytest.mark.parametrize("accum", [1, 2], ids=["plain", "grad_accum2"])
def test_train_steps_match_jax(accum):
    jmodel, model = _pair(21)
    batches = _batches(3)
    jl, jp, _ = _jax_run(jmodel, batches, accum)
    tl, tp, _ = _port_run(model, batches, accum)
    assert _max_err(tl, jl) <= TOL, (tl, jl)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert _max_err(tp[k], jp[k]) <= TOL, k


def _update_err(got, want, init):
    """How far one set of f32 masters' update from ``init`` lies from the
    reference's: ``|got - want| / |want - init|`` in L2. A master that
    was never updated scores 1, one moved the wrong way 2."""
    moved = np.linalg.norm(want - init)
    return float(np.linalg.norm(got - want) / moved), float(moved)


def test_bf16_multi_precision_matches_jax():
    """At the fp32 tests' lr (an Adam step moves each element by about
    lr): each master's update agrees with JAX's within 10% in L2. Not
    elementwise: where the two frameworks' bf16 gradients are tiny they
    can differ in sign, and those elements part by up to 2 lr a step."""
    jmodel, model = _pair(22, "bfloat16")
    init = {k: p.detach().double().numpy()
            for k, p in model.named_parameters()}
    batches = _batches(3)
    jl, _, jmaster = _jax_run(jmodel, batches, 1, multi_precision=True)
    tl, _, opt = _port_run(model, batches, 1, multi_precision=True)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert _max_err(tl, jl) <= 2e-3, (tl, jl)
    sd = opt.state_dict()
    assert sorted(jmaster) == sorted(init)
    for k, w in jmaster.items():
        got = sd[f"{k}_fp32_master_0"]
        assert got.dtype == torch.float32
        err, moved = _update_err(got.double().numpy(), w, init[k])
        print(f"{k}: reference moved {moved:.3e} (L2), port off by "
              f"{err:.3f} of that")
        assert err <= 0.1, (k, err)
        # planted faults the check must catch: masters never updated, or
        # moved against the reference
        assert _update_err(init[k], w, init[k])[0] > 0.1
        assert _update_err(2 * init[k] - w, w, init[k])[0] > 0.1
        # the bf16 parameter is its master, rounded
        p = dict(model.named_parameters())[k]
        assert torch.equal(p.detach(), got.to(torch.bfloat16))
    assert sd["@step"] == 3 and "LR_Scheduler" in sd


@pytest.mark.parametrize("transpose_y", [False, True], ids=["untied", "tied"])
def test_fused_linear_cross_entropy_matches_jax(transpose_y):
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((2, 12, 16)).astype(np.float32)
    wshape = (40, 16) if transpose_y else (16, 40)
    weight = (rng.standard_normal(wshape) * 0.3).astype(np.float32)
    labels = rng.integers(0, 40, (2, 12))
    labels[0, 3] = labels[1, 7] = -100          # ignore_index
    labels[1, 0] = -1                            # any negative label
    jh = paddle.to_tensor(hidden, stop_gradient=False)
    jw = paddle.to_tensor(weight, stop_gradient=False)
    jloss = JIF.fused_linear_cross_entropy(
        jh, jw, paddle.to_tensor(labels.astype(np.int32)),
        transpose_y=transpose_y, chunk_tokens=5)
    jloss.backward()
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(weight).requires_grad_(True)
    tloss = FF.fused_linear_cross_entropy(
        th, tw, torch.from_numpy(labels), transpose_y=transpose_y,
        chunk_tokens=5)
    tloss.backward()
    assert _max_err(float(tloss.detach()), float(jloss)) <= TOL
    assert _max_err(th.grad.numpy(), jh.grad.numpy()) <= TOL
    assert _max_err(tw.grad.numpy(), jw.grad.numpy()) <= TOL


@pytest.mark.parametrize("transpose_y", [False, True], ids=["untied", "tied"])
def test_fused_linear_cross_entropy_bf16_matches_jax(transpose_y):
    """bf16 inputs: each chunk's logits stay f32, as JAX's
    ``preferred_element_type=float32``. The loss agrees within 1e-4, which
    logits rounded to bf16 before the softmax miss; the bf16 gradients
    within 1e-2 of their largest element (both sides round them)."""
    rng = np.random.default_rng(6)
    hidden = torch.from_numpy(
        rng.standard_normal((2, 12, 64)).astype(np.float32)).bfloat16()
    wshape = (40, 64) if transpose_y else (64, 40)
    weight = torch.from_numpy(
        (rng.standard_normal(wshape) * 0.3).astype(np.float32)).bfloat16()
    labels = rng.integers(0, 40, (2, 12))
    labels[0, 3] = -100
    jh, jw = (paddle.to_tensor(jnp.asarray(t.float().numpy(), jnp.bfloat16),
                               stop_gradient=False) for t in (hidden, weight))
    jloss = JIF.fused_linear_cross_entropy(
        jh, jw, paddle.to_tensor(labels.astype(np.int32)),
        transpose_y=transpose_y, chunk_tokens=5)
    jloss.backward()
    th, tw = (t.clone().requires_grad_(True) for t in (hidden, weight))
    tloss = FF.fused_linear_cross_entropy(
        th, tw, torch.from_numpy(labels), transpose_y=transpose_y,
        chunk_tokens=5)
    tloss.backward()
    want = float(jloss)
    assert tloss.dtype == torch.float32
    assert _max_err(float(tloss.detach()), want) <= 1e-4
    w2 = weight.t() if transpose_y else weight
    rounded = torch.nn.functional.cross_entropy(
        (hidden.reshape(-1, 64) @ w2).float(),
        torch.from_numpy(labels).reshape(-1), ignore_index=-100)
    assert _max_err(float(rounded), want) > 1e-4   # the check has teeth
    for got, ref in ((th.grad, jh.grad), (tw.grad, jw.grad)):
        assert got.dtype == torch.bfloat16
        ref = np.asarray(ref.numpy(), np.float32)
        assert (_max_err(got.float().numpy(), ref)
                <= 1e-2 * np.abs(ref).max())


def test_fused_linear_cross_entropy_all_ignored_is_zero():
    h = torch.ones(3, 4, requires_grad=True)
    loss = FF.fused_linear_cross_entropy(h, torch.ones(4, 5),
                                         torch.full((3,), -100))
    loss.backward()
    assert float(loss.detach()) == 0.0 and not h.grad.any()


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_forward_with_labels_matches_jax(tie):
    paddle.seed(23)
    jcfg = JLlamaConfig.tiny()
    jcfg.tie_word_embeddings = tie
    jmodel = JLlamaForCausalLM(jcfg)
    cfg = LlamaConfig.tiny()
    cfg.tie_word_embeddings = tie
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_numpy_state({k: np.asarray(v)
                            for k, v in jmodel.raw_state()[0].items()})
    (x, y), = _batches(1, b=2, s=23)
    want = float(jmodel(paddle.to_tensor(x.astype(np.int32)),
                        labels=paddle.to_tensor(y.astype(np.int32))))
    got = model(torch.from_numpy(x), labels=torch.from_numpy(y))
    assert got.dim() == 0
    assert _max_err(float(got.detach()), want) <= TOL
    assert cfg.num_params() == sum(p.numel() for p in model.parameters())
    assert cfg.num_params() == jcfg.num_params()


def test_lr_schedules_match_jax_exactly():
    pairs = [
        (jlr.LinearWarmup(jlr.CosineAnnealingDecay(0.1, T_max=15,
                                                   eta_min=1e-3), 5, 0.0,
                          0.1),
         tlr.LinearWarmup(tlr.CosineAnnealingDecay(0.1, T_max=15,
                                                   eta_min=1e-3), 5, 0.0,
                          0.1)),
        (jlr.CosineAnnealingDecay(3e-4, T_max=7),
         tlr.CosineAnnealingDecay(3e-4, T_max=7)),
        (jlr.LinearWarmup(0.5, 4, 0.1, 0.5), tlr.LinearWarmup(0.5, 4, 0.1,
                                                              0.5)),
    ]
    for j, t in pairs:
        seq_j, seq_t = [], []
        for _ in range(20):
            seq_j.append(j())
            seq_t.append(t())
            j.step()
            t.step()
        assert seq_t == seq_j


@pytest.mark.parametrize("cls,kw", [
    ("Adam", dict(weight_decay=0.1)),
    ("AdamW", dict(weight_decay=0.1)),
    ("AdamW", dict(weight_decay=0.1,
                   apply_decay_param_fun=lambda n: n != "b")),
], ids=["adam-coupled-wd", "adamw", "adamw-exclude"])
def test_optimizer_updates_match_jax(cls, kw):
    """Three eager steps of the reference optimizer (its ``apply_one``
    arithmetic) and the port's on the same parameters and gradients."""
    rng = np.random.default_rng(9)
    init = {n: rng.standard_normal((5, 3)).astype(np.float32)
            for n in ("a", "b")}
    grads = [{n: rng.standard_normal((5, 3)).astype(np.float32)
              for n in init} for _ in range(3)]
    jparams = {n: Parameter(v.copy(), name=n) for n, v in init.items()}
    jopt = getattr(paddle.optimizer, cls)(learning_rate=0.05,
                                          parameters=list(jparams.values()),
                                          **kw)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for n, v in init.items()}
    topt = {"Adam": Adam, "AdamW": AdamW}[cls](
        learning_rate=0.05, parameters=list(tparams.items()), **kw)
    for g in grads:
        for n in init:
            jparams[n].grad = paddle.to_tensor(g[n])
            tparams[n].grad = torch.from_numpy(g[n])
        jopt.step()
        topt.step()
    for n in init:
        assert _max_err(tparams[n].detach().numpy(),
                        jparams[n].numpy()) <= 1e-6, n


@pytest.mark.parametrize("kw,refused", [
    (dict(mesh=object()), TypeError),
    (dict(param_spec_fn=lambda n, v: None), ValueError),
    (dict(sharding_level=2), None),
    (dict(sharding_axis="dp"), None),
    (dict(gradient_merge_k=2), None),
    (dict(localsgd_k=2), ValueError),
    (dict(remat=True), None), (dict(metrics_every=5), None),
], ids=["mesh", "param_spec_fn", "sharding_level", "sharding_axis",
        "gradient_merge", "localsgd", "remat", "metrics_every"])
def test_refused_train_step_options(kw, refused):
    """A mesh must be a ``DeviceMesh`` and a parameter spec needs one (the
    hybrid step itself: tests/test_torch_hybrid_train.py); without a mesh
    a ZeRO level or axis is taken at level 0, as in the reference (ZeRO
    itself: tests/test_torch_sharding.py, tests/test_torch_zero_train.py),
    and LocalSGD, which needs a mesh with dp > 1, raises ``ValueError``
    (tests/test_torch_localsgd_dgc.py); gradient merge, remat and the
    metrics cadence are ported (tests/test_torch_train_fit.py holds them
    to JAX's) and take effect."""
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    opt = AdamW(1e-3, parameters=model.parameters())
    if refused:
        with pytest.raises(refused):
            TrainStep(model, opt, **kw)
        return
    step = TrainStep(model, opt, **kw)
    assert (step.gradient_merge_k, step.remat, step.metrics_every,
            step.sharding_level) == (
        kw.get("gradient_merge_k", 1), kw.get("remat", False),
        kw.get("metrics_every", 0), 0)


def test_loss_fn_and_state_dict():
    """``loss_fn(model(*batch[:-1]), batch[-1])``, and a state dict of
    parameters plus the optimizer's reference-named state."""
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    opt = AdamW(1e-3, parameters=model.named_parameters())
    ce = torch.nn.functional.cross_entropy
    step = TrainStep(model, opt, loss_fn=lambda logits, y: ce(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1)))
    (x, y), = _batches(1, b=2, s=8)
    loss = step(torch.from_numpy(x), torch.from_numpy(y))
    with torch.no_grad():
        ref = model.forward(torch.from_numpy(x), labels=torch.from_numpy(y))
    assert np.isfinite(float(loss)) and np.isfinite(float(ref))
    sd = step.state_dict()
    assert "lm_head.weight" in sd
    opt_sd = sd["@opt_state"]
    assert "lm_head.weight_moment1_0" in opt_sd
    assert "lm_head.weight_moment2_0" in opt_sd
    assert opt_sd["@step"] == 1
