"""The port's optimizers, LR schedulers, regularizers and AMP against the JAX
package's, on the CPU.

Every optimizer runs five eager steps on the same f32 parameters and
gradients in both packages (the reference's ``apply_one`` arithmetic on
each side): parameters within 1e-5 (the sums and powers run in another
order). Parameter groups (a group's ``learning_rate`` factor and
``weight_decay``) are held to the reference's per-parameter
``optimize_attr`` and a second optimizer for the second group; ``lr_ratio``
to ``optimize_attr``; ``L2Decay`` to the reference's; ``L1Decay`` to the
reference's optimizer fed ``g + c * sign(p)`` (the reference reads an L1
coefficient as an L2 one). ``amsgrad``, which the reference accepts but
does not apply, is held to a numpy transcription of Paddle's update.
``LBFGS`` with a closure, with and without its line search, after five
steps (1e-5). Each scheduler against the reference's over 12 steps
(exactly: the same float arithmetic). ``GradScaler`` (scale history and
parameters through an overflow) exactly, ``decorate`` (which parameters
are cast, the masters switched on) and ``auto_cast``'s casting decisions
against the reference's dispatch.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter, _maybe_amp_cast
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models.llama import LlamaDecoderLayer as JDecoderLayer
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.regularizer import L2Decay as JL2Decay
from paddle_tpu_torch import amp, optimizer as topt
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.llama import LlamaDecoderLayer
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

TOL = 1e-5
STEPS = 5
LR = 0.05


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _data(seed=9, names=("a", "b")):
    rng = np.random.default_rng(seed)
    init = {n: rng.standard_normal((5, 3)).astype(np.float32) for n in names}
    grads = [{n: rng.standard_normal((5, 3)).astype(np.float32)
              for n in init} for _ in range(STEPS)]
    return init, grads


def _jparams(init):
    return {n: Parameter(v.copy(), name=n) for n, v in init.items()}


def _tparams(init):
    return {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for n, v in init.items()}


def _run(jopts, topt_, jparams, tparams, grads, jgrad=None):
    for g in grads:
        for n in g:
            jg = g[n] if jgrad is None else jgrad(n, g[n], jparams[n])
            jparams[n].grad = paddle.to_tensor(jg)
            tparams[n].grad = torch.from_numpy(g[n])
        for o in jopts:
            o.step()
        topt_.step()
    for n in jparams:
        assert _max_err(tparams[n].detach().numpy(),
                        jparams[n].numpy()) <= TOL, n


OPTIMIZERS = [
    ("SGD", dict(weight_decay=0.1)),
    ("Momentum", dict(momentum=0.9, weight_decay=0.05)),
    ("Momentum", dict(momentum=0.8, use_nesterov=True)),
    ("Adam", dict(weight_decay=0.1)),
    ("AdamW", dict(weight_decay=0.1,
                   apply_decay_param_fun=lambda n: n != "b")),
    ("Adamax", dict(weight_decay=0.01)),
    ("RMSProp", dict(momentum=0.5, weight_decay=0.01)),
    ("RMSProp", dict(centered=True)),
    ("Adagrad", dict(initial_accumulator_value=0.1, weight_decay=0.01)),
    ("Adadelta", dict(weight_decay=0.01)),
    ("Lamb", dict(lamb_weight_decay=0.02)),
    ("LarsMomentum", dict(lars_weight_decay=0.01,
                          exclude_from_weight_decay=["b"])),
    ("NAdam", dict(weight_decay=0.01)),
    ("RAdam", dict(weight_decay=0.01)),
    ("ASGD", dict(batch_num=3, weight_decay=0.01)),
    ("Rprop", dict()),
]


@pytest.mark.parametrize("cls,kw", OPTIMIZERS, ids=[
    "sgd", "momentum", "momentum-nesterov", "adam", "adamw-exclude",
    "adamax", "rmsprop", "rmsprop-centered", "adagrad", "adadelta", "lamb",
    "lars", "nadam", "radam", "asgd", "rprop"])
def test_optimizer_matches_jax(cls, kw):
    init, grads = _data()
    jp, tp = _jparams(init), _tparams(init)
    jo = getattr(paddle.optimizer, cls)(learning_rate=LR,
                                        parameters=list(jp.values()), **kw)
    to = getattr(topt, cls)(learning_rate=LR, parameters=list(tp.items()),
                            **kw)
    _run([jo], to, jp, tp, grads)


def test_lamb_exclude_fn_takes_the_name():
    init, grads = _data(3)
    jp, tp = _jparams(init), _tparams(init)
    jo = paddle.optimizer.Lamb(LR, 0.1, parameters=list(jp.values()),
                               exclude_from_weight_decay_fn=lambda p:
                               p.name == "a")
    to = topt.Lamb(LR, 0.1, parameters=list(tp.items()),
                   exclude_from_weight_decay_fn=lambda n: n == "a")
    _run([jo], to, jp, tp, grads)


def test_parameter_groups_match_jax():
    """Group 1: factor 0.5 on the rate and its own decay; group 2: the
    optimizer's. The reference: ``optimize_attr`` and one optimizer per
    decay."""
    init, grads = _data(4)
    jp, tp = _jparams(init), _tparams(init)
    jp["a"].optimize_attr["learning_rate"] = 0.5
    jos = [paddle.optimizer.Adam(LR, parameters=[jp["a"]], weight_decay=0.1),
           paddle.optimizer.Adam(LR, parameters=[jp["b"]],
                                 weight_decay=0.01)]
    to = topt.Adam(LR, weight_decay=0.01, parameters=[
        {"params": [("a", tp["a"])], "learning_rate": 0.5,
         "weight_decay": 0.1},
        {"params": [("b", tp["b"])]}])
    _run(jos, to, jp, tp, grads)
    with pytest.raises(NotImplementedError):
        topt.Adam(LR, parameters=[{"params": [tp["a"]], "beta1": 0.5}])


def test_lr_ratio_matches_optimize_attr():
    """``lr_ratio(name)`` and a tensor's own ``optimize_attr`` factor, both
    held to the reference's ``optimize_attr``."""
    init, grads = _data(5)
    jp, tp = _jparams(init), _tparams(init)
    jp["b"].optimize_attr["learning_rate"] = 0.3
    jp["a"].optimize_attr["learning_rate"] = 0.7
    tp["a"].optimize_attr = {"learning_rate": 0.7}
    jo = paddle.optimizer.AdamW(LR, parameters=list(jp.values()))
    to = topt.AdamW(LR, parameters=list(tp.items()),
                    lr_ratio=lambda n: 0.3 if n == "b" else 1.0)
    _run([jo], to, jp, tp, grads)


@pytest.mark.parametrize("cls", ["SGD", "Momentum", "Adam"])
def test_regularizers_match_jax(cls):
    init, grads = _data(6)
    # L2Decay: the reference takes its coefficient
    jp, tp = _jparams(init), _tparams(init)
    jo = getattr(paddle.optimizer, cls)(learning_rate=LR,
                                        parameters=list(jp.values()),
                                        weight_decay=JL2Decay(0.1))
    to = getattr(topt, cls)(learning_rate=LR, parameters=list(tp.items()),
                            weight_decay=L2Decay(0.1))
    _run([jo], to, jp, tp, grads)
    # L1Decay: the reference optimizer fed g + c * sign(p)
    jp, tp = _jparams(init), _tparams(init)
    jo = getattr(paddle.optimizer, cls)(learning_rate=LR,
                                        parameters=list(jp.values()))
    to = getattr(topt, cls)(learning_rate=LR, parameters=list(tp.items()),
                            weight_decay=L1Decay(0.1))
    _run([jo], to, jp, tp, grads,
         jgrad=lambda n, g, p: g + 0.1 * np.sign(p.numpy()))
    with pytest.raises(TypeError):
        topt.AdamW(LR, parameters=list(tp.items()),
                   weight_decay=L1Decay(0.1))


def test_amsgrad_matches_paddle_update():
    init, grads = _data(7)
    tp = _tparams(init)
    to = topt.Adam(LR, parameters=list(tp.items()), amsgrad=True)
    b1, b2, eps = 0.9, 0.999, 1e-8
    ref = {n: v.astype(np.float64) for n, v in init.items()}
    m = {n: 0.0 for n in init}
    v = {n: 0.0 for n in init}
    vmax = {n: 0.0 for n in init}
    for t, g in enumerate(grads, 1):
        for n in init:
            tp[n].grad = torch.from_numpy(g[n])
            m[n] = b1 * m[n] + (1 - b1) * g[n]
            v[n] = b2 * v[n] + (1 - b2) * g[n] ** 2
            vmax[n] = np.maximum(vmax[n], v[n])
            ref[n] = ref[n] - LR * (m[n] / (1 - b1 ** t)) / (
                np.sqrt(vmax[n] / (1 - b2 ** t)) + eps)
        to.step()
    for n in init:
        assert _max_err(tp[n].detach().numpy(), ref[n]) <= TOL
    assert "a_moment2_max_0" in to.state_dict()


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_with_closure_matches_jax(line_search):
    rng = np.random.default_rng(8)
    a = rng.standard_normal((6, 6)).astype(np.float32)
    quad = (a @ a.T + 6 * np.eye(6)).astype(np.float32)
    rhs = rng.standard_normal(6).astype(np.float32)
    x0 = np.zeros(6, np.float32)
    jx = Parameter(x0.copy(), name="x")
    jq, jr = paddle.to_tensor(quad), paddle.to_tensor(rhs)
    jo = paddle.optimizer.LBFGS(0.1, parameters=[jx],
                                line_search_fn=line_search)

    def jclosure():
        jo.clear_grad()
        loss = 0.5 * (jx * paddle.matmul(jq, jx)).sum() - (jx * jr).sum()
        loss.backward()
        return loss

    tx = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    tq, tr = torch.from_numpy(quad), torch.from_numpy(rhs)
    to = topt.LBFGS(0.1, parameters=[("x", tx)], line_search_fn=line_search)

    def tclosure():
        to.clear_grad()
        loss = 0.5 * (tx * (tq @ tx)).sum() - (tx * tr).sum()
        loss.backward()
        return loss

    for _ in range(STEPS):
        jl = float(jo.step(jclosure))
        tl = float(to.step(tclosure).detach())
        assert abs(tl - jl) <= TOL * max(1.0, abs(jl))
    assert _max_err(tx.detach().numpy(), jx.numpy()) <= TOL


def test_step_closure_returns_its_loss():
    init, grads = _data(2)
    tp = _tparams(init)
    to = topt.SGD(LR, parameters=list(tp.items()))

    def closure():
        to.clear_grad()
        loss = sum((p * torch.from_numpy(grads[0][n])).sum()
                   for n, p in tp.items())
        loss.backward()
        return loss

    before = {n: p.detach().clone() for n, p in tp.items()}
    loss = to.step(closure)
    assert loss is not None
    for n, p in tp.items():
        assert torch.allclose(p.detach(), before[n]
                              - LR * torch.from_numpy(grads[0][n]))


SCHEDULERS = [
    ("NoamDecay", dict(d_model=64, warmup_steps=4, learning_rate=1.0)),
    ("PiecewiseDecay", dict(boundaries=[3, 7], values=[0.1, 0.05, 0.01])),
    ("NaturalExpDecay", dict(learning_rate=0.1, gamma=0.2)),
    ("InverseTimeDecay", dict(learning_rate=0.1, gamma=0.3)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=5, cycle=True)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=5, power=2.0)),
    ("LinearWarmup", dict(learning_rate=0.1, warmup_steps=3, start_lr=0.0,
                          end_lr=0.1)),
    ("ExponentialDecay", dict(learning_rate=0.1, gamma=0.8)),
    ("MultiStepDecay", dict(learning_rate=0.1, milestones=[2, 5, 9])),
    ("StepDecay", dict(learning_rate=0.1, step_size=3, gamma=0.5)),
    ("LambdaDecay", dict(learning_rate=0.1, lr_lambda=lambda e: 0.9 ** e)),
    ("MultiplicativeDecay", dict(learning_rate=0.1,
                                 lr_lambda=lambda e: 0.95)),
    ("CosineAnnealingDecay", dict(learning_rate=0.1, T_max=7, eta_min=0.01)),
    ("CosineAnnealingWarmRestarts", dict(learning_rate=0.1, T_0=3,
                                         T_mult=2)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=10)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=10,
                        anneal_strategy="linear")),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=3, mode="triangular2")),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=2, step_size_down=4, mode="exp_range",
                      exp_gamma=0.9)),
]


@pytest.mark.parametrize("cls,kw", SCHEDULERS, ids=[
    "noam", "piecewise", "natural_exp", "inverse_time", "poly-cycle",
    "poly-power", "linear_warmup", "exponential", "multistep", "step",
    "lambda", "multiplicative", "cosine", "cosine_restarts", "one_cycle",
    "one_cycle-linear", "cyclic-triangular2", "cyclic-exp_range"])
def test_scheduler_matches_jax_exactly(cls, kw):
    js, ts = getattr(jlr, cls)(**kw), getattr(tlr, cls)(**kw)
    for _ in range(12):
        assert ts() == js()
        js.step()
        ts.step()


def test_reduce_on_plateau_matches_jax_exactly():
    kw = dict(learning_rate=0.1, patience=1, factor=0.5, cooldown=1)
    js, ts = jlr.ReduceOnPlateau(**kw), tlr.ReduceOnPlateau(**kw)
    for metric in (3.0, 2.0, 2.5, 2.4, 2.6, 1.0, 1.1, 1.2, 1.3, 0.5):
        js.step(metric)
        ts.step(torch.tensor(metric))
        assert ts() == js() and ts.last_epoch == js.last_epoch


def test_grad_scaler_matches_jax():
    """Dynamic scaling through an overflow: the same scale history, the
    skipped update, and the same parameters."""
    init, grads = _data(10, names=("a",))
    grads[2]["a"][0, 0] = np.inf
    jp, tp = _jparams(init), _tparams(init)
    jo = paddle.optimizer.SGD(LR, parameters=list(jp.values()))
    to = topt.SGD(LR, parameters=list(tp.items()))
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)
    js, ts = paddle.amp.GradScaler(**kw), amp.GradScaler(**kw)
    for g in grads:
        scale = float(ts.get_loss_scaling())
        assert scale == float(js.get_loss_scaling().numpy())
        assert float(ts.scale(torch.tensor(2.0))) == 2.0 * scale
        jp["a"].grad = paddle.to_tensor(g["a"] * scale)
        tp["a"].grad = torch.from_numpy(g["a"] * scale)
        js.minimize(jo, None)
        ts.minimize(to, None)
        assert ts.state_dict() == js.state_dict()
    assert _max_err(tp["a"].detach().numpy(), jp["a"].numpy()) <= TOL


def test_decorate_matches_jax():
    """O2 casts every float parameter but the excluded layers' to bf16 and
    turns on the masters, as in the reference."""
    paddle.seed(1)
    jmodel = JLlamaForCausalLM(JLlamaConfig.tiny())
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    jo = paddle.optimizer.AdamW(1e-3, parameters=jmodel.parameters())
    to = topt.AdamW(1e-3, parameters=model.named_parameters())
    jmodel, jo = paddle.amp.decorate(jmodel, jo, level="O2",
                                     excluded_layers=[jmodel.llama.layers[1]])
    model, to = amp.decorate(model, to, level="O2",
                             excluded_layers=[model.llama.layers[1]])
    jd = {n: str(p._value.dtype) for n, p in jmodel.named_parameters()}
    td = {n: str(p.dtype).replace("torch.", "")
          for n, p in model.named_parameters()}
    assert td == jd and to._multi_precision and jo._multi_precision
    assert td["llama.layers.1.mlp.up_proj.weight"] == "float32"
    # a class excludes every instance
    model = amp.decorate(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"),
                         excluded_layers=LlamaDecoderLayer)
    jmodel = paddle.amp.decorate(JLlamaForCausalLM(JLlamaConfig.tiny()),
                                 excluded_layers=JDecoderLayer)
    assert ({n: str(p.dtype).replace("torch.", "")
             for n, p in model.named_parameters()}
            == {n: str(p._value.dtype)
                for n, p in jmodel.named_parameters()})


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", ["linear", "sdpa", "cross_entropy", "gelu"])
def test_auto_cast_decisions_match_jax(level, op):
    f32, b16 = np.zeros(2, np.float32), np.zeros(2, np.float32)
    with paddle.amp.auto_cast(level=level):
        want = [str(v.dtype) for v in _maybe_amp_cast(
            op, (jnp.asarray(f32), jnp.asarray(b16, jnp.bfloat16)))]
    with amp.auto_cast(level=level):
        got = [str(t.dtype).replace("torch.", "") for t in amp.amp_cast(
            op, torch.from_numpy(f32), torch.from_numpy(b16).bfloat16())]
    assert got == want
    assert amp.amp_cast(op, torch.zeros(2))[0].dtype == torch.float32
    assert amp.is_bfloat16_supported("cpu")
