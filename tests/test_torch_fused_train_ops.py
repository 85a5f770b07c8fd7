"""The port's training-side fused ops and fused layers
(``incubate.nn.functional``, ``incubate.nn``) and the functions they
reach (``relu``, ``softmax``, ``linear``) against the JAX package's, on
the CPU, on the same seeded numpy weights and inputs.

Tolerance: 1e-5 absolute in fp32 (JAX at
``jax_default_matmul_precision=highest``), at dropout 0 or outside
training. Dropout itself is held by law: in training the kept share is
``1 - p`` (within 0.02 on 16 k draws), every kept value is ``x / (1 - p)``,
one generator seed gives one mask and another seed another; without a
generator training dropout raises. The JAX fused layers always drop out
at their functionals' defaults, so each port layer in eval mode is held
to the JAX functional on the JAX layer's weights at rate 0. Also: the
fused attention's unmasked eval call reaches the flash route non-causal,
and the refusals raise ``NotImplementedError``.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as jinn
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.device import seed
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.incubate.nn import functional as FF
from paddle_tpu_torch.nn import functional as F

TOL = 1e-5
B, S, D, NH = 2, 5, 16, 2
DH = D // NH
FFN = 32


def _err(a, b):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _j(a):
    return None if a is None else paddle.to_tensor(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jnp(out):
    return np.asarray(out.numpy() if hasattr(out, "numpy") else out)


# ------------------------------------------------------------ nn.functional
def test_relu_softmax_linear_match_jax():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 3, 7), _rand(rng, 7, 4), _rand(rng, 4)
    assert _err(F.relu(_t(x)), JF.relu(_j(x)).numpy()) == 0.0
    for axis in (-1, 0):
        assert _err(F.softmax(_t(x), axis=axis),
                    JF.softmax(_j(x), axis=axis).numpy()) <= TOL
    assert F.softmax(_t(x).to(torch.bfloat16), dtype="float32").dtype \
        == torch.float32
    assert _err(F.linear(_t(x), _t(w), _t(b)),
                JF.linear(_j(x), _j(w), _j(b)).numpy()) <= TOL


# ------------------------------------------------------------- norms, adds
@pytest.mark.parametrize("case", ["residual", "plain", "axis1"])
def test_fused_layer_norm_matches_jax(case):
    rng = np.random.default_rng(1)
    x = _rand(rng, B, 3, 8, scale=3.0)
    shape = (3, 8) if case == "axis1" else (8,)
    w, b = _rand(rng, *shape) + 1.0, _rand(rng, *shape)
    kw = dict(begin_norm_axis=1) if case == "axis1" else {}
    extra = {}
    if case == "residual":
        extra = dict(bias=_rand(rng, 8), residual=_rand(rng, B, 3, 8))
    want = JIF.fused_layer_norm(_j(x), _j(w), _j(b), 1e-5, **kw,
                                **{k: _j(v) for k, v in extra.items()})
    got = FF.fused_layer_norm(_t(x), _t(w), _t(b), 1e-5, **kw,
                              **{k: _t(v) for k, v in extra.items()})
    if case == "residual":
        assert _err(got[0], _jnp(want[0])) <= TOL
        assert _err(got[1], _jnp(want[1])) <= TOL
    else:
        assert _err(got, _jnp(want)) <= TOL


def test_fused_dropout_add_and_residual_ln_match_jax_without_dropout():
    rng = np.random.default_rng(2)
    x, y = _rand(rng, B, S, D), _rand(rng, B, S, D)
    for kw in (dict(p=0.5, training=False), dict(p=0.0),
               dict(p=0.3, training=False, mode="downscale_in_infer")):
        assert _err(FF.fused_dropout_add(_t(x), _t(y), **kw),
                    JIF.fused_dropout_add(_j(x), _j(y), **kw).numpy()) <= TOL
    bias, sc, sh = _rand(rng, D), _rand(rng, D) + 1.0, _rand(rng, D)
    for kw in (dict(dropout_rate=0.5, training=False),
               dict(dropout_rate=0.0)):
        want = JIF.fused_bias_dropout_residual_layer_norm(
            _j(x), _j(y), _j(bias), _j(sc), _j(sh), **kw).numpy()
        got = FF.fused_bias_dropout_residual_layer_norm(
            _t(x), _t(y), _t(bias), _t(sc), _t(sh), **kw)
        assert _err(got, want) <= TOL


@pytest.mark.parametrize("op", ["dropout_add", "bias_dropout_residual_ln",
                                "mha", "feedforward"])
def test_training_dropout_law(op, monkeypatch):
    """Kept share ``1 - p``, kept values scaled by ``1 / (1 - p)``, one
    mask a generator seed; no generator raises."""
    p = 0.3
    x = torch.ones(4, 64, 64)
    zero = torch.zeros_like(x)
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(_rand(rng, 3, 4, 16, 64, scale=0.1))
    lw = torch.eye(64)
    w1, w2 = torch.eye(64), torch.eye(64)

    def run(g):
        if op == "dropout_add":
            return FF.fused_dropout_add(x, zero, p=p, generator=g)
        if op == "bias_dropout_residual_ln":
            # the LayerNorm of (dropout(x) + 0) for a row of ones and
            # zeros: keep the pre-norm values through a spy instead
            seen = []
            real = F.layer_norm

            def spy(h, *a, **k):
                seen.append(h)
                return real(h, *a, **k)
            with monkeypatch.context() as m:
                m.setattr(F, "layer_norm", spy)
                FF.fused_bias_dropout_residual_layer_norm(
                    x, zero, dropout_rate=p, generator=g)
            return seen[0]
        if op == "mha":
            # attention dropout off; the output dropout of an identity
            # projection of constant rows
            xi = torch.zeros(4, 64, 64)
            out = FF.fused_multi_head_attention(
                xi, qkv * 0.0, lw, attn_dropout_rate=0.0, dropout_rate=p,
                add_residual=False, pre_layer_norm=True, generator=g,
                linear_bias=torch.ones(64))
            return out
        # pre-LN of constant rows is 0: the output is x + dropout(bias)
        return FF.fused_feedforward(x, w1, w2, linear2_bias=torch.ones(64),
                                    dropout1_rate=0.0, dropout2_rate=p,
                                    activation="relu", pre_layer_norm=True,
                                    generator=g) - x

    a, b, c = run(seed(7)), run(seed(7)), run(seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.02
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / (1 - p)))
    with pytest.raises(ValueError, match="generator"):
        run(None)


# ----------------------------------------------------------------- matmuls
@pytest.mark.parametrize("tw", [False, True])
def test_fused_linear_and_matmul_bias_match_jax(tw):
    rng = np.random.default_rng(4)
    x, b = _rand(rng, B, S, 6), _rand(rng, 4)
    w = _rand(rng, 4, 6) if tw else _rand(rng, 6, 4)
    assert _err(FF.fused_linear(_t(x), _t(w), _t(b), transpose_weight=tw),
                JIF.fused_linear(_j(x), _j(w), _j(b),
                                 transpose_weight=tw).numpy()) <= TOL
    xm = _rand(rng, B, 6, S) if tw else x
    assert _err(FF.fused_matmul_bias(_t(xm), _t(w), _t(b), transpose_x=tw,
                                     transpose_y=tw),
                JIF.fused_matmul_bias(_j(xm), _j(w), _j(b), transpose_x=tw,
                                      transpose_y=tw).numpy()) <= TOL


@pytest.mark.parametrize("act", ["gelu", "relu", "none"])
def test_fused_linear_activation_matches_jax(act):
    rng = np.random.default_rng(5)
    x, y, b = _rand(rng, 6, 3), _rand(rng, 4, 6), _rand(rng, 4)
    kw = dict(trans_x=True, trans_y=True, activation=act)
    assert _err(FF.fused_linear_activation(_t(x), _t(y), _t(b), **kw),
                JIF.fused_linear_activation(_j(x), _j(y), _j(b),
                                            **kw).numpy()) <= TOL


def test_swiglu_matches_jax():
    rng = np.random.default_rng(6)
    x, y = _rand(rng, B, S, 8), _rand(rng, B, S, 8)
    assert _err(FF.swiglu(_t(x), _t(y)),
                JIF.swiglu(_j(x), _j(y)).numpy()) <= TOL
    assert _err(FF.swiglu(_t(x)), JIF.swiglu(_j(x)).numpy()) <= TOL


# --------------------------------------------------------------- attention
def _mha_args(rng, case):
    a = dict(x=_rand(rng, B, S, D), qkv_weight=_rand(rng, 3, NH, DH, D,
                                                     scale=0.3),
             linear_weight=_rand(rng, D, D, scale=0.3))
    kw = dict(training=False)
    if case in ("post_ln", "mask", "cache"):
        a.update(qkv_bias=_rand(rng, 3, NH, DH), linear_bias=_rand(rng, D),
                 ln_scale=_rand(rng, D) + 1.0, ln_bias=_rand(rng, D))
    if case == "pre_ln":
        a.update(pre_ln_scale=_rand(rng, D) + 1.0, pre_ln_bias=_rand(rng, D))
        kw.update(pre_layer_norm=True)
    if case == "mask":
        a.update(attn_mask=_rand(rng, B, 1, S, S))
    if case == "cache":
        a.update(cache_kv=_rand(rng, 2, B, 3, NH, DH))
    if case == "no_residual":
        kw.update(add_residual=False, dropout_rate=0.0, attn_dropout_rate=0.0,
                  training=True)
    return a, kw


@pytest.mark.parametrize("case", ["post_ln", "pre_ln", "mask", "cache",
                                  "no_residual"])
def test_fused_multi_head_attention_matches_jax(case, monkeypatch):
    a, kw = _mha_args(np.random.default_rng(7), case)
    x = a.pop("x")
    want = JIF.fused_multi_head_attention(
        _j(x), **{k: _j(v) for k, v in a.items()}, **kw).numpy()
    routes = []
    real = F.flash_attention_bshd

    def spy(q, k, v, **k2):
        routes.append(k2.get("causal"))
        return real(q, k, v, **k2)

    monkeypatch.setattr(F, "flash_attention_bshd", spy)
    got = FF.fused_multi_head_attention(
        _t(x), **{k: _t(v) for k, v in a.items()}, **kw)
    assert _err(got, want) <= TOL
    # unmasked, no training dropout: the flash route, not causal
    assert routes == ([] if case == "mask" else [False])


@pytest.mark.parametrize("act,pre", [("relu", False), ("gelu", True)])
def test_fused_feedforward_matches_jax(act, pre):
    rng = np.random.default_rng(8)
    # weights of std 1/sqrt(fan-in): O(1) outputs, 1e-5 near f32's ulp
    a = dict(x=_rand(rng, B, S, D),
             linear1_weight=_rand(rng, D, FFN, scale=D ** -0.5),
             linear2_weight=_rand(rng, FFN, D, scale=FFN ** -0.5),
             linear1_bias=_rand(rng, FFN),
             linear2_bias=_rand(rng, D), ln1_scale=_rand(rng, D) + 1.0,
             ln1_bias=_rand(rng, D), ln2_scale=_rand(rng, D) + 1.0,
             ln2_bias=_rand(rng, D))
    kw = dict(activation=act, pre_layer_norm=pre, training=False)
    x = a.pop("x")
    want = JIF.fused_feedforward(_j(x), **{k: _j(v) for k, v in a.items()},
                                 **kw).numpy()
    got = FF.fused_feedforward(_t(x), **{k: _t(v) for k, v in a.items()},
                               **kw)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_ec_moe_matches_jax(act):
    rng = np.random.default_rng(9)
    e = 3
    args = (_rand(rng, B, S, 8), _rand(rng, B, S, e), _rand(rng, e, 8, 12),
            _rand(rng, e, 12), _rand(rng, e, 12, 8), _rand(rng, e, 8))
    want = JIF.fused_ec_moe(*[_j(v) for v in args], act_type=act).numpy()
    got = FF.fused_ec_moe(*[_t(v) for v in args], act_type=act)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
@pytest.mark.parametrize("case", ["positions", "tables", "tables+positions",
                                  "computed", "time_major",
                                  "time_major_computed"])
def test_fused_rotary_position_embedding_matches_jax(case, neox):
    rng = np.random.default_rng(10)
    tm = case.startswith("time_major")
    q = _rand(rng, *((S, B, NH, DH) if tm else (B, S, NH, DH)))
    k = _rand(rng, *q.shape)
    kw = dict(use_neox_rotary_style=neox, time_major=tm)
    pos = rng.integers(0, 40, (B, S)).astype(np.int64)
    if case in ("positions", "tables+positions"):
        kw["position_ids"] = pos
    if case.startswith("tables") or case == "time_major":
        n = 40 if case == "tables+positions" else S
        kw["sin"], kw["cos"] = _rand(rng, n, DH), _rand(rng, n, DH)
    jkw = {k2: (_j(v) if isinstance(v, np.ndarray) else v)
           for k2, v in kw.items()}
    tkw = {k2: (_t(v) if isinstance(v, np.ndarray) else v)
           for k2, v in kw.items()}
    want = JIF.fused_rotary_position_embedding(_j(q), _j(k), None, **jkw)
    got = FF.fused_rotary_position_embedding(_t(q), _t(k), None, **tkw)
    assert got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        assert _err(g, _jnp(w)) <= TOL


# ------------------------------------------------------------------ layers
def _port_layer(cls, *args, **kw):
    return cls(*args, device="cpu", generator=seed(1), **kw)


def _jax_layer(cls, *args, **kw):
    """A JAX layer built lazily (no random draw), its weights loaded
    later."""
    with paddle.LazyGuard():
        return cls(*args, **kw)


def _load(layer, jlayer, seed_value):
    """Seeded numpy weights (N(0, 0.3); LayerNorm scales 1 + N(0, 0.3))
    into the JAX layer and the port's; returns them as JAX tensors."""
    rng = np.random.default_rng(seed_value)
    named = {}
    for k, spec in jlayer.raw_state()[0].items():
        w = _rand(rng, *spec.shape, scale=0.3)
        named[k] = w + 1.0 if "ln_scale" in k else w
    assert sorted(named) == sorted(dict(layer.named_parameters()))
    jlayer.load_raw_state({k: paddle.to_tensor(v)._value
                           for k, v in named.items()})
    with torch.no_grad():
        for k, p in layer.named_parameters():
            p.copy_(torch.from_numpy(named[k]))
    return {k: paddle.to_tensor(v) for k, v in named.items()}


@pytest.mark.parametrize("tw", [False, True])
def test_fused_linear_layer_matches_jax(tw):
    jl = _jax_layer(jinn.FusedLinear, 6, 4, transpose_weight=tw)
    tl = _port_layer(tinn.FusedLinear, 6, 4, transpose_weight=tw)
    _load(tl, jl, 12)
    x = _rand(np.random.default_rng(12), B, S, 6)
    assert _err(tl(_t(x)), jl(_j(x)).numpy()) <= TOL
    assert _port_layer(tinn.FusedLinear, 6, 4, bias_attr=False).bias is None


def test_fused_bias_dropout_residual_layer_norm_layer_matches_jax():
    jl = _jax_layer(jinn.FusedBiasDropoutResidualLayerNorm, D,
                    dropout_rate=0.5)
    tl = _port_layer(tinn.FusedBiasDropoutResidualLayerNorm, D,
                     dropout_rate=0.5)
    _load(tl, jl, 13)
    jl.eval()
    tl.eval()
    rng = np.random.default_rng(13)
    x, r = _rand(rng, B, S, D), _rand(rng, B, S, D)
    assert _err(tl(_t(x), _t(r)), jl(_j(x), _j(r)).numpy()) <= TOL


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_fused_encoder_layers_match_jax_functionals(pre):
    """FusedMultiHeadAttention, FusedFeedForward and
    FusedTransformerEncoderLayer in eval mode against the JAX functionals
    on the JAX layers' weights at rate 0 (the JAX layers drop out even in
    eval mode)."""
    jl = _jax_layer(jinn.FusedTransformerEncoderLayer, D, NH, FFN,
                    activation="gelu", normalize_before=pre)
    tl = _port_layer(tinn.FusedTransformerEncoderLayer, D, NH, FFN,
                     activation="gelu", normalize_before=pre).eval()
    w = _load(tl, jl, 14)
    rng = np.random.default_rng(14)
    x, mask = _rand(rng, B, S, D), _rand(rng, B, 1, S, S)
    off = dict(training=False)
    ja = JIF.fused_multi_head_attention(
        _j(x), w["attn.qkv_weight"], w["attn.linear_weight"],
        pre_layer_norm=pre, attn_mask=_j(mask), **off)
    jf = JIF.fused_feedforward(ja, w["ffn.w1"], w["ffn.w2"],
                               activation="gelu", pre_layer_norm=pre, **off)
    ta = tl.attn(_t(x), attn_mask=_t(mask))
    assert _err(ta, ja.numpy()) <= TOL
    assert _err(tl.ffn(ta), jf.numpy()) <= TOL
    assert _err(tl(_t(x), src_mask=_t(mask)), jf.numpy()) <= TOL


def test_fused_multi_transformer_layer_matches_jax_functional():
    tl = _port_layer(tinn.FusedMultiTransformer, D, NH, FFN,
                     num_layers=2).eval()
    with torch.no_grad():
        for p in tl.parameters():     # biases away from their zeros
            p.add_(0.1 * torch.randn(p.shape, generator=seed(2)))
    lists = [[paddle.to_tensor(p.detach().numpy()) for p in getattr(tl, k)]
             for k in ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases",
                       "out_weights", "out_biases", "ffn_ln_scales",
                       "ffn_ln_biases", "ffn1_weights", "ffn1_biases",
                       "ffn2_weights", "ffn2_biases")]
    assert len(list(tl.parameters())) == 24
    x = _rand(np.random.default_rng(15), B, S, D)
    want = JIF.fused_multi_transformer(_j(x), *lists).numpy()
    assert _err(tl(_t(x)), want) <= TOL


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("call", [
    lambda: FF.fused_multi_head_attention(
        torch.zeros(1, 2, 8), torch.zeros(3, 2, 4, 8), torch.zeros(8, 8),
        ring_id=0, training=False),
    lambda: FF.fused_multi_head_attention(
        torch.zeros(1, 2, 8), torch.zeros(3, 2, 4, 8), torch.zeros(8, 8),
        transpose_qkv_wb=True, training=False),
    lambda: FF.fused_multi_head_attention(
        torch.zeros(1, 2, 8), torch.zeros(3, 2, 4, 8), torch.zeros(8, 8),
        num_heads=4, training=False),
    lambda: FF.fused_feedforward(torch.zeros(1, 2, 8), torch.zeros(8, 8),
                                 torch.zeros(8, 8), ring_id=0,
                                 training=False),
    lambda: FF.fused_layer_norm(torch.zeros(2, 8), None, None,
                                begin_norm_axis=-2),
    lambda: FF.fused_layer_norm(torch.zeros(2, 8), None, None,
                                quant_scale=1.0),
    lambda: FF.fused_layer_norm(torch.zeros(2, 8), None, None,
                                residual_alpha=0.5),
    lambda: FF.fused_layer_norm(torch.zeros(2, 8), None, None,
                                norm_type="rms"),
    lambda: _port_layer(tinn.FusedLinear, 4, 4, weight_attr=object()),
    lambda: _port_layer(tinn.FusedMultiHeadAttention, 8, 2, kdim=4),
    lambda: _port_layer(tinn.FusedMultiHeadAttention, 8, 2,
                        need_weights=True),
    lambda: _port_layer(tinn.FusedMultiHeadAttention, 8, 2)(
        torch.zeros(1, 2, 8), cache=object()),
    lambda: _port_layer(tinn.FusedFeedForward, 8, 16,
                        linear1_weight_attr=object()),
], ids=["mha-ring_id", "mha-transpose_qkv_wb", "mha-num_heads", "ffn-ring_id",
        "ln-axis", "ln-quant", "ln-residual_alpha", "ln-unknown",
        "linear-weight_attr", "mha-kdim",
        "mha-need_weights", "mha-cache", "ffn-attr"])
def test_unported_arguments_raise(call):
    with pytest.raises(NotImplementedError):
        call()
