"""Fused layers (counterpart of ``paddle_tpu/incubate/nn/__init__.py``, the
reference's ``incubate/nn/layer/fused_transformer.py``): ``nn.Module``
wrappers over :mod:`.functional`.

Parameters are the JAX layers' names, shapes and initializers (Xavier
normal for every weight, the LayerNorm scales too; zeros for biases), drawn
from ``generator``, which also draws training dropout's masks. Each layer
is built on the card unless ``device`` says otherwise.

Designed differences: the JAX layers call their functionals with the
functionals' own defaults, so ``FusedMultiHeadAttention`` and
``FusedFeedForward`` drop out at rate 0.5 even in eval mode and
``FusedMultiTransformer`` ignores ``normalize_before``, ``activation`` and
``dropout_rate``. Here every layer passes its own rates (an unset
attention or activation rate is ``dropout_rate``, Paddle's rule), its
``epsilon``, its options and ``self.training``; at rate 0 or in eval mode
the value is the JAX layers' at rate 0. ``FusedMultiTransformer``'s weight
lists are ``nn.ParameterList``s (the JAX layer's plain lists register no
parameter). Arguments no layer here uses (``weight_attr``, ``bias_attr``
other than ``False`` for ``FusedLinear``'s bias, ``kdim``/``vdim`` other
than ``embed_dim``, ``need_weights``, a forward's ``key``/``value``/
``cache``) raise ``NotImplementedError``.
"""

from typing import Optional

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...nn.initializer import Constant, XavierNormal
from . import functional

__all__ = ["functional", "FusedLinear", "FusedBiasDropoutResidualLayerNorm",
           "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer"]


def _refuse(layer: str, **unused) -> None:
    given = sorted(k for k, v in unused.items() if v is not None)
    if given:
        raise NotImplementedError(
            f"{layer}: {', '.join(given)} not ported (the JAX layer ignores "
            "them)")


class _Fused(nn.Module):
    """Holds the device, dtype and generator every new weight is drawn
    with (Xavier normal; ``bias=True``: zeros)."""

    def __init__(self, device: DeviceLike, dtype: Optional[torch.dtype],
                 generator: Optional[torch.Generator]):
        super().__init__()
        self._dev = resolve_device(device)
        self._dtype = dtype or torch.float32
        self.generator = generator

    def _param(self, *shape, bias: bool = False) -> nn.Parameter:
        init = Constant(0.0) if bias else XavierNormal()
        return nn.Parameter(init(shape, self._dev, self._dtype,
                                 self.generator))


class FusedLinear(_Fused):
    """``x @ W + b``; W ``(in, out)``, or ``(out, in)`` with
    ``transpose_weight``; ``bias_attr=False``: no bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        _refuse("FusedLinear", weight_attr=weight_attr,
                bias_attr=None if bias_attr is False else bias_attr)
        super().__init__(device, dtype, generator)
        self._tw = transpose_weight
        self.weight = self._param(*((out_features, in_features)
                                    if transpose_weight
                                    else (in_features, out_features)))
        self.bias = (self._param(out_features, bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return functional.fused_linear(x, self.weight, self.bias,
                                transpose_weight=self._tw)


class FusedBiasDropoutResidualLayerNorm(_Fused):
    """``layer_norm(dropout(x) + residual)`` with a learned scale and
    shift."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        _refuse("FusedBiasDropoutResidualLayerNorm", weight_attr=weight_attr,
                bias_attr=bias_attr)
        super().__init__(device, dtype, generator)
        self._p = dropout_rate
        self._eps = epsilon
        self.ln_scale = self._param(embed_dim)
        self.ln_bias = self._param(embed_dim, bias=True)

    def forward(self, x, residual):
        return functional.fused_bias_dropout_residual_layer_norm(
            x, residual, None, self.ln_scale, self.ln_bias,
            dropout_rate=self._p if self.training else 0.0,
            ln_epsilon=self._eps, training=self.training,
            generator=self.generator)


class FusedMultiHeadAttention(_Fused):
    """Self-attention of ``embed_dim`` in ``num_heads`` heads with no
    biases and no LayerNorm parameters (pre-LN with ``normalize_before``,
    else post-LN): ``qkv_weight`` ``(3, H, D / H, D)``, ``linear_weight``
    ``(D, D)``."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 weight_attr=None, bias_attr=None, epsilon=1e-5, name=None,
                 *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        _refuse("FusedMultiHeadAttention",
                kdim=None if kdim in (None, embed_dim) else kdim,
                vdim=None if vdim in (None, embed_dim) else vdim,
                need_weights=need_weights or None, weight_attr=weight_attr,
                bias_attr=bias_attr)
        super().__init__(device, dtype, generator)
        self.num_heads = num_heads
        self.pre_ln = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                                  else attn_dropout_rate)
        self.epsilon = epsilon
        d = embed_dim
        self.qkv_weight = self._param(3, num_heads, d // num_heads, d)
        self.linear_weight = self._param(d, d)

    def forward(self, query, attn_mask=None, key=None, value=None,
                cache=None):
        _refuse("FusedMultiHeadAttention.forward",
                key=None if key is query else key,
                value=None if value is query else value, cache=cache)
        return functional.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.pre_ln, pre_ln_epsilon=self.epsilon,
            ln_epsilon=self.epsilon, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            training=self.training, num_heads=self.num_heads,
            generator=self.generator)


class FusedFeedForward(_Fused):
    """``linear2(dropout(act(linear1(x)))) + x`` with no biases and no
    LayerNorm parameters (pre-LN with ``normalize_before``, else post-LN):
    ``w1`` ``(d_model, dim_feedforward)``, ``w2`` the reverse."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, name=None, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, **attrs):
        _refuse("FusedFeedForward", **attrs)
        super().__init__(device, dtype, generator)
        self.pre_ln = normalize_before
        self.act = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.epsilon = epsilon
        self.w1 = self._param(d_model, dim_feedforward)
        self.w2 = self._param(dim_feedforward, d_model)

    def forward(self, src, cache=None):
        _refuse("FusedFeedForward.forward", cache=cache)
        return functional.fused_feedforward(
            src, self.w1, self.w2, dropout1_rate=self.act_dropout_rate,
            dropout2_rate=self.dropout_rate, activation=self.act,
            ln1_epsilon=self.epsilon, ln2_epsilon=self.epsilon,
            pre_layer_norm=self.pre_ln, training=self.training,
            generator=self.generator)


class FusedTransformerEncoderLayer(nn.Module):
    """A :class:`FusedMultiHeadAttention` then a :class:`FusedFeedForward`
    (an unset attention rate is ``dropout_rate``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, *,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        _refuse("FusedTransformerEncoderLayer.forward", cache=cache)
        return self.ffn(self.attn(src, attn_mask=src_mask))


class FusedMultiTransformer(_Fused):
    """The stacked fused decoder over
    :func:`~.functional.fused_multi_transformer` (KV caches, pre- or
    post-LN, GELU or ReLU): one ``nn.ParameterList`` a weight kind, one
    entry a layer."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device, dtype, generator)
        d, n = embed_dim, num_layers
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.normalize_before = normalize_before

        def stack(*shape, bias=False):
            return nn.ParameterList(self._param(*shape, bias=bias)
                                    for _ in range(n))

        self.ln_scales = stack(d)
        self.ln_biases = stack(d, bias=True)
        self.qkv_weights = stack(3, num_heads, d // num_heads, d)
        self.qkv_biases = stack(3, num_heads, d // num_heads, bias=True)
        self.out_weights = stack(d, d)
        self.out_biases = stack(d, bias=True)
        self.ffn_ln_scales = stack(d)
        self.ffn_ln_biases = stack(d, bias=True)
        self.ffn1_weights = stack(d, dim_feedforward)
        self.ffn1_biases = stack(dim_feedforward, bias=True)
        self.ffn2_weights = stack(dim_feedforward, d)
        self.ffn2_biases = stack(d, bias=True)

    def forward(self, src, attn_mask=None, caches=None, time_step=None):
        return functional.fused_multi_transformer(
            src, list(self.ln_scales), list(self.ln_biases),
            list(self.qkv_weights), list(self.qkv_biases),
            list(self.out_weights), list(self.out_biases),
            list(self.ffn_ln_scales), list(self.ffn_ln_biases),
            list(self.ffn1_weights), list(self.ffn1_biases),
            list(self.ffn2_weights), list(self.ffn2_biases),
            pre_layer_norm=self.normalize_before, attn_mask=attn_mask,
            cache_kvs=caches, time_step=time_step,
            dropout_rate=self.dropout_rate, activation=self.activation,
            training=self.training)
