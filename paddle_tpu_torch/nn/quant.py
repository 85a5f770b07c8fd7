"""Weight-only quantization (counterpart of ``paddle_tpu/nn/quant.py``;
Paddle's ``paddle.nn.quant``): ``weight_quantize``, ``weight_dequantize``,
``weight_only_linear``, ``llm_int8_linear``, ``QuantizedLinear`` and
``quantize_linears``.

The math is shared with :mod:`paddle_tpu_torch.incubate.nn.functional`, as
in the JAX package: abs-max int8 or int4 (two a byte, the even row in the
low nibble) per output channel or per group, dequantized in f32 into the
activation dtype and multiplied with f32 accumulation. The JAX package
runs this outside any Pallas kernel (``jnp.matmul``), so the port runs
PyTorch ops and ``torch.mm``: no kernel of its own.

A ``quantize_linears`` model serves through ``ServingEngine``'s generic
route: its quantized weights are buffers, not parameters, so the fused
decode's layout finds them missing, as the JAX engine's does.

Not ported yet: ``QuantizedLinear.from_linear``'s streaming branch for a
``Linear`` built under ``LazyGuard`` (the port has no lazy parameters).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..incubate.nn.functional import (_dequantize_weight, weight_only_linear,
                                      weight_quantize)
from .layers.common import Linear

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "llm_int8_linear", "QuantizedLinear", "quantize_linears"]


def weight_dequantize(x, scale, algo: str = "weight_only_int8",
                      out_dtype="float32", group_size: int = -1
                      ) -> torch.Tensor:
    """Inverse of :func:`weight_quantize`: the dense weight in
    ``out_dtype`` (a ``torch.dtype`` or its name), no gradient."""
    if isinstance(out_dtype, str):
        out_dtype = getattr(torch, out_dtype)
    with torch.no_grad():
        return _dequantize_weight(x, scale, algo, group_size, out_dtype)


class QuantizedLinear(nn.Module):
    """Weight-only quantized drop-in for :class:`~..layers.common.Linear`:
    ``y = x @ dequantize(quant_weight) (+ bias)``. The int8 payload
    ``quant_weight`` (``(in, out)``, or ``(in // 2, out)`` packed int4) and
    its f32 ``weight_scale`` are buffers (no gradients); the bias, in the
    model's dtype, stays a parameter. Built on the card unless ``device``
    says otherwise."""

    def __init__(self, in_features: int, out_features: int,
                 algo: str = "weight_only_int8", group_size: int = -1,
                 has_bias: bool = True, *, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.algo, self.group_size = algo, group_size
        if "int4" in algo and in_features % 2:
            raise ValueError(f"int4 packing needs an even in_features, "
                             f"got {in_features}")
        if group_size > 0 and in_features % group_size:
            raise ValueError(f"in_features {in_features} not divisible by "
                             f"group_size {group_size}")
        device = resolve_device(device)
        packed_k = in_features if "int8" in algo else in_features // 2
        scale_shape = ((in_features // group_size, out_features)
                       if group_size > 0 else (out_features,))
        self.register_buffer("quant_weight", torch.zeros(
            (packed_k, out_features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.zeros(
            scale_shape, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype or torch.float32))
            if has_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return weight_only_linear(
            x, self.quant_weight, self.bias, self.weight_scale,
            weight_dtype="int8" if "int8" in self.algo else "int4",
            group_size=self.group_size)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, algo={self.algo}")

    @staticmethod
    @torch.no_grad()
    def from_linear(linear: Linear, algo: str = "weight_only_int8",
                    group_size: int = -1, _shared=None) -> "QuantizedLinear":
        """Quantize a ``Linear``'s weight into a new ``QuantizedLinear`` on
        the same device (the bias copied). ``_shared``: the
        ``(quant_weight, weight_scale)`` of another ``QuantizedLinear``
        made from the same weight parameter, which this one aliases."""
        w = linear.weight
        q = QuantizedLinear(linear.in_features, linear.out_features,
                            algo=algo, group_size=group_size,
                            has_bias=linear.bias is not None,
                            device=w.device, dtype=w.dtype)
        if _shared is not None:
            q.quant_weight, q.weight_scale = _shared
        else:
            qw, scale = weight_quantize(w, algo=algo, group_size=group_size)
            q.quant_weight.copy_(qw)
            q.weight_scale.copy_(scale)
        if linear.bias is not None:
            q.bias.copy_(linear.bias)
        return q


def quantize_linears(layer: nn.Module, algo: str = "weight_only_int8",
                     group_size: int = -1, skip=()) -> nn.Module:
    """Replace, in place, every submodule of ``layer`` whose type is exactly
    ``Linear`` by a ``QuantizedLinear`` made from it, except those whose
    attribute name is in ``skip`` (e.g. ``("lm_head",)``) and, under int4,
    those with an odd ``in_features`` (left unquantized). Ties survive: a
    ``Linear`` reached twice quantizes once and stays shared, and two
    ``Linear``s sharing a weight parameter share one set of buffers.
    Returns ``layer``."""
    todo = []
    for parent in layer.modules():
        for name, sub in list(parent._modules.items()):
            if type(sub) is Linear and name not in skip:
                if "int4" in algo and sub.in_features % 2:
                    continue
                todo.append((parent, name, sub))
    made = {}      # id(Linear) -> its QuantizedLinear
    shared = {}    # id(weight parameter) -> (quant_weight, weight_scale)
    for parent, name, sub in todo:
        q = made.get(id(sub))
        if q is None:
            tie = shared.get(id(sub.weight))
            q = made[id(sub)] = QuantizedLinear.from_linear(
                sub, algo, group_size, _shared=tie)
            if tie is None:
                shared[id(sub.weight)] = (q.quant_weight, q.weight_scale)
        setattr(parent, name, q)
    return layer


def llm_int8_linear(x, weight, bias=None, weight_scale=None,
                    threshold: float = 6.0) -> torch.Tensor:
    """Paddle's llm.int8 linear. As in the JAX package the outlier
    decomposition reduces to the dequantized int8 GEMM
    (:func:`weight_only_linear`); ``threshold`` is kept for the
    signature."""
    return weight_only_linear(x, weight, bias=bias,
                              weight_scale=weight_scale, weight_dtype="int8")
