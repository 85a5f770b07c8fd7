"""``auto_cast`` and ``decorate`` (counterpart of
``paddle_tpu/amp/auto_cast.py``): the same white and black lists."""

from __future__ import annotations

import contextlib
import threading
from typing import Set

import torch

WHITE_LIST: Set[str] = {
    # matmul-class ops: safe and fast in bf16 (tensor cores)
    "matmul", "linear", "conv2d", "conv1d", "conv2d_transpose", "einsum",
    "bmm", "mm", "mv", "addmm", "flash_attention", "sdpa",
}

BLACK_LIST: Set[str] = {
    # numerically sensitive: kept in fp32. The norm ops are not listed:
    # they compute their moments in f32 and return the input dtype
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "softmax",
    "log_softmax", "cross_entropy", "bce", "bce_logits", "nll_loss",
    "sum", "mean", "norm", "cumsum", "softmax_with_cross_entropy",
    "pow", "square", "reciprocal", "rsqrt", "sqrt", "kl_div",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_LOW = (torch.bfloat16, torch.float16)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = "bfloat16"
        self.level = "O1"
        self.custom_white: Set[str] = set()
        self.custom_black: Set[str] = set()


_state = _AmpState()


def amp_state():
    return _state if _state.enabled else None


def white_list():
    return WHITE_LIST | _state.custom_white


def black_list():
    return (BLACK_LIST | _state.custom_black) - _state.custom_white


def amp_cast(name: str, *tensors):
    """``tensors`` as op ``name`` takes them under the current
    ``auto_cast``: f32 ones cast to the AMP dtype when the op is cast
    (white-listed at O1, not black-listed at O2); bf16/fp16 ones cast to
    f32 for a black-listed op; unchanged outside ``auto_cast``."""
    st = amp_state()
    if st is None:
        return tensors
    cast = (name not in black_list() if st.level == "O2"
            else name in white_list())
    if cast:
        target = _DTYPES[st.dtype]
        return tuple(t.to(target) if isinstance(t, torch.Tensor)
                     and t.dtype == torch.float32 else t for t in tensors)
    if name in black_list():
        return tuple(t.float() if isinstance(t, torch.Tensor)
                     and t.dtype in _LOW else t for t in tensors)
    return tensors


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16", use_promote: bool = True):
    """``paddle.amp.auto_cast``. O1: white-listed ops run in ``dtype``;
    O2: everything except the black list runs in ``dtype``."""
    if dtype not in _DTYPES:
        raise ValueError(f"auto_cast dtype must be one of {sorted(_DTYPES)}"
                         f", got {dtype!r}")
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white, _state.custom_black)
    _state.enabled = enable
    _state.dtype = dtype
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = prev


amp_guard = auto_cast


@torch.no_grad()
def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """``paddle.amp.decorate``: at O2 casts every floating parameter of the
    models to ``dtype`` in place, except those of ``excluded_layers``
    (module instances, or classes whose instances are excluded), and keeps
    f32 master weights in the optimizers unless ``master_weight=False``.
    Returns what it was given, as the reference does."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        target = _DTYPES[dtype]
        for m in model_list:
            excluded = set()
            if excluded_layers:
                excl = (excluded_layers
                        if isinstance(excluded_layers, (list, tuple))
                        else [excluded_layers])
                for e in excl:
                    subs = ([s for s in m.modules() if isinstance(s, e)]
                            if isinstance(e, type) else [e])
                    for sub in subs:
                        excluded.update(id(p) for p in sub.parameters())
            for p in m.parameters():
                if id(p) not in excluded and p.is_floating_point():
                    p.data = p.data.to(target)
    single_model_out = model_list[0] if single_model else model_list
    if optimizers is None:
        return single_model_out
    opt_list = (list(optimizers) if isinstance(optimizers, (list, tuple))
                else [optimizers])
    for o in opt_list:
        if master_weight is not False:
            o._multi_precision = True
    return single_model_out, (opt_list if isinstance(optimizers,
                                                     (list, tuple))
                              else opt_list[0])
