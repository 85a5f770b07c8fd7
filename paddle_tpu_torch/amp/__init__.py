"""Automatic mixed precision (counterpart of ``paddle_tpu/amp/``).

``auto_cast`` sets a thread-local state that the port's matmul-class ops
read (``nn.Linear`` as ``linear``, ``scaled_dot_product_attention`` as
``sdpa``, the criterion's ``cross_entropy``) and casts their inputs as the
reference's dispatch does: O1 casts white-listed ops' f32 inputs to the AMP
dtype, O2 every op's outside the black list, and a black-listed op gets
its bf16/fp16 inputs in f32. ``decorate`` casts a model's float parameters
for O2 and turns on the optimizer's f32 masters. ``GradScaler`` is the
reference's dynamic loss scaling. :mod:`.debugging` is the NaN/Inf checker
(``FLAGS_check_nan_inf``), ``checked_jit``, ``check_numerics`` and the
offline ``compare_accuracy``.
"""

from . import debugging
from .auto_cast import (amp_cast, amp_guard, amp_state, auto_cast,
                        black_list, decorate, white_list)
from .grad_scaler import AmpScaler, GradScaler


def is_float16_supported(device=None) -> bool:
    """Whether ``device`` (default: the card) computes in fp16: every CUDA
    card and the CPU do."""
    return True


def is_bfloat16_supported(device=None) -> bool:
    """Whether ``device`` (default: the card) computes in bf16: the CPU
    does, a CUDA card from compute capability 8.0 (the H100 is 9.0)."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return True
    return torch.cuda.is_available() and (
        torch.cuda.get_device_capability(dev)[0] >= 8)


__all__ = ["AmpScaler", "GradScaler", "amp_cast", "amp_guard", "amp_state",
           "auto_cast", "black_list", "debugging", "decorate",
           "is_bfloat16_supported", "is_float16_supported", "white_list"]
