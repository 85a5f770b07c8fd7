"""PyTorch and CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference. This package keeps its
module names, so each ported module has an obvious counterpart, but it is
idiomatic PyTorch: ``nn.Module``s and plain functions on ``torch.Tensor``.
Every TPU (Pallas) kernel on a ported path is a CUDA kernel written by hand
for ``sm_90a`` (``kernels/csrc``). Entry points run on the card unless the
caller passes ``device="cpu"``; nothing here imports JAX.

Ported so far: Llama serving (``generation.serving.ServingEngine``) with
whole-prompt prefill, fused block decode and generic paged decode; Llama
training through ``hapi.TrainStep`` with ``optimizer.AdamW``,
``nn.ClipGradByGlobalNorm``, the warmup/cosine LR schedules and flash
attention forward and backward, packed sequences through the flash
kernels' segment ids (``nn.functional.flash_attn_unpadded``), and the
fused RMSNorm (``incubate.nn.functional.fused_rms_norm``).
"""

from .device import resolve_device, seed

__all__ = ["resolve_device", "seed"]
