"""PyTorch and CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference. This package keeps its
module names, so each ported module has an obvious counterpart, but it is
idiomatic PyTorch: ``nn.Module``s and plain functions on ``torch.Tensor``.
Every TPU (Pallas) kernel on a ported path is a CUDA kernel written by hand
for ``sm_90a`` (``kernels/csrc``). Entry points run on the card unless the
caller passes ``device="cpu"``; nothing here imports JAX.

Ported so far: Llama serving (``generation.serving.ServingEngine``) with
whole-prompt and chunked prefill, fused block decode and generic paged
decode, the scheduler (deadlines, the bucket ladder, SLO preemption) and
request surface, and decode programs cached per configuration
(``generation.program_cache``; CUDA graphs on the card); Llama
training on one card through ``hapi.Model.fit`` over ``io.DataLoader``
(callbacks, ``metric``, checkpoints through ``framework.save``/``load``)
or ``hapi.TrainStep`` (remat, gradient merge, the metrics cadence), every
optimizer of ``optimizer`` and schedule of ``optimizer.lr``, ``amp`` and
``regularizer``; flash attention forward and backward (also with its lse,
``flash_attention_with_lse``), SDPA's dense path with a mask or dropout,
packed sequences through the flash kernels' segment ids
(``nn.functional.flash_attn_unpadded``), and the fused RMSNorm
(``incubate.nn.functional.fused_rms_norm``).
"""

from .device import resolve_device, seed

__all__ = ["resolve_device", "seed"]
