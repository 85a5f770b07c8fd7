"""The port's hand-written Hopper kernels and their plain PyTorch versions.

Each kernel wrapper carries ``launches``, one count per variant of its
kernel (the native one under the wrapper's name, the quantized ones as
``<name>_int8``, ``<name>_int4``, ``<name>_int8_int4``, the flash kernels'
segment-id ones as ``<name>_seg``), which it
increments each time it launches that variant (never for the plain
version on a CPU tensor), so a run can show that its main path went
through the kernels.
"""

from . import (decode_attention, flash_attention, fused_block_decode,
               paged_attention, rms_norm)


def wrappers():
    """The kernel wrappers of the ported slices: serving, then training
    (attention, then the fused RMSNorm)."""
    return (decode_attention.flash_prefill, paged_attention.paged_attention,
            paged_attention.paged_chunk_attention,
            fused_block_decode.fused_block_decode,
            fused_block_decode.fused_multi_block_decode,
            flash_attention.flash_attention_fwd,
            flash_attention.flash_attention_bwd_dq,
            flash_attention.flash_attention_bwd_dkv,
            rms_norm.rms_norm_fwd, rms_norm.rms_norm_bwd_dx)


def reset_launches() -> None:
    for fn in wrappers():
        fn.launches = dict.fromkeys(fn.launches, 0)


def launch_counts() -> dict:
    """Every kernel variant's launches, by name."""
    return {name: n for fn in wrappers() for name, n in fn.launches.items()}
