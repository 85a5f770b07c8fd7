"""``fleet.utils`` (counterpart of ``paddle_tpu/distributed/fleet/utils``):
``recompute``, long-context attention over the ``sep`` axis and Megatron
sequence parallelism. The reference's file-system clients (``fs``) are a
later slice."""

from . import recompute as _recompute_mod  # noqa: F401
from . import ring_flash_attention, sequence_parallel_utils  # noqa: F401
from .recompute import recompute  # noqa: F401
from .ring_flash_attention import (  # noqa: F401
    ring_flash_attention as ring_flash_attention_fn,
    sep_scaled_dot_product_attention, ulysses_attention,
)
