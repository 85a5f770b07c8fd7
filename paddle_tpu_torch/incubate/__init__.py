"""``incubate`` (counterpart of ``paddle_tpu/incubate``): the fused-op
surface ``nn`` and the single-card mixture of experts of
``distributed``."""

from . import distributed, nn  # noqa: F401
