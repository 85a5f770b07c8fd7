"""``incubate.distributed`` (counterpart of ``paddle_tpu/incubate/distributed``):
the single-card part of its mixture of experts."""

from . import models  # noqa: F401
