"""``paddle_tpu_torch.distributed.utils`` (counterpart of
``paddle_tpu/distributed/utils``): the MoE repacks."""

from .moe_utils import global_gather, global_scatter  # noqa: F401
