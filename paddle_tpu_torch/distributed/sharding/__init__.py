"""The group-sharded (ZeRO) API (counterpart of
``paddle_tpu/distributed/sharding``)."""

from .group_sharded import (  # noqa: F401
    group_sharded_parallel, save_group_sharded_model,
)
