"""Sharding (ZeRO) (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding``): the layout rule,
the stage wrappers and the plan ``TrainStep(mesh=...)`` runs."""

from .group_sharded_stage import (  # noqa: F401
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3,
    unwrap_optimizer,
)
from .group_sharded_utils import (  # noqa: F401
    LEVEL_TO_STAGE, extend_spec_with_sharding,
    extend_spec_with_sharding_on_mesh, mesh_sizes, resolve_sharding_axis,
    resolve_sharding_axis_on_mesh,
)
from .zero import ZeroPlan  # noqa: F401
