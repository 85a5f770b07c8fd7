"""Mixture of experts on one card (counterpart of
``paddle_tpu/incubate/distributed/models/moe``): the gates, the
static-capacity dispatch ``top_k_dispatch``, the stacked ``Experts`` and
``MoELayer``. Expert parallelism (``moe_group``, ``mp_group``,
``expert_axis``) is not ported and raises ``NotImplementedError``."""

from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .moe_layer import Experts, MoELayer, top_k_dispatch  # noqa: F401
