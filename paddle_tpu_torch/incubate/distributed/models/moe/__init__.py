"""Mixture of experts (counterpart of
``paddle_tpu/incubate/distributed/models/moe``): the gates, the
static-capacity dispatch ``top_k_dispatch`` (over the global batch across
data-parallel ranks), the stacked ``Experts`` and ``MoELayer``, with expert
parallelism over a data axis (``expert_axis`` / ``moe_group``).
``mp_group`` and ``recompute_interval`` raise ``NotImplementedError``."""

from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .moe_layer import Experts, MoELayer, top_k_dispatch  # noqa: F401
