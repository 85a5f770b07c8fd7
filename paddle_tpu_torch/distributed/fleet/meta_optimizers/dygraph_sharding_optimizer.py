"""The stage-1 sharding optimizer (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_sharding_optimizer.py``).

Like the reference it stamps the inner optimizer with stage 1 and the
sharding axis (``sharding``, or ``dp`` when only that axis has more than
one rank); a ``TrainStep(mesh=...)`` built over it runs the ZeRO plan
(``meta_parallel/sharding/zero.py``). Its own eager ``step`` outside a
``TrainStep`` first averages every gradient over the sharding group, then
runs the inner optimizer, so the ranks stay equal and take the data mean
(the reference's numbers; the whole parameters update on every rank).
"""

from __future__ import annotations

from ..base_topology import try_get_hybrid_communicate_group
from ..meta_parallel.sharding.group_sharded_stage import (
    OptimizerWrapper, axis_group, eager_step, hcg_axis)


class DygraphShardingOptimizer(OptimizerWrapper):
    def __init__(self, optimizer=None, hcg=None, user_defined_strategy=None,
                 params=None, inner_optimizer_class=None, **inner_kw):
        # the reference takes both signatures: (optimizer, hcg) and the
        # older (hcg, user_defined_strategy, params, inner_optimizer_class,
        # **kw)
        if optimizer is None and inner_optimizer_class is not None:
            optimizer = inner_optimizer_class(parameters=params, **inner_kw)
        self._hcg = hcg or try_get_hybrid_communicate_group()
        super().__init__(optimizer, hcg_axis(self._hcg) or "sharding")
        self._group = axis_group(self._hcg, hcg_axis(self._hcg))

    def step(self):
        return eager_step(self._inner_opt, self._group)
