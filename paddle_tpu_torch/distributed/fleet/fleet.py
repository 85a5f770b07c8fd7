"""The Fleet facade (counterpart of
``paddle_tpu/distributed/fleet/fleet.py``): ``fleet.init`` builds the
hybrid topology from ``strategy.hybrid_configs`` (starting the runtime
with :func:`~..parallel.init_parallel_env` when no one has),
``distributed_model`` wraps the model by the topology's mode and
``distributed_optimizer`` wraps the optimizer as the reference does:
``strategy.dgc`` turns a ``Momentum`` into
:class:`~.meta_optimizers.DGCMomentum`, a sharding degree above one with
``sharding_configs["stage"] == 1`` gives a
:class:`~.meta_optimizers.DygraphShardingOptimizer`, and the result goes
into :class:`~.meta_optimizers.HybridParallelOptimizer`.

At ``pp_degree > 1`` ``distributed_model`` returns a
:class:`~.meta_parallel.PipelineParallel` over the model (a
``PipelineLayer``). Refused with ``NotImplementedError``: the
parameter-server mode (ROADMAP Queue 1, item 6); static-graph
``minimize`` as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from .base_topology import CommunicateTopology, HybridCommunicateGroup
from .distributed_strategy import DistributedStrategy
from .meta_optimizers import (DGCMomentum, DygraphShardingOptimizer,
                              HybridParallelOptimizer)
from .meta_parallel.meta_parallel_base import (DataParallel,
                                               ShardingParallel,
                                               TensorParallel)


def _dgc_of(optimizer, cfg):
    """``strategy.dgc``: a ``Momentum`` (exactly) as a
    :class:`DGCMomentum` over the same parameters and settings."""
    from ...optimizer.optimizer import Momentum
    from ...regularizer import L1Decay
    if type(optimizer) is not Momentum:
        raise TypeError("strategy.dgc requires a Momentum optimizer "
                        f"(got {type(optimizer).__name__})")
    kind, coeff = optimizer._decay
    return DGCMomentum(
        learning_rate=optimizer._lr, momentum=optimizer._momentum,
        rampup_begin_step=cfg.get("rampup_begin_step", 0),
        rampup_step=cfg.get("rampup_step", 1),
        sparsity=cfg.get("sparsity", [0.999]),
        parameters=[(optimizer._names[p], p) for p in optimizer._params()],
        use_nesterov=optimizer._nesterov,
        weight_decay=L1Decay(coeff) if kind == "l1" else coeff,
        grad_clip=optimizer._grad_clip,
        multi_precision=optimizer._multi_precision)


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, "
                              f"item {item})")


class Fleet:
    def __init__(self):
        self._is_initialized = False
        self._user_defined_strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._role_maker = None

    def init(self, role_maker=None, is_collective: bool = True,
             strategy: Optional[DistributedStrategy] = None):
        if not is_collective:
            _not_ported("the parameter-server mode "
                        "(fleet.init(is_collective=False))", 6)
        if role_maker is None:
            from .role_maker import PaddleCloudRoleMaker
            role_maker = PaddleCloudRoleMaker(is_collective=True)
        self._role_maker = role_maker
        if not dist.is_initialized():
            from ..parallel import init_parallel_env
            init_parallel_env()
        strategy = strategy or DistributedStrategy()
        self._user_defined_strategy = strategy
        deg = strategy.degrees()
        topo = CommunicateTopology(
            ("data", "pipe", "sharding", "sep", "model"),
            (deg["dp"], deg["pp"], deg["sharding"], deg["sep"], deg["mp"]))
        self._hcg = HybridCommunicateGroup(topo)
        self._is_initialized = True
        return self

    def is_initialized(self) -> bool:
        return self._is_initialized

    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        if self._hcg is None:
            raise RuntimeError("fleet.init() has not been called")
        return self._hcg

    def worker_index(self) -> int:
        if self._role_maker is not None:
            return self._role_maker.worker_index()
        return self._hcg.global_rank if self._hcg else 0

    def worker_num(self) -> int:
        if self._role_maker is not None and self._role_maker.worker_num() > 1:
            return self._role_maker.worker_num()
        return self._hcg.nranks if self._hcg else 1

    def is_first_worker(self) -> bool:
        return self.worker_index() == 0

    def barrier_worker(self):
        if dist.is_initialized():
            from ..communication.collectives import barrier
            barrier()

    def is_worker(self) -> bool:
        return True

    def is_server(self) -> bool:
        return False

    def worker_endpoints(self, to_string=False):
        rm = self._role_maker
        eps = (rm.get_trainer_endpoints() if rm is not None
               and hasattr(rm, "get_trainer_endpoints") else [])
        return ",".join(eps) if to_string else eps

    def server_num(self) -> int:
        return 0

    def server_index(self) -> int:
        return -1

    def server_endpoints(self, to_string=False):
        return "" if to_string else []

    def init_worker(self, scopes=None):
        """Collective mode: nothing to connect."""

    def init_server(self, *args, **kwargs):
        _not_ported("fleet.init_server (the parameter server)", 6)

    def run_server(self):
        _not_ported("fleet.run_server (the parameter server)", 6)

    def stop_worker(self):
        """Collective mode: nothing to stop."""

    def distributed_model(self, model):
        """The wrapper of the topology's mode: pp > 1
        :class:`PipelineParallel`, else mp > 1 :class:`TensorParallel`,
        else sharding > 1 :class:`ShardingParallel`, else
        :class:`DataParallel`."""
        hcg = self.get_hybrid_communicate_group()
        strategy = self._user_defined_strategy
        if hcg.get_pipe_parallel_world_size() > 1:
            from .meta_parallel.pipeline_parallel import PipelineParallel
            return PipelineParallel(model, hcg, strategy)
        if hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, hcg, strategy)
        if hcg.get_sharding_parallel_world_size() > 1:
            return ShardingParallel(model, hcg, strategy)
        return DataParallel(model, hcg, strategy)

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._user_defined_strategy = strategy
        st = self._user_defined_strategy or DistributedStrategy()
        hcg = self._hcg
        if getattr(st, "dgc", False):
            optimizer = _dgc_of(optimizer, st.dgc_configs)
        if hcg is not None and hcg.get_sharding_parallel_world_size() > 1 \
                and int(st.sharding_configs.get("stage", 1)) == 1:
            optimizer = DygraphShardingOptimizer(optimizer, hcg)
        return HybridParallelOptimizer(optimizer, hcg, st)

    def minimize(self, optimizer, loss, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        raise NotImplementedError(
            "static-graph fleet.minimize is out of scope; use "
            "distributed_model + TrainStep")


_fleet_singleton = Fleet()


def init(role_maker=None, is_collective: bool = True, strategy=None):
    return _fleet_singleton.init(role_maker, is_collective, strategy)


def is_initialized() -> bool:
    return _fleet_singleton.is_initialized()


def distributed_model(model):
    return _fleet_singleton.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return _fleet_singleton.distributed_optimizer(optimizer, strategy)


def get_hybrid_communicate_group():
    return _fleet_singleton.get_hybrid_communicate_group()
