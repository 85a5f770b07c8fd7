"""DistributedStrategy (a copy of
``paddle_tpu/distributed/fleet/distributed_strategy.py``, which imports no
JAX): the reference's strategy switches (``strategy.amp = True``) and
``*_configs`` dicts, which merge user values over defaults and reject
unknown keys.
"""

from __future__ import annotations

import copy
from typing import Any, Dict


_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "hybrid_configs": {
        "dp_degree": 1,
        "mp_degree": 1,
        "pp_degree": 1,
        "sharding_degree": 1,
        "sep_degree": 1,
        "order": ["dp", "pp", "sharding", "sep", "mp"],
    },
    "pipeline_configs": {
        "accumulate_steps": 1,
        "micro_batch_size": None,  # None = derive as batch / accumulate_steps;
                                   # set explicitly to have train_batch validate

        "schedule_mode": "1F1B",     # FThenB | 1F1B (remat off/on — see
                                     # pipeline_parallel.py module docstring)
        "virtual_pp_degree": 1,      # interleaved chunks per device (VPP)
        "p2p_cache_shape": True,
    },
    "amp_configs": {
        "init_loss_scaling": 32768.0,
        "use_dynamic_loss_scaling": True,
        "incr_every_n_steps": 1000,
        "decr_every_n_nan_or_inf": 2,
        "incr_ratio": 2.0,
        "decr_ratio": 0.5,
        "use_pure_fp16": False,
        "use_pure_bf16": False,
        "custom_white_list": [],
        "custom_black_list": [],
    },
    "sharding_configs": {
        "sharding_degree": 1,
        "stage": 1,
        "offload": False,
        "comm_overlap": True,
    },
    "recompute_configs": {
        "checkpoints": [],
        "enable_offload": False,
    },
    "tensor_parallel_configs": {
        "tensor_parallel_degree": 1,
        "tensor_init_seed": -1,
    },
    "sep_configs": {},
    "elastic_configs": {},
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    "localsgd_configs": {"k_steps": 1, "begin_step": 1},
    "dgc_configs": {"rampup_begin_step": 0, "rampup_step": 1,
                    "sparsity": [0.999]},
    # PS mode (proto a_sync_configs): async push/pull against the host
    # table runtime (distributed/ps). k_steps<=0 = fully async (the only
    # mode the TPU PS implements — geo/half-async collapse into it)
    "a_sync_configs": {"k_steps": -1, "launch_barrier": True},
}

_FLAGS = {
    "a_sync": False,
    "amp": False,
    "recompute": False,
    "pipeline": False,
    "tensor_parallel": False,
    "sharding": False,
    "gradient_merge": False,
    "localsgd": False,
    "dgc": False,
    "sequence_parallel": False,
    "heter_ccl_mode": False,
    "find_unused_parameters": False,
    "fuse_grad_size_in_MB": 32,
    "last_comm_group_size_MB": 1,
    "without_graph_optimization": True,
}


class DistributedStrategy:
    """Keeps the reference's attribute surface: boolean strategy switches
    (``strategy.amp = True``) + per-strategy ``*_configs`` dicts that merge
    user values over defaults and reject unknown keys."""

    def __init__(self):
        for k, v in _FLAGS.items():
            object.__setattr__(self, "_" + k, v)
        for k, v in _DEFAULTS.items():
            object.__setattr__(self, "_" + k, copy.deepcopy(v))

    def __getattr__(self, name):
        d = object.__getattribute__(self, "__dict__")
        if "_" + name in d:
            return d["_" + name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.endswith("_configs"):
            if "_" + name not in self.__dict__:
                raise AttributeError(f"unknown strategy config {name!r}")
            base = self.__dict__["_" + name]
            unknown = set(value) - set(base) if base else set()
            if unknown:
                raise ValueError(
                    f"unknown keys {sorted(unknown)} for {name}; "
                    f"valid: {sorted(base)}")
            base.update(value)
        elif "_" + name in self.__dict__:
            object.__setattr__(self, "_" + name, value)
        else:
            object.__setattr__(self, name, value)

    # ------------------------------------------------------------- helpers
    @property
    def hybrid_parallel_order(self):
        return list(self._hybrid_configs.get("order",
                                             ["dp", "pp", "sharding", "sep", "mp"]))

    def degrees(self) -> Dict[str, int]:
        h = self._hybrid_configs
        return {k: int(h.get(f"{k}_degree", 1))
                for k in ("dp", "mp", "pp", "sharding", "sep")}

    def __repr__(self):
        on = [k for k in _FLAGS if isinstance(getattr(self, k), bool)
              and getattr(self, k)]
        return (f"DistributedStrategy(hybrid={self.degrees()}, "
                f"enabled={on})")
