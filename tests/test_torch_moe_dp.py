"""MoE-GPT at dp = 2 without expert parallelism against the JAX package's
``TrainStep(mesh=...)``: the routing is the GLOBAL batch's.

The reference is one program over the global batch: its capacity counts
every token, its first-come positions run over all tokens (choice 0 of
every token before choice 1), and its aux loss takes ``me`` and ``ce``
over every token. A rank that routed its own rows alone (the capacity of
its own count, positions in its own order, the aux loss of its own means,
which ``E * sum(me * ce)`` does not average into the global one) gives
other losses from the first step. The tiny MoE-GPT (2 layers, 4 experts,
top-2, aux weight 0.01) runs at ``capacity_factor`` 0.5 so that the
capacity cuts, and at the default 1.2, where only the aux loss tells.

- The losses of 3 AdamW steps (the global mean, each rank's the same)
  within 1e-5 relative of JAX's.
- The parameters gathered from both ranks (``convert.gather_state``,
  which also holds the replicas equal bit for bit) each within 1e-3 of
  JAX's update in L2, as ``test_torch_moe.py`` holds the one-card step.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest

import torch_moe_twins as twins
from paddle_tpu_torch.convert import gather_state

TOL = 1e-5
PARAM_RTOL = 1e-3
CFG = dict(num_hidden_layers=2)
CASES = [twins.case("cut", 2, dict(CFG, capacity_factor=0.5)),
         twins.case("default", 2, dict(CFG))]


@pytest.fixture(scope="module")
def runs():
    return twins.run_both(CASES, twins.weights(CFG))


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_losses_match_jax(runs, name):
    (jl, _), per_rank = runs[name]
    for res in per_rank:
        assert res["losses"] == per_rank[0]["losses"]
        err = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], jl))
        assert err <= TOL, (res["losses"], jl)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_parameters_match_jax(runs, name):
    (_, jp), per_rank = runs[name]
    got = gather_state([r["shard"] for r in per_rank], per_rank[0]["specs"],
                       [r["coords"] for r in per_rank], {"dp": 2})
    errs = twins.param_errors(got, jp, twins.weights(CFG),
                              hidden=64)
    assert max(errs.values()) <= PARAM_RTOL, max(errs.items(),
                                                 key=lambda kv: kv[1])
