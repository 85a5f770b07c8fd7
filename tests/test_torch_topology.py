"""The hybrid topology, strategy, role makers and RNG tracker against the
JAX package's, without processes.

- ``CommunicateTopology`` and ``HybridCommunicateGroup`` (described for
  each global rank, no runtime): rank lists, coordinates and every getter
  equal the JAX classes' for several (dp, pp, sharding, sep, mp) tuples.
- ``DistributedStrategy``: defaults, merged configs, degrees and the
  refusal of unknown keys, as the JAX copy.
- The role makers read the ``PADDLE_*`` protocol as the JAX ones do, and
  refuse the same inconsistencies.
- ``model_parallel_random_seed`` seeds the same states the JAX tracker
  does; ``rng_state`` runs the default generator from a state and leaves
  the default stream where it was.
"""

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from paddle_tpu.distributed.fleet import base_topology as jtopo
from paddle_tpu.distributed.fleet import random as jrandom
from paddle_tpu.distributed.fleet import role_maker as jrole
from paddle_tpu.distributed.fleet.distributed_strategy import (
    DistributedStrategy as JStrategy)
from paddle_tpu_torch.distributed import get_rank, get_world_size
from paddle_tpu_torch.distributed.fleet import base_topology as topo
from paddle_tpu_torch.distributed.fleet import random as trandom
from paddle_tpu_torch.distributed.fleet import role_maker
from paddle_tpu_torch.distributed.fleet.distributed_strategy import (
    DistributedStrategy)

DEGREES = [(2, 1, 1, 1, 2), (1, 2, 1, 1, 4), (2, 2, 2, 1, 1),
           (1, 1, 1, 2, 2), (8, 1, 1, 1, 1)]
GETTERS = ("get_data_parallel_rank", "get_data_parallel_world_size",
           "get_data_parallel_group_src_rank", "get_model_parallel_rank",
           "get_model_parallel_world_size",
           "get_model_parallel_group_src_rank", "get_stage_id",
           "get_pipe_parallel_world_size", "is_first_stage", "is_last_stage",
           "get_sharding_parallel_rank", "get_sharding_parallel_world_size",
           "get_sharding_parallel_group_src_rank", "get_sep_parallel_rank",
           "get_sep_parallel_world_size", "get_parallel_mode",
           "get_global_rank")
GROUPS = ("get_data_parallel_group", "get_model_parallel_group",
          "get_pipe_parallel_group", "get_sharding_parallel_group",
          "get_sep_parallel_group", "get_check_parallel_group")


@pytest.mark.parametrize("dims", DEGREES, ids=str)
def test_topology_matches_jax(dims):
    names = ("data", "pipe", "sharding", "sep", "model")
    t, j = topo.CommunicateTopology(names, dims), \
        jtopo.CommunicateTopology(names, dims)
    assert t.world_size() == j.world_size()
    for n in names:
        assert t.get_dim(n) == j.get_dim(n)
        assert t.get_comm_list(n) == j.get_comm_list(n)
        for i in range(t.get_dim(n)):
            assert t.get_axis_list(n, i) == j.get_axis_list(n, i)
    for r in range(t.world_size()):
        assert tuple(t.get_coord(r)) == tuple(j.get_coord(r))
        assert t.get_rank(**t.get_coord(r)._asdict()) == r


@pytest.mark.parametrize("dims", DEGREES, ids=str)
def test_hybrid_group_getters_match_jax(dims):
    dp, pp, sh, sep, mp = dims
    names = ("data", "pipe", "sharding", "sep", "model")
    n = int(np.prod(dims))
    for rank in range(n):
        h = topo.HybridCommunicateGroup(
            topo.CommunicateTopology(names, dims), global_rank=rank)
        j = jtopo.HybridCommunicateGroup(
            jtopo.CommunicateTopology(names, dims), global_rank=rank)
        for g in GETTERS:
            assert getattr(h, g)() == getattr(j, g)(), (rank, g)
        for g in GROUPS:
            mine, want = getattr(h, g)(), getattr(j, g)()
            assert mine.ranks == want.ranks, (rank, g)
            assert mine.nranks == want.nranks
            assert mine.rank == mine.ranks.index(rank)
        if pp > 1:
            assert h.get_rank_from_stage(pp - 1) == \
                j.get_rank_from_stage(pp - 1)
    topo._reset_hcg()
    jtopo._reset_hcg()


def test_create_and_reset():
    h = topo.create_hybrid_communicate_group(dp_degree=2, mp_degree=2,
                                             global_rank=3)
    assert topo.get_hybrid_communicate_group() is h
    assert repr(h) == "HybridCommunicateGroup(dp=2, pp=1, sharding=1, " \
                      "sep=1, mp=2)"
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        h.get_mesh()
    topo._reset_hcg()
    assert topo.try_get_hybrid_communicate_group() is None
    with pytest.raises(RuntimeError, match="fleet.init"):
        topo.get_hybrid_communicate_group()


def test_strategy_matches_jax():
    s, j = DistributedStrategy(), JStrategy()
    assert s.degrees() == j.degrees()
    for st in (s, j):
        st.hybrid_configs = {"dp_degree": 2, "mp_degree": 4}
        st.amp = True
        st.sharding_configs = {"stage": 2}
    assert s.degrees() == j.degrees() == {"dp": 2, "mp": 4, "pp": 1,
                                          "sharding": 1, "sep": 1}
    assert s.hybrid_parallel_order == j.hybrid_parallel_order
    assert s.sharding_configs == j.sharding_configs
    assert repr(s) == repr(j)
    for st in (s, j):
        with pytest.raises(ValueError, match="unknown keys"):
            st.hybrid_configs = {"bogus_degree": 2}
        with pytest.raises(AttributeError):
            st.bogus_configs = {}


ENVS = [
    {},
    {"PADDLE_TRAINER_ID": "1", "PADDLE_TRAINERS_NUM": "2",
     "PADDLE_TRAINER_ENDPOINTS": "127.0.0.1:6170,127.0.0.1:6171",
     "PADDLE_CURRENT_ENDPOINT": "127.0.0.1:6171"},
    {"PADDLE_TRAINER_ID": "3", "PADDLE_TRAINERS_NUM": "4"},
]


@pytest.mark.parametrize("env", ENVS, ids=["empty", "two", "four"])
def test_role_makers_read_the_protocol_as_jax(monkeypatch, env):
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t, j = role_maker.PaddleCloudRoleMaker(), jrole.PaddleCloudRoleMaker()
    for m in ("worker_index", "worker_num", "is_worker", "is_server",
              "is_first_worker", "get_trainer_endpoints",
              "get_current_endpoint", "role"):
        assert getattr(t, m)() == getattr(j, m)(), m
    # without a runtime the environment's protocol gives rank and world
    assert (get_rank(), get_world_size()) == (t.worker_index(),
                                              t.worker_num())


def test_role_makers_refuse_as_jax(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "5")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    for mod in (role_maker, jrole):
        with pytest.raises(ValueError, match="out of range"):
            mod.PaddleCloudRoleMaker()
        with pytest.raises(ValueError, match="out of range"):
            mod.UserDefinedRoleMaker(current_id=2, worker_num=2)
    u, ju = (role_maker.UserDefinedRoleMaker(current_id=1, worker_num=3),
             jrole.UserDefinedRoleMaker(current_id=1, worker_num=3))
    assert (u.worker_index(), u.worker_num(), u.role()) == \
        (ju.worker_index(), ju.worker_num(), ju.role())


@pytest.fixture
def torch_rng():
    """The default generator's state, restored after the test."""
    state = torch.get_rng_state()
    yield
    torch.set_rng_state(state)


def test_rng_tracker_seeds_match_jax(torch_rng):
    dims = (2, 1, 1, 1, 2)
    topo.HybridCommunicateGroup(topo.CommunicateTopology(dims=dims),
                                global_rank=3)
    jtopo.HybridCommunicateGroup(jtopo.CommunicateTopology(dims=dims),
                                 global_rank=3)
    try:
        trandom.model_parallel_random_seed(7, device="cpu")
        jrandom.model_parallel_random_seed(7)
    finally:
        topo._reset_hcg()
        jtopo._reset_hcg()
    t, j = trandom.get_rng_state_tracker(), jrandom.get_rng_state_tracker()
    assert sorted(t.states_) == sorted(j.states_)
    assert t.seeds_ == j.seeds_
    seeds = {k: g.initial_seed() for k, g in t.states_.items()}
    assert seeds == {trandom.GLOBAL_RNG: 7 + 100 + 10,
                     trandom.MODEL_PARALLEL_RNG: 7 + 10 + 10,
                     trandom.LOCAL_RNG: 7 + 1024 + 3}
    for name, seed in seeds.items():              # JAX's key of that seed
        np.testing.assert_array_equal(
            np.asarray(j.states_[name]),
            np.asarray(jax.random.PRNGKey(seed)))


def test_rng_state_swaps_the_default_generator(torch_rng):
    tr = trandom.RNGStatesTracker()
    tr.add("a", 11, device="cpu")
    torch.manual_seed(0)
    with tr.rng_state("a"):
        first = torch.rand(3)
    base = torch.rand(3)
    torch.manual_seed(0)
    assert torch.equal(base, torch.rand(3))       # the default stream kept
    assert torch.equal(first, torch.rand(
        3, generator=torch.Generator().manual_seed(11)))
    with tr.rng_state("a"):
        second = torch.rand(3)                     # the state advanced
    gen = torch.Generator().manual_seed(11)
    torch.rand(3, generator=gen)
    assert torch.equal(second, torch.rand(3, generator=gen))
    with pytest.raises(ValueError, match="already exists"):
        tr.add("b", 11, device="cpu")
    with pytest.raises(ValueError, match="does not exist"):
        with tr.rng_state("missing"):
            pass
