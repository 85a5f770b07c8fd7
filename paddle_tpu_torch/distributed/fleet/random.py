"""Tensor-parallel random states (counterpart of
``paddle_tpu/distributed/fleet/random.py``).

:class:`RNGStatesTracker` keeps named ``torch.Generator`` states. Inside
``rng_state(name)`` the device's default generator runs from that state
(swapped in, then the advanced state swapped back out), so dropout in a
tensor-parallel region draws the same mask on every ``mp`` rank (the
model-parallel state) or a different one on each (the local state), as in
Megatron and Paddle. The reference folds a rank into a JAX key instead; the
seeds are the same.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from ...device import DeviceLike, resolve_device

MODEL_PARALLEL_RNG = "model_parallel_rng"
LOCAL_RNG = "local_seed"
GLOBAL_RNG = "global_seed"


def _default_state(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def _set_default_state(device: torch.device, state) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


class RNGStatesTracker:
    def __init__(self):
        self.states_: Dict[str, torch.Generator] = {}
        self.seeds_ = set()
        self.active_state: Optional[str] = None

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name: str, seed: int, device: DeviceLike = None):
        """A state ``name`` seeded with ``seed`` on ``device`` (default:
        the card)."""
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        gen = torch.Generator(device=resolve_device(device))
        self.states_[name] = gen.manual_seed(int(seed))

    def get_states_tracker(self) -> Dict[str, torch.Tensor]:
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states_tracker(self, states: Dict[str, torch.Tensor]) -> None:
        for k, st in states.items():
            self.states_[k].set_state(st)

    def generator(self, name: str = MODEL_PARALLEL_RNG) -> torch.Generator:
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        return self.states_[name]

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        """The device's default generator runs from state ``name`` for the
        duration."""
        gen = self.generator(name)
        dev = gen.device
        saved = _default_state(dev)
        _set_default_state(dev, gen.get_state())
        prev, self.active_state = self.active_state, name
        try:
            yield
        finally:
            self.active_state = prev
            gen.set_state(_default_state(dev))
            _set_default_state(dev, saved)


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(seed: int = 1024, device: DeviceLike = None):
    """The tracker's states from a base seed and this rank's place in the
    topology, as the reference sets them: the model-parallel state is the
    same on every ``mp`` rank of a (dp, pp) slot, the local state differs
    from rank to rank; the global state also seeds ``torch``'s default
    generators."""
    from . import base_topology
    hcg = base_topology.try_get_hybrid_communicate_group()
    if hcg is not None:
        dp_rank = hcg.get_data_parallel_rank()
        pp_rank = hcg.get_stage_id()
        global_rank = hcg.get_global_rank()
    else:
        dp_rank = pp_rank = global_rank = 0
    local_seed = seed + 1024 + global_rank
    global_seed = seed + 100 + dp_rank * 10 + pp_rank
    tracker = get_rng_state_tracker()
    tracker.reset()
    tracker.add(GLOBAL_RNG, global_seed, device)
    tracker.add(LOCAL_RNG, local_seed, device)
    tracker.add(MODEL_PARALLEL_RNG, seed + 10 + dp_rank * 10 + pp_rank,
                device)
    torch.manual_seed(global_seed)


def determinate_seed(name: str) -> int:
    import zlib
    return zlib.adler32(name.encode())
