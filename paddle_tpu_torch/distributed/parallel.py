"""The parallel environment (counterpart of
``paddle_tpu/distributed/parallel.py``).

:func:`init_parallel_env` reads the reference's launch protocol and starts
``torch.distributed``:

  PADDLE_TRAINER_ID    this process's global rank (default 0)
  PADDLE_TRAINERS_NUM  the world size (default 1)
  PADDLE_MASTER        host:port of rank 0's store (else the first of
                       PADDLE_TRAINER_ENDPOINTS; a one-rank world without
                       either takes a free localhost port)
  PADDLE_LOCAL_RANK    this process's card on its host (default: the rank)

By default each rank runs NCCL on ``cuda:PADDLE_LOCAL_RANK``. Gloo on the
CPU runs only when asked (``backend="gloo", device="cpu"``); without a card
and without that request the call raises, never falling back to the CPU.
Gloo on a CUDA device (``backend="gloo", device="cuda:0"``) lets several
ranks share one card, which NCCL refuses.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from .communication.group import DEFAULT_TIMEOUT, _world_group

_device: Optional[torch.device] = None
# the timeout init_parallel_env was given: later groups take it too
_timeout = DEFAULT_TIMEOUT


def _reset() -> None:
    global _device, _timeout
    _device, _timeout = None, DEFAULT_TIMEOUT


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ParallelEnv:
    """The environment's view of this process (reference class)."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    nranks = world_size

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("PADDLE_LOCAL_RANK", str(self.rank)))

    dev_id = local_rank

    @property
    def device(self) -> Optional[torch.device]:
        """The device this rank's collectives run on (None before
        :func:`init_parallel_env`)."""
        return _device

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


def _master(world: int) -> str:
    master = os.environ.get("PADDLE_MASTER")
    if not master:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        master = eps.split(",")[0] if eps else ""
    if not master:
        if world > 1:
            raise RuntimeError(
                f"init_parallel_env: a world of {world} ranks needs "
                "PADDLE_MASTER (host:port of rank 0's store)")
        master = f"127.0.0.1:{free_port()}"
    return master


def init_parallel_env(backend: Optional[str] = None, device=None,
                      timeout: datetime.timedelta = DEFAULT_TIMEOUT
                      ) -> ParallelEnv:
    """Start this rank's process group from the ``PADDLE_*`` protocol
    (once; later calls return the environment). ``backend`` defaults to
    ``"nccl"`` and ``device`` to ``cuda:PADDLE_LOCAL_RANK``; the world's
    collectives, and those of every group made later without a timeout of
    its own, fail after ``timeout``."""
    global _device, _timeout
    if dist.is_initialized():
        return ParallelEnv()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    local = int(os.environ.get("PADDLE_LOCAL_RANK", str(rank)))
    backend = backend or "nccl"
    dev = torch.device(device if device is not None else f"cuda:{local}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_parallel_env runs on the CUDA card by default, but "
                "torch.cuda.is_available() is False; pass backend='gloo', "
                "device='cpu' to run ranks on the CPU")
        torch.cuda.set_device(dev)
    elif backend != "gloo":
        raise ValueError(f"init_parallel_env: backend {backend!r} on "
                         f"{dev.type}; the CPU runs gloo")
    dist.init_process_group(backend, init_method=f"tcp://{_master(world)}",
                            world_size=world, rank=rank, timeout=timeout)
    _device, _timeout = dev, timeout
    _world_group()
    return ParallelEnv()


def get_rank(group=None) -> int:
    if group is not None:
        return group.rank
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def is_initialized() -> bool:
    return dist.is_initialized()


def device_count() -> int:
    return torch.cuda.device_count()
