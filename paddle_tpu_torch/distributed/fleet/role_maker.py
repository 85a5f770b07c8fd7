"""Role makers (a copy of ``paddle_tpu/distributed/fleet/role_maker.py``,
which imports no JAX): resolve this process's identity in the job from the
``PADDLE_*`` launch protocol (:mod:`..parallel`).

Collective roles are the default; ``is_collective=False`` resolves the
parameter-server TRAINER/PSERVER split. The port has no parameter-server
runtime yet, so ``fleet.init`` refuses that mode.
"""

from __future__ import annotations

import os
from typing import List, Optional

__all__ = ["Role", "PaddleCloudRoleMaker", "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class RoleMakerBase:
    def _get_rank(self) -> int:
        raise NotImplementedError

    def _get_size(self) -> int:
        raise NotImplementedError

    # reference API names
    def worker_index(self) -> int:
        return self._get_rank()

    def worker_num(self) -> int:
        return self._get_size()

    def is_worker(self) -> bool:
        return True

    def is_server(self) -> bool:
        return False

    def is_first_worker(self) -> bool:
        return self._get_rank() == 0

    def role(self):
        return Role.WORKER


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reads the launch CLI's env protocol:

      PADDLE_TRAINER_ID          this process's global rank
      PADDLE_TRAINERS_NUM        world size
      PADDLE_TRAINER_ENDPOINTS   comma-separated host:port of every rank
      PADDLE_CURRENT_ENDPOINT    this rank's endpoint

    Parameter-server mode (``is_collective=False``; reference
    role_maker._ps_env) adds:

      TRAINING_ROLE                  TRAINER | PSERVER
      PADDLE_PSERVERS_IP_PORT_LIST   comma-separated server host:port
      POD_IP / PADDLE_PORT           this server's bind address
    """

    def __init__(self, is_collective: bool = True, **kwargs):
        self._is_collective = is_collective
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._endpoints: List[str] = [e for e in eps.split(",") if e]
        self._current = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        self._role = Role.WORKER
        self._server_endpoints: List[str] = []
        if not is_collective:
            # PS env is parsed ONLY in PS mode (reference _ps_env): a
            # stale PADDLE_PSERVERS_IP_PORT_LIST must not give a
            # collective job phantom servers
            srv = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
            self._server_endpoints = [e for e in srv.split(",") if e]
            training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
            if training_role not in ("TRAINER", "PSERVER"):
                raise ValueError(
                    f"TRAINING_ROLE={training_role!r}: expected TRAINER "
                    "or PSERVER")
            if training_role == "PSERVER":
                if "PADDLE_PORT" not in os.environ:
                    raise ValueError(
                        "TRAINING_ROLE=PSERVER needs PADDLE_PORT (and "
                        "POD_IP) to locate this server in "
                        "PADDLE_PSERVERS_IP_PORT_LIST")
                self._role = Role.SERVER
                self._current = (
                    os.environ.get("POD_IP", "127.0.0.1") + ":"
                    + os.environ["PADDLE_PORT"])
                if self._current not in self._server_endpoints:
                    raise ValueError(
                        f"this server {self._current} is not in "
                        f"PADDLE_PSERVERS_IP_PORT_LIST="
                        f"{self._server_endpoints}")
        if self._endpoints and len(self._endpoints) != self._size:
            raise ValueError(
                f"PADDLE_TRAINER_ENDPOINTS has {len(self._endpoints)} "
                f"entries but PADDLE_TRAINERS_NUM={self._size}")
        if not 0 <= self._rank < self._size:
            raise ValueError(
                f"PADDLE_TRAINER_ID={self._rank} out of range for "
                f"PADDLE_TRAINERS_NUM={self._size}")

    def _get_rank(self) -> int:
        return self._rank

    def _get_size(self) -> int:
        return self._size

    def get_trainer_endpoints(self) -> List[str]:
        return list(self._endpoints)

    def get_current_endpoint(self) -> str:
        return self._current

    # ------------------------------------------------- PS-mode identity
    def role(self):
        return self._role

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def server_endpoints(self) -> List[str]:
        return list(self._server_endpoints)

    def server_num(self) -> int:
        return len(self._server_endpoints)

    def server_index(self) -> int:
        if self._role != Role.SERVER:
            return -1
        return self._server_endpoints.index(self._current)


class UserDefinedRoleMaker(RoleMakerBase):
    """Explicit identity, no env (reference class of the same name)."""

    def __init__(self, current_id: int = 0, worker_num: int = 1,
                 worker_endpoints: Optional[List[str]] = None,
                 role=Role.WORKER, **kwargs):
        if not 0 <= current_id < worker_num:
            raise ValueError(
                f"current_id={current_id} out of range for "
                f"worker_num={worker_num}")
        self._rank = current_id
        self._size = worker_num
        self._endpoints = list(worker_endpoints or [])
        self._role = role

    def _get_rank(self) -> int:
        return self._rank

    def _get_size(self) -> int:
        return self._size

    def get_trainer_endpoints(self) -> List[str]:
        return list(self._endpoints)

    def role(self):
        return self._role
