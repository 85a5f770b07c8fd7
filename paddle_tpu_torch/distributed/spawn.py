"""``paddle.distributed.spawn`` (counterpart of
``paddle_tpu/distributed/spawn.py``): run ``func(rank, *args)`` in
``nprocs`` fresh processes with the ``PADDLE_*`` launch protocol set
(:mod:`.parallel`), rank 0's store on a free localhost port.

Processes start with the ``spawn`` method, never ``fork``: the caller may
hold a CUDA context or JAX's threads, which a forked child inherits
broken. ``join`` waits at most ``timeout`` seconds; a rank that raised, or
died, or is still running then fails the call with the failing rank's
traceback (the others are terminated). What each ``func`` returns comes
back, pickled, in :attr:`MultiprocessContext.results`.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

from .parallel import free_port


@contextlib.contextmanager
def _environ(env: Dict[str, str]):
    """``env`` set in this process while a child starts (a spawned child
    copies the environment when it starts, before it imports anything)."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _worker(func, rank, args, out):
    try:
        out.put((rank, True, func(rank, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


class MultiprocessContext:
    """The spawned ranks (reference: ``MultiprocessContext``):
    ``processes`` in rank order, ``results`` (each rank's return value)
    once :meth:`join` has returned."""

    def __init__(self, processes, out):
        self.processes = processes
        self.results: List[Any] = [None] * len(processes)
        self._out = out
        self._done: Dict[int, bool] = {}

    def _drain(self, block_s: float) -> None:
        """Take every result waiting (the first within ``block_s``): a
        context joined after its ranks have exited holds several."""
        try:
            item = self._out.get(timeout=block_s)
        except queue.Empty:
            return
        while True:
            rank, ok, value = item
            if not ok:
                self._fail(f"rank {rank} raised:\n{value}")
            self.results[rank] = value
            self._done[rank] = True
            try:
                item = self._out.get_nowait()
            except queue.Empty:
                return

    def _fail(self, msg: str) -> None:
        self.terminate()
        raise RuntimeError(f"spawn: {msg}")

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for every rank (at most ``timeout`` seconds)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        n = len(self.processes)
        while len(self._done) < n:
            self._drain(0.2)
            for rank, p in enumerate(self.processes):
                if rank not in self._done and not p.is_alive() \
                        and p.exitcode is not None:
                    # its last words may still be in the queue
                    self._drain(1.0)
                    if rank not in self._done:
                        self._fail(f"rank {rank} exited with code "
                                   f"{p.exitcode} without a result")
            if deadline is not None and time.monotonic() > deadline:
                late = [r for r in range(n) if r not in self._done]
                self._fail(f"ranks {late} still running after {timeout} s")
        for p in self.processes:
            p.join(timeout=10)

    def terminate(self) -> None:
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        for p in self.processes:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()


def spawn(func, args: Sequence = (), nprocs: int = -1, join: bool = True,
          daemon: bool = False, timeout: Optional[float] = None,
          env: Optional[Dict[str, str]] = None) -> MultiprocessContext:
    """Start ``nprocs`` ranks (at least 1) of ``func(rank, *args)``;
    ``env`` adds variables to every rank's environment. With ``join`` the
    call returns once all ranks returned (see :meth:`MultiprocessContext.
    join`)."""
    nprocs = max(1, int(nprocs))
    ctx = mp.get_context("spawn")
    master = f"127.0.0.1:{free_port()}"
    out = ctx.Queue()
    procs = []
    for rank in range(nprocs):
        penv = {
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nprocs),
            "PADDLE_LOCAL_RANK": str(rank),
            "PADDLE_MASTER": master,
        }
        penv.update(env or {})
        p = ctx.Process(target=_worker, args=(func, rank, tuple(args), out),
                        daemon=daemon)
        with _environ(penv):
            p.start()
        procs.append(p)
    context = MultiprocessContext(procs, out)
    if join:
        context.join(timeout)
    return context
