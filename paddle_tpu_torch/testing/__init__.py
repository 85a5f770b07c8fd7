"""Robustness-testing utilities.

:mod:`paddle_tpu_torch.testing.faults` is the deterministic fault-injection
registry (``FLAGS_fault_inject``) the serving engine's replay recovery is
exercised against; :mod:`paddle_tpu_torch.testing.transport` checks that a
``harvest_request`` bundle crosses a process boundary intact, and resumes
its decode in a spawned child.
"""

from __future__ import annotations

from . import faults, transport

__all__ = ["faults", "transport"]
