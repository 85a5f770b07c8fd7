"""Robustness-testing utilities.

:mod:`paddle_tpu_torch.testing.faults` is the deterministic fault-injection
registry (``FLAGS_fault_inject``) the serving engine's replay recovery is
exercised against. The JAX package's cross-process handoff harness
(``transport``) comes with the engine's ``harvest_request`` and
``adopt_request``, which are not ported yet.
"""

from __future__ import annotations

from . import faults

__all__ = ["faults"]
