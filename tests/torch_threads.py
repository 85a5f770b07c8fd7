"""One intra-op thread for torch in the port's test processes.

Every ``tests/test_torch_*.py`` imports this module first. The suite runs
under several xdist workers on one host, and torch's default (one thread a
core) only makes the workers' threads compete with each other and with
JAX's compiles: a test that burns 99 s of CPU on 8 threads takes the same
wall time on one thread with 32 s of CPU. No parity tolerance depends on
the count: each file passes at either.
"""

import torch

torch.set_num_threads(1)
