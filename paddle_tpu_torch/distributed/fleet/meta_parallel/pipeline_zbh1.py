"""The zero-bubble (ZBH1) pipeline schedule (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_zbh1.py``).

Each stage's backward is split into B, the gradient of the stage's input
(the critical path: it is sent down at once), and W, the gradients of
the stage's parameters, which can wait and fill the ticks where the
lockstep schedules idle. :func:`zbh1_schedule` is the reference's greedy
static table (at most one unit a stage a tick, priority B > F > W) and
:func:`_stash_tables` its arrival table, both copied (pure numpy), so the
port's tables equal the reference's. ``PipelineTrainStep(schedule=
"zbh1")`` runs each rank's row of :func:`zbh1_ticks`:

- F: the stage's forward (stage 0 runs the prefix first; the last stage
  its suffix and the loss, scaled by 1/M), keeping the output of every
  module that owns parameters;
- B: one ``torch.autograd.grad`` (``retain_graph=True``) from the stage's
  output to its input and to those module outputs: the attention's
  backward runs here, once, and the input's gradient goes to the stage
  below (stage 0 sends none);
- W: each such module's parameter gradients from its output's gradient,
  through its own backward node alone (a ``Linear``'s X^T dY); a
  parameter read outside its module's forward (a tied weight through
  ``forward_func``) takes its gradient from the kept graph. Under
  ``remat`` no output is kept (a checkpointed block holds none): B takes
  the input's gradient and W all the parameters' from the kept graph,
  which recomputes the blocks and runs their backward again.

Designed difference: the reference's W recomputes the stage's forward (a
functional program keeps no graph between units); the port keeps the
autograd graph and the module outputs' gradients from F until W instead,
so a stage holds a microbatch's activations from its F to its W. Scope
and refusals are the reference's: no interleaved VPP, an even stage
split, ZeRO levels 1-2 over ``dp``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def zbh1_schedule(S: int, M: int) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Greedy ZBH1 tables: (F, B, W), each (T, S), holding the microbatch
    index a stage processes at that tick, or -1. Priority B > F > W."""
    f_time = np.full((S, M), -1)
    b_time = np.full((S, M), -1)
    next_f = [0] * S
    next_b = [0] * S
    next_w = [0] * S
    rows_f, rows_b, rows_w = [], [], []
    t = 0
    cap = 6 * (M + S) + 8
    while any(n < M for n in next_w) and t < cap:
        rf, rb, rw = [-1] * S, [-1] * S, [-1] * S
        for s in range(S):
            m = next_b[s]
            b_ready = m < M and (
                (s == S - 1 and 0 <= f_time[s][m] < t)
                or (s < S - 1 and 0 <= b_time[s + 1][m] < t))
            mf = next_f[s]
            f_ready = mf < M and (s == 0 or 0 <= f_time[s - 1][mf] < t)
            if b_ready:
                rb[s] = m
                b_time[s][m] = t
                next_b[s] += 1
            elif f_ready:
                rf[s] = mf
                f_time[s][mf] = t
                next_f[s] += 1
            elif next_w[s] < next_b[s]:
                rw[s] = next_w[s]
                next_w[s] += 1
        rows_f.append(rf)
        rows_b.append(rb)
        rows_w.append(rw)
        t += 1
    if any(n < M for n in next_w):
        raise RuntimeError(f"zbh1 schedule did not complete in {cap} ticks")
    return (np.asarray(rows_f, np.int32), np.asarray(rows_b, np.int32),
            np.asarray(rows_w, np.int32))


def _stash_tables(Ft, Bt, S):
    """stash_f[t][s]: slot where the activation arriving at stage s at the
    START of tick t belongs (= what s-1 forwarded at t-1); stash_b the
    same for dx arriving from s+1. -1 = nothing arrived."""
    T = Ft.shape[0]
    sf = np.full((T, S), -1, np.int32)
    sb = np.full((T, S), -1, np.int32)
    for t in range(1, T):
        for s in range(S):
            if s > 0:
                sf[t][s] = Ft[t - 1][s - 1]
            if s < S - 1:
                sb[t][s] = Bt[t - 1][s + 1]
    return sf, sb


def zbh1_ticks(S: int, M: int) -> List[List[Optional[Tuple[str, int,
                                                              int]]]]:
    """:func:`zbh1_schedule` as the runner's tick table: at each tick, each
    stage's unit ``(kind, stage, microbatch)`` or None. A message sent at
    tick t is in its receiver's stash at tick t + 1, as
    :func:`_stash_tables` says."""
    tables = dict(zip("FBW", zbh1_schedule(S, M)))
    ticks = []
    for t in range(tables["F"].shape[0]):
        row: List[Optional[Tuple[str, int, int]]] = [None] * S
        for kind, tab in tables.items():
            for s in range(S):
                if tab[t][s] >= 0:
                    row[s] = (kind, s, int(tab[t][s]))
        ticks.append(row)
    return ticks
