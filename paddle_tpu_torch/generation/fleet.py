"""Fleet serving: a prefix-affinity router over N ``ServingEngine``
replicas of one model (counterpart of ``paddle_tpu/generation/fleet.py``).

:class:`FleetRouter` owns N engines over ONE model and places every
submitted request by

- **prefix affinity**: the replica whose
  :class:`~paddle_tpu_torch.generation.serving.PrefixCache` holds the
  longest page-aligned prefix of the prompt
  (``PrefixCache.peek(include_spilled=True)``: a host-tier hit still beats
  a cold prefill), so shared system prompts concentrate per replica;
- **deadline-aware load** as the tiebreak among equal hits: a request with
  a deadline goes to the replica with the least deadline-bearing work,
  then the least work; one without, the least work first;
- **round robin** as the fallback for a prompt no replica has seen
  (``policy="round_robin"`` forces it for every request: the baseline
  arm).

Replica loss is an event, not an exception path: the ``router_dispatch``
fault site drills it. A replica whose step raises is harvested (its
finished results banked above the engines, its live requests exported as
host state through ``export_requests``), its device state released, and it
is rebuilt with the same geometry while the harvested requests re-route
through normal placement (``inject_request``). Greedy decoding makes every
re-routed continuation the uninterrupted one, token for token. Consecutive
losses with no finished work in between are bounded by ``max_losses``
(``FLAGS_serving_max_retries`` x max(2, replicas)); past it ``run_step``
raises.

All router state is host-side Python. On the card the replicas share the
model's weights; each has its own pools and captures its own CUDA graphs (a
graph binds one engine's pools: one per bucket rung, one for its chunk
program), where the JAX replicas share one compiled program per key. A
rebuilt replica allocates fresh pools and captures afresh; the lost one's
pools, stacked weights and graphs are released first
(:meth:`ServingEngine.close`), so losses do not accumulate device memory.
``FLAGS_fused_block_layers=N > 1`` stacks a device copy of the decoder
weights in every engine (about 13 GB at Llama-2-7B width), so N > 1 costs
that per replica, and one more while a lost replica is rebuilt: run a
fleet at N = 1.

Unlike the JAX router, a kernel or CUDA error
(:class:`~paddle_tpu_torch.kernels._build.KernelError`,
``torch.AcceleratorError``) raised by a replica's step is not taken for a
loss: it propagates, as the engine's own recovery lets it.

Telemetry: ``fleet_requests_routed{replica,reason}``,
``fleet_replica_losses{replica}``, ``fleet_rerouted_requests`` and the
``fleet_replicas`` gauge, as in the JAX package.

Not ported yet: tensor-parallel replicas (``tp_degree > 1`` raises through
the engine).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import flags as _flags
from .. import observability as obs
from ..testing import faults
from .serving import _UNRECOVERABLE, OK, Request, ServingEngine

__all__ = ["FleetRouter"]


class _FleetTelemetry:
    enabled = True

    def __init__(self):
        r = obs.registry()
        self.routed = r.counter(
            "fleet_requests_routed",
            "requests placed by the fleet router, by replica and "
            "placement reason (affinity = longest cached prefix won; "
            "balance = affinity tie broken by deadline-aware load; "
            "round_robin = no replica had the prefix)",
            labels=("replica", "reason"))
        self.losses = r.counter(
            "fleet_replica_losses",
            "replica-loss events absorbed by the router (harvest + "
            "rebuild + re-route)", labels=("replica",))
        self.rerouted = r.counter(
            "fleet_rerouted_requests",
            "in-flight/queued requests re-routed from a lost replica "
            "out of its host-side state")
        self.replicas = r.gauge(
            "fleet_replicas", "engine replicas the router is driving")


class _NullFleetTelemetry:
    enabled = False

    def __init__(self):
        self.routed = self.losses = obs.NULL
        self.rerouted = self.replicas = obs.NULL


def _host_prompt(prompt) -> np.ndarray:
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu().numpy()
    return np.asarray(prompt, np.int32).reshape(-1)


class FleetRouter:
    """Drive ``model`` behind N :class:`ServingEngine` replicas with
    prefix-affinity placement. The surface is the engine's: ``submit``
    returns a fleet-wide rid; ``run_step`` pumps every replica with work
    one scheduler round; ``poll``, ``results``, ``take_results``,
    ``status`` and ``statuses`` translate rids; ``run`` steps until
    drained. Engine keyword arguments apply to every replica;
    ``prefix_cache`` defaults on. Host probes: ``placements`` ((rid,
    replica, reason) in order), ``losses``, ``rerouted``."""

    POLICIES = ("prefix_affinity", "round_robin")

    def __init__(self, model, replicas: int = 2,
                 policy: str = "prefix_affinity", **engine_kw):
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown policy {policy!r} (have {self.POLICIES})")
        self.model = model
        self.policy = policy
        engine_kw.setdefault("prefix_cache", True)
        self._engine_kw = dict(engine_kw)
        self.engines: List[ServingEngine] = [
            self._make_engine(i) for i in range(replicas)]
        self._rr = 0                    # round-robin cursor
        self._next_rid = 0              # fleet-wide rids
        # fleet rid -> (replica, local rid), and each replica's inverse
        self._where: Dict[int, Tuple[int, int]] = {}
        self._local2g: List[Dict[int, int]] = [{} for _ in range(replicas)]
        # results and statuses banked above the engines: a lost replica's
        # finished work survives its rebuild here
        self._results: Dict[int, List[int]] = {}
        self._status: Dict[int, str] = {}
        # the loss budget: consecutive losses with no finished work
        # anywhere in the fleet in between
        self.max_losses = (int(_flags.get_flag("serving_max_retries"))
                           * max(2, replicas))
        self._consec_losses = 0
        self._completed_at_loss = 0
        self.losses = 0
        self.rerouted = 0
        self.placements: List[Tuple[int, int, str]] = []
        self._f_router = faults.site("router_dispatch")
        self._m = (_FleetTelemetry() if obs.enabled()
                   else _NullFleetTelemetry())
        self._observe_fleet()

    def _make_engine(self, idx: int) -> ServingEngine:
        return ServingEngine(self.model, replica=str(idx),
                             **self._engine_kw)

    # ------------------------------------------------------------ frontend
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               deadline: Optional[float] = None,
               on_token: Optional[Callable] = None,
               replica: Optional[int] = None) -> int:
        """Place one request and return its fleet rid. ``on_token`` is
        called with the fleet rid (the wrapper closes over it, so it
        survives re-routing); ``replica`` pins the placement."""
        prompt = _host_prompt(prompt)
        rid = self._next_rid
        self._next_rid += 1
        if replica is not None:
            ri, why = int(replica), "pinned"
        else:
            ri, why = self._place(prompt, deadline)
        cb = None
        if on_token is not None:
            def cb(_lrid, tok, done, _cb=on_token, _g=rid):
                try:
                    _cb(_g, tok, done)
                except Exception as exc:
                    # a raising user callback surfaces to the caller, and
                    # is never taken for a replica loss
                    exc._fleet_callback = True
                    raise
        lrid = self.engines[ri].submit(
            prompt, max_new_tokens, eos_token_id=eos_token_id,
            deadline=deadline, on_token=cb)
        self._where[rid] = (ri, lrid)
        self._local2g[ri][lrid] = rid
        self.placements.append((rid, ri, why))
        self._observe_placement(ri, why)
        return rid

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    def run_step(self) -> bool:
        """One scheduler round on every replica with work. A replica whose
        check of ``router_dispatch`` or whose step raises is lost: its
        finished results bank, its live requests re-route from host state
        and it is rebuilt. Returns whether work remains."""
        for ri in range(len(self.engines)):
            eng = self.engines[ri]
            if not eng.has_work():
                continue
            try:
                self._f_router.check(replica=ri)
                eng.step()
            except Exception as exc:
                if (getattr(exc, "_fleet_callback", False)
                        or isinstance(exc, _UNRECOVERABLE)):
                    raise
                if self._fleet_completed() > self._completed_at_loss:
                    self._consec_losses = 0     # progress since the last
                if self._consec_losses >= self.max_losses:
                    raise
                self._lose_replica(ri, exc)
        return self.has_work()

    def run(self, max_wall: Optional[float] = None
            ) -> Dict[int, List[int]]:
        """Step until drained; returns ``{rid: tokens}`` and keeps the
        statuses of exactly those rids until the next drain. Past
        ``max_wall`` seconds every replica's remaining work ends
        ``TIMEOUT``."""
        t0 = time.perf_counter()
        while self.has_work():
            if max_wall is not None and time.perf_counter() - t0 > max_wall:
                why = "fleet run(max_wall=%.3f) watchdog" % max_wall
                for eng in self.engines:
                    if eng.has_work():
                        eng._expire_all(why)
                        eng._drain_events()
                break
            self.run_step()
        out = self._drain()
        self._status = {rid: self._status[rid] for rid in out
                        if rid in self._status}
        return out

    def results(self) -> Dict[int, List[int]]:
        """Finished results so far, without draining: banked ones and what
        every replica holds."""
        out = dict(self._results)
        for ri, eng in enumerate(self.engines):
            for lrid, toks in eng.results().items():
                rid = self._local2g[ri].get(lrid)
                if rid is not None:
                    out[rid] = toks
        return out

    def take_results(self) -> Dict[int, List[int]]:
        """Drain finished results and their statuses."""
        out = self._drain()
        for rid in out:
            self._status.pop(rid, None)
        return out

    def poll(self, rid: int) -> Dict[str, object]:
        if rid in self._results:
            return {"status": self._status.get(rid, OK),
                    "tokens": list(self._results[rid]), "done": True}
        ri, lrid = self._where[rid]
        return self.engines[ri].poll(lrid)

    def status(self, rid: int) -> str:
        st = self._status.get(rid)
        if st is not None:
            return st
        loc = self._where.get(rid)
        if loc is None:
            return "PENDING"
        ri, lrid = loc
        return self.engines[ri].status(lrid)

    def statuses(self) -> Dict[int, str]:
        out = dict(self._status)
        for rid, (ri, lrid) in self._where.items():
            out[rid] = self.engines[ri].status(lrid)
        return out

    # ----------------------------------------------------------- placement
    def _place(self, prompt: np.ndarray,
               deadline: Optional[float]) -> Tuple[int, str]:
        """Prefix affinity, then the deadline-aware tiebreak, then round
        robin (or round robin alone under that policy)."""
        if self.policy == "round_robin" or len(self.engines) == 1:
            return self._rr_next(), "round_robin"
        best, cands = 0, []
        for ri, eng in enumerate(self.engines):
            if eng._prefix is None:
                continue
            hit = eng._prefix.peek(prompt, include_spilled=True)
            if hit > best:
                best, cands = hit, [ri]
            elif hit == best and best > 0:
                cands.append(ri)
        if not cands:
            return self._rr_next(), "round_robin"
        if len(cands) == 1:
            return cands[0], "affinity"
        return (min(cands, key=lambda ri: self._load_key(ri, deadline)),
                "balance")

    def _load_key(self, ri: int, deadline: Optional[float]):
        tight, total = self.engines[ri].load()
        return ((tight, total, ri) if deadline is not None
                else (total, tight, ri))

    def _rr_next(self) -> int:
        ri = self._rr % len(self.engines)
        self._rr += 1
        return ri

    # ------------------------------------------------------- replica loss
    def _fleet_completed(self) -> int:
        """Finished requests visible fleet-wide: banked ones plus every
        replica's undrained results (the loss budget's progress signal)."""
        return (len(self._results)
                + sum(len(e._results) for e in self.engines))

    def _lose_replica(self, ri: int, exc: Exception) -> None:
        """Absorb one loss: bank the replica's finished work, take its
        callbacks and export its live requests, release its device state,
        rebuild it with the same geometry and re-route the exports."""
        eng = self.engines[ri]
        st = eng.statuses()
        for lrid, toks in eng.take_results().items():
            rid = self._local2g[ri].pop(lrid, None)
            if rid is not None:
                self._where.pop(rid, None)
                self._results[rid] = toks
                self._status[rid] = st.get(lrid, OK)
        callbacks = eng.take_callbacks()
        harvested = eng.export_requests()
        eng.close()
        lost_map = self._local2g[ri]
        self._local2g[ri] = {}
        self.engines[ri] = self._make_engine(ri)
        self.losses += 1
        self._consec_losses += 1
        self._completed_at_loss = self._fleet_completed()
        self._observe_loss(ri)
        for req in harvested:
            cb = callbacks.get(req.rid)
            rid = lost_map.pop(req.rid, None)
            if rid is None:
                continue
            self._route_existing(rid, req, cb)
            self.rerouted += 1
        self._observe_reroutes(len(harvested))

    def _route_existing(self, rid: int, req: Request,
                        on_token: Optional[Callable] = None) -> None:
        """Re-route one harvested request through normal placement; it
        keeps its tokens and deadline and replays on the replica it
        lands on."""
        ri, why = self._place(req.prompt, req.deadline)
        lrid = self.engines[ri].inject_request(req, on_token=on_token)
        self._where[rid] = (ri, lrid)
        self._local2g[ri][lrid] = rid
        self.placements.append((rid, ri, why))
        self._observe_placement(ri, why)

    def _drain(self) -> Dict[int, List[int]]:
        out, self._results = self._results, {}
        for ri, eng in enumerate(self.engines):
            st = eng.statuses()
            for lrid, toks in eng.take_results().items():
                rid = self._local2g[ri].pop(lrid, None)
                if rid is None:
                    continue
                self._where.pop(rid, None)
                out[rid] = toks
                self._status.setdefault(rid, st.get(lrid, OK))
        if out:
            # drained completions are progress: re-baseline the budget
            self._consec_losses = 0
            self._completed_at_loss = self._fleet_completed()
        return out

    # ------------------------------------------------- telemetry helpers
    def _observe_fleet(self) -> None:
        if self._m.enabled:
            self._m.replicas.set(len(self.engines))

    def _observe_placement(self, ri: int, why: str) -> None:
        if self._m.enabled:
            self._m.routed.labels(replica=str(ri), reason=why).inc()

    def _observe_loss(self, ri: int) -> None:
        if self._m.enabled:
            self._m.losses.labels(replica=str(ri)).inc()

    def _observe_reroutes(self, n: int) -> None:
        if self._m.enabled and n:
            self._m.rerouted.inc(n)
