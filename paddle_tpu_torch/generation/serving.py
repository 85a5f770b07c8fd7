"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``paddle_tpu/generation/serving.py`` (``ServingEngine``'s
scheduler, request surface and prefix cache). Requests admit into free
batch slots as they open, in deadline-slack order (tightest first;
requests without a deadline keep submission order among themselves). A
prompt of at most ``prefill_chunk`` tokens (or any prompt with chunking
off, ``prefill_chunk=0``) is prefilled whole into the paged pool at
admission; a longer one parks on a cursor and is prefilled one fixed-size
chunk per step (``PagedChunkState``: the chunk attends to the written
prefix plus itself). Each step spends at most one prefill-compute unit
(one whole prefill or one chunk), alternating between new admissions and
in-flight chunks when both wait. Every step then decodes one greedy token
for every slot past its prefill, at the current rung of the batch-bucket
ladder, with per-slot ragged lengths; idle slots write into the reserved
null page and mid-prefill slots write at their cursor (the next chunk
overwrites it), and both outputs are ignored. Finished sequences return
their pages to the pool.

Around that core, as in the JAX package:

- the request surface: ``submit(deadline=, on_token=)``, ``run_step``,
  ``poll``, ``run(max_wall=)``, ``results``/``take_results``,
  ``status``/``statuses``, ``load``, and the router's
  ``export_requests``/``take_callbacks``/``inject_request``/``close``
  (:mod:`.fleet`);
- the disaggregated handoff: ``harvest_request`` detaches a live greedy
  request with its written KV pages (host copies, verbatim), and
  ``adopt_request`` seats such a bundle in another engine of the same pool
  geometry, mid-stream, writing the pages in place (its CUDA graphs keep
  their addresses): the continuation is the solo stream, bit for bit,
  with no prefill re-run. The bundle is host state only
  (``HANDOFF_SCHEMA_VERSION``-tagged; :mod:`..testing.transport` checks
  that it crosses a process boundary);
- terminal statuses ``OK``/``FAILED``/``TIMEOUT`` (deadlines are enforced
  at step boundaries, with the tokens produced so far);
- replay recovery: a step that raises does not propagate. The pools are
  reset in place (:meth:`PagedKVCache.reset`: the tensors keep their
  addresses, so the CUDA graphs captured over them keep replaying), the
  prefix cache starts empty, every in-flight request goes back to the
  queue in replay form, and one whose no-progress budget
  (``FLAGS_serving_max_retries``) is spent ends ``FAILED``; the engine
  backs off exponentially (``FLAGS_serving_retry_backoff``) while nothing
  progresses. A :class:`~paddle_tpu_torch.kernels._build.KernelError` (a
  kernel that does not build or launch) and a CUDA error
  (``torch.AcceleratorError``) are not replayed: ``step`` raises them, so
  no recovery hides a kernel or the device;
- replay-form admission: a request that carries tokens (a preemption
  victim, a recovered or an injected request) re-prefills prompt + tokens,
  and greedy decoding continues where it stopped;
- the bucket ladder (``FLAGS_serving_bucket_ladder``): decode runs at the
  smallest rung covering demand, grows at once and shrinks after
  ``FLAGS_serving_bucket_patience`` steps of lower demand, compacting the
  live block-table rows into the low slots (``bucket_migrations`` counts);
- SLO preemption (``FLAGS_serving_preempt``): a waiting request whose
  deadline is in danger unseats the slackest running one, which replays
  later (``preemptions`` counts);
- the prefix cache (``prefix_cache=True``, :class:`PrefixCache`): the full
  prompt pages of every prefilled request stay cached, and a later request
  with the same page-aligned prefix adopts them read-only instead of
  prefilling them. A short remaining suffix is teacher-forced through the
  decode step, a long one (more than two pages, chunking on) is prefilled
  in chunks from the adopted cursor. A page-blocked head first evicts
  cached pages, then may be passed (boundedly) by a request whose prefix is
  cached; preemption counts evictable pages. With ``host_tier_pages``
  (``FLAGS_serving_kv_host_tier_pages``) eviction spills cold pages to
  host memory, and a hit restores them, in place;
- telemetry (``FLAGS_telemetry``, :mod:`..observability`): the JAX engine's
  metric families under the same names, help strings and labels
  (``replica``, ``tp``), its request spans and events, and the pool ledger
  gauges, all written at the host boundary of a step, outside any captured
  CUDA graph (a write inside a capture would fire once and never on
  replay);
- fault sites (``FLAGS_fault_inject``, :mod:`..testing.faults`):
  ``prefill``, ``chunk_prefill`` and ``decode_dispatch`` checked after the
  pools are detached, ``bucket_migrate`` at a migration's begin, per
  compacted sequence and at its commit, ``preempt`` before a victim is
  unseated, the prefix cache's ``kv_spill`` before each spill and
  restore, and ``spec_draft`` / ``spec_verify`` before a speculation
  round's draft sync, draft scan and verify (before its cursor roll);
- speculative decoding (``draft_model=``): a step whose decode rows the
  slot budget affords (``FLAGS_serving_spec_max_slots``, a row billed
  γ + 1 slots) serves each row by one round: the draft's KV catches up to
  the target's through the draft's chunk program
  (``FLAGS_serving_spec_sync_chunk`` tokens a chunk), the draft scan runs
  γ + 1 decode steps of the draft at B = 1 (its token fed back on the
  device; the extra step writes the last proposal's KV), the proposals
  are read once, and the target verifies them in one (1, γ + 1) chunk
  (``PagedChunkState``). Greedy rows take the longest agreeing prefix and
  the target's token after it, so the tokens are the plain engine's;
  sampled rows (``submit(temperature > 0, top_k, top_p, seed)``) take
  rejection sampling against the target's filtered law
  (:mod:`.sampling`), with the draft's draws from uniforms of a
  ``torch.Generator`` seeded by (seed, position) and the acceptance's
  from numpy's ``default_rng((seed, position))``, so a replayed round
  draws the same. γ adapts per request within ``FLAGS_serving_spec_rungs``
  (``FLAGS_serving_spec_adaptive``). The draft keeps its own worst-case
  pool in slot lockstep with the target's.

The engine reaches the model through ``cache_spec()``,
``forward_with_cache`` (the generic decode and whole-prompt prefill),
``forward_hidden`` (the chunk, the draft scan's generic branch and the
verify: the hidden states, whose LM head the program applies to the rows it
reads; the chunk's to its tail row only) and ``logits``; the fused routes
also need ``block_decode_spec()`` (Llama's). A draft and its target share a
vocabulary.

Decode runs the fused block kernel once per layer (``FLAGS_fused_block_decode``,
the default), the N-layer kernel once per group of N layers
(``FLAGS_fused_block_layers=N > 1``, over weights stacked once per engine),
or the model's own cached forward, whose attention is the paged decode
kernel. Each bucket rung's decode program, the chunk program (one per
chunk length; its cursor, ``last_idx`` and block table are device inputs,
so nothing on the chunk path reads a device value on the host) and the
speculative programs (the draft's sync chunk, and a draft scan and a
verify per γ rung and mode) come from the process-wide
:mod:`.program_cache`. On the CPU a program is the eager step; on a CUDA
device the engine captures each as a CUDA graph (one per engine and key: a
graph binds this engine's pools and weights) after one eager call, and
replays it from static input buffers. Whole-prompt prefill stays eager
(one program per prompt length in the JAX package).

``kv_dtype="int8"`` (``FLAGS_serving_kv_dtype``) stores the pool as int8
rows with per-row f32 scales, written by every route and read by every
attention kernel; ``weight_dtype="int4"`` (``FLAGS_fused_weight_dtype``)
packs the N-layer route's stacked matrices as int4 tiles. Prefill and
chunks keep the native per-layer weights, and with N = 1 int4 changes
nothing, as in the JAX package.

Left for a later slice, and refused with ``NotImplementedError``:
tensor-parallel decode. Sampling needs a speculative engine, as in the JAX
package: without a draft model ``submit(temperature > 0)`` raises its
``ValueError``. A page-pool shortfall at admission backs the request off
to the queue, as in the JAX package.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import flags as _flags
from .. import kernels as _kernels
from .. import observability as obs
from ..kernels._build import KernelError
from ..kernels.fused_block_decode import (BlockDecodeWeights,
                                          MultiBlockDecodeWeights, _rms,
                                          fused_block_decode,
                                          fused_multi_block_decode,
                                          stack_block_weights)
from ..kernels.paged_attention import (PagedChunkState, PagedDecodeState,
                                       PagedKVCache, QuantizedPages)
from ..testing import faults
from .program_cache import (ATOM_FUSED, ATOM_GENERIC, ATOM_GREEDY,
                            ATOM_SAMPLE, TAG_KV, TAG_NLAYER, TAG_WT,
                            DecodeKey, decode_program_cache, model_signature)
from .sampling import _spec_filtered_probs, race_sample

__all__ = ["Request", "ServingEngine", "PrefixCache", "OK", "FAILED",
           "TIMEOUT", "HANDOFF_SCHEMA_VERSION"]

# terminal request statuses (Request.status / ServingEngine.status)
OK, FAILED, TIMEOUT = "OK", "FAILED", "TIMEOUT"

# what replay recovery never absorbs: a kernel that did not build or launch,
# and a CUDA error (it leaves the context unusable)
_UNRECOVERABLE = (KernelError, torch.AcceleratorError)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    # prompt-suffix tokens still to be teacher-forced through the decode
    # step (a prefix-cache admission skipped their prefill)
    pending: List[int] = field(default_factory=list)
    # prefix-cache pages this request adopted (pinned until it detaches)
    pinned: List[int] = field(default_factory=list)
    # host clock at submission and at the last generated token
    t_submit: float = 0.0
    t_last: float = 0.0
    # absolute host-clock cutoff (submit(deadline=...)), enforced at step
    # boundaries; None = no deadline
    deadline: Optional[float] = None
    # terminal status ("PENDING" while queued or in flight)
    status: str = "PENDING"
    error: Optional[str] = None
    # replay recovery: consecutive no-progress replays, and the (tokens,
    # prefill cursor) high-water mark at the last failure (progress on
    # either resets the budget: a long prompt's chunks are progress before
    # it has a token)
    retries: int = 0
    progress_mark: Tuple[int, int] = (-1, -1)
    # chunked prefill: what the chunks teacher-force (the prompt, plus the
    # emitted tokens on a replay), and the cursor (None once the request
    # decodes)
    feed: Optional[np.ndarray] = None
    prefill_pos: Optional[int] = None
    # times a cached-prefix request passed this one while it was the
    # page-blocked head (bounded by ServingEngine._BYPASS_BUDGET)
    bypassed: int = 0
    # times this request was unseated for a tighter deadline (bounded by
    # FLAGS_serving_preempt_budget)
    preempts: int = 0
    # the sampling law, carried for a speculative engine (temperature 0 =
    # greedy, the only law a plain engine serves)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    # per-request adaptive draft length: the current γ rung (0: none yet)
    # and the accept-rate EMA that moves it; both survive replay (the
    # draft's agreement is a property of the request's text)
    gamma: int = 0
    spec_ema: float = 0.5
    # the draft pool holds this slot's span (its cursor is the draft
    # pool's seq_lens row)
    spec_ready: bool = False


_POOL_STATES = ("used", "free", "shared", "pinned", "spilled")

# the harvest_request / adopt_request bundle's schema, checked at adoption:
# a pair of engines of different revisions refuses instead of mis-seating
# pages
HANDOFF_SCHEMA_VERSION = 1


class _EngineTelemetry:
    """Instrument handles for the serving hot path, resolved once per
    engine: a write inside ``step()`` is one attribute read, with no
    registry lookup and no flag read per token. The JAX engine's families
    under the same names, help strings and labels: every family carries
    ``replica`` (the engine's id: two engines in one process keep apart)
    and ``tp`` (the tensor-parallel degree, "1" here). The tensor-parallel
    family is registered, and nothing of this port writes it yet."""

    enabled = True

    def __init__(self, replica: str = "0", tp: str = "1"):
        r = obs.registry()
        t = obs.tracer()
        rl = ("replica", "tp")

        def c(name, help):
            return r.counter(name, help,
                             labels=rl).labels(replica=replica, tp=tp)

        def g(name, help):
            return r.gauge(name, help,
                           labels=rl).labels(replica=replica, tp=tp)

        def h(name, help):
            return r.histogram(name, help,
                               labels=rl).labels(replica=replica, tp=tp)

        self.span = t.span
        self.event = t.event
        self.submitted = c(
            "serving_requests_submitted", "requests accepted by submit()")
        self.finished = c(
            "serving_requests_finished", "requests that completed")
        self.prefills = c(
            "serving_prefills", "b=1 prefill programs dispatched")
        self.shared_admits = c(
            "serving_shared_admissions",
            "admissions that adopted cached prefix pages (prefill skipped)")
        self.decode_steps = c(
            "serving_decode_steps", "full-batch decode steps dispatched")
        self.ttft = h(
            "serving_ttft_seconds",
            "time to first generated token, submit() to host-visible")
        self.itl = h(
            "serving_inter_token_seconds",
            "per-request latency between consecutive generated tokens")
        self.queue_depth = g(
            "serving_queue_depth", "requests waiting for a batch slot")
        self.occupancy = g(
            "serving_batch_occupancy",
            "active slots in the fixed-shape decode batch")
        self.kv_pages_in_use = g(
            "serving_kv_pages_in_use",
            "KV pool pages held by sequences or the prefix cache "
            "(excludes the reserved null page)")
        self.prefix_pinned = g(
            "serving_prefix_pinned_pages",
            "prefix-cache pages pinned by in-flight requests — the "
            "pressure that caps evict() reclaim")
        self.evict_short = c(
            "serving_prefix_evict_shortfall_pages",
            "pages evict() was asked for but could not free "
            "(pinned/shared)")
        # ---- fault-tolerance instruments (replay recovery)
        self.retries = c(
            "serving_retries_total",
            "in-flight request replays re-queued by recovery after a "
            "failed dispatch")
        self.recoveries = c(
            "serving_recoveries",
            "replay-recovery events: failed dispatch -> fresh pools + "
            "re-queue of all in-flight requests")
        self.requests_failed = c(
            "serving_requests_failed",
            "requests terminated FAILED (no-progress retry budget "
            "exhausted)")
        self.requests_timeout = c(
            "serving_requests_timeout",
            "requests terminated TIMEOUT (per-request deadline or the "
            "run(max_wall=...) watchdog)")
        self.recovery_seconds = h(
            "serving_recovery_seconds",
            "wall clock of one replay recovery (fresh pools + requeue, "
            "excluding backoff sleep)")
        self.page_pressure = g(
            "serving_page_pressure",
            "KV pages short at the last page-blocked admission (0 = "
            "admission is not page-blocked)")
        # ---- continuous-batching instruments (chunked prefill +
        # bucket ladder)
        self.prefill_chunk_s = h(
            "serving_prefill_chunk_seconds",
            "wall clock of one chunked-prefill chunk dispatch — the "
            "bound on how long a long-prompt arrival can stall decode")
        self.decode_stall_s = h(
            "serving_decode_stall_seconds",
            "per-step wall clock decoding slots spent waiting on "
            "scheduler + prefill work before the decode dispatch "
            "(observed only on steps that ran prefill work while "
            "decode-ready requests were waiting)")
        self.bucket = g(
            "serving_bucket",
            "current decode batch-bucket rung of the bucket ladder")
        self.migrations = c(
            "serving_bucket_migrations",
            "bucket-ladder migrations (grow or shrink) — each rung's "
            "program compiles once, so steady state stops migrating "
            "or cycles between already-compiled rungs")
        # ---- SLO-aware preemption
        self.preemptions = c(
            "serving_preemptions",
            "running requests unseated for a tighter-deadline arrival "
            "and re-queued for bit-identical replay from host state")
        self.preempted_tokens = c(
            "serving_preempted_tokens_replayed",
            "decode tokens preemption victims will regenerate on "
            "replay — the compute a preemption trades for deadline "
            "slack")
        # ---- speculative decoding
        self.spec_rounds_c = c(
            "serving_spec_rounds",
            "speculation rounds retired (one draft-propose scan + one "
            "target-verify chunk per round)")
        self.spec_accept = h(
            "serving_spec_accept_rate",
            "per-round fraction of draft proposals the target verify "
            "accepted — the signal per-request adaptive γ follows")
        self.spec_accepted = c(
            "serving_spec_tokens_accepted",
            "draft-proposed tokens the target verify accepted")
        self.spec_rejected = c(
            "serving_spec_tokens_rejected",
            "draft-proposed tokens the target verify rejected — their "
            "KV positions rolled back to the accepted length and the "
            "next dispatch overwrites them")
        self.spec_gamma = g(
            "serving_spec_gamma",
            "γ (draft tokens per round) of the most recent speculation "
            "round: per-request adaptive within the "
            "FLAGS_serving_spec_rungs set, capped down as batch "
            "occupancy prices speculation out")
        # ---- tensor-parallel decode (not ported yet)
        self.collective_s = h(
            "serving_collective_seconds",
            "wall clock of one tensor-parallel sharded decode dispatch "
            "(per-layer psum pair + compute), observed host-side at the "
            "dispatch boundary — only tp > 1 engines write it")
        # ---- the pool ledger: step-end gauges over the PagedKVCache
        # ledger, resolved per state label; "spilled" is the host-RAM
        # tier
        pages = r.gauge(
            "kv_pool_pages",
            "KV page-pool ledger by state: used (held by sequences or "
            "the prefix cache), free, shared (refcount > 1), pinned "
            "(prefix pages an in-flight request's block table holds), "
            "spilled (prefix pages resident only in the host-RAM tier)",
            labels=("replica", "tp", "state"))
        pbytes = r.gauge(
            "kv_pool_bytes",
            "KV page-pool ledger in bytes (all layers, k+v)",
            labels=("replica", "tp", "state"))
        self.pool_pages = {s: pages.labels(replica=replica, tp=tp, state=s)
                           for s in _POOL_STATES}
        self.pool_bytes = {s: pbytes.labels(replica=replica, tp=tp,
                                            state=s)
                           for s in _POOL_STATES}
        self.pool_frag = g(
            "kv_pool_fragmentation",
            "free-list fragmentation: 1 - largest contiguous free run "
            "/ free pages (0 = clean; recomputed only when the free "
            "list changed)")
        self.host_tier_peak = g(
            "kv_host_tier_peak_pages",
            "high-water mark of pages resident in the host-RAM KV "
            "tier — the tier watermark memwatch prices against host "
            "memory")
        self.counter_track = t.counter


class _NullEngineTelemetry:
    """FLAGS_telemetry=0 binding: every write is a no-op method call."""

    enabled = False

    def __init__(self, replica: str = "0", tp: str = "1"):
        self.span = obs.null_span
        self.event = obs.null_event
        self.submitted = self.finished = self.prefills = obs.NULL
        self.shared_admits = self.decode_steps = obs.NULL
        self.ttft = self.itl = obs.NULL
        self.queue_depth = self.occupancy = obs.NULL
        self.kv_pages_in_use = self.prefix_pinned = obs.NULL
        self.evict_short = obs.NULL
        self.retries = self.recoveries = obs.NULL
        self.requests_failed = self.requests_timeout = obs.NULL
        self.recovery_seconds = self.page_pressure = obs.NULL
        self.prefill_chunk_s = self.decode_stall_s = obs.NULL
        self.bucket = self.migrations = obs.NULL
        self.preemptions = self.preempted_tokens = obs.NULL
        self.spec_rounds_c = self.spec_accept = obs.NULL
        self.spec_accepted = self.spec_rejected = obs.NULL
        self.spec_gamma = self.collective_s = obs.NULL
        self.pool_pages = {s: obs.NULL for s in _POOL_STATES}
        self.pool_bytes = {s: obs.NULL for s in _POOL_STATES}
        self.pool_frag = self.host_tier_peak = obs.NULL
        self.counter_track = obs.null_counter


class _PrefixTelemetry:
    enabled = True

    def __init__(self, replica: str = "0"):
        r = obs.registry()
        rl = ("replica",)

        def c(name, help):
            return r.counter(name, help, labels=rl).labels(replica=replica)

        self.hits = c(
            "prefix_cache_hits", "lookups that matched >= 1 cached page")
        self.misses = c(
            "prefix_cache_misses", "lookups that matched nothing")
        self.hit_pages = c(
            "prefix_cache_hit_pages", "cached pages returned by lookups")
        self.registered_pages = c(
            "prefix_cache_registered_pages",
            "new prompt pages registered into the trie")
        self.evicted_pages = c(
            "prefix_cache_evicted_pages",
            "pages actually returned to the free list by evict()")
        # ---- host-RAM tiering
        self.spilled_pages = c(
            "prefix_cache_spilled_pages",
            "cold prefix pages spilled to the host-RAM tier (device "
            "page freed, KV bytes retained host-side)")
        self.restored_pages = c(
            "prefix_cache_restored_pages",
            "spilled prefix pages paged back onto the device on "
            "prefix adoption")
        self.dropped_spilled = c(
            "prefix_cache_dropped_spilled_pages",
            "spilled pages evicted from the host tier entirely "
            "(host-tier budget pressure)")


class _NullPrefixTelemetry:
    enabled = False

    def __init__(self, replica: str = "0"):
        self.hits = self.misses = self.hit_pages = obs.NULL
        self.registered_pages = self.evicted_pages = obs.NULL
        self.spilled_pages = self.restored_pages = obs.NULL
        self.dropped_spilled = obs.NULL


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (a later slice of "
                               "paddle_tpu_torch)")


# ------------------------------------------------------ decode programs
# The eager decode steps. Each takes its weights (the parameter dict, the
# parameter dict and the stacked groups, or the model), the tokens
# (b, 1) int64, the per-layer pool pairs, the block tables and the lengths,
# and returns the f32 logits (b, vocab) and the pool pairs (updated in
# place: the same tensors).
def _head(x, spec, p):
    """Final norm and LM head of the fused routes, f32 logits."""
    x = _rms(x, p[spec["final_norm"]], spec["epsilon"])
    if spec["lm_head"]:
        logits = x @ p[spec["lm_head"]]
    else:
        logits = x @ p[spec["embed"]].T
    return logits.float()


def _fused_layers(spec, p, toks, pools, bt, sl):
    """Embedding lookup and one fused block kernel per layer: the hidden
    states (b, hidden) and the pool pairs."""
    x = p[spec["embed"]][toks[:, 0]]
    pairs = []
    for i, lw in enumerate(spec["layers"]):
        w = BlockDecodeWeights(**{f: p[n] for f, n in lw.items()})
        kp, vp = pools[i]
        x, kp, vp = fused_block_decode(
            x, w, kp, vp, bt, sl, num_heads=spec["num_heads"],
            num_kv_heads=spec["num_kv_heads"],
            rope_theta=spec["rope_theta"], epsilon=spec["epsilon"])
        pairs.append((kp, vp))
    return x, pairs


@torch.inference_mode()
def _fused_step(spec, p, toks, pools, bt, sl):
    """Embedding lookup, one fused block kernel per layer, final norm and
    LM head."""
    x, pairs = _fused_layers(spec, p, toks, pools, bt, sl)
    return _head(x, spec, p), pairs


@torch.inference_mode()
def _fused_nlayer_step(spec, weights, toks, pools, bt, sl):
    """Embedding lookup, one N-layer fused kernel per layer group over the
    stacked weights, final norm and LM head."""
    p, stacked = weights
    x = p[spec["embed"]][toks[:, 0]]
    pairs = []
    for group, gw in zip(spec["layer_groups"], stacked):
        x, kps, vps = fused_multi_block_decode(
            x, gw, [pools[i][0] for i in group],
            [pools[i][1] for i in group], bt, sl,
            num_heads=spec["num_heads"], num_kv_heads=spec["num_kv_heads"],
            rope_theta=spec["rope_theta"], epsilon=spec["epsilon"])
        pairs.extend(zip(kps, vps))
    return _head(x, spec, p), pairs


@torch.inference_mode()
def _generic_step(model, toks, pools, bt, sl):
    """The model's cached forward; per-slot positions from seq_lens."""
    logits, states = model.forward_with_cache(
        toks, [PagedDecodeState(k, v, bt, sl) for k, v in pools], None)
    return logits[:, -1].float(), [(st.k_pages, st.v_pages)
                                   for st in states]


@torch.inference_mode()
def _chunk_step(model, ids, pools, bt, sl, last_idx):
    """One fixed-size chunk of one prompt through the model against the
    paged pool: ``ids`` (1, C) land at positions ``sl .. sl+C-1`` (``sl``
    (1,) int32, the cursor, which is also the rotary offset) and attend to
    the written prefix plus themselves (``PagedChunkState``). Only row
    ``last_idx`` ((1,) int64: the real tail of a final chunk) goes through
    the final norm's output into the LM head. Every input is a device
    tensor, so a CUDA graph replays the step for any cursor. Returns that
    row's f32 logits (vocab,) and the pool pairs."""
    hidden, states = model.forward_hidden(
        ids, [PagedChunkState(k, v, bt, sl) for k, v in pools], sl)
    row = model.logits(hidden[0].index_select(0, last_idx))[0].float()
    return row, [(st.k_pages, st.v_pages) for st in states]


# ------------------------------------------------ speculative programs
# One speculation round: the draft scan proposes γ tokens, the verify
# chunk checks them. Both return ``(outputs, pool pairs)``, with every
# input a device tensor and nothing read back to the host inside, so a
# CUDA graph replays them.
@torch.inference_mode()
def _spec_draft_step(fspec, gamma, sample, top_k, weights, tok, pools, bt,
                     sl, *law):
    """The draft scan: γ + 1 decode steps of the draft at B = 1, each at
    cursor ``sl + i`` and fed the previous step's token on the device. The
    extra step only writes the last proposal's KV (its head is skipped),
    so a fully accepted round leaves the draft's cache without a gap.
    ``fspec`` (the draft's fused layout) runs the fused one-layer kernel
    per layer, else the draft model's cached forward (``weights`` is then
    the model) over ``PagedDecodeState``s. A round near the end of the
    token budget writes past the slot's span: the draft pool's table has
    room for that, so those writes land on its null page. Greedy proposals
    are the argmax; sampled ones (``law`` = uniforms (γ, V), temperature
    (1,), top_p (1,)) race over the filtered draft distribution q.
    Returns ``((proposals (γ,) int64, q (γ, V) f32 or None), pool
    pairs)``."""
    if sample:
        u, temperature, top_p = law
    t, pairs = tok, list(pools)
    props, qs = [], []
    for i in range(gamma + 1):
        csl = sl + i
        if fspec is not None:
            x, pairs = _fused_layers(fspec, weights, t, pairs, bt, csl)
            if i == gamma:
                break
            row = _head(x, fspec, weights)[0]
        else:
            hidden, states = weights.forward_hidden(
                t, [PagedDecodeState(k, v, bt, csl) for k, v in pairs],
                None)
            pairs = [(st.k_pages, st.v_pages) for st in states]
            if i == gamma:
                break
            row = weights.logits(hidden[:, -1])[0].float()
        if sample:
            q = _spec_filtered_probs(row, temperature, top_k, top_p)
            nxt = race_sample(q, u[i])
            qs.append(q)
        else:
            nxt = torch.argmax(row)
        props.append(nxt)
        t = nxt.reshape(1, 1)
    return (torch.stack(props), torch.stack(qs) if sample else None), pairs


@torch.inference_mode()
def _spec_verify_step(sample, top_k, model, ids, pools, bt, sl, *law):
    """The verify: one (1, γ + 1) chunk of the target (``ids``: the last
    token and the γ proposals) at the cursor ``sl`` through
    ``PagedChunkState`` (it writes their KV and attends to the prefix plus
    itself), every row through the LM head. Returns ``((argmax (γ+1,)
    int64, f32 logits (γ+1, V), the filtered law (γ+1, V) when sampled,
    else None), pool pairs)``; ``law`` = temperature (1,), top_p (1,)."""
    hidden, states = model.forward_hidden(
        ids, [PagedChunkState(k, v, bt, sl) for k, v in pools], sl)
    rows = model.logits(hidden[0]).float()
    probs = (_spec_filtered_probs(rows, law[0], top_k, law[1]) if sample
             else None)
    return ((torch.argmax(rows, dim=-1), rows, probs),
            [(st.k_pages, st.v_pages) for st in states])


class _DecodeProgram:
    """What the program cache holds for one key: the eager step and the
    key's trace probe. On the CPU the program's first call is its trace
    (timed onto the probe); on the card the graphs note their captures."""

    def __init__(self, step, note_trace, traced: bool):
        self.step = step
        self.note_trace = note_trace
        self._traced = traced

    def __call__(self, *args):
        if self._traced:
            return self.step(*args)
        t0 = time.perf_counter()
        out = self.step(*args)
        self._traced = True
        self.note_trace(time.perf_counter() - t0)
        return out


def _build_decode(note_trace, step, on_card):
    return _DecodeProgram(step, note_trace, traced=on_card)


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _pool_ptrs(pools) -> Tuple[int, ...]:
    """Device addresses of every tensor of the per-layer pool pairs."""
    out = []
    for pair in pools:
        for t in pair:
            if isinstance(t, QuantizedPages):
                out.extend((t.q.data_ptr(), t.scale.data_ptr()))
            else:
                out.append(t.data_ptr())
    return tuple(out)


class _EagerStep:
    """A cached program run eagerly over an engine's weights: the host
    arrays go to the device each call. A program takes ``(weights, first
    input, pools, *other inputs)`` and returns ``(outputs, pool pairs)``:
    a step's logits, or a speculative program's tuple of device tensors
    (what a call of this class returns)."""

    def __init__(self, program: _DecodeProgram, weights, device):
        self.program = program
        self.weights = weights
        self.device = device

    def run(self, arrays, pools):
        first, *rest = (_to_device(a, self.device) for a in arrays)
        return self.program(self.weights, first, pools, *rest)

    def __call__(self, *args):
        """``args``: the host arrays, then the pool pairs."""
        *arrays, pools = args
        return self.run(arrays, pools)


class _EagerDecode(_EagerStep):
    """One rung's decode program, eagerly."""

    def __call__(self, toks, bt, sl, pools):
        """``toks`` (b, 1), ``bt`` (b, pages), ``sl`` (b,) host arrays.
        Returns (next tokens (b,) on the host, logits (b, vocab) f32, the
        pool pairs)."""
        logits, pairs = self.run((toks.astype(np.int64), bt, sl), pools)
        return torch.argmax(logits, dim=-1).cpu().numpy(), logits, pairs


class _EagerChunk(_EagerStep):
    """The chunk program, eagerly."""

    def __call__(self, ids, bt, sl, last_idx, pools):
        """``ids`` (1, C) int64, ``bt`` (1, pages) int32, ``sl`` (1,)
        int32, ``last_idx`` (1,) int64 host arrays. Returns (the tail row's
        logits (vocab,) f32, its argmax as a device scalar, the pool
        pairs): nothing is read back to the host."""
        row, pairs = self.run((ids, bt, sl, last_idx), pools)
        return row, torch.argmax(row), pairs


class _StepGraph:
    """A program as a CUDA graph over one engine's pools and weights
    (mixed in before an eager runner, whose call it takes: the host
    arrays, then the pool pairs). The first call runs the eager step (the
    warm-up: library loads, lazy caches) and then captures it; later calls
    copy the host arrays through pinned buffers into the static inputs and
    replay, and return what :meth:`_result` makes of the static outputs.
    A step's argmax of the logits is part of the graph.

    The kernel wrappers count launches in Python, which a replay never
    runs: the counters' increase during the capture is taken back (the
    capture launches nothing) and added again on every replay. The graph
    writes the pools at the addresses it was captured with, so a call with
    other pools raises :class:`KernelError`, which recovery does not replay
    (recovery itself resets the pools in place). The
    capture runs the step's device work only: the engine's telemetry and
    fault checks happen around a call, never inside it."""

    kind = "step"

    def _init_graph(self, inputs) -> None:
        """``inputs``: ``(shape, dtype)`` of each static input, in the
        program's order."""
        self.graph = None
        with torch.inference_mode():
            self.s_in = [torch.zeros(shape, dtype=dt, device=self.device)
                         for shape, dt in inputs]
            self.h_in = [torch.zeros(shape, dtype=dt, pin_memory=True)
                         for shape, dt in inputs]
        self.s_out: tuple = ()
        self.ptrs: Tuple[int, ...] = ()
        self.launches: List[tuple] = []     # (wrapper, variant, count)
        # recorded after each call's input copies (before its first record
        # a wait on it returns at once)
        self._staged = torch.cuda.Event()

    @torch.inference_mode()
    def _stage(self, arrays) -> None:
        # a call that returns without waiting for the device (a chunk) may
        # leave its copies queued: the pinned buffers are rewritten only
        # after the last call's copies have read them
        self._staged.synchronize()
        for host, dev, arr in zip(self.h_in, self.s_in, arrays):
            host.numpy()[...] = arr
            dev.copy_(host, non_blocking=True)
        self._staged.record(torch.cuda.current_stream(self.device))

    def _body(self, pools):
        """The captured work on the static inputs: ``(static outputs, pool
        pairs)``; here the logits and their argmax."""
        logits, pairs = self.program(self.weights, self.s_in[0], pools,
                                     *self.s_in[1:])
        return (logits, torch.argmax(logits, dim=-1)), pairs

    @torch.inference_mode()
    def _capture(self, pools) -> None:
        torch.cuda.synchronize(self.device)
        before = _kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs, pairs = self._body(pools)
        after = _kernels.launch_counts()
        self.launches = []
        for fn in _kernels.wrappers():
            for name in fn.launches:
                n = after[name] - before[name]
                if n:
                    fn.launches[name] -= n
                    self.launches.append((fn, name, n))
        ptrs = _pool_ptrs(pools)
        if _pool_ptrs(pairs) != ptrs:
            raise KernelError(f"{self.kind} graph: the captured step "
                              "returned other pools than it was given")
        self.graph, self.ptrs, self.s_out = graph, ptrs, outs

    @torch.inference_mode()
    def __call__(self, *args):
        *arrays, pools = args
        if self.graph is None:
            t0 = time.perf_counter()
            out = super().__call__(*args)
            self._capture(pools)
            self.program.note_trace(time.perf_counter() - t0)
            return out
        self._replay(arrays, pools)
        return self._result(pools)

    def _result(self, pools):
        """A replay's return, as the eager call's."""
        raise NotImplementedError

    @torch.inference_mode()
    def _replay(self, arrays, pools) -> None:
        if _pool_ptrs(pools) != self.ptrs:
            raise KernelError(
                f"{self.kind} graph: the pools are not at the addresses the "
                "graph was captured with (they were replaced after the "
                "capture)")
        self._stage(arrays)
        self.graph.replay()
        for fn, name, n in self.launches:
            fn.launches[name] += n


class _DecodeGraph(_StepGraph, _EagerDecode):
    """One rung's decode program as a CUDA graph; each call reads the next
    tokens back to the host."""

    kind = "decode"

    def __init__(self, program: _DecodeProgram, weights, device, b: int,
                 pages: int):
        _EagerDecode.__init__(self, program, weights, device)
        self._init_graph((((b, 1), torch.int64), ((b, pages), torch.int32),
                          ((b,), torch.int32)))
        self.h_out = torch.zeros((b,), dtype=torch.int64, pin_memory=True)

    def _result(self, pools):
        logits, argmax = self.s_out
        self.h_out.copy_(argmax, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self.h_out.numpy().copy(), logits, pools


class _ChunkGraph(_StepGraph, _EagerChunk):
    """The chunk program of one chunk length as a CUDA graph over one
    engine; a call returns without waiting for the device (the engine
    reads the argmax of a final chunk only)."""

    kind = "chunk"

    def __init__(self, program: _DecodeProgram, model, device, chunk: int,
                 pages: int):
        _EagerChunk.__init__(self, program, model, device)
        self._init_graph((((1, chunk), torch.int64),
                          ((1, pages), torch.int32), ((1,), torch.int32),
                          ((1,), torch.int64)))

    def _result(self, pools):
        return self.s_out + (pools,)


# a sampled program's temperature and top-p inputs
_LAW_SCALARS = [((1,), torch.float32), ((1,), torch.float32)]


class _SpecGraph(_StepGraph, _EagerStep):
    """A speculative program as a CUDA graph over one engine; a call
    returns without waiting for the device (the engine reads what it
    needs: the proposals, the verify's rows)."""

    kind = "spec"

    def __init__(self, program: _DecodeProgram, weights, device, inputs):
        _EagerStep.__init__(self, program, weights, device)
        self._init_graph(inputs)

    def _body(self, pools):
        return self.program(self.weights, self.s_in[0], pools,
                            *self.s_in[1:])

    def _result(self, pools):
        return self.s_out, pools


class PrefixCache:
    """Page-aligned prompt-prefix trie over a :class:`PagedKVCache`.

    Each node maps one full page of prompt tokens, keyed by its parent
    chain (equal chunks under different prefixes never collide), to the
    page holding that chunk's KV. A registered page carries a cache
    reference, so it outlives its request, and later requests with the
    same prefix adopt it read-only instead of prefilling it: the KV at
    position i depends only on tokens 0..i. Eviction drops least-recently
    used leaf nodes only (an interior node must outlive its children).

    With ``host_tier_pages > 0`` eviction pressure first spills cold nodes
    (:meth:`PagedKVCache.spill_page`: the device page returns to the free
    list, the node keeps the host copy), and ``lookup`` restores spilled
    chain nodes on adoption. Only pages the cache alone references (rc ==
    1) and no in-flight request pins spill; under a fragmented free list
    the pick prefers pages next to a free run. Past the host budget the
    coldest spilled leaves drop.

    It publishes the JAX cache's counters (``prefix_cache_hits``, misses,
    hit, registered, evicted, spilled, restored and dropped pages, labelled
    ``replica``), and checks the ``kv_spill`` fault site before each spill
    (``op="spill"``) and each restore (``op="restore"``), before anything
    changes: a fault leaves the tier consistent."""

    _ROOT = ("root",)

    def __init__(self, pool: PagedKVCache, replica: str = "0",
                 host_tier_pages: int = 0):
        self.pool = pool
        self.page_size = pool.page_size
        self.host_tier_pages = int(host_tier_pages)
        # key -> {"page": int | None, "parent": key | None, "children": int,
        #         "tick": int, "pins": int, "host": HostPage | None}
        # (page is None exactly while the node is spilled)
        self._nodes: Dict[tuple, dict] = {}
        self._by_page: Dict[int, tuple] = {}    # page id -> node key
        self._tick = 0
        self._pinned_nodes = 0      # nodes with pins > 0
        self._spilled_nodes = 0     # nodes in the host tier
        self._f_spill = faults.site("kv_spill")
        self._m = (_PrefixTelemetry(replica) if obs.enabled()
                   else _NullPrefixTelemetry(replica))

    def _chunks(self, prompt: np.ndarray):
        key = self._ROOT
        for i in range(0, (len(prompt) // self.page_size) * self.page_size,
                       self.page_size):
            key = (key, prompt[i:i + self.page_size].tobytes())
            yield key

    def lookup(self, prompt: np.ndarray, max_cover: Optional[int] = None):
        """Longest cached page-aligned prefix: ``(page_ids, n_tokens)``.
        Spilled chain nodes are restored when a free device page exists;
        the hit ends at the first one that cannot be. ``max_cover`` caps
        the coverage in tokens (the engine passes ``len(prompt) - 1``: the
        first generated token's logits are not cached, and a restore for a
        page the caller would discard spends a free page for nothing)."""
        self._tick += 1
        pages: List[int] = []
        for key in self._chunks(prompt):
            if max_cover is not None and \
                    (len(pages) + 1) * self.page_size > max_cover:
                break
            node = self._nodes.get(key)
            if node is None:
                break
            if node["host"] is not None:
                if self.pool.free_page_count() == 0:
                    break
                self._restore_node(key, node)
            node["tick"] = self._tick
            pages.append(node["page"])
        if pages:
            self._m.hits.inc()
            self._m.hit_pages.inc(len(pages))
        else:
            self._m.misses.inc()
        return pages, len(pages) * self.page_size

    def _restore_node(self, key: tuple, node: dict) -> None:
        """Page one spilled node back in: a fresh page off the free list,
        the host copy written into it, the cache reference restored."""
        self._f_spill.check(op="restore")
        pid = self.pool.take_free_page()
        self.pool.restore_page(node["host"], pid)
        node["host"] = None
        node["page"] = pid
        self._by_page[pid] = key
        self._spilled_nodes -= 1
        self._m.restored_pages.inc()

    def register(self, prompt: np.ndarray, block_row) -> None:
        """Cache the full prompt pages of a sequence whose prompt KV is
        complete (``block_row``: its block-table row)."""
        self._tick += 1
        for i, key in enumerate(self._chunks(prompt)):
            pid = int(block_row[i])
            node = self._nodes.get(key)
            if node is not None:        # already cached: keep that page
                node["tick"] = self._tick
                if node["host"] is not None:
                    # the sequence wrote this chunk's KV on the device
                    # again: the node turns resident on its page
                    self.pool.forget_spilled(node["host"])
                    node["host"] = None
                    node["page"] = pid
                    self._by_page[pid] = key
                    self._spilled_nodes -= 1
                    self.pool.ref_page(pid)
                continue
            parent = key[0] if key[0] in self._nodes else None
            self._nodes[key] = {"page": pid, "parent": parent,
                                "children": 0, "tick": self._tick,
                                "pins": 0, "host": None}
            self._by_page[pid] = key
            if parent is not None:
                self._nodes[parent]["children"] += 1
            self.pool.ref_page(pid)
            self._m.registered_pages.inc()

    def pin(self, pages) -> None:
        """Mark cached pages adopted by an in-flight request: ``evict``
        leaves a pinned node alone until ``unpin``."""
        for pid in pages:
            key = self._by_page.get(int(pid))
            if key is not None:
                node = self._nodes[key]
                node["pins"] += 1
                if node["pins"] == 1:
                    self._pinned_nodes += 1

    def unpin(self, pages) -> None:
        for pid in pages:
            key = self._by_page.get(int(pid))
            if key is not None and self._nodes[key]["pins"] > 0:
                node = self._nodes[key]
                node["pins"] -= 1
                if node["pins"] == 0:
                    self._pinned_nodes -= 1

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` device pages, never a pinned node's or
        one another holder still references (rc > 1): with a host tier,
        cold nodes spill first, then LRU leaves drop. Returns the pages
        that really went back to the free list."""
        freed = self.spill(n_pages) if self.host_tier_pages > 0 else 0
        dropped = 0
        while freed + dropped < n_pages:
            leaves = [(node["tick"], key) for key, node in
                      self._nodes.items()
                      if node["children"] == 0 and node["pins"] == 0
                      and node["host"] is None
                      and self.pool._page_rc[node["page"]] == 1]
            if not leaves:
                break
            _, key = min(leaves, key=lambda t: t[0])
            if self._drop_node(key):
                dropped += 1
        if dropped:
            self._m.evicted_pages.inc(dropped)
        return freed + dropped

    def _drop_node(self, key: tuple) -> bool:
        """Remove one node; returns whether a device page went back to the
        free list (a spilled node's drop frees host memory only)."""
        node = self._nodes.pop(key)
        if node["parent"] is not None:
            self._nodes[node["parent"]]["children"] -= 1
        if node["host"] is not None:
            self.pool.forget_spilled(node["host"])
            self._spilled_nodes -= 1
            return False
        self._by_page.pop(node["page"], None)
        return self.pool.unref_page(node["page"])

    def spill(self, n_pages: int) -> int:
        """Move up to ``n_pages`` cold resident nodes (unpinned, rc == 1)
        to the host tier, in LRU order; with the free list fragmented
        (> 0.5), the colder half's first page next to a free page goes
        first. The tier is a hard budget: the coldest spilled leaves drop
        to make room, and spilling stops when none can. Returns the device
        pages freed."""
        freed = 0
        cands = sorted(
            ((node["tick"], key) for key, node in self._nodes.items()
             if node["host"] is None and node["pins"] == 0
             and self.pool._page_rc[node["page"]] == 1),
            key=lambda t: t[0])
        frag = (len(cands) > 1
                and self.pool.free_list_fragmentation() > 0.5)
        free = set(self.pool._free) if frag else None
        while freed < n_pages and cands:
            if self._spilled_nodes >= self.host_tier_pages:
                self._drop_spilled_until(self.host_tier_pages - 1)
                if self._spilled_nodes >= self.host_tier_pages:
                    break
            idx = 0
            if frag:
                for j in range(max(1, len(cands) // 2)):
                    pid = self._nodes[cands[j][1]]["page"]
                    if pid + 1 in free or pid - 1 in free:
                        idx = j
                        break
            _, key = cands.pop(idx)
            node = self._nodes[key]
            pid = node["page"]
            self._f_spill.check(op="spill", page=pid)
            node["host"] = self.pool.spill_page(pid)
            node["page"] = None
            self._by_page.pop(pid, None)
            self._spilled_nodes += 1
            if self.pool.unref_page(pid):
                freed += 1
                if free is not None:
                    free.add(pid)
            self._m.spilled_pages.inc()
        return freed

    def _drop_spilled_until(self, limit: int) -> None:
        """Drop the coldest spilled leaves until the tier holds at most
        ``limit`` pages (a spilled interior node waits for its
        children)."""
        while self._spilled_nodes > max(0, limit):
            spilled_leaves = [(node["tick"], key) for key, node in
                              self._nodes.items()
                              if node["host"] is not None
                              and node["children"] == 0
                              and node["pins"] == 0]
            if not spilled_leaves:
                break
            _, key = min(spilled_leaves, key=lambda t: t[0])
            self._drop_node(key)
            self._m.dropped_spilled.inc()

    def spilled_page_count(self) -> int:
        """Pages held only in the host tier."""
        return self._spilled_nodes

    def evictable_page_count(self) -> int:
        """Device pages ``evict`` could free now: resident, unpinned,
        cache-only. Without a host tier only leaves drop, so an ancestor of
        a node that cannot go does not count; with one, any such node
        spills, as far as the tier has room (its free places plus its
        droppable spilled leaves)."""
        free_ok = (lambda node: node["host"] is None
                   and node["pins"] == 0
                   and self.pool._page_rc[node["page"]] == 1)
        blocked: set = set()
        for node in self._nodes.values():
            if free_ok(node):
                continue
            k = node["parent"]
            while k is not None and k not in blocked:
                blocked.add(k)
                parent = self._nodes.get(k)
                k = parent["parent"] if parent is not None else None
        droppable = sum(1 for key, node in self._nodes.items()
                        if key not in blocked and free_ok(node))
        if self.host_tier_pages <= 0:
            return droppable
        flat = sum(1 for node in self._nodes.values() if free_ok(node))
        room = max(0, self.host_tier_pages - self._spilled_nodes)
        room += sum(1 for node in self._nodes.values()
                    if node["host"] is not None
                    and node["children"] == 0 and node["pins"] == 0)
        return droppable + min(room, max(0, flat - droppable))

    def pinned_page_count(self) -> int:
        """Pages an in-flight request's block table points at."""
        return self._pinned_nodes

    def peek(self, prompt: np.ndarray,
             include_spilled: bool = False) -> int:
        """Tokens of the cached page-aligned prefix, without touching the
        LRU ticks: the scheduler's admission probe. Device-resident pages
        only unless ``include_spilled`` (a restore takes a free page, as a
        fresh allocation does)."""
        n = 0
        for key in self._chunks(prompt):
            node = self._nodes.get(key)
            if node is None:
                break
            if node["host"] is not None and not include_spilled:
                break
            n += self.page_size
        return n


class ServingEngine:
    """Drive ``model`` (a port causal LM: ``LlamaForCausalLM``,
    ``GPTForCausalLM``, or either after ``nn.quant.quantize_linears``) as
    a continuous-batching server: ``submit`` enqueues, each ``step``
    sweeps deadlines, migrates the decode batch between bucket rungs,
    preempts for an endangered deadline, admits waiting requests into
    free slots, runs at most one prefill-compute unit (a whole-prompt
    prefill or one chunk of a long prompt) and decodes one token for every
    slot past its prefill. ``run`` steps until drained and returns ``{rid:
    tokens}``; ``run_step`` and ``poll`` are the non-blocking surface.
    ``prefix_cache=True`` caches
    prompt pages for later requests with the same prefix
    (:class:`PrefixCache`), with a host-memory tier of ``host_tier_pages``
    pages (``FLAGS_serving_kv_host_tier_pages``; 0: none). A step that
    raises is recovered by replay (the module docstring); ``replica``
    labels every metric series of this engine.

    ``record_logits=True`` keeps, in ``logits[rid]``, the f32 logits row
    each generated token was taken from (host memory: vocabulary floats
    per token), for checks against a reference."""

    def __init__(self, model, max_batch: int = 4, page_size: int = 64,
                 num_pages: Optional[int] = None, max_seq_len: int = 1024,
                 prefix_cache: bool = False,
                 bucket_ladder: Optional[Tuple[int, ...]] = None,
                 prefill_chunk: Optional[int] = None,
                 replica: str = "0",
                 host_tier_pages: Optional[int] = None,
                 draft_model=None,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 tp_degree: Optional[int] = None,
                 record_logits: bool = False):
        # the pool's storage and the N-layer route's stacked weights
        self.kv_dtype = str(_flags.get_flag("serving_kv_dtype")
                            if kv_dtype is None else kv_dtype)
        if self.kv_dtype not in ("native", "int8"):
            raise ValueError(f"kv_dtype must be 'native' or 'int8', "
                             f"got {self.kv_dtype!r}")
        self.weight_dtype = str(_flags.get_flag("fused_weight_dtype")
                                if weight_dtype is None else weight_dtype)
        if self.weight_dtype not in ("native", "int4"):
            raise ValueError(f"weight_dtype must be 'native' or 'int4', "
                             f"got {self.weight_dtype!r}")
        tp = (_flags.get_flag("serving_tp_degree") if tp_degree is None
              else int(tp_degree))
        if tp > 1:
            raise _later("tensor-parallel decode (tp_degree > 1)")
        if tp < 1:
            raise ValueError(f"tp_degree must be >= 1, got {tp}")
        self.chunk = int(_flags.get_flag("serving_prefill_chunk")
                         if prefill_chunk is None else prefill_chunk)
        if self.chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got {self.chunk}")
        # the batch-bucket ladder: rungs above max_batch drop, max_batch is
        # always the top rung; decode starts at the lowest
        if bucket_ladder is None:
            raw = str(_flags.get_flag("serving_bucket_ladder"))
            rungs = [int(r) for r in raw.replace(";", ",").split(",")
                     if r.strip()]
        else:
            rungs = [int(r) for r in bucket_ladder]
        if any(r < 1 for r in rungs):
            raise ValueError(f"bucket ladder rungs must be >= 1: {rungs}")
        self.ladder: Tuple[int, ...] = tuple(sorted(
            {r for r in rungs if r <= max_batch} | {max_batch}))
        self.bucket = self.ladder[0]
        self.bucket_patience = int(_flags.get_flag("serving_bucket_patience"))
        self._shrink_wait = 0
        # SLO preemption policy
        self.preempt_enabled = bool(_flags.get_flag("serving_preempt"))
        self.preempt_budget = int(_flags.get_flag("serving_preempt_budget"))
        self.preempt_margin = float(_flags.get_flag("serving_preempt_margin"))
        self.preempt_horizon = float(
            _flags.get_flag("serving_preempt_horizon"))

        self.model = model
        # this engine's id in a process that runs several: the replica
        # label of every metric series
        self.replica = str(replica)
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.record_logits = bool(record_logits)
        self.device = model.device
        spec = model.cache_spec()
        if num_pages is None:
            # FLAGS_serving_page_budget usable pages (+1: the null page),
            # or the worst case
            budget = int(_flags.get_flag("serving_page_budget"))
            num_pages = (budget + 1 if budget > 0 else
                         1 + max_batch * (-(-max_seq_len // page_size)))
        maxpos = model.config.max_position_embeddings
        if max_seq_len > maxpos:
            raise ValueError(
                f"engine max_seq_len ({max_seq_len}) exceeds the model's "
                f"max_position_embeddings ({maxpos})")
        self.pool = PagedKVCache(
            num_layers=len(spec), num_pages=num_pages, page_size=page_size,
            num_kv_heads=spec[0][0], head_dim=spec[0][1],
            max_batch=max_batch, max_seq_len=max_seq_len, dtype=model.dtype,
            reserve_null_page=True, kv_dtype=self.kv_dtype,
            device=self.device)
        # the prefix cache and its host-memory tier (pages; 0: off)
        self.host_tier_pages = int(
            _flags.get_flag("serving_kv_host_tier_pages")
            if host_tier_pages is None else host_tier_pages)
        self._prefix_enabled = bool(prefix_cache)
        self._prefix = self._new_prefix_cache()
        # fault sites, bound here (NULL_SITE unless FLAGS_fault_inject names
        # them), and the replay-recovery budget
        self._f_prefill = faults.site("prefill")
        self._f_chunk = faults.site("chunk_prefill")
        self._f_decode = faults.site("decode_dispatch")
        self._f_migrate = faults.site("bucket_migrate")
        self._f_preempt = faults.site("preempt")
        self.max_retries = int(_flags.get_flag("serving_max_retries"))
        self.retry_backoff = float(_flags.get_flag("serving_retry_backoff"))
        self._consec_failures = 0   # engine-wide no-progress failures
        # an admission whose dispatch raised (rolled back, so in no slot)
        self._failed_admission: Optional[Request] = None
        # the last _next_admission left the slack head page-blocked (a
        # bypass admission must not clear the pressure gauge)
        self._head_blocked = False
        # _shared_adopt_pages by rid, cleared each step and whenever pages
        # move: the scheduler probes a request several times a step
        self._probe_memo: Dict[int, int] = {}
        # the flags a decode program reads, resolved once: part of its key
        self._flags = _flags.snapshot(_flags.PROGRAM_FLAGS)
        self._model_sig = model_signature(model)
        self._params = dict(model.named_parameters())
        self._spec = self._fused_spec()
        # the N-layer route's stacked weights, one group each, built once
        self._stacked = (self._stacked_weights(self._spec)
                         if self._spec and "layer_groups" in self._spec
                         else None)
        # speculative decoding: the draft's own pool, in slot lockstep
        # with the target's (its seq_lens row is the draft's cursor)
        self.draft_model = draft_model
        self._draft_pool: Optional[PagedKVCache] = None
        if draft_model is not None:
            self._init_spec(draft_model, page_size)
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._queue: List[Request] = []
        self._results: Dict[int, List[int]] = {}
        self._status: Dict[int, str] = {}
        self._last_tok = np.zeros((max_batch,), np.int64)
        self._next_rid = 0
        # bucket rung -> its decode program (bound to this engine), and key
        self._decode_fns: Dict[int, _EagerDecode] = {}
        self._decode_keys: Dict[int, DecodeKey] = {}
        self.decode_key: Optional[DecodeKey] = None    # the current rung's
        # the chunk program (bound to this engine) and its key
        self._chunk_fn: Optional[_EagerChunk] = None
        self.chunk_key: Optional[DecodeKey] = None
        # streaming: (callback, rid, token | None, done) events buffered in
        # a step and drained after it, so a raising callback surfaces to the
        # caller; callbacks stay engine-local (rid -> on_token)
        self._events: List[tuple] = []
        self._callbacks: Dict[int, Callable] = {}
        # the fairness flip: the next contended step's prefill unit goes to
        # the in-flight chunks
        self._chunk_turn = False
        # host probes
        self.bucket_migrations = 0
        self.preemptions = 0
        self.chunk_dispatches = 0
        self.max_decode_stall = 0.0
        self._host_tier_peak = 0
        self.logits: Dict[int, List[np.ndarray]] = {}
        # seconds of each decode step (dispatch to tokens on the host), of
        # each whole-prompt prefill (dispatch to first token), and from
        # each request's submission to its first token (by rid; a chunked
        # prompt's closes on its final chunk, a replay's is not a first)
        self.decode_step_seconds: List[float] = []
        self.prefill_seconds: List[float] = []
        self.ttft_seconds: Dict[int, float] = {}
        # telemetry, bound once (no-op stubs with FLAGS_telemetry off)
        self._m = (_EngineTelemetry(self.replica, "1") if obs.enabled()
                   else _NullEngineTelemetry(self.replica, "1"))
        # the pool ledger's fragmentation, recomputed only when the free
        # list's epoch moved
        self._pool_frag_epoch = -1
        self._pool_frag = 0.0
        self._observe_bucket()

    def _new_prefix_cache(self) -> Optional[PrefixCache]:
        if not self._prefix_enabled:
            return None
        return PrefixCache(self.pool, replica=self.replica,
                           host_tier_pages=self.host_tier_pages)

    def _init_spec(self, draft_model, page_size: int) -> None:
        """The speculative engine's state: the draft's weights and pool,
        the γ rungs and budget, the fault sites and the host probes."""
        if not all(hasattr(draft_model, a) for a in (
                "cache_spec", "forward_hidden", "logits", "config")):
            raise _later(f"a draft_model of type "
                         f"{type(draft_model).__name__} (the port drafts "
                         "with its paged-cache causal LMs, which provide "
                         "cache_spec, forward_hidden and logits: Llama, "
                         "GPT)")
        dvocab = draft_model.config.vocab_size
        if dvocab != self.model.config.vocab_size:
            raise ValueError(
                f"the draft model's vocabulary ({dvocab}) is not the "
                f"target's ({self.model.config.vocab_size})")
        if draft_model.device != self.device:
            raise ValueError(f"the draft model is on {draft_model.device}, "
                             f"the target on {self.device}")
        dmax = draft_model.config.max_position_embeddings
        if self.max_seq_len > dmax:
            raise ValueError(
                f"engine max_seq_len ({self.max_seq_len}) exceeds the "
                f"draft model's max_position_embeddings ({dmax})")
        raw = str(_flags.get_flag("serving_spec_rungs"))
        rungs = sorted({int(r) for r in raw.replace(";", ",").split(",")
                        if r.strip()})
        if not rungs or rungs[0] < 1:
            raise ValueError(
                f"serving_spec_rungs must name rungs >= 1: {raw!r}")
        self.spec_rungs: Tuple[int, ...] = tuple(rungs)
        dspec = draft_model.cache_spec()
        # always worst-case pages: the target admits against its budget,
        # and the draft's sync must never fail to allocate the same span.
        # The table has room for a round past the longest span (a draft
        # scan writes up to γ + 1 positions from the cursor): those
        # columns name the null page, where such writes land
        self._draft_pool = PagedKVCache(
            num_layers=len(dspec),
            num_pages=1 + self.max_batch * (-(-self.max_seq_len
                                              // page_size)),
            page_size=page_size, num_kv_heads=dspec[0][0],
            head_dim=dspec[0][1], max_batch=self.max_batch,
            max_seq_len=self.max_seq_len + rungs[-1] + 1,
            dtype=draft_model.dtype, reserve_null_page=True,
            kv_dtype=self.kv_dtype, device=self.device)
        self._draft_params = dict(draft_model.named_parameters())
        self._draft_sig = model_signature(draft_model)
        # the draft scan's route: the fused one-layer kernel when the draft
        # qualifies (always per layer), else its cached forward
        self._draft_fspec = self._fused_spec(draft=True)
        g0 = int(_flags.get_flag("serving_spec_gamma"))
        self.spec_gamma_default = max(
            r for r in self.spec_rungs if r <= max(g0, rungs[0]))
        self.spec_adaptive = bool(_flags.get_flag("serving_spec_adaptive"))
        # the decode-slot budget γ + 1 pricing bills; the floor keeps a
        # lone row affordable at the smallest rung
        self.spec_slots = (int(_flags.get_flag("serving_spec_max_slots"))
                           or max(self.max_batch, rungs[0] + 1))
        self.spec_sync_chunk = max(
            1, int(_flags.get_flag("serving_spec_sync_chunk")))
        self._f_spec_draft = faults.site("spec_draft")
        self._f_spec_verify = faults.site("spec_verify")
        # (kind, extra) -> the program bound to this engine, and its key
        self._spec_fns: Dict[tuple, object] = {}
        self._spec_keys: Dict[tuple, DecodeKey] = {}
        self.spec_draft_key: Optional[DecodeKey] = None  # the last used
        self.spec_verify_key: Optional[DecodeKey] = None
        # host probes
        self.spec_rounds = 0
        self.spec_tokens_accepted = 0
        self.spec_tokens_rejected = 0
        self.spec_last_gamma = 0
        self.spec_sync_chunks = 0

    # ------------------------------------------------------------ frontend
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               deadline: Optional[float] = None,
               on_token: Optional[Callable] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None) -> int:
        """Enqueue one request; returns its id. ``deadline`` (seconds from
        now) bounds its total latency: past it, queued or in flight, the
        request ends ``TIMEOUT`` at the next step boundary with the tokens
        it has. ``on_token(rid, token, done)`` streams: one call per token
        with ``done=False``, then ``(rid, None, True)`` when the request
        ends; callbacks run on the caller's thread after each step.
        ``temperature > 0`` needs a speculative engine (``draft_model=``),
        whose verify program is the engine's sampler."""
        if temperature is not None and float(temperature) < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if float(temperature or 0.0) > 0.0 and self.draft_model is None:
            raise ValueError(
                "temperature > 0 requires a speculative engine "
                "(ServingEngine(..., draft_model=...)): the spec verify "
                "program is the engine's sampler")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" exceeds engine max_seq_len ({self.max_seq_len})")
        # a request that can never fit would block admission for good
        need = -(-(len(prompt) + max_new_tokens) // self.pool.page_size)
        usable = self.pool.num_pages - 1        # null page reserved
        if need > min(usable, self.pool.max_pages_per_seq):
            raise ValueError(
                f"request needs {need} pages but the pool can ever offer "
                f"{min(usable, self.pool.max_pages_per_seq)}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, int(max_new_tokens), eos_token_id)
        if on_token is not None:
            self._callbacks[rid] = on_token
        req.temperature = float(temperature or 0.0)
        req.top_k = int(top_k)
        req.top_p = float(top_p)
        req.seed = int(seed) if seed is not None else rid
        req.t_submit = time.perf_counter()
        if deadline is not None:
            req.deadline = req.t_submit + float(deadline)
        self._queue.append(req)
        self._m.submitted.inc()
        return rid

    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def load(self) -> Tuple[int, int]:
        """``(deadline_bearing, total)`` live requests, queued and in
        flight."""
        live = [r for r in self._slots if r is not None] + self._queue
        return (sum(1 for r in live if r.deadline is not None), len(live))

    def run_step(self) -> bool:
        """One scheduler round; returns whether work remains."""
        self.step()
        return self.has_work()

    def poll(self, rid: int) -> Dict[str, object]:
        """``{"status", "tokens", "done"}`` of one request, the tokens so
        far as a copy. A finished request reports its terminal status until
        a drain (``run``, ``take_results``) prunes it."""
        if rid in self._results:
            return {"status": self._status.get(rid, OK),
                    "tokens": list(self._results[rid]), "done": True}
        for req in list(self._slots) + self._queue:
            if req is not None and req.rid == rid:
                return {"status": "PENDING", "tokens": list(req.tokens),
                        "done": False}
        raise KeyError(f"unknown or already-drained request id {rid}")

    def run(self, max_wall: Optional[float] = None) -> Dict[int, List[int]]:
        """Step until drained and return ``{rid: tokens}`` (partial tokens
        for a ``TIMEOUT`` request: see :meth:`status`). Past ``max_wall``
        seconds everything still queued or in flight ends ``TIMEOUT``."""
        t0 = time.perf_counter()
        while self.has_work():
            if max_wall is not None and time.perf_counter() - t0 > max_wall:
                self._expire_all("run(max_wall=%.3f) watchdog" % max_wall)
                self._drain_events()
                break
            self.step()
        out, self._results = self._results, {}
        # keep the statuses of exactly the requests this drain returned
        self._status = {rid: self._status[rid] for rid in out
                        if rid in self._status}
        return out

    def results(self) -> Dict[int, List[int]]:
        """Completed results so far, without draining them."""
        return {rid: list(toks) for rid, toks in self._results.items()}

    def take_results(self) -> Dict[int, List[int]]:
        """Drain completed results and their statuses (the ``run_step``
        loop's collection surface)."""
        out, self._results = self._results, {}
        for rid in out:
            self._status.pop(rid, None)
        return out

    def status(self, rid: int) -> str:
        """``OK`` / ``FAILED`` / ``TIMEOUT`` for a finished request,
        ``PENDING`` while it is queued or in flight."""
        return self._status.get(rid, "PENDING")

    def statuses(self) -> Dict[int, str]:
        return dict(self._status)

    # ---------------------------------------------------- router surface
    def export_requests(self) -> List[Request]:
        """Detach every live request, in flight and queued, as host state
        in submission order, each in replay form (prompt + emitted tokens;
        slots and cursors dropped). Their pages go back to the pool; the
        engine is left without work. Callbacks stay behind: take them with
        :meth:`take_callbacks`."""
        live = [r for r in self._slots if r is not None]
        pool_alive = self.pool.k_pages and self.pool.k_pages[0] is not None
        out = sorted(live + self._queue, key=lambda r: r.rid)
        for req in live:
            if pool_alive and req.slot is not None:
                self.pool.free_sequence(req.slot)
        for req in out:
            self._to_replay_form(req)
        self._slots = [None] * self.max_batch
        self._queue = []
        self._last_tok[:] = 0
        return out

    def take_callbacks(self) -> Dict[int, Callable]:
        """Detach the rid -> streaming-callback registry."""
        out, self._callbacks = self._callbacks, {}
        return out

    def inject_request(self, req: Request,
                       on_token: Optional[Callable] = None) -> int:
        """Enqueue an existing request under a fresh rid. Its prompt,
        tokens, deadline and budgets ride along: a request with tokens
        admits as a replay (prefill of prompt + tokens)."""
        req.rid = self._next_rid
        self._next_rid += 1
        req.status = "PENDING"
        req.error = None
        if on_token is not None:
            self._callbacks[req.rid] = on_token
        self._queue.append(req)
        return req.rid

    def close(self) -> None:
        """Release this engine's device state: the pools (the draft's too),
        the host tier, the N-layer route's stacked weights and every CUDA
        graph it captured (with their private memory pools). The model's
        weights stay. A closed engine takes no more work: a
        :class:`~paddle_tpu_torch.generation.fleet.FleetRouter` exports a
        lost replica's requests, closes it and builds its replacement."""
        self._decode_fns.clear()
        self._chunk_fn = None
        if self.draft_model is not None:
            self._spec_fns.clear()
        self._stacked = None
        self._prefix = None
        for pool in (self.pool, self._draft_pool):
            if pool is not None:
                n = len(pool.k_pages)
                pool.k_pages, pool.v_pages = [None] * n, [None] * n
                pool._detached = None

    # ------------------------------------------- disaggregated handoff
    def harvest_request(self, rid: int) -> dict:
        """Detach one seated greedy request with its written KV pages: the
        prefill half of prefill/decode disaggregation. Every page of its
        span is copied to host memory verbatim (an int8 pool's payload and
        scales) and leaves with the request, in replay form; the slot's
        pages go back to the pool. On the card the call waits for the
        copies, so the bundle is whole when it returns. Returns the bundle
        :meth:`adopt_request` seats: ``{"v": HANDOFF_SCHEMA_VERSION,
        "request", "pages" (HostPage list), "seq_len", "last_token"}``,
        host state only; the streaming callback stays behind (re-bind it
        through ``adopt_request(on_token=)``).

        Refused: a request not seated in a slot (queued or finished ones
        move through export_requests / inject_request), one mid-prefill or
        with a teacher-forced suffix pending, a sampled one, and a
        detached pool."""
        req = next((r for r in self._slots
                    if r is not None and r.rid == rid), None)
        if req is None or req.slot is None:
            raise ValueError(
                f"harvest_request: rid {rid} is not seated in a slot "
                "(queued/completed requests re-route through "
                "export_requests/inject_request instead)")
        if req.prefill_pos is not None or req.pending:
            raise ValueError(
                "harvest_request: request is mid-prefill (chunk cursor "
                "or teacher-forced suffix pending) — hand off after its "
                "first generated token")
        if req.temperature > 0.0:
            raise ValueError(
                "harvest_request: sampled requests park their KV cursor "
                "in the spec verify program; only greedy requests hand "
                "off with pages")
        if not self.pool.k_pages or self.pool.k_pages[0] is None:
            raise RuntimeError("harvest_request: pool is detached")
        slot = req.slot
        seq_len = int(self.pool.seq_lens[slot])
        last_tok = int(self._last_tok[slot])
        pages = []
        for i in range(int(self.pool._pages_used[slot])):
            hp = self.pool.spill_page(int(self.pool.block_tables[slot, i]))
            # the copy leaves with the request: it never joins this
            # pool's host tier
            self.pool.forget_spilled(hp)
            pages.append(hp)
        if self.device.type == "cuda":
            # the copies to pinned memory were queued without waiting;
            # the bundle is read on the host (pickled), so wait for them
            torch.cuda.current_stream(self.device).synchronize()
        self.pool.free_sequence(slot)
        self._to_replay_form(req)
        self._slots[slot] = None
        self._last_tok[slot] = 0
        self._callbacks.pop(rid, None)
        return {"v": HANDOFF_SCHEMA_VERSION, "request": req,
                "pages": pages, "seq_len": seq_len,
                "last_token": last_tok}

    def adopt_request(self, bundle: dict,
                      on_token: Optional[Callable] = None) -> int:
        """Seat a harvested request mid-stream: the decode half of
        :meth:`harvest_request`. Allocates the request's span in the first
        free slot, writes the bundle's pages into it in place
        (:meth:`PagedKVCache.adopt_page`), restores the KV cursor and the
        last emitted token (staged by the next decode step, as an
        admission's), and resumes decoding under a fresh rid, with
        ``on_token`` bound to it. The bundle's pages must be this pool's
        geometry (``HostPage.nbytes == bytes_per_page``: layers, kv heads,
        page size and kv dtype). Refused: another schema version, another
        page size in bytes, no free slot, a span shorter than the pages."""
        v = bundle.get("v")
        if v != HANDOFF_SCHEMA_VERSION:
            raise ValueError(
                f"adopt_request: bundle schema version {v!r} != this "
                f"engine's {HANDOFF_SCHEMA_VERSION} — the disaggregated "
                "pair must run the same handoff revision (re-harvest on "
                "a matching build instead of mis-seating pages)")
        req: Request = bundle["request"]
        pages = bundle["pages"]
        if not self.pool.k_pages or self.pool.k_pages[0] is None:
            raise RuntimeError("adopt_request: pool is detached")
        if pages and pages[0].nbytes != self.pool.bytes_per_page:
            raise ValueError(
                f"adopt_request: page layout mismatch — bundle pages "
                f"are {pages[0].nbytes} bytes, this pool's are "
                f"{self.pool.bytes_per_page} (layers/kv-heads/page_size/"
                "kv_dtype must agree across the disaggregated pair)")
        try:
            slot = self._slots.index(None)
        except ValueError:
            raise RuntimeError(
                "adopt_request: no free slot (drain or grow max_batch)")
        try:
            self.pool.allocate(slot,
                               len(req.prompt) + int(req.max_new_tokens))
        except RuntimeError:
            # a partial allocation is recorded in the slot: return it
            self.pool.free_sequence(slot)
            raise
        if int(self.pool._pages_used[slot]) < len(pages):
            self.pool.free_sequence(slot)
            raise ValueError(
                f"adopt_request: bundle carries {len(pages)} pages but "
                f"the span only needs {int(self.pool._pages_used[slot])}")
        for i, hp in enumerate(pages):
            self.pool.adopt_page(hp, int(self.pool.block_tables[slot, i]))
        self.pool.seq_lens[slot] = int(bundle["seq_len"])
        req.rid = self._next_rid
        self._next_rid += 1
        req.slot = slot
        req.status = "PENDING"
        req.error = None
        now = time.perf_counter()
        req.t_submit = req.t_submit or now
        req.t_last = now
        if on_token is not None:
            self._callbacks[req.rid] = on_token
        self._slots[slot] = req
        self._last_tok[slot] = int(bundle["last_token"])
        return req.rid

    # ---------------------------------------------------- decode programs
    def _key(self, kind: str, bucket: Optional[int] = None,
             extra: Tuple = ()) -> DecodeKey:
        extra = tuple(extra) + ((TAG_KV, self.kv_dtype),
                                (TAG_WT, self.weight_dtype))
        return DecodeKey(
            kind=kind, model_sig=self._model_sig,
            batch_bucket=self.max_batch if bucket is None else bucket,
            page_budget=(self.pool.num_pages, self.pool.page_size,
                         self.pool.max_pages_per_seq),
            dtype=str(self.pool.k_pages[0].dtype),
            flags=self._flags.as_tuple(), extra=extra)

    def _fused_spec(self, draft: bool = False):
        """The model's fused-block layout when the fused path applies:
        ``FLAGS_fused_block_decode`` on, the model publishes
        ``block_decode_spec`` (Llama; GPT does not) and every named weight
        is a parameter (a ``quantize_linears`` model keeps its weights as
        int8 buffers, so it takes the generic route, as in the JAX
        package).
        Under ``FLAGS_fused_block_layers=N > 1`` it carries the model's
        ``layer_groups``. ``draft=True`` probes the draft model, whose scan
        always runs one layer a launch."""
        if not self._flags.fused_block_decode:
            return None
        model = self.draft_model if draft else self.model
        get_spec = getattr(model, "block_decode_spec", None)
        if get_spec is None:
            return None
        if draft:
            spec = get_spec()
            params = self._draft_params
        else:
            spec = get_spec(self._flags.fused_block_layers)
            params = self._params
        names = [spec["embed"], spec["final_norm"]]
        if spec["lm_head"]:
            names.append(spec["lm_head"])
        for lw in spec["layers"]:
            names.extend(lw.values())
        if not all(n in params for n in names):
            return None
        return spec

    @torch.no_grad()
    def _stacked_weights(self, spec) -> Tuple[MultiBlockDecodeWeights, ...]:
        """Each layer group's weights stacked into one
        ``MultiBlockDecodeWeights`` (q|k|v and gate|up merged; int4 tiles
        under ``weight_dtype="int4"``): a device copy of the decoder
        layers' weights, made once per engine; the per-layer originals
        keep serving prefill."""
        p = self._params
        return tuple(
            stack_block_weights([
                BlockDecodeWeights(**{f: p[n] for f, n in
                                      spec["layers"][i].items()})
                for i in group], weight_dtype=self.weight_dtype)
            for group in spec["layer_groups"])

    def _decode_program(self, bucket: int) -> _EagerDecode:
        """The decode step of one bucket rung: the cached program of its
        key, bound to this engine (a CUDA graph on the card), made once per
        rung."""
        fn = self._decode_fns.get(bucket)
        if fn is None:
            spec = self._spec
            if self._stacked is not None:
                key = self._key("decode_fused_nlayer", bucket, extra=(
                    TAG_NLAYER,
                    tuple(len(g) for g in spec["layer_groups"])))
                step = functools.partial(_fused_nlayer_step, spec)
                weights = (self._params, self._stacked)
            elif spec:
                key = self._key("decode_fused", bucket)
                step = functools.partial(_fused_step, spec)
                weights = self._params
            else:
                key = self._key("decode_generic", bucket)
                step, weights = _generic_step, self.model
            on_card = self.device.type == "cuda"
            program = decode_program_cache().get(key, functools.partial(
                _build_decode, step=step, on_card=on_card))
            if on_card:
                fn = _DecodeGraph(program, weights, self.device, bucket,
                                  self.pool.max_pages_per_seq)
            else:
                fn = _EagerDecode(program, weights, self.device)
            self._decode_fns[bucket] = fn
            self._decode_keys[bucket] = key
        self.decode_key = self._decode_keys[bucket]
        return fn

    def _chunk_program(self) -> _EagerChunk:
        """The chunk program: the cached program of the ``prefill_chunk``
        key (one per chunk length; every chunk of every prompt runs the
        same ``(1, chunk)`` shape, the final partial chunk padded), bound
        to this engine (a CUDA graph on the card), made once."""
        if self._chunk_fn is None:
            key = self._key("prefill_chunk", bucket=1, extra=(self.chunk,))
            on_card = self.device.type == "cuda"
            program = decode_program_cache().get(key, functools.partial(
                _build_decode, step=_chunk_step, on_card=on_card))
            if on_card:
                self._chunk_fn = _ChunkGraph(program, self.model,
                                             self.device, self.chunk,
                                             self.pool.max_pages_per_seq)
            else:
                self._chunk_fn = _EagerChunk(program, self.model,
                                             self.device)
            self.chunk_key = key
        return self._chunk_fn

    # ----------------------------------------------------------- admission
    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return _to_device(arr, self.device)

    def _store(self, states) -> None:
        self.pool.install_pools([(st.k_pages, st.v_pages) for st in states])

    def _admit_shared(self, req: Request, slot: int, pages: List[int],
                      n_cached: int) -> None:
        """Prefix-cache admission: adopt the cached prompt pages read-only
        and pin them; their prefill is skipped. A suffix of at most two
        pages (or any, with chunking off) is teacher-forced through the
        decode step, one token a step (its outputs are prompt positions and
        are dropped; the step that feeds the last suffix token gives the
        first generated token). A longer one, with chunking on, is
        prefilled in chunks from the adopted cursor."""
        self.pool.adopt_shared(slot, pages)
        self._prefix.pin(pages)
        req.pinned = [int(p) for p in pages]
        self.pool.seq_lens[slot] = n_cached
        suffix = req.prompt[n_cached:]
        self.pool.allocate(slot, len(suffix) + req.max_new_tokens)
        if self.chunk and len(suffix) > 2 * self.pool.page_size:
            req.feed = req.prompt
            req.prefill_pos = n_cached
        else:
            self._last_tok[slot] = int(suffix[0])
            req.pending = [int(t) for t in suffix[1:]]
        req.slot = slot
        self._slots[slot] = req
        self._m.shared_admits.inc()

    def _covers_enough(self, req: Request, n_cached: int) -> bool:
        """With chunking off a suffix replays one token a decode step: a
        hit is taken only when the suffix is at most ``max(2 pages,
        n_cached)`` tokens."""
        return (len(req.prompt) - n_cached
                <= max(2 * self.pool.page_size, n_cached))

    def _hit_worth_taking(self, req: Request) -> bool:
        """Would ``_admit`` take this request's hit? Judged on the coverage
        it could have (spilled pages included) before ``lookup`` restores
        any: a hit the coverage rule refuses must not spend free pages on
        restores that admission never priced."""
        if self.chunk:
            return True
        n = self._prefix.peek(req.prompt, include_spilled=True)
        while n >= len(req.prompt):
            n -= self.pool.page_size
        return n > 0 and self._covers_enough(req, n)

    def _admission_feed(self, req: Request) -> np.ndarray:
        """What prefill teacher-forces: the prompt, or on a replay prompt +
        every emitted token (its argmax is then the next greedy token)."""
        if not req.tokens:
            return req.prompt
        return np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])

    def _admit(self, req: Request, slot: int) -> bool:
        """Seat ``req`` in ``slot``. A first admission whose prompt prefix
        is cached adopts it (``_admit_shared``; the coverage never takes
        the whole prompt, so the first token is computed). Otherwise a
        feed longer than a nonzero ``prefill_chunk`` gets its whole page
        span now and parks on the chunk cursor (its chunks run one per
        step, not here); any other is prefilled whole here, the step's
        prefill-compute unit. Returns whether prefill compute ran."""
        # the queued phase closes at admission
        self._m.event("request.queued", req.t_submit, time.perf_counter(),
                      rid=req.rid)
        if (self._prefix is not None and not req.tokens
                and self._hit_worth_taking(req)):
            pages, n_cached = self._prefix.lookup(
                req.prompt, max_cover=len(req.prompt) - 1)
            if pages and (self.chunk or self._covers_enough(req, n_cached)):
                self._admit_shared(req, slot, pages, n_cached)
                return False
        feed = self._admission_feed(req)
        if self.chunk and len(feed) > self.chunk:
            remaining = req.max_new_tokens - len(req.tokens)
            self.pool.allocate(slot, len(feed) + remaining)
            req.feed = feed
            req.prefill_pos = 0
            req.slot = slot
            self._slots[slot] = req
            return False
        self._prefill(req, slot, feed)
        return True

    def _register(self, req: Request, slot: int) -> None:
        """The prompt's KV is complete in ``slot``: cache its full pages
        (a first admission's only; a replay's feed is not a prompt)."""
        if self._prefix is not None and not req.tokens:
            self._prefix.register(req.prompt, self.pool.block_tables[slot])

    @torch.inference_mode()
    def _prefill(self, req: Request, slot: int, feed: np.ndarray) -> None:
        """Whole-feed prefill of one request into ``slot`` (b = 1)."""
        replay = bool(req.tokens)
        p = len(feed)
        self.pool.allocate(slot, p + req.max_new_tokens - len(req.tokens))
        bt = self._tensor(self.pool.block_tables[slot:slot + 1])
        sl = torch.zeros((1,), dtype=torch.int32, device=self.device)
        ids = self._tensor(feed[None].astype(np.int64))
        t0 = time.perf_counter()
        with self._m.span("request.prefill", rid=req.rid, prompt_len=p):
            pools = self.pool.take_pools()
            self._f_prefill.check()
            logits, states = self.model.forward_with_cache(
                ids, [PagedDecodeState(k, v, bt, sl) for k, v in pools], 0)
            self._store(states)
            row = logits[0, -1].float()
            tok = int(torch.argmax(row))    # the span holds the token read
        self._m.prefills.inc()
        tnow = time.perf_counter()
        self.prefill_seconds.append(tnow - t0)
        if req.temperature > 0.0:
            self._park_sampled(req, slot, feed)
            return
        if replay:
            # a replay's token continues the sequence: inter-token latency
            self._m.itl.observe(tnow - req.t_last)
        else:
            self._m.ttft.observe(tnow - req.t_submit)
            self.ttft_seconds[req.rid] = tnow - req.t_submit
        self.pool.seq_lens[slot] = p
        self._last_tok[slot] = tok
        req.slot = slot
        self._slots[slot] = req
        self._register(req, slot)
        self._take_token(req, tok, row, tnow)

    @torch.inference_mode()
    def _prefill_chunk(self, req: Request) -> None:
        """One chunk of one mid-prefill request: ``prefill_chunk`` tokens of
        its feed through the chunk program at the cursor (the final partial
        chunk pads; its pad rows are causally invisible to the real ones
        and its pad positions past the block table are dropped), then the
        cursor advances. The cursor, the block table and the tail row's
        index go in as device inputs; only the final chunk's argmax (the
        request's next token) is read back to the host."""
        feed, pos, c = req.feed, req.prefill_pos, self.chunk
        end = min(pos + c, len(feed))
        last = end == len(feed)
        ids = np.zeros((1, c), np.int64)
        ids[0, :end - pos] = feed[pos:end]
        slot = req.slot
        fn = self._chunk_program()
        t0 = time.perf_counter() if self._m.enabled else 0.0
        pools = self.pool.take_pools()
        self._f_chunk.check()
        row, tok, pairs = fn(ids, self.pool.block_tables[slot:slot + 1],
                             np.full((1,), pos, np.int32),
                             np.full((1,), end - pos - 1, np.int64), pools)
        self.pool.install_pools(pairs)
        self.pool.seq_lens[slot] = end
        req.prefill_pos = end
        self.chunk_dispatches += 1
        if not last:
            self._observe_chunk(time.perf_counter() - t0)
            return
        req.prefill_pos = None
        req.feed = None
        if req.temperature > 0.0:
            # the tail's argmax is not read: the verify samples it
            self._observe_chunk(time.perf_counter() - t0, final=True)
            self._park_sampled(req, slot, feed)
            return
        tok = int(tok)
        tnow = time.perf_counter()
        self._observe_chunk(tnow - t0, final=True)
        if req.tokens:
            self._m.itl.observe(tnow - req.t_last)
        else:
            self._m.ttft.observe(tnow - req.t_submit)
            self.ttft_seconds[req.rid] = tnow - req.t_submit
        self._last_tok[slot] = tok
        self._register(req, slot)
        self._take_token(req, tok, row, tnow)

    def _park_sampled(self, req: Request, slot: int,
                      feed: np.ndarray) -> None:
        """A sampled request never takes a prefill's greedy token: its feed
        is written but for the last token, which stays the pending input
        (the cursor parks one short), so the first speculation round's
        verify samples the position the prefill would have decided, and a
        replayed admission resumes at the same position (the same
        draws)."""
        self.pool.seq_lens[slot] = len(feed) - 1
        self._last_tok[slot] = int(feed[-1])
        req.slot = slot
        self._slots[slot] = req
        self._register(req, slot)

    def _chunk_step(self) -> bool:
        """At most one prefill chunk a step; among mid-prefill requests the
        scheduler order (deadline slack, then submission) picks. Returns
        whether one ran."""
        cands = [r for r in self._slots
                 if r is not None and r.prefill_pos is not None]
        if not cands:
            return False
        now = time.perf_counter()
        self._prefill_chunk(min(cands, key=lambda r: self._slack_key(r, now)))
        return True

    # ---------------------------------------------------------- bookkeeping
    def _to_replay_form(self, req: Request, unpin: bool = True) -> None:
        """Drop a request's per-admission state: prompt + emitted tokens
        drive any re-admission. Every path that detaches a live request
        (finish, recovery, preemption, export) comes here, and its adopted
        prefix-cache pages are unpinned here (``unpin=False`` after a
        recovery, whose fresh prefix cache never saw them)."""
        if unpin and req.pinned and self._prefix is not None:
            self._prefix.unpin(req.pinned)
        if req.spec_ready:
            # the draft pool's span goes back while that pool is attached
            # (a reset pool holds nothing of it); gamma and spec_ema stay
            if (req.slot is not None
                    and self._draft_pool.k_pages[0] is not None):
                self._draft_pool.free_sequence(req.slot)
            req.spec_ready = False
        req.pinned = []
        req.pending = []
        req.prefill_pos = None
        req.feed = None
        req.slot = None
        req.bypassed = 0

    def _rollback_admission(self, req: Request, slot: int) -> None:
        """Undo an admission that ran out of pages mid-``allocate``: the
        slot's pages and pins go back, and the request is whole again for
        the queue (its bypass count kept: it may still be the head)."""
        self.pool.free_sequence(slot)
        self._slots[slot] = None
        bypassed = req.bypassed
        self._to_replay_form(req)
        req.bypassed = bypassed

    def _take_token(self, req: Request, tok: int, row: torch.Tensor,
                    now: float) -> None:
        req.t_last = now
        req.tokens.append(tok)
        if self.record_logits:
            self.logits.setdefault(req.rid, []).append(row.cpu().numpy())
        self._emit(req, tok)
        self._finish_if_done(req)

    def _emit(self, req: Request, tok: Optional[int],
              done: bool = False) -> None:
        """Buffer one streaming event; :meth:`step` drains the buffer."""
        cb = self._callbacks.get(req.rid)
        if cb is not None:
            self._events.append((cb, req.rid, tok, done))

    def _drain_events(self) -> None:
        while self._events:
            cb, rid, tok, done = self._events.pop(0)
            cb(rid, tok, done)

    def _finalize(self, req: Request, status: str,
                  error: Optional[str] = None) -> None:
        """End a request: release its slot and pages, bank its tokens
        (partial for a ``TIMEOUT``) and record the status."""
        if req.slot is not None:
            self.pool.free_sequence(req.slot)
            self._slots[req.slot] = None
        self._to_replay_form(req)
        req.status = status
        req.error = error
        self._results[req.rid] = req.tokens
        self._status[req.rid] = status
        self._emit(req, None, done=True)
        self._callbacks.pop(req.rid, None)

    def _finish_if_done(self, req: Request) -> None:
        done = len(req.tokens) >= req.max_new_tokens or (
            req.eos_token_id is not None
            and req.tokens and req.tokens[-1] == req.eos_token_id)
        if done and req.slot is not None:
            self._finalize(req, OK)
            self._m.finished.inc()
            if self._m.enabled:
                self._m.event("request.complete", req.t_submit,
                              time.perf_counter(), rid=req.rid,
                              tokens=len(req.tokens))

    def _sweep_deadlines(self) -> None:
        """End every queued or in-flight request past its deadline
        ``TIMEOUT``, with its tokens so far."""
        now = time.perf_counter()
        expired = [r for r in self._slots
                   if r is not None and r.deadline is not None
                   and now > r.deadline]
        expired += [r for r in self._queue
                    if r.deadline is not None and now > r.deadline]
        if not expired:
            return
        rids = {r.rid for r in expired}
        self._queue = [r for r in self._queue if r.rid not in rids]
        for req in expired:
            self._finalize(req, TIMEOUT, "deadline exceeded")
        self._observe_timeouts(len(expired))

    def _expire_all(self, why: str) -> None:
        """The ``run(max_wall=...)`` watchdog: end everything ``TIMEOUT``."""
        remaining = [r for r in self._slots if r is not None]
        remaining += list(self._queue)
        self._queue = []
        for req in remaining:
            self._finalize(req, TIMEOUT, why)
        if remaining:
            self._observe_timeouts(len(remaining))
        self._observe_step_end()

    # ---------------------------------------------------------- scheduling
    _BYPASS_BUDGET = 4   # cached-prefix bypasses one blocked head allows
    _BYPASS_SCAN = 8     # queue depth scanned for a bypass candidate

    @staticmethod
    def _slack_key(req: Request, now: float):
        """Deadline slack ascending; requests without a deadline tie at
        +inf and keep submission order among themselves."""
        slack = (req.deadline - now) if req.deadline is not None \
            else float("inf")
        return (slack, req.rid)

    def _pages_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens)
                 // self.pool.page_size)

    def _admission_order(self) -> List[Request]:
        """This step's admission order, computed once a step."""
        now = time.perf_counter()
        return sorted(self._queue, key=lambda r: self._slack_key(r, now))

    def _shared_adopt_pages(self, req: Request) -> int:
        """Pages admitting ``req`` would adopt from the prefix cache (0: it
        would not take the shared route), as ``_admit`` routes it: a
        replay never shares, a whole-prompt hit loses its last page, and
        with chunking off the coverage rule applies. Device-resident pages
        only; memoised for the step."""
        if self._prefix is None or req.tokens:
            return 0
        memo = self._probe_memo.get(req.rid)
        if memo is not None:
            return memo
        n = self._prefix.peek(req.prompt)
        while n >= len(req.prompt):
            n -= self.pool.page_size
        if n <= 0 or (not self.chunk and not self._covers_enough(req, n)):
            n = 0
        pages = n // self.pool.page_size
        self._probe_memo[req.rid] = pages
        return pages

    def _fresh_pages_needed(self, req: Request) -> int:
        """Free-list pages admitting ``req`` costs now: its whole span less
        what its cached prefix supplies."""
        return self._pages_needed(req) - self._shared_adopt_pages(req)

    def _needs_prefill_unit(self, req: Request) -> bool:
        """Would admitting ``req`` run a whole prefill (the step's unit)?
        A shared adoption and a chunked admission only park a cursor."""
        if self._shared_adopt_pages(req):
            return False
        return not (self.chunk
                    and len(req.prompt) + len(req.tokens) > self.chunk)

    def _next_admission(self, order: List[Request]) -> Optional[Request]:
        """The next request to admit from ``order``, or None. The slack
        head goes first when its fresh pages are free; a page-blocked head
        first evicts cached pages (and is repriced: eviction may drop part
        of its own cached prefix), then may be passed, at most
        ``_BYPASS_BUDGET`` times, by one of the next ``_BYPASS_SCAN``
        requests whose cached prefix makes its fresh pages fit. Else the
        head waits, and nothing passes it."""
        head = order[0]
        self._head_blocked = False
        need = self._fresh_pages_needed(head)
        if need > self.pool.free_page_count() and self._prefix is not None:
            want = need - self.pool.free_page_count()
            freed = self._prefix.evict(want)
            if freed < want:
                # pinned or shared pages refused: banked as pressure
                self._observe_evict_shortfall(want - freed)
            self._probe_memo.clear()
            need = self._fresh_pages_needed(head)
        if need <= self.pool.free_page_count():
            return head
        # the head waits in the queue; its shortfall is published
        self._head_blocked = True
        self._observe_page_pressure(need - self.pool.free_page_count())
        if self._prefix is not None and head.bypassed < self._BYPASS_BUDGET:
            for req in order[1:1 + self._BYPASS_SCAN]:
                adopt = self._shared_adopt_pages(req)
                if adopt and (self._pages_needed(req) - adopt
                              <= self.pool.free_page_count()):
                    head.bypassed += 1
                    return req
        return None

    def _maybe_migrate(self, order: List[Request]) -> None:
        """Pick the smallest rung covering demand: the active requests plus
        the queued ones the pool could admit, in admission order. Growth is
        immediate; a shrink waits ``bucket_patience`` steps of lower
        demand."""
        if len(self.ladder) == 1:
            return
        active = sum(1 for r in self._slots if r is not None)
        free = self.pool.free_page_count()
        admittable = 0
        for req in order[:self.max_batch]:
            need = self._fresh_pages_needed(req)
            if need > free:
                break
            free -= need
            admittable += 1
        demand = max(1, min(active + admittable, self.max_batch))
        target = next(r for r in self.ladder if r >= demand)
        if target > self.bucket:
            self._migrate(target)
            self._shrink_wait = 0
        elif target < self.bucket:
            self._shrink_wait += 1
            if self._shrink_wait >= self.bucket_patience:
                self._migrate(target)
                self._shrink_wait = 0
        else:
            self._shrink_wait = 0

    def _migrate(self, target: int) -> None:
        """Move the decode batch to rung ``target``. A shrink compacts the
        live requests into the low slots (block-table row moves; no page is
        copied); growth widens the next decode. The ``bucket_migrate`` site
        is checked at the begin, after each row move and at the commit
        (recovery replays the whole batch from host state, so no
        half-compacted table survives)."""
        self._f_migrate.check(phase="begin", frm=self.bucket, to=target)
        if target < self.bucket:
            dst = 0
            for s in range(target, self.max_batch):
                req = self._slots[s]
                if req is None:
                    continue
                while self._slots[dst] is not None:
                    dst += 1        # always < target: target covers active
                self.pool.move_sequence(s, dst)
                if req.spec_ready:
                    # the draft pool mirrors the target's slots
                    self._draft_pool.move_sequence(s, dst)
                self._last_tok[dst] = self._last_tok[s]
                self._slots[dst] = req
                self._slots[s] = None
                req.slot = dst
                self._f_migrate.check(phase="move", rid=req.rid)
        self.bucket = target
        self.bucket_migrations += 1
        self._f_migrate.check(phase="commit")
        self._observe_bucket(migrated=True)

    def _preempt_for(self, order: List[Request]) -> None:
        """When the slack head has a deadline with slack inside the horizon
        and cannot admit (no free slot in the rung, or too few free pages),
        unseat the slackest running request whose slack exceeds the head's
        by more than the margin, until the head can admit or no request
        qualifies. Pages the prefix cache could evict count as free. A
        victim replays later from prompt + tokens; each is unseated at most
        ``preempt_budget`` times."""
        if not self.preempt_enabled or not order:
            return
        head = order[0]
        if head.deadline is None:
            return
        now = time.perf_counter()
        head_slack = head.deadline - now
        if head_slack > self.preempt_horizon:
            return
        while True:
            free_slots = self._slots[:self.bucket].count(None)
            reclaimable = (self.pool.free_page_count()
                           + (self._prefix.evictable_page_count()
                              if self._prefix is not None else 0))
            if free_slots and self._fresh_pages_needed(head) <= reclaimable:
                return
            victim, best = None, (-1.0, -1)
            for r in self._slots:
                if (r is None or r.rid == head.rid
                        or r.preempts >= self.preempt_budget):
                    continue
                slack = ((r.deadline - now) if r.deadline is not None
                         else float("inf"))
                if slack <= head_slack + self.preempt_margin:
                    continue
                if (slack, r.rid) > best:
                    best, victim = (slack, r.rid), r
            if victim is None:
                return
            # checked before anything changes
            self._f_preempt.check(rid=victim.rid)
            self._unseat(victim)
            self._probe_memo.clear()        # pages moved: reprice the head

    def _unseat(self, req: Request) -> None:
        """Return a running request to the queue as host state: its slot
        and pages go back, its tokens and deadline stay."""
        slot = req.slot
        self.pool.free_sequence(slot)
        self._slots[slot] = None
        self._last_tok[slot] = 0
        self._to_replay_form(req)
        req.preempts += 1
        self.preemptions += 1
        self._queue.append(req)
        self._observe_preemption(req)

    # ------------------------------------------------ speculative decoding
    # One round for one request: the draft scan and the verify chunk, the
    # proposals read once between them. Only the verify decides tokens:
    # the writes past the accepted length (past the draft's span: its
    # pool's null page; past the target's table: dropped by the chunk
    # writer) are overwritten before any real row attends to them, so γ
    # needs no fitting to the budget's tail.
    # accept-rate EMA thresholds of the adaptive rung walk: grow on a high
    # EMA and a clean round, shrink on a low one (the gap stops flapping)
    _SPEC_GROW = 0.75
    _SPEC_SHRINK = 0.35

    def _spec_occupancy_cap(self, n_rows: int) -> int:
        """The largest γ rung the slot budget affords ``n_rows`` rows at
        γ + 1 slots each; 0: priced out (the plain batched step is the
        cheaper schedule)."""
        for g in reversed(self.spec_rungs):
            if n_rows * (g + 1) <= self.spec_slots:
                return g
        return 0

    def _spec_gamma(self, req: Request, cap: int) -> int:
        """This round's γ: the request's rung, capped by occupancy, snapped
        down to a rung, and trimmed toward the end of its token budget
        (truncation keeps the tokens right either way; this keeps the draft
        cheap)."""
        g = req.gamma or self.spec_gamma_default
        if cap:
            g = min(g, cap)
        remaining = req.max_new_tokens - len(req.tokens)
        fit = [r for r in self.spec_rungs
               if r <= min(g, max(1, remaining - 1))]
        return fit[-1] if fit else self.spec_rungs[0]

    def _spec_step(self, rows: List[Request]) -> bool:
        """Serve this step's decode rows by speculation rounds, or decline
        (False) and let the plain batched step run. All or nothing: a row
        still teacher-forcing a prompt suffix keeps the step plain, and so
        does an occupancy that prices speculation out, unless a sampled
        row is present (the verify is the only sampler: it forces rounds,
        at the smallest rung over the budget)."""
        if any(r.pending for r in rows):
            return False
        sampled = any(r.temperature > 0.0 for r in rows)
        cap = self._spec_occupancy_cap(len(rows))
        if cap == 0 and not sampled:
            return False
        for req in list(rows):
            self._spec_round(req, self._spec_gamma(req, cap))
        return True

    def _spec_sync(self, req: Request) -> None:
        """Bring the draft's KV of this slot up to the target's length L.
        The first entry allocates the slot's whole span (the worst-case
        draft pool cannot run short); a gap (admission prefilled the target
        only, or plain steps ran while speculation was priced out) is
        teacher-forced through the draft's chunk program in fixed (1, C)
        chunks, whose outputs are not read."""
        slot = req.slot
        L = int(self.pool.seq_lens[slot])
        dpool = self._draft_pool
        if not req.spec_ready:
            dpool.allocate(slot, L + 1 + req.max_new_tokens - len(req.tokens))
            req.spec_ready = True
        cur = int(dpool.seq_lens[slot])
        if cur >= L:
            return
        feed = self._admission_feed(req)
        width = self.spec_sync_chunk
        fn = self._spec_sync_program()
        while cur < L:
            end = min(cur + width, L)
            ids = np.zeros((1, width), np.int64)
            ids[0, :end - cur] = feed[cur:end]
            dpools = dpool.take_pools()
            self._f_spec_draft.check(rid=req.rid, op="sync")
            _row, _tok, pairs = fn(ids, dpool.block_tables[slot:slot + 1],
                                   np.full((1,), cur, np.int32),
                                   np.full((1,), end - cur - 1, np.int64),
                                   dpools)
            dpool.install_pools(pairs)
            self.spec_sync_chunks += 1
            cur = end
        dpool.seq_lens[slot] = L

    def _spec_law(self, req: Request, rows: int, L: int) -> List[np.ndarray]:
        """A sampled round's draw inputs: ``rows`` rows of uniforms over the
        vocabulary from a ``torch.Generator`` seeded by (seed, position),
        the temperature and top-p."""
        gen = torch.Generator().manual_seed(
            (req.seed * 1000003 + L) & 0x7FFFFFFF)
        vocab = self.model.config.vocab_size
        u = torch.rand((rows, vocab), generator=gen).numpy()
        return [u, np.full((1,), req.temperature, np.float32),
                np.full((1,), req.top_p, np.float32)]

    def _spec_round(self, req: Request, gamma: int) -> None:
        """One draft / verify round for one decode row. On entry and exit
        both pools hold the KV of ids[:L] and ``_last_tok`` is ids[L], the
        newest token not yet written. Both fault sites fire before the
        cursor roll, so a fault replays the round from host state, drawing
        the same."""
        slot = req.slot
        sample = req.temperature > 0.0
        self._spec_sync(req)
        L = int(self.pool.seq_lens[slot])
        t0 = time.perf_counter() if self._m.enabled else 0.0
        law = self._spec_law(req, gamma, L) if sample else []
        # the draft: γ proposals in one program
        dfn = self._spec_draft_program(gamma, sample, req.top_k)
        dpools = self._draft_pool.take_pools()
        self._f_spec_draft.check(rid=req.rid, op="draft")
        (props, qrows), dpairs = dfn(
            self._last_tok[slot:slot + 1, None],
            self._draft_pool.block_tables[slot:slot + 1],
            self._draft_pool.seq_lens[slot:slot + 1], *law, dpools)
        self._draft_pool.install_pools(dpairs)
        # the verify's ids need the proposals: the round's one read of
        # the draft
        props_np = props.cpu().numpy()
        ids = np.empty((1, gamma + 1), np.int64)
        ids[0, 0] = self._last_tok[slot]
        ids[0, 1:] = props_np
        # the verify: one (1, γ + 1) chunk of the target
        vfn = self._spec_verify_program(gamma, sample, req.top_k)
        pools = self.pool.take_pools()
        self._f_spec_verify.check(rid=req.rid)
        (greedy, rows, prows), pairs = vfn(
            ids, self.pool.block_tables[slot:slot + 1],
            self.pool.seq_lens[slot:slot + 1], *law[1:], pools)
        self.pool.install_pools(pairs)
        # acceptance on the host: the longest agreeing prefix and the
        # target's next token, or rejection sampling
        if sample:
            new_toks, accepted = self._spec_accept_sample(
                req, L, gamma, props_np, qrows.cpu().numpy(),
                prows.cpu().numpy())
        else:
            greedy_np = greedy.cpu().numpy()
            accepted = 0
            while (accepted < gamma
                   and int(props_np[accepted]) == int(greedy_np[accepted])):
                accepted += 1
            new_toks = [int(t) for t in props_np[:accepted]]
            new_toks.append(int(greedy_np[accepted]))
        # clip to the token budget and to the first EOS: the plain engine
        # stops there
        new_toks = new_toks[:req.max_new_tokens - len(req.tokens)]
        if req.eos_token_id is not None and req.eos_token_id in new_toks:
            new_toks = new_toks[:new_toks.index(req.eos_token_id) + 1]
        # the cursor roll: both pools advance to exactly the accepted
        # length; the rejected tail's KV is overwritten before it is read
        self.pool.seq_lens[slot] = L + len(new_toks)
        self._draft_pool.seq_lens[slot] = L + len(new_toks)
        now = time.perf_counter()
        first = not req.tokens
        if first:
            # the verify wrote the prompt's last position: its pages are
            # complete
            self._register(req, slot)
        if self.record_logits:
            self.logits.setdefault(req.rid, []).extend(
                rows[:len(new_toks)].cpu().numpy())
        for t in new_toks:
            req.tokens.append(int(t))
            self._emit(req, int(t))
        if first:
            self._m.ttft.observe(now - req.t_submit)
            self.ttft_seconds[req.rid] = now - req.t_submit
        else:
            # one inter-token sample a round: its tokens arrive together
            self._m.itl.observe(now - req.t_last)
        req.t_last = now
        self._last_tok[slot] = int(new_toks[-1])
        # adaptive γ: the accept-rate EMA moves the rung
        rate = accepted / gamma
        req.spec_ema = 0.7 * req.spec_ema + 0.3 * rate
        if self.spec_adaptive:
            idx = max(i for i, r in enumerate(self.spec_rungs)
                      if r <= max(gamma, self.spec_rungs[0]))
            if accepted == gamma and req.spec_ema >= self._SPEC_GROW:
                idx = min(idx + 1, len(self.spec_rungs) - 1)
            elif req.spec_ema < self._SPEC_SHRINK:
                idx = max(idx - 1, 0)
            req.gamma = self.spec_rungs[idx]
        else:
            req.gamma = gamma
        self.spec_rounds += 1
        self.spec_tokens_accepted += accepted
        self.spec_tokens_rejected += gamma - accepted
        self.spec_last_gamma = gamma
        self._observe_spec(gamma, accepted, rate, t0, now)
        self._finish_if_done(req)

    def _spec_accept_sample(self, req: Request, L: int, gamma: int,
                            props: np.ndarray, qrows: np.ndarray,
                            prows: np.ndarray):
        """Rejection sampling (the speculative-sampling identity): accept
        draft token d_i with probability min(1, p_i(d_i) / q_i(d_i)); on
        the first rejection draw the correction from the residual
        normalize(max(p_i - q_i, 0)); after a full accept draw the bonus
        token from the target's last row. p and q are the filtered
        distributions the programs return, so the emitted law is exactly
        the target's sampling law. Uniforms come from default_rng((seed,
        L)): a replayed round at the same accepted length redraws
        identically. Returns (new_tokens, accepted_count)."""
        rng = np.random.default_rng((req.seed, L))
        out: List[int] = []
        for i in range(gamma):
            d = int(props[i])
            q = float(qrows[i, d])
            p = float(prows[i, d])
            if q <= 0.0 or rng.random() * q <= p:
                out.append(d)
                continue
            resid = np.maximum(
                prows[i].astype(np.float64) - qrows[i], 0.0)
            s = float(resid.sum())
            if s <= 0.0:        # q >= p everywhere (numerically): the
                resid = prows[i].astype(np.float64)     # target row
                s = float(resid.sum())                  # itself
            out.append(int(rng.choice(resid.shape[0], p=resid / s)))
            return out, i
        last = prows[gamma].astype(np.float64)
        out.append(int(rng.choice(last.shape[0], p=last / last.sum())))
        return out, gamma

    # one program per (kind, γ rung, mode, top_k): DecodeKey.extra
    def _spec_program(self, kind: str, extra: Tuple, step, weights,
                      draft: bool, graph, eager, *shape):
        """The cached program of a speculative key, bound to this engine:
        ``eager(program, weights, device)``, or on the card the CUDA graph
        ``graph(program, weights, device, *shape)``; made once per key."""
        memo = (kind,) + tuple(extra)
        fn = self._spec_fns.get(memo)
        if fn is None:
            pool = self._draft_pool if draft else self.pool
            key = DecodeKey(
                kind=kind,
                model_sig=self._draft_sig if draft else self._model_sig,
                batch_bucket=1,
                page_budget=(pool.num_pages, pool.page_size,
                             pool.max_pages_per_seq),
                dtype=str(pool.k_pages[0].dtype),
                flags=self._flags.as_tuple(),
                extra=tuple(extra) + ((TAG_KV, self.kv_dtype),
                                      (TAG_WT, self.weight_dtype)))
            on_card = self.device.type == "cuda"
            program = decode_program_cache().get(key, functools.partial(
                _build_decode, step=step, on_card=on_card))
            fn = (graph(program, weights, self.device, *shape) if on_card
                  else eager(program, weights, self.device))
            self._spec_fns[memo] = fn
            self._spec_keys[memo] = key
        if kind == "spec_draft":
            self.spec_draft_key = self._spec_keys[memo]
        elif kind == "spec_verify":
            self.spec_verify_key = self._spec_keys[memo]
        return fn

    def _spec_sync_program(self) -> _EagerChunk:
        """The draft model's chunk program at the sync width."""
        return self._spec_program(
            "prefill_chunk", (self.spec_sync_chunk,), _chunk_step,
            self.draft_model, True, _ChunkGraph, _EagerChunk,
            self.spec_sync_chunk, self._draft_pool.max_pages_per_seq)

    @staticmethod
    def _spec_mode(sample: bool, top_k: int) -> tuple:
        return (ATOM_SAMPLE, int(top_k)) if sample else (ATOM_GREEDY,)

    def _spec_draft_program(self, gamma: int, sample: bool,
                            top_k: int) -> _EagerStep:
        fspec = self._draft_fspec
        path = (ATOM_FUSED,) if fspec else (ATOM_GENERIC,)
        pages = self._draft_pool.max_pages_per_seq
        inputs = [((1, 1), torch.int64), ((1, pages), torch.int32),
                  ((1,), torch.int32)]
        if sample:
            inputs += [((gamma, self.model.config.vocab_size),
                        torch.float32)] + _LAW_SCALARS
        return self._spec_program(
            "spec_draft", (gamma,) + path + self._spec_mode(sample, top_k),
            functools.partial(_spec_draft_step, fspec, gamma, sample,
                              int(top_k)),
            self._draft_params if fspec else self.draft_model, True,
            _SpecGraph, _EagerStep, inputs)

    def _spec_verify_program(self, gamma: int, sample: bool,
                             top_k: int) -> _EagerStep:
        pages = self.pool.max_pages_per_seq
        inputs = [((1, gamma + 1), torch.int64), ((1, pages), torch.int32),
                  ((1,), torch.int32)]
        if sample:
            inputs += _LAW_SCALARS
        return self._spec_program(
            "spec_verify", (gamma + 1,) + self._spec_mode(sample, top_k),
            functools.partial(_spec_verify_step, sample, int(top_k)),
            self.model, False, _SpecGraph, _EagerStep, inputs)

    # ---------------------------------------------------------------- step
    def step(self) -> None:
        """One scheduler round: deadline sweep, bucket migration, SLO
        preemption, admission, at most one prefill-compute unit, one decode
        at the current rung. A step that raises is recovered by replay
        (:meth:`_recover_dispatch`), unless it raised a kernel or CUDA
        error. Streaming callbacks run after it, outside the recovery
        boundary, so a raising callback surfaces to the caller."""
        try:
            self._step_inner()
            self._consec_failures = 0
        except Exception as exc:
            self._recover_dispatch(exc)
        finally:
            self._drain_events()

    def _recover_dispatch(self, exc: Exception) -> None:
        """Replay recovery. Every request's prompt and emitted tokens are
        host state: reset the pools (in place, :meth:`_rebuild_pool`), end
        ``FAILED`` the requests whose no-progress budget is spent, put the
        rest back in the queue in replay form (greedy decoding makes the
        replayed continuation the uninterrupted one) and back off
        exponentially while nothing progresses. A kernel error and a CUDA
        error (the context is unusable) raise instead."""
        if isinstance(exc, _UNRECOVERABLE):
            raise exc
        t0 = time.perf_counter()
        live = [r for r in self._slots if r is not None]
        failed_adm = self._failed_admission
        self._failed_admission = None
        # a failed admission was rolled back before the raise, so it is in
        # no slot
        victims = live + ([failed_adm] if failed_adm is not None else [])
        if not victims:
            if self._queue and self._consec_failures < self.max_retries:
                # nothing in flight died but work is queued (a migration
                # fault before admission): back off and press on, within
                # the engine-wide no-progress budget
                if self.pool.k_pages[0] is None or (
                        self._draft_pool is not None
                        and self._draft_pool.k_pages[0] is None):
                    self._rebuild_pool()    # a step left the pools out
                self._consec_failures += 1
                self._observe_recovery(0, 0, time.perf_counter() - t0)
                time.sleep(min(
                    self.retry_backoff * (2 ** (self._consec_failures - 1)),
                    2.0))
                return
            # nothing in flight and nothing queued, or the budget is spent:
            # not a failure replay can absorb
            raise exc
        self._rebuild_pool()
        survivors: List[Request] = []
        failed: List[Request] = []
        any_progress = False
        for req in victims:
            # progress is (tokens, prefill cursor), a high-water mark: the
            # cursor restarts at 0 on every replay, so a failure point
            # oscillating below the best attempt is not progress
            progress = (len(req.tokens), req.prefill_pos or 0)
            self._to_replay_form(req, unpin=False)
            if progress > req.progress_mark:
                any_progress = True
                req.retries = 1
                req.progress_mark = progress
            else:
                req.retries += 1
            if req.retries > self.max_retries:
                failed.append(req)
            else:
                survivors.append(req)
        self._slots = [None] * self.max_batch
        self._last_tok[:] = 0
        for req in failed:
            self._finalize(req, FAILED, repr(exc))
        # replays keep their submission order relative to the queue
        self._queue = sorted(survivors + self._queue, key=lambda r: r.rid)
        self._consec_failures = (1 if any_progress
                                 else self._consec_failures + 1)
        self._observe_recovery(len(survivors), len(failed),
                               time.perf_counter() - t0)
        if self._queue:
            time.sleep(min(
                self.retry_backoff * (2 ** (self._consec_failures - 1)),
                2.0))

    def _rebuild_pool(self) -> None:
        """Fresh pools of the same geometry, in place: the pairs a failed
        step detached go back, every tensor is zeroed at its address and
        the allocator starts over (:meth:`PagedKVCache.reset`), so the
        CUDA graphs captured over them keep replaying and no program is
        rebuilt. The draft pool is reset with it, in place too (the JAX
        engine allocates a fresh one): replay re-syncs the draft from host
        state. The prefix cache indexed the old contents (and its host
        tier) and starts empty."""
        self.pool.reset()
        if self._draft_pool is not None:
            self._draft_pool.reset()
        self._prefix = self._new_prefix_cache()
        self._probe_memo.clear()
        self._pool_frag_epoch = -1      # re-publish the ledger

    def _step_inner(self) -> None:
        self._sweep_deadlines()
        self._probe_memo.clear()        # prefix probes are per step
        # decode-ready requests before this step's scheduler and prefill
        # work: the ones that work stalls
        waiting = any(r is not None and r.prefill_pos is None
                      for r in self._slots)
        t_sched = time.perf_counter()
        order = self._admission_order() if self._queue else []
        self._maybe_migrate(order)
        # before the fill: a victim's slot admits the head this step
        self._preempt_for(order)
        chunk_pending = any(r is not None and r.prefill_pos is not None
                            for r in self._slots)
        did_prefill = chunk_ran_first = False
        if chunk_pending and self._chunk_turn:
            did_prefill = chunk_ran_first = self._chunk_step()
        for slot in range(self.bucket):
            if self._slots[slot] is not None or not order:
                continue
            req = self._next_admission(order)
            if req is None:
                break           # the head waits for pages, order kept
            if did_prefill and self._needs_prefill_unit(req):
                break           # the unit is spent: it admits next step
            order.remove(req)
            self._queue.remove(req)
            try:
                did_prefill |= self._admit(req, slot)
            except Exception as e:
                if isinstance(e, RuntimeError) and \
                        "page pool exhausted" in str(e):
                    # allocate came up short (pinned pages counted as
                    # evictable): back off to the queue head and wait
                    self._rollback_admission(req, slot)
                    self._queue.insert(0, req)
                    self._observe_page_pressure(max(
                        1, self._pages_needed(req)
                        - self.pool.free_page_count()))
                    break
                # a failed dispatch: the request goes to recovery (it
                # holds no slot after the rollback)
                self._rollback_admission(req, slot)
                self._failed_admission = req
                raise
            if not self._head_blocked:
                # a bypass admission leaves the blocked head's pressure
                self._observe_page_pressure(0)
        admission_used_unit = did_prefill and not chunk_ran_first
        if not did_prefill:
            did_prefill = self._chunk_step()
        self._chunk_turn = chunk_pending and admission_used_unit
        if waiting and did_prefill:
            self._observe_stall(time.perf_counter() - t_sched)

        decode_rows = [r for r in self._slots
                       if r is not None and r.prefill_pos is None]
        self._observe_step_begin(len(decode_rows))
        if not decode_rows:
            return
        if self._draft_pool is not None and self._spec_step(decode_rows):
            # the rows were served by speculation rounds
            self._observe_step_end()
            return
        b = self.bucket
        fn = self._decode_program(b)
        t0 = time.perf_counter()
        pools = self.pool.take_pools()
        self._f_decode.check()
        toks, logits, pairs = fn(self._last_tok[:b, None],
                                 self.pool.block_tables[:b],
                                 self.pool.seq_lens[:b], pools)
        self.pool.install_pools(pairs)
        now = time.perf_counter()
        self.decode_step_seconds.append(now - t0)
        self._m.event("engine.decode_step", t0, now,
                      active=len(decode_rows))
        for slot, req in enumerate(self._slots):
            if req is None or req.prefill_pos is not None:
                # an idle row wrote the null page, a mid-prefill row its
                # cursor position (the next chunk overwrites it): ignored
                continue
            if req.temperature > 0.0 and not req.pending:
                # a sampled row takes no greedy token: its write at the
                # cursor is a correct prefix write, and the cursor stays
                # for the next round's verify to sample that position
                continue
            self.pool.seq_lens[slot] += 1
            if req.pending:
                # teacher-forcing a cached prefix's suffix: the output is a
                # prompt position's, not a token; feed the next one
                self._last_tok[slot] = req.pending.pop(0)
                continue
            tok = int(toks[slot])
            if req.tokens:
                self._m.itl.observe(now - req.t_last)
            else:
                # the first token of a shared admission: the prompt's KV
                # is complete, so its suffix pages are cached too
                self._m.ttft.observe(now - req.t_submit)
                self.ttft_seconds[req.rid] = now - req.t_submit
                self._register(req, slot)
            self._last_tok[slot] = tok
            self._take_token(req, tok, logits[slot], now)
        self._observe_step_end()

    # ------------------------------------------------------------ telemetry
    # Host bookkeeping once a step, outside any captured graph.
    def _observe_step_begin(self, n_active: int) -> None:
        m = self._m
        if not m.enabled:
            return
        if n_active:
            m.decode_steps.inc()
        else:
            # an idle step decodes nothing; the gauges stay current
            self._observe_step_end()

    def _observe_step_end(self) -> None:
        """One gauge refresh a step, after finished requests freed their
        slots and pages, so a drained engine reads 0."""
        m = self._m
        if not m.enabled:
            return
        m.queue_depth.set(len(self._queue))
        m.occupancy.set(self.max_batch - self._slots.count(None))
        if not self._queue:
            m.page_pressure.set(0)      # an empty queue has no pressure
        self._observe_pool_ledger()

    def _observe_pool_ledger(self) -> None:
        """The pool ledger as step-end gauges plus one counter-track sample
        (pages and bytes in line with the serving timeline). Fragmentation
        is recomputed only when the free list's epoch moved."""
        m = self._m
        led = self.pool.ledger(fragmentation=False)
        pinned = (self._prefix.pinned_page_count()
                  if self._prefix is not None else 0)
        m.kv_pages_in_use.set(led["pages_in_use"])
        if self._prefix is not None:
            m.prefix_pinned.set(pinned)
        m.pool_pages["used"].set(led["pages_in_use"])
        m.pool_pages["free"].set(led["pages_free"])
        m.pool_pages["shared"].set(led["pages_shared"])
        m.pool_pages["pinned"].set(pinned)
        m.pool_pages["spilled"].set(led["pages_spilled"])
        m.pool_bytes["used"].set(led["bytes_in_use"])
        m.pool_bytes["free"].set(led["bytes_free"])
        m.pool_bytes["shared"].set(
            led["pages_shared"] * led["bytes_per_page"])
        m.pool_bytes["pinned"].set(pinned * led["bytes_per_page"])
        m.pool_bytes["spilled"].set(led["bytes_spilled"])
        if led["pages_spilled"] > self._host_tier_peak:
            self._host_tier_peak = led["pages_spilled"]
            m.host_tier_peak.set(self._host_tier_peak)
        if led["epoch"] != self._pool_frag_epoch:
            self._pool_frag_epoch = led["epoch"]
            self._pool_frag = self.pool.free_list_fragmentation()
            m.pool_frag.set(self._pool_frag)
        m.counter_track(
            "kv_pool", time.perf_counter(),
            pages_in_use=led["pages_in_use"],
            bytes_in_use=led["bytes_in_use"],
            pages_shared=led["pages_shared"], pages_pinned=pinned,
            pages_spilled=led["pages_spilled"])

    def _observe_page_pressure(self, short: int) -> None:
        """Pages the queue head is short at admission (0: not blocked)."""
        if self._m.enabled:
            self._m.page_pressure.set(short)

    def _observe_timeouts(self, n: int) -> None:
        if self._m.enabled:
            self._m.requests_timeout.inc(n)

    def _observe_recovery(self, n_replayed: int, n_failed: int,
                          dt: float) -> None:
        """One recovery: requests re-queued, requests ended ``FAILED``, its
        wall clock, and the reset pool's ledger at once (the failed step
        never reached its step-end refresh)."""
        m = self._m
        if not m.enabled:
            return
        m.recoveries.inc()
        if n_replayed:
            m.retries.inc(n_replayed)
        if n_failed:
            m.requests_failed.inc(n_failed)
        m.recovery_seconds.observe(dt)
        self._observe_pool_ledger()

    def _observe_evict_shortfall(self, short: int) -> None:
        """``evict`` freed fewer pages than asked: how many, and the
        pinned pages that explain it."""
        m = self._m
        if not m.enabled or self._prefix is None:
            return
        m.evict_short.inc(short)
        m.prefix_pinned.set(self._prefix.pinned_page_count())

    def _observe_preemption(self, req: Request) -> None:
        """One victim unseated, and the decode tokens its replay
        regenerates."""
        m = self._m
        if not m.enabled:
            return
        m.preemptions.inc()
        if req.tokens:
            m.preempted_tokens.inc(len(req.tokens))

    def _observe_spec(self, gamma: int, accepted: int, rate: float,
                      t0: float, t1: float) -> None:
        """One speculation round retired: the accept-rate histogram (the
        adaptive-γ signal), the accepted and rejected token counters, the
        γ gauge and a timeline event."""
        m = self._m
        if not m.enabled:
            return
        m.spec_rounds_c.inc()
        m.spec_accept.observe(rate)
        if accepted:
            m.spec_accepted.inc(accepted)
        if gamma - accepted:
            m.spec_rejected.inc(gamma - accepted)
        m.spec_gamma.set(gamma)
        m.event("engine.spec_round", t0, t1, gamma=gamma,
                accepted=accepted)

    def _observe_chunk(self, dt: float, final: bool = False) -> None:
        """One chunk dispatched (its host wall clock); the final chunk
        counts the request's prefill."""
        if self._m.enabled:
            self._m.prefill_chunk_s.observe(dt)
            if final:
                self._m.prefills.inc()

    def _observe_stall(self, dt: float) -> None:
        """Scheduler and prefill work ran while decode-ready requests
        waited: that wall clock is the decode stall (the host probe
        ``max_decode_stall`` keeps its maximum whatever the flag)."""
        if dt > self.max_decode_stall:
            self.max_decode_stall = dt
        if self._m.enabled:
            self._m.decode_stall_s.observe(dt)

    def _observe_bucket(self, migrated: bool = False) -> None:
        """The rung gauge moves only on a migration (and once when the
        engine is made)."""
        if self._m.enabled:
            self._m.bucket.set(self.bucket)
            if migrated:
                self._m.migrations.inc()
