"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``paddle_tpu/generation/serving.py`` (the core of
``ServingEngine``). Requests admit into free batch slots as they open. A
prompt of at most ``prefill_chunk`` tokens (or any prompt with chunking
off, ``prefill_chunk=0``) is prefilled whole into the paged pool at
admission; a longer one parks on a cursor and is prefilled one fixed-size
chunk per step (``PagedChunkState``: the chunk attends to the written
prefix plus itself), so a long prompt stalls the decoding requests by one
chunk at a time, never a whole prompt. Each step spends at most one
prefill-compute unit (one whole prefill or one chunk), alternating between
new admissions and in-flight chunks when both wait. Every step then
decodes one greedy token for the whole fixed-shape batch with per-slot
ragged lengths; idle slots write into the reserved null page and
mid-prefill slots write at their cursor (the next chunk overwrites it),
and both outputs are ignored. Finished sequences return their pages to
the pool.

Decode runs the fused block kernel once per layer (``FLAGS_fused_block_decode``,
the default), the N-layer kernel once per group of N layers
(``FLAGS_fused_block_layers=N > 1``, over weights stacked once per engine),
or the model's own cached forward, whose attention is the paged decode
kernel. The programs are plain eager PyTorch functions.

``kv_dtype="int8"`` (``FLAGS_serving_kv_dtype``) stores the pool as int8
rows with per-row f32 scales, written by every route and read by every
attention kernel; ``weight_dtype="int4"`` (``FLAGS_fused_weight_dtype``)
packs the N-layer route's stacked matrices as int4 tiles. Prefill and
chunks keep the native per-layer weights, and with N = 1 int4 changes
nothing, as in the JAX package.

Left for later slices, and refused with ``NotImplementedError``:
speculative decoding (``draft_model``), the prefix cache, tensor-parallel
decode, sampling (``temperature > 0``), deadlines and a bucket ladder of
more than one rung. Replay recovery, telemetry and fault injection are
not part of this slice: a failed step raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import flags as _flags
from ..kernels.fused_block_decode import (BlockDecodeWeights,
                                          MultiBlockDecodeWeights, _rms,
                                          fused_block_decode,
                                          fused_multi_block_decode,
                                          stack_block_weights)
from ..kernels.paged_attention import (PagedChunkState, PagedDecodeState,
                                       PagedKVCache)

__all__ = ["Request", "ServingEngine"]

@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    t_submit: float = 0.0               # host clock at submission
    # chunked prefill: what the chunks teacher-force, and the cursor (None
    # once the request decodes)
    feed: Optional[np.ndarray] = None
    prefill_pos: Optional[int] = None


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (a later slice of "
                               "paddle_tpu_torch)")


class ServingEngine:
    """Drive ``model`` (a port ``LlamaForCausalLM``) as a continuous-batching
    server: ``submit`` enqueues, each ``step`` admits waiting requests into
    free slots, runs at most one prefill-compute unit (a whole-prompt
    prefill or one chunk of a long prompt) and decodes one token for every
    slot past its prefill, ``run`` steps until drained and returns
    ``{rid: tokens}``.

    ``record_logits=True`` keeps, in ``logits[rid]``, the f32 logits row
    each generated token was taken from (host memory: vocabulary floats
    per token), for checks against a reference."""

    def __init__(self, model, max_batch: int = 4, page_size: int = 64,
                 num_pages: Optional[int] = None, max_seq_len: int = 1024,
                 prefix_cache: bool = False,
                 bucket_ladder: Optional[Tuple[int, ...]] = None,
                 prefill_chunk: Optional[int] = None,
                 draft_model=None,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 tp_degree: Optional[int] = None,
                 record_logits: bool = False):
        if draft_model is not None:
            raise _later("speculative decoding (draft_model=)")
        if prefix_cache:
            raise _later("the prefix cache (prefix_cache=True)")
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
        # the JAX engine's ladder: rungs above max_batch drop, max_batch is
        # the top rung; its default (4, 8, 16, 32) leaves one rung for
        # max_batch <= 4
        rungs = (4, 8, 16, 32) if bucket_ladder is None else bucket_ladder
        if any(int(r) < 1 for r in rungs):
            raise ValueError(f"bucket ladder rungs must be >= 1: {rungs}")
        ladder = sorted({int(r) for r in rungs if int(r) <= max_batch}
                        | {max_batch})
        if len(ladder) > 1:
            raise _later(f"a multi-rung bucket ladder {tuple(ladder)}")
        self.bucket = max_batch

        self.model = model
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.record_logits = bool(record_logits)
        self.device = model.device
        spec = model.cache_spec()
        if num_pages is None:
            num_pages = 1 + max_batch * (-(-max_seq_len // page_size))
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
        self._params = dict(model.named_parameters())
        self._spec = self._fused_spec()
        # the N-layer route's stacked weights, one group each, built once
        self._stacked = (self._stacked_weights(self._spec)
                         if self._spec and "layer_groups" in self._spec
                         else None)
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._queue: List[Request] = []
        self._results: Dict[int, List[int]] = {}
        self._last_tok = np.zeros((max_batch,), np.int64)
        self._next_rid = 0
        # the fairness flip: the next contended step's prefill unit goes to
        # the in-flight chunks
        self._chunk_turn = False
        self.chunk_dispatches = 0
        self.logits: Dict[int, List[np.ndarray]] = {}
        # host probes: seconds of each decode step (dispatch to tokens on
        # the host), of each whole-prompt prefill (dispatch to first
        # token), and from each request's submission to its first token
        # (by rid; a chunked prompt's closes on its final chunk)
        self.decode_step_seconds: List[float] = []
        self.prefill_seconds: List[float] = []
        self.ttft_seconds: Dict[int, float] = {}

    # ------------------------------------------------------------ frontend
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               deadline: Optional[float] = None,
               temperature: float = 0.0) -> int:
        """Enqueue one greedy request; returns its id."""
        if deadline is not None:
            raise _later("request deadlines (deadline=)")
        if float(temperature or 0.0) != 0.0:
            raise _later("sampling (temperature > 0)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" exceeds engine max_seq_len ({self.max_seq_len})")
        need = self._pages_needed(len(prompt), max_new_tokens)
        usable = self.pool.num_pages - 1        # null page reserved
        if need > min(usable, self.pool.max_pages_per_seq):
            raise ValueError(
                f"request needs {need} pages but the pool can ever offer "
                f"{min(usable, self.pool.max_pages_per_seq)}")
        req = Request(self._next_rid, prompt, int(max_new_tokens),
                      eos_token_id, t_submit=time.perf_counter())
        self._next_rid += 1
        self._queue.append(req)
        return req.rid

    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def run(self) -> Dict[int, List[int]]:
        """Step until drained; returns and clears ``{rid: tokens}``."""
        while self.has_work():
            self.step()
        out, self._results = self._results, {}
        return out

    def results(self) -> Dict[int, List[int]]:
        """Completed results so far, without draining them."""
        return {rid: list(toks) for rid, toks in self._results.items()}

    # ------------------------------------------------------------ internals
    def _pages_needed(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new) // self.pool.page_size)

    def _fused_spec(self):
        """The model's fused-block layout when the fused path applies:
        ``FLAGS_fused_block_decode`` on and every named weight present.
        Under ``FLAGS_fused_block_layers=N > 1`` it carries the model's
        ``layer_groups``."""
        if not _flags.get_flag("fused_block_decode"):
            return None
        spec = self.model.block_decode_spec(
            _flags.get_flag("fused_block_layers"))
        names = [spec["embed"], spec["final_norm"]]
        if spec["lm_head"]:
            names.append(spec["lm_head"])
        for lw in spec["layers"]:
            names.extend(lw.values())
        if not all(n in self._params for n in names):
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

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _states(self, pools, bt, sl) -> List[PagedDecodeState]:
        return [PagedDecodeState(k, v, bt, sl) for k, v in pools]

    def _store(self, states) -> None:
        self.pool.install_pools([(st.k_pages, st.v_pages) for st in states])

    def _chunked(self, req: Request) -> bool:
        """Whether ``req``'s prompt prefills in chunks: it is longer than a
        nonzero ``prefill_chunk``."""
        return bool(self.chunk) and len(req.prompt) > self.chunk

    def _admit(self, req: Request, slot: int) -> bool:
        """Seat ``req`` in ``slot``. A chunked prompt gets its whole page
        span now and parks on the chunk cursor (its chunks run one per
        step, not here); any other prompt is prefilled whole here, the
        step's prefill-compute unit. Returns whether prefill compute ran."""
        if self._chunked(req):
            self.pool.allocate(slot, len(req.prompt) + req.max_new_tokens)
            req.feed = req.prompt
            req.prefill_pos = 0
            req.slot = slot
            self._slots[slot] = req
            return False
        self._prefill(req, slot)
        return True

    @torch.inference_mode()
    def _prefill(self, req: Request, slot: int) -> None:
        """Whole-prompt prefill of one request into ``slot`` (b = 1)."""
        feed = req.prompt
        p = len(feed)
        self.pool.allocate(slot, p + req.max_new_tokens)
        bt = self._tensor(self.pool.block_tables[slot:slot + 1])
        sl = torch.zeros((1,), dtype=torch.int32, device=self.device)
        ids = self._tensor(feed[None].astype(np.int64))
        t0 = time.perf_counter()
        pools = self.pool.take_pools()
        logits, states = self.model.forward_with_cache(
            ids, self._states(pools, bt, sl), 0)
        self._store(states)
        row = logits[0, -1].float()
        tok = int(torch.argmax(row))
        tnow = time.perf_counter()
        self.prefill_seconds.append(tnow - t0)
        self.ttft_seconds[req.rid] = tnow - req.t_submit
        self.pool.seq_lens[slot] = p
        self._last_tok[slot] = tok
        req.slot = slot
        self._slots[slot] = req
        self._append(req, tok, row)

    @torch.inference_mode()
    def _prefill_chunk(self, req: Request) -> None:
        """One chunk of one mid-prefill request: ``prefill_chunk`` tokens of
        its feed through the model at the cursor (one fixed ``(1, chunk)``
        forward under ``PagedChunkState``; the final partial chunk pads, its
        pad rows are causally invisible to the real ones and its pad
        positions past the block table are dropped), then the cursor
        advances. Only the final chunk computes logits, of the real tail's
        row, and pulls its argmax to the host: the request's first token."""
        feed, pos, c = req.feed, req.prefill_pos, self.chunk
        end = min(pos + c, len(feed))
        last = end == len(feed)
        ids = np.zeros((1, c), np.int64)
        ids[0, :end - pos] = feed[pos:end]
        slot = req.slot
        bt = self._tensor(self.pool.block_tables[slot:slot + 1])
        sl = self._tensor(np.full((1,), pos, np.int32))
        pools = self.pool.take_pools()
        # the cursor reaches the rotary positions as a host int
        hidden, states = self.model.llama(
            self._tensor(ids),
            caches=[PagedChunkState(k, v, bt, sl) for k, v in pools],
            offset=pos)
        self._store(states)
        self.pool.seq_lens[slot] = end
        req.prefill_pos = end
        self.chunk_dispatches += 1
        if not last:
            return
        row = self.model.logits(hidden[0, end - pos - 1]).float()
        tok = int(torch.argmax(row))
        self.ttft_seconds[req.rid] = time.perf_counter() - req.t_submit
        self._last_tok[slot] = tok
        req.prefill_pos = None
        req.feed = None
        self._append(req, tok, row)

    def _chunk_step(self) -> bool:
        """At most one prefill chunk a step, of the earliest submitted
        mid-prefill request. Returns whether one ran."""
        cands = [r for r in self._slots
                 if r is not None and r.prefill_pos is not None]
        if not cands:
            return False
        self._prefill_chunk(min(cands, key=lambda r: r.rid))
        return True

    def _append(self, req: Request, tok: int, row: torch.Tensor) -> None:
        req.tokens.append(tok)
        if self.record_logits:
            self.logits.setdefault(req.rid, []).append(row.cpu().numpy())
        done = len(req.tokens) >= req.max_new_tokens or (
            req.eos_token_id is not None and tok == req.eos_token_id)
        if done:
            self.pool.free_sequence(req.slot)
            self._slots[req.slot] = None
            req.slot = None
            self._results[req.rid] = req.tokens

    def _head(self, x, spec, p):
        """Final norm and LM head of the fused routes, f32 logits."""
        x = _rms(x, p[spec["final_norm"]], spec["epsilon"])
        if spec["lm_head"]:
            logits = x @ p[spec["lm_head"]]
        else:
            logits = x @ p[spec["embed"]].T
        return logits.float()

    @torch.inference_mode()
    def _decode_fused(self, toks, pools, bt, sl):
        """Embedding lookup, one fused block kernel per layer, final norm
        and LM head."""
        spec, p = self._spec, self._params
        x = p[spec["embed"]][toks[:, 0]]
        states = []
        for i, lw in enumerate(spec["layers"]):
            w = BlockDecodeWeights(**{f: p[n] for f, n in lw.items()})
            kp, vp = pools[i]
            x, kp, vp = fused_block_decode(
                x, w, kp, vp, bt, sl, num_heads=spec["num_heads"],
                num_kv_heads=spec["num_kv_heads"],
                rope_theta=spec["rope_theta"], epsilon=spec["epsilon"])
            states.append(PagedDecodeState(kp, vp, bt, sl))
        return self._head(x, spec, p), states

    @torch.inference_mode()
    def _decode_fused_nlayer(self, toks, pools, bt, sl):
        """Embedding lookup, one N-layer fused kernel per layer group over
        the stacked weights, final norm and LM head."""
        spec, p = self._spec, self._params
        x = p[spec["embed"]][toks[:, 0]]
        states = []
        for group, weights in zip(spec["layer_groups"], self._stacked):
            x, kps, vps = fused_multi_block_decode(
                x, weights, [pools[i][0] for i in group],
                [pools[i][1] for i in group], bt, sl,
                num_heads=spec["num_heads"],
                num_kv_heads=spec["num_kv_heads"],
                rope_theta=spec["rope_theta"], epsilon=spec["epsilon"])
            states.extend(PagedDecodeState(kp, vp, bt, sl)
                          for kp, vp in zip(kps, vps))
        return self._head(x, spec, p), states

    @torch.inference_mode()
    def _decode_generic(self, toks, pools, bt, sl):
        """The model's cached forward; per-slot positions from seq_lens."""
        logits, states = self.model.forward_with_cache(
            toks, self._states(pools, bt, sl), None)
        return logits[:, -1].float(), states

    def step(self) -> None:
        """One scheduler round: admit into free slots in submission order,
        spend at most one prefill-compute unit (a whole-prompt prefill or a
        chunk; when both wait they take turns), then decode one token for
        every slot past its prefill."""
        order = sorted(self._queue, key=lambda r: r.rid)
        chunk_pending = any(r is not None and r.prefill_pos is not None
                            for r in self._slots)
        did_prefill = chunk_ran_first = False
        if chunk_pending and self._chunk_turn:
            did_prefill = chunk_ran_first = self._chunk_step()
        for slot in range(self.bucket):
            if self._slots[slot] is not None or not order:
                continue
            head = order[0]
            need = self._pages_needed(len(head.prompt), head.max_new_tokens)
            if need > self.pool.free_page_count():
                break           # the head waits for pages, order kept
            if did_prefill and not self._chunked(head):
                break           # the unit is spent: it admits next step
            order.pop(0)
            self._queue.remove(head)
            did_prefill |= self._admit(head, slot)
        admission_used_unit = did_prefill and not chunk_ran_first
        if not did_prefill:
            self._chunk_step()
        self._chunk_turn = chunk_pending and admission_used_unit

        if not any(r is not None and r.prefill_pos is None
                   for r in self._slots):
            return
        b = self.bucket
        bt = self._tensor(self.pool.block_tables[:b])
        sl = self._tensor(self.pool.seq_lens[:b])
        toks = self._tensor(self._last_tok[:b, None])
        t0 = time.perf_counter()
        pools = self.pool.take_pools()
        if self._spec is None:
            decode = self._decode_generic
        elif self._stacked is None:
            decode = self._decode_fused
        else:
            decode = self._decode_fused_nlayer
        logits, states = decode(toks, pools, bt, sl)
        self._store(states)
        next_toks = torch.argmax(logits, dim=-1).cpu().numpy()
        now = time.perf_counter()
        self.decode_step_seconds.append(now - t0)
        for slot, req in enumerate(self._slots):
            if req is None or req.prefill_pos is not None:
                # an idle row wrote the null page, a mid-prefill row its
                # cursor position (the next chunk overwrites it): ignored
                continue
            self.pool.seq_lens[slot] += 1
            tok = int(next_toks[slot])
            self._last_tok[slot] = tok
            self._append(req, tok, logits[slot])
