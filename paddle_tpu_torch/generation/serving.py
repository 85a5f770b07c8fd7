"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``paddle_tpu/generation/serving.py`` (the core of
``ServingEngine``). Requests admit into free batch slots as they open,
each is prefilled whole into the paged pool (one prefill per step), and
every step then decodes one greedy token for the whole fixed-shape batch
with per-slot ragged lengths; idle slots write into the reserved null page
and their outputs are ignored. Finished sequences return their pages to
the pool.

Decode runs the fused block kernel once per layer (``FLAGS_fused_block_decode``,
the default) or the model's own cached forward, whose attention is the
paged decode kernel. The programs are plain eager PyTorch functions.

Left for later slices, and refused with ``NotImplementedError``:
speculative decoding (``draft_model``), the prefix cache, int8 KV pools,
int4 weights, tensor-parallel decode, sampling (``temperature > 0``),
deadlines, a bucket ladder of more than one rung and chunked prefill
(prompts longer than a nonzero ``prefill_chunk``). Replay recovery,
telemetry and fault injection are not part of this slice: a failed step
raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import flags as _flags
from ..kernels.fused_block_decode import (BlockDecodeWeights, _rms,
                                          fused_block_decode)
from ..kernels.paged_attention import PagedDecodeState, PagedKVCache

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


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (a later slice of "
                               "paddle_tpu_torch)")


class ServingEngine:
    """Drive ``model`` (a port ``LlamaForCausalLM``) as a continuous-batching
    server: ``submit`` enqueues, each ``step`` admits at most one waiting
    request (its whole-prompt prefill) and decodes one token for every
    active slot, ``run`` steps until drained and returns ``{rid: tokens}``.

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
        if kv_dtype is None:
            kv_dtype = _flags.get_flag("serving_kv_dtype")
        if kv_dtype == "int8":
            raise _later("the int8 KV pool (kv_dtype='int8')")
        if kv_dtype != "native":
            raise ValueError(f"kv_dtype must be 'native' or 'int8', "
                             f"got {kv_dtype!r}")
        if weight_dtype == "int4":
            raise _later("int4 weight tiles (weight_dtype='int4')")
        if weight_dtype not in (None, "native"):
            raise ValueError(f"weight_dtype must be 'native' or 'int4', "
                             f"got {weight_dtype!r}")
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
            reserve_null_page=True, device=self.device)
        self._params = dict(model.named_parameters())
        self._spec = self._fused_spec()
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._queue: List[Request] = []
        self._results: Dict[int, List[int]] = {}
        self._last_tok = np.zeros((max_batch,), np.int64)
        self._next_rid = 0
        self.logits: Dict[int, List[np.ndarray]] = {}
        # host probes: seconds of each decode step (dispatch to tokens on
        # the host), of each prefill (dispatch to first token) and from
        # each request's submission to its first token
        self.decode_step_seconds: List[float] = []
        self.prefill_seconds: List[float] = []
        self.ttft_seconds: List[float] = []

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
        if self.chunk and len(prompt) > self.chunk:
            raise _later(f"chunked prefill (a {len(prompt)}-token prompt > "
                         f"prefill_chunk={self.chunk})")
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
        ``FLAGS_fused_block_decode`` on and every named weight present."""
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

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _states(self, pools, bt, sl) -> List[PagedDecodeState]:
        return [PagedDecodeState(k, v, bt, sl) for k, v in pools]

    def _store(self, states) -> None:
        self.pool.install_pools([(st.k_pages, st.v_pages) for st in states])

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
        self.ttft_seconds.append(tnow - req.t_submit)
        self.pool.seq_lens[slot] = p
        self._last_tok[slot] = tok
        req.slot = slot
        self._slots[slot] = req
        self._append(req, tok, row)

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
        x = _rms(x, p[spec["final_norm"]], spec["epsilon"])
        if spec["lm_head"]:
            logits = x @ p[spec["lm_head"]]
        else:
            logits = x @ p[spec["embed"]].T
        return logits.float(), states

    @torch.inference_mode()
    def _decode_generic(self, toks, pools, bt, sl):
        """The model's cached forward; per-slot positions from seq_lens."""
        logits, states = self.model.forward_with_cache(
            toks, self._states(pools, bt, sl), None)
        return logits[:, -1].float(), states

    def step(self) -> None:
        """One scheduler round: admit (one prefill at most), then decode one
        token for every active slot."""
        order = sorted(self._queue, key=lambda r: r.rid)
        for slot in range(self.bucket):
            if self._slots[slot] is not None or not order:
                continue
            head = order[0]
            need = self._pages_needed(len(head.prompt), head.max_new_tokens)
            if need > self.pool.free_page_count():
                break           # the head waits for pages, order kept
            self._queue.remove(head)
            self._prefill(head, slot)
            break               # one prefill per step

        rows = [r for r in self._slots if r is not None]
        if not rows:
            return
        b = self.bucket
        bt = self._tensor(self.pool.block_tables[:b])
        sl = self._tensor(self.pool.seq_lens[:b])
        toks = self._tensor(self._last_tok[:b, None])
        t0 = time.perf_counter()
        pools = self.pool.take_pools()
        decode = (self._decode_fused if self._spec is not None
                  else self._decode_generic)
        logits, states = decode(toks, pools, bt, sl)
        self._store(states)
        next_toks = torch.argmax(logits, dim=-1).cpu().numpy()
        now = time.perf_counter()
        self.decode_step_seconds.append(now - t0)
        for slot, req in enumerate(self._slots):
            if req is None:
                continue        # idle row wrote the null page; ignored
            self.pool.seq_lens[slot] += 1
            tok = int(next_toks[slot])
            self._last_tok[slot] = tok
            self._append(req, tok, logits[slot])
