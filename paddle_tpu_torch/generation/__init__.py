"""Autoregressive generation: ``GenerationMixin`` (PaddleNLP's
``model.generate``), the continuous-batching ``serving.ServingEngine`` on the
paged KV cache, and its decode program cache (``program_cache``).

Counterpart of ``paddle_tpu/generation/__init__.py``. ``generate`` decodes
greedily, sampled (temperature, top-k, top-p) or by beam search, with a
repetition penalty, ``min_new_tokens`` and eos/pad, over static
``(B, T, Hkv, D)`` ring-buffer caches; ``generate_paged`` decodes greedily
over a paged KV pool (no null page; the structure a serving loop needs);
``generate_speculative`` is greedy speculative decoding with a draft model,
lossless against ``generate``.

Where the JAX package jits each generation as one program (a ``lax.scan``
over the ring buffers), the port runs an eager host loop under
``torch.inference_mode()``, one cached forward a token, the caches updated
in place, with ``eval()`` set for the loop and the training mode restored
after. Offsets are host ints, so the loop reads no device value per layer.
On the card a prefill (S > 1) and the speculative verify launch the
prefill kernel, ``generate_paged``'s decode the paged decode kernel; a
one-token step over a ring buffer is the dense composition, as in the JAX
package outside Pallas. Sampled ``generate`` draws from an explicit
``generator=`` (a ``torch.Generator``): the JAX package's ``jax.random``
bits cannot be reproduced, so sampled streams follow the same law, not the
same draws.

Models opt in by inheriting ``GenerationMixin`` and providing
``cache_spec() -> [(num_kv_heads, head_dim), ...]`` (one per layer) and
``forward_with_cache(input_ids, caches, offset) -> (logits, caches)``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..kernels.paged_attention import PagedDecodeState, PagedKVCache
from .sampling import (_NEG_INF, _apply_logit_adjust, _spec_filtered_probs,
                       race_sample)

__all__ = ["GenerationMixin"]


def _first_param(model) -> torch.Tensor:
    return next(iter(model.parameters()))


def _ring_caches(model, batch: int, max_len: int, dtype=None):
    """Zero ring buffers, one ``(k, v)`` pair a layer, each
    ``(batch, max_len, num_kv_heads, head_dim)`` on the model's device."""
    p = _first_param(model)
    dtype = dtype or p.dtype
    return [(torch.zeros((batch, max_len, hkv, d), dtype=dtype,
                         device=p.device),
             torch.zeros((batch, max_len, hkv, d), dtype=dtype,
                         device=p.device))
            for hkv, d in model.cache_spec()]


@contextlib.contextmanager
def _inference(*models):
    """``eval()`` and ``torch.inference_mode()`` for a generation loop;
    each model's training mode is restored after."""
    was = [m.training for m in models]
    for m in models:
        m.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        for m, training in zip(models, was):
            if training:
                m.train()


def _argmax(rows: torch.Tensor) -> torch.Tensor:
    return torch.argmax(rows.float(), dim=-1)


class GenerationMixin:
    """Adds ``generate``, ``generate_paged`` and ``generate_speculative``
    to a module with decode hooks."""

    def init_cache(self, batch: int, max_len: int, dtype=None):
        """Zero ring-buffer KV caches: one (k, v) pair per layer, each
        (batch, max_len, num_kv_heads, head_dim), in the parameters' dtype
        unless ``dtype`` says otherwise, on the model's device."""
        return _ring_caches(self, batch, max_len, dtype)

    def _prompt_ids(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(input_ids)
        if ids.dim() != 2:
            raise ValueError(f"input_ids must be (batch, seq), got "
                             f"{tuple(ids.shape)}")
        if ids.dtype not in (torch.int32, torch.int64):
            ids = ids.to(torch.int64)
        return ids.to(_first_param(self).device)

    def _check_positions(self, total: int, what: str) -> None:
        maxpos = getattr(getattr(self, "config", None),
                         "max_position_embeddings", None)
        if maxpos is not None and total > maxpos:
            raise ValueError(f"{what} = {total} exceeds "
                             f"max_position_embeddings ({maxpos})")

    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None,
                 repetition_penalty: float = 1.0,
                 min_new_tokens: int = 0,
                 num_beams: int = 1,
                 length_penalty: float = 1.0,
                 return_full_sequence: bool = True,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Greedy, sampled or beam autoregressive decode. Returns the
        (B, P + N) full sequence (or the (B, N) generated tail with
        ``return_full_sequence=False``) in the prompt's integer dtype, on
        the model's device. After an ``eos_token_id`` hit a row emits
        ``pad_token_id`` (default: the eos id, else 0) for the remaining
        steps.

        ``repetition_penalty`` > 1 divides positive (multiplies negative)
        logits of every token already in the row, prompt included.
        ``min_new_tokens`` masks ``eos_token_id`` for the first N steps.
        ``do_sample`` draws from the filtered law (``temperature``, then
        ``top_k``, then the ``top_p`` nucleus) with uniforms from
        ``generator`` (required then). ``num_beams`` > 1 is beam search
        (greedy over beams; ``do_sample`` must be False), scoring the
        final beams by ``sum(logprobs) / len**length_penalty``."""
        ids = self._prompt_ids(input_ids)
        b, p = ids.shape
        n = int(max_new_tokens)
        self._check_positions(
            p + n, f"prompt ({p}) + max_new_tokens ({max_new_tokens})")
        if pad_token_id is None:
            pad_token_id = eos_token_id if eos_token_id is not None else 0
        if num_beams > 1 and do_sample:
            raise ValueError("beam search is greedy over beams — "
                             "do_sample=True is not supported with "
                             "num_beams > 1 (reference raises too)")
        if do_sample and generator is None:
            raise ValueError("sampled generate draws its uniforms from an "
                             "explicit torch.Generator: pass generator=")
        with _inference(self):
            if n == 0:
                toks = ids[:, :0]
            elif num_beams > 1:
                toks = self._beam_generate(
                    ids, n, int(num_beams), eos_token_id, pad_token_id,
                    float(length_penalty), float(repetition_penalty),
                    int(min_new_tokens))
            else:
                toks = self._sample_generate(
                    ids, n, bool(do_sample), float(temperature), int(top_k),
                    float(top_p), eos_token_id, pad_token_id,
                    float(repetition_penalty), int(min_new_tokens),
                    generator)
        return torch.cat([ids, toks], dim=1) if return_full_sequence \
            else toks

    def _sample_generate(self, ids, n, do_sample, temperature, top_k, top_p,
                         eos, pad, repetition_penalty, min_new_tokens,
                         generator, caches=None) -> torch.Tensor:
        """The greedy / sampled loop: prefill writes cache positions
        [0, P) and predicts token P; step i feeds token i - 1 at P + i - 1.
        ``caches`` (default: zero ring buffers of P + N) are whatever
        ``forward_with_cache`` takes. Returns the (B, N) tokens."""
        b, p = ids.shape
        rows = torch.arange(b, device=ids.device)
        track = repetition_penalty != 1.0

        def select(logits, step):
            lg = _apply_logit_adjust(logits.float(), seen, step,
                                     repetition_penalty, min_new_tokens, eos)
            if not do_sample:
                return torch.argmax(lg, dim=-1)
            probs = _spec_filtered_probs(lg, temperature, top_k, top_p)
            u = torch.rand(probs.shape, generator=generator,
                           device=generator.device)
            return race_sample(probs, u.to(probs.device))

        if caches is None:
            caches = self.init_cache(b, p + n)
        logits, caches = self.forward_with_cache(ids, caches, 0)
        # the vocabulary from the logits, not self.config: the mixin
        # contract only asks for cache_spec + forward_with_cache
        seen = None
        if track:
            seen = torch.zeros((b, logits.shape[-1]), dtype=torch.bool,
                               device=ids.device)
            seen.scatter_(1, ids.long(), True)
        tok = select(logits[:, -1], 0).to(ids.dtype)
        if track:
            seen[rows, tok.long()] = True
        finished = (tok == eos) if eos is not None else torch.zeros_like(
            tok, dtype=torch.bool)
        out = [tok]
        pad_t = torch.tensor(pad, dtype=ids.dtype, device=ids.device)
        for step in range(1, n):
            logits, caches = self.forward_with_cache(tok[:, None], caches,
                                                     p + step - 1)
            nxt = select(logits[:, -1], step).to(ids.dtype)
            nxt = torch.where(finished, pad_t, nxt)
            if track:
                seen[rows, nxt.long()] = True
            if eos is not None:
                finished = finished | (nxt == eos)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1)

    def _beam_generate(self, ids, n, beams, eos, pad, length_penalty,
                       repetition_penalty, min_new_tokens) -> torch.Tensor:
        """Beam search (PaddleNLP's ``beam_search``): the beams ride the
        caches' batch axis (B * beams rows), reordered to their chosen
        origins every step; a finished beam extends only with pad at no
        extra score. The best final beam by
        ``sum(logprobs) / len**length_penalty`` (tokens up to and including
        eos) is rebuilt by following its origins back. Returns (B, N)."""
        b, p = ids.shape
        bb = b * beams
        dev = ids.device
        track = repetition_penalty != 1.0

        def logprobs(logits, step):
            lg = _apply_logit_adjust(logits[:, -1].float(), seen, step,
                                     repetition_penalty, min_new_tokens, eos)
            return torch.log_softmax(lg, dim=-1).reshape(b, beams, -1)

        caches = self.init_cache(bb, p + n)
        ids_t = ids.repeat_interleave(beams, dim=0)
        logits, caches = self.forward_with_cache(ids_t, caches, 0)
        vocab = logits.shape[-1]
        seen = None
        if track:
            seen = torch.zeros((bb, vocab), dtype=torch.bool, device=dev)
            seen.scatter_(1, ids_t.long(), True)
        lp = logprobs(logits, 0)
        # every beam of a row is the same after prefill: keep beam 0's
        # distribution only, so the top-k picks distinct tokens
        first = torch.where((torch.arange(beams, device=dev) == 0)[None, :,
                                                                     None],
                            lp[:, :1], _NEG_INF)
        scores, idx = torch.topk(first.reshape(b, -1), beams, dim=-1)
        tok = (idx % vocab).to(ids.dtype)
        finished = (tok == eos) if eos is not None else torch.zeros_like(
            tok, dtype=torch.bool)
        lengths = torch.ones((b, beams), dtype=torch.int32, device=dev)
        flat_rows = torch.arange(bb, device=dev)
        if track:
            seen[flat_rows, tok.reshape(bb).long()] = True
        pad_row = torch.where(torch.arange(vocab, device=dev) == pad, 0.0,
                              _NEG_INF)
        base = torch.arange(b, device=dev)[:, None] * beams
        tok0, steps, origins = tok, [], []
        for step in range(1, n):
            logits, caches = self.forward_with_cache(tok.reshape(bb, 1),
                                                     caches, p + step - 1)
            lp = logprobs(logits, step)
            lp = torch.where(finished[:, :, None], pad_row, lp)
            cand = scores[:, :, None] + lp
            scores, idx = torch.topk(cand.reshape(b, -1), beams, dim=-1)
            src = idx // vocab                              # beam origin
            nxt = (idx % vocab).to(tok.dtype)
            finished = finished.gather(1, src)
            lengths = lengths.gather(1, src)
            flat_src = (base + src).reshape(bb)
            caches = [(k[flat_src], v[flat_src]) for k, v in caches]
            if track:
                seen = seen[flat_src]
                seen[flat_rows, nxt.reshape(bb).long()] = True
            lengths = torch.where(finished, lengths, lengths + 1)
            if eos is not None:
                finished = finished | (nxt == eos)
            steps.append(nxt)
            origins.append(src)
            tok = nxt
        # follow each final beam's origins back to its first token
        beam_idx = torch.arange(beams, device=dev).expand(b, beams)
        rev = []
        for step_tok, step_src in zip(reversed(steps), reversed(origins)):
            rev.append(step_tok.gather(1, beam_idx))
            beam_idx = step_src.gather(1, beam_idx)
        seqs = torch.stack([tok0.gather(1, beam_idx)] + rev[::-1],
                           dim=2)                           # (b, beams, n)
        norm = scores / lengths.float() ** length_penalty
        best = torch.argmax(norm, dim=1)
        return seqs[torch.arange(b, device=dev), best]

    def generate_paged(self, input_ids, max_new_tokens: int = 32,
                       page_size: int = 64, num_pages: Optional[int] = None,
                       eos_token_id: Optional[int] = None,
                       pad_token_id: Optional[int] = None,
                       return_full_sequence: bool = True) -> torch.Tensor:
        """Greedy decode over a paged KV cache (Paddle's
        ``block_multihead_attention`` serving): a :class:`PagedKVCache`
        without a null page, every row's span allocated up front, one
        ``PagedDecodeState`` a layer. The prefill writes the prompts'
        pages and attends on the prefill kernel; each token then decodes
        through the block tables on the paged decode kernel. The tokens
        equal ``generate``'s greedy ones."""
        ids = self._prompt_ids(input_ids)
        b, p = ids.shape
        n = int(max_new_tokens)
        total = p + n
        self._check_positions(
            total, f"prompt ({p}) + max_new_tokens ({max_new_tokens})")
        if n == 0:
            return ids if return_full_sequence else ids[:, :0]
        spec = self.cache_spec()
        if num_pages is None:
            num_pages = b * (-(-total // page_size))
        if pad_token_id is None:
            pad_token_id = eos_token_id if eos_token_id is not None else 0
        param = _first_param(self)
        with _inference(self):
            mgr = PagedKVCache(
                num_layers=len(spec), num_pages=num_pages,
                page_size=page_size, num_kv_heads=spec[0][0],
                head_dim=spec[0][1], max_batch=b, max_seq_len=total,
                dtype=param.dtype, device=param.device)
            for row in range(b):
                mgr.allocate(row, total)
            bt = torch.from_numpy(mgr.block_tables[:b]).to(param.device)
            zeros = torch.zeros((b,), dtype=torch.int32, device=param.device)
            states = [PagedDecodeState(mgr.k_pages[i], mgr.v_pages[i], bt,
                                       zeros) for i in range(len(spec))]
            gen = self._sample_generate(
                ids, n, do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                eos=eos_token_id, pad=pad_token_id, repetition_penalty=1.0,
                min_new_tokens=0, generator=None, caches=states)
        return torch.cat([ids, gen], dim=1) if return_full_sequence else gen

    def generate_speculative(self, input_ids, draft_model,
                             max_new_tokens: int = 32,
                             num_speculative_tokens: int = 4,
                             return_full_sequence: bool = True
                             ) -> torch.Tensor:
        """Greedy speculative decoding (Leviathan et al.): ``draft_model``
        proposes ``num_speculative_tokens`` (γ) tokens a round, the target
        verifies them in one (γ + 1)-token cached forward (the prefill
        kernel on the card), and the longest agreeing prefix plus the
        target's token after it are accepted. Lossless: the output equals
        ``generate(..., do_sample=False)`` token for token.

        Both models keep ring buffers of ``P + N + γ + 2`` positions;
        rejected positions keep stale k/v past the valid length, which
        attention masks and later writes overwrite. Each round keeps
        ``L - M == 1`` (both caches hold the accepted sequence but its
        newest token), so a round is one single-token draft feed, γ - 1
        draft proposals and one verify. Batch 1 only (acceptance lengths
        differ between rows); no eos stop. The last call's rounds and
        accepted proposals are in ``speculative_stats``."""
        g = int(num_speculative_tokens)
        ids = self._prompt_ids(input_ids)
        b, p = ids.shape
        if b != 1:
            raise ValueError("generate_speculative supports batch=1 "
                             "(per-row acceptance lengths diverge)")
        n = int(max_new_tokens)
        cap = p + n + g + 2            # slack: a round may overshoot n
        self._check_positions(
            cap, f"prompt ({p}) + max_new_tokens ({n}) + speculative "
            f"slack ({g + 2})")
        dev = ids.device
        if _first_param(draft_model).device != dev:
            raise ValueError(f"the draft model is on "
                             f"{_first_param(draft_model).device}, the "
                             f"target on {dev}")
        rounds = accepted = 0
        with _inference(self, draft_model):
            t_caches = _ring_caches(self, 1, cap)
            d_caches = _ring_caches(draft_model, 1, cap)
            logits, t_caches = self.forward_with_cache(ids, t_caches, 0)
            _, d_caches = draft_model.forward_with_cache(ids, d_caches, 0)
            seq = ids[0].tolist() + [int(_argmax(logits[0, -1]))]
            big_l = len(seq)   # accepted; both caches hold seq[:L - 1]
            while len(seq) - p < n:
                # the draft: its one gap (seq[L - 1]) fed at L - 1, then
                # γ - 1 proposals fed back on the device
                feed = torch.tensor([[seq[big_l - 1]]], dtype=ids.dtype,
                                    device=dev)
                props = []
                for i in range(g):
                    lg, d_caches = draft_model.forward_with_cache(
                        feed, d_caches, big_l - 1 + i)
                    tok = _argmax(lg[0, -1])
                    props.append(tok)
                    feed = tok.reshape(1, 1).to(ids.dtype)
                proposals = torch.stack(props).tolist()
                chunk = torch.tensor([[seq[big_l - 1]] + proposals],
                                     dtype=ids.dtype, device=dev)
                lg, t_caches = self.forward_with_cache(chunk, t_caches,
                                                       big_l - 1)
                greedy = _argmax(lg[0]).tolist()
                a = 0
                while a < g and proposals[a] == greedy[a]:
                    a += 1
                seq.extend(proposals[:a])
                seq.append(greedy[a])
                big_l = len(seq)
                rounds += 1
                accepted += a
            gen = torch.tensor([seq[p:p + n]], dtype=ids.dtype, device=dev)
        self.speculative_stats = dict(rounds=rounds, proposed=rounds * g,
                                      accepted=accepted)
        return torch.cat([ids, gen], dim=1) if return_full_sequence else gen
