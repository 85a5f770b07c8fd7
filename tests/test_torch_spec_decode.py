"""Speculative decoding in the port's ServingEngine against the JAX
package's (``tests/test_spec_decode.py``'s contracts, on Llama): greedy
parity and construction. The engine pair and drafts are
``torch_spec_twins``'; replay and pricing are
``test_torch_spec_replay.py``, sampling ``test_torch_spec_sampling.py``.
Held equal, exactly:

- greedy streams: the port's speculative engine against the JAX spec
  engine's, the port's plain engine's and the JAX model's solo decode,
  on the fused route and the generic one (``FLAGS_fused_block_decode=0``),
  native and int8 pools, through chunked prefill, bucket migration and a
  request that fills the whole table (``prompt + max_new_tokens ==
  max_seq_len``);
- what the schedule observes: ``spec_rounds``, tokens accepted and
  rejected, every round's (request, γ), the statuses and the spec metric
  families, against the JAX engine's; the program keys and their reuse;
- the draft pool's table, which has room for a round past the longest
  span: such a round's writes land on the null page.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.generation.program_cache import decode_program_cache
from paddle_tpu_torch.kernels import paged_attention as tpa
from torch_serving_twins import both_flags, solo, tokens
from torch_spec_twins import (  # noqa: F401  (fixtures)
    PAGE, _both, _hold, _plain, _submit_run, clock, models)


# ------------------------------------------------------- greedy parity
SCENARIOS = {
    # name: (script, engine kwargs, flags)
    "fused": (_submit_run((5, 8, 13), 10), {}, {}),
    "generic": (_submit_run((5, 8, 13), 10), {},
                dict(fused_block_decode=False)),
    "int8": (_submit_run((5, 8, 13), 10), dict(kv_dtype="int8"), {}),
    "int8-generic": (_submit_run((5, 8, 13), 10), dict(kv_dtype="int8"),
                     dict(fused_block_decode=False)),
    "chunked": (_submit_run((40, 7), 12, head=1, stagger=1),
                dict(max_seq_len=128, prefill_chunk=16), {}),
    "migration": (_submit_run((6, 9, 5, 7), 8, stagger=3),
                  dict(max_batch=4, bucket_ladder=(2, 4)), {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_greedy_streams_and_schedule_match_jax(models, clock, name):
    script, kw, flags = SCENARIOS[name]
    got = _hold(models, clock, script, flags=flags, **kw)
    assert got["spec_rounds"] > 0
    assert got["families"]["serving_spec_rounds"] == got["spec_rounds"]
    if name == "migration":
        assert got["migrations"] >= 1


def test_draft_key_names_route_and_mode(models, clock):
    def script(eng):
        _submit_run((5,), 6, head=1)(eng)
        return dict(draft=eng.spec_draft_key, verify=eng.spec_verify_key)
    for fused, route in ((True, "fused"), (False, "generic")):
        want, got = _both(models, clock, script,
                          flags=dict(fused_block_decode=fused))
        for k in ("draft", "verify"):
            assert got[k].kind == want[k].kind
            assert got[k].extra == want[k].extra
            assert got[k].batch_bucket == want[k].batch_bucket == 1
        assert got["verify"].page_budget == want["verify"].page_budget
        # the port's draft table has room for a round past the longest span
        assert got["draft"].page_budget[:2] == want["draft"].page_budget[:2]
        assert got["draft"].page_budget[2] == -(-(64 + 8 + 1) // PAGE)
        assert route in got["draft"].extra
        assert got["draft"].extra[:1] == (got["rounds"][-1][1],)


def test_one_program_per_key_shared_across_engines(models, clock):
    cache = decode_program_cache()
    _plain(models, clock, _submit_run((5,), 1, head=1))  # warm the target
    _both(models, clock, _submit_run((5, 8), 6))
    keys = set(cache.keys())
    traces = {k: cache.trace_count(k) for k in keys}
    _both(models, clock, _submit_run((5, 8), 6))
    assert set(cache.keys()) == keys
    assert {k: cache.trace_count(k) for k in keys} == traces
    kinds = {k.kind for k in keys}
    assert {"spec_draft", "spec_verify", "prefill_chunk"} <= kinds


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_table_end_request(models, clock, fused):
    """prompt + max_new_tokens == max_seq_len (a whole number of pages):
    the last rounds' draft scans run past the slot's span (onto the draft
    table's null-page columns) and the verifies past the target's table
    (whose chunk writes drop)."""
    got = _hold(models, clock, _submit_run((22, 10), 10, head=2),
                flags=dict(fused_block_decode=fused), max_seq_len=32)
    assert got["spec_rounds"] > 0


def test_streams_equal_the_jax_model(models, clock):
    jmodel = models["target"][0]
    rng = np.random.default_rng(1)
    ps = [tokens(rng, n) for n in (5, 8, 13)]
    _, got = _both(models, clock, _submit_run((5, 8, 13), 10))
    assert got["streams"] == [solo(jmodel, p, 10) for p in ps]


# --------------------------------------------------------- construction
def test_engine_refusals(models):
    target, draft = models["target"][1], models["draft"][1]
    plain = tserving.ServingEngine(target, max_batch=2, page_size=PAGE,
                                   max_seq_len=64)
    with pytest.raises(ValueError, match="speculative engine"):
        plain.submit(np.arange(3, dtype=np.int32), 2, temperature=0.5)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tserving.ServingEngine(target, max_batch=2, page_size=PAGE,
                               max_seq_len=256, draft_model=draft)
    # a tensor-parallel speculative engine is taken (its streams:
    # tests/test_torch_tp_decode.py); its kv heads must divide the degree
    tp = tserving.ServingEngine(target, max_batch=2, page_size=PAGE,
                                max_seq_len=64, draft_model=draft,
                                tp_degree=2)
    assert tp.tp_degree == 2 and tp._draft_pool is not None
    with pytest.raises(ValueError, match="kv-head"):
        tserving.ServingEngine(target, max_batch=2, page_size=PAGE,
                               max_seq_len=64, draft_model=draft,
                               tp_degree=3)
    eng = tserving.ServingEngine(target, max_batch=2, page_size=PAGE,
                                 max_seq_len=64, draft_model=draft)
    pool = eng._draft_pool
    assert pool.num_pages == 1 + 2 * (64 // PAGE) and pool.reserved_null_page
    assert (eng.spec_rungs, eng.spec_gamma_default, eng.spec_slots,
            eng.spec_sync_chunk) == ((2, 4, 8), 4, 3, 64)



# ---------------------------------------------- writes past the span
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_draft_scan_past_the_span_lands_on_the_null_page(models, fused,
                                                         kv_dtype):
    """The draft pool's table has room for a round past the longest span:
    a γ = 8 scan from two tokens before the span's end writes those two
    into the slot's last page and the rest onto the null page, and leaves
    every other page as it was."""
    with both_flags(fused_block_decode=fused):
        eng = tserving.ServingEngine(
            models["target"][1], max_batch=2, page_size=PAGE,
            max_seq_len=32, draft_model=models["draft"][1],
            kv_dtype=kv_dtype)
    pool = eng._draft_pool
    assert pool.max_pages_per_seq == -(-(32 + 8 + 1) // PAGE)
    pool.allocate(0, 32)
    pool.allocate(1, 16)
    pool.seq_lens[0] = 30
    assert (pool.block_tables[0, 32 // PAGE:] == 0).all()
    before = [[p.clone() for p in tpa._parts(t)]
              for t in pool.k_pages + pool.v_pages]
    fn = eng._spec_draft_program(8, False, 0)
    (props, _), pairs = fn(np.array([[3]], np.int64),
                           pool.block_tables[0:1], pool.seq_lens[0:1],
                           pool.take_pools())
    pool.install_pools(pairs)
    assert props.shape == (8,)
    assert ((props >= 0) & (props < models["target"][1].config.vocab_size)
            ).all()
    last = int(pool.block_tables[0, 3])
    changed = set()
    for old, new in zip(before, pool.k_pages + pool.v_pages):
        for a, b in zip(old, tpa._parts(new)):
            pages = (a != b).movedim(1, 0).flatten(1).any(1)
            changed |= set(torch.nonzero(pages).flatten().tolist())
    assert changed == {0, last}


def test_draft_table_is_zero_past_each_span(models):
    """A span's allocation names pages for the span only: the table's
    spare columns stay on the null page through allocation, a move and
    a free."""
    eng = tserving.ServingEngine(
        models["target"][1], max_batch=2, page_size=PAGE, max_seq_len=32,
        draft_model=models["draft"][1])
    pool = eng._draft_pool
    pool.allocate(1, 32)
    assert (pool.block_tables[1, :4] > 0).all()
    assert (pool.block_tables[1, 4:] == 0).all()
    pool.move_sequence(1, 0)
    assert (pool.block_tables[0, 4:] == 0).all()
    pool.free_sequence(0)
    assert (pool.block_tables == 0).all()
