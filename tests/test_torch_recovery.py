"""Replay recovery of the port's ServingEngine against the JAX engine's.

Both engines serve the tiny GQA Llama of ``torch_serving_twins`` under the
same ``FLAGS_fault_inject`` spec (``FLAGS_serving_retry_backoff`` 0.001,
and a fake host clock whose ``sleep`` returns at once), and each case holds
what the two observed equal: statuses, token streams, the
``serving_retries_total`` / ``serving_recoveries`` /
``serving_requests_failed`` counters and ``faults_injected`` fires, and
every armed site's check and fire counts (the fire points). Streams are
also held to the JAX model's solo greedy decode. The cases are the JAX
package's recovery tests (a failed decode dispatch, retry exhaustion,
decode faults on the generic and the fused route, chunk faults, persistent
chunk faults that end FAILED, migration faults, a raising callback that is
not recovered, a program-build fault), plus ``kv_spill`` faults with a host
tier, a ``preempt`` fault, the engine-wide no-progress budget when nothing
is in flight, and, in the port only: a ``KernelError`` or a CUDA error is
not replayed, recovery resets the pools in place (the same tensors, so CUDA
graphs captured over them stay valid) without a new program trace, and
``PagedKVCache.reset`` equals a fresh cache. The engine pair is
``torch_recovery_twins``'; the card's drill at its geometry is
``test_torch_recovery_drill.py``.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from paddle_tpu.generation import serving as jserving
from paddle_tpu.generation.program_cache import \
    clear_decode_program_cache as jclear_cache
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.generation.program_cache import (
    clear_decode_program_cache, decode_program_cache)
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels._build import KernelError
from paddle_tpu_torch.testing import faults as tfaults
from torch_recovery_twins import (  # noqa: F401  (fixtures)
    _both, _check, _submit_run, clock, models)
from torch_serving_twins import clocked, solo, tokens

# ------------------------------------------- the JAX package's recovery cases
def test_transient_dispatch_failure_recovers_with_parity(models, clock):
    """A decode dispatch that raises once after the pools were detached:
    recovery re-queues the request for a re-prefill of prompt + tokens and
    the stream equals the uninterrupted one."""
    prompt = tokens(np.random.default_rng(9), 5)

    def script(eng):
        rid = eng.submit(prompt, 6)
        eng.step()
        eng.step()                              # prefill, one decode
        real = eng._decode_fns[eng.bucket]
        boomed = []

        def boom_once(*a, **k):
            if not boomed:
                boomed.append(1)
                raise RuntimeError("simulated post-dispatch failure")
            return real(*a, **k)

        eng._decode_fns[eng.bucket] = boom_once
        out = eng.run()
        return dict(streams=[out[rid]], statuses=[eng.status(rid)],
                    boomed=boomed,
                    attached=all(k is not None for k in eng.pool.k_pages))

    want, got = _both(models, clock, script, max_batch=2, page_size=8,
                      max_seq_len=32)
    _check(models, want, got, [prompt], 6)
    assert got["boomed"] == [1] and got["attached"]
    assert got["counters"] == {"serving_retries_total": 1,
                               "serving_recoveries": 1,
                               "serving_requests_failed": 0}


def test_retry_exhaustion_fails_requests_without_killing_run(models, clock):
    """A prefill that always fails makes no progress: the request ends
    FAILED with no tokens after max_retries replays, run returns, and the
    disarmed engine then serves a request OK."""
    prompt = tokens(np.random.default_rng(9), 5)

    def script(eng):
        rid = eng.submit(prompt, 4)
        out = eng.run()
        failed = (eng.status(rid), out[rid])
        eng._f_prefill = tfaults.NULL_SITE      # disarm (both: no-op stub)
        rid2 = eng.submit(prompt, 4)
        out2 = eng.run()
        return dict(failed=failed, streams=[out2[rid2]],
                    statuses=[eng.status(rid2)], drained=not eng.has_work(),
                    free=eng.pool.free_page_count())

    want, got = _both(models, clock, script, spec="prefill:every=1",
                      max_batch=2, page_size=8, max_seq_len=32)
    _check(models, want, got, [prompt], 4)
    assert got["failed"] == ("FAILED", [])
    assert got["counters"] == {"serving_retries_total": 3,
                               "serving_recoveries": 4,
                               "serving_requests_failed": 1}
    assert got["fires"] == {"prefill": 4}


@pytest.mark.parametrize("fused,spec,lens", [
    (False, "decode_dispatch:every=3", (5, 9, 7)),
    (True, "decode_dispatch:every=3;prefill:p=0.2:seed=11", (4, 11)),
], ids=["generic", "fused"])
def test_injected_decode_faults_replay_parity(models, clock, fused, spec,
                                              lens):
    rng = np.random.default_rng(21 + fused)
    prompts = [tokens(rng, n) for n in lens]
    want, got = _both(models, clock, _submit_run(prompts, 5), spec=spec,
                      flags=dict(fused_block_decode=fused), max_batch=2,
                      page_size=8, max_seq_len=32)
    _check(models, want, got, prompts, 5)
    assert got["fires"]["decode_dispatch"] >= 1
    assert got["counters"]["serving_recoveries"] == sum(
        got["fires"].values())


def test_chunk_replay_parity_under_faults(models, clock):
    """A chunk dispatch dies after the pools were detached, mid-prefill;
    the replay re-prefills from host state."""
    rng = np.random.default_rng(4)
    prompts = [tokens(rng, n) for n in (33, 10, 28)]
    want, got = _both(models, clock, _submit_run(prompts, 5, max_wall=120),
                      spec="chunk_prefill:every=3:times=2", max_batch=2,
                      page_size=8, max_seq_len=64, prefill_chunk=8)
    _check(models, want, got, prompts, 5)
    assert got["fires"] == {"chunk_prefill": 2}


def test_persistent_chunk_faults_terminate_failed_not_spin(models, clock):
    """Faults at oscillating chunk cursors never complete a prefill: the
    high-water progress mark spends the budget and the request ends FAILED
    (not TIMEOUT); the engine is drained and a clean one serves."""
    prompt = tokens(np.random.default_rng(14), 40)

    def script(eng):
        rid = eng.submit(prompt, 4)
        out = eng.run(max_wall=60.0)
        return dict(status=eng.status(rid), tokens=out[rid],
                    drained=not eng.has_work(),
                    attached=all(k is not None for k in eng.pool.k_pages))

    want, got = _both(models, clock, script,
                      spec="chunk_prefill:p=0.9:seed=3", max_batch=2,
                      page_size=8, max_seq_len=64, prefill_chunk=8)
    assert got == want
    assert (got["status"], got["tokens"]) == ("FAILED", [])
    assert got["drained"] and got["attached"]
    assert got["counters"]["serving_requests_failed"] == 1
    _, model = models
    clean = tserving.ServingEngine(model, max_batch=2, page_size=8,
                                   max_seq_len=64, prefill_chunk=8)
    rid = clean.submit(prompt, 4)
    assert clean.run()[rid] == solo(models[0], prompt, 4)


def test_migration_replay_parity_under_faults(models, clock):
    """Faults at a migration's begin, between compaction moves and at its
    commit recover by replay."""
    rng = np.random.default_rng(7)
    prompts = [tokens(rng, int(n)) for n in rng.integers(4, 14, size=5)]
    want, got = _both(models, clock, _submit_run(prompts, 5, max_wall=120),
                      spec="bucket_migrate:every=2:times=3",
                      flags=dict(serving_bucket_patience=1), max_batch=4,
                      page_size=8, max_seq_len=48, bucket_ladder=(2, 4),
                      prefill_chunk=0)
    _check(models, want, got, prompts, 5)
    assert got["fires"]["bucket_migrate"] >= 1


def test_raising_callback_surfaces_not_recovered(models, clock):
    prompt = np.arange(5, dtype=np.int32)

    def boom(rid, tok, done):
        raise ValueError("user callback bug")

    def script(eng):
        eng.submit(prompt, 4, on_token=boom)
        with pytest.raises(ValueError, match="user callback bug"):
            eng.run()
        return dict(consec=eng._consec_failures)

    want, got = _both(models, clock, script, max_batch=1, page_size=8,
                      max_seq_len=32, prefill_chunk=0)
    assert got == want and got["consec"] == 0
    assert got["counters"]["serving_recoveries"] == 0


def test_program_build_fault_recovers_and_serves(models, clock):
    """An injected program-cache build failure is absorbed by recovery:
    the next attempt builds and the output equals the solo decode. (The
    JAX engine's first build is its prefill program, the port's its first
    decode program: the port's prefill is eager.)"""
    prompt = tokens(np.random.default_rng(5), 6)

    def script(eng):
        rid = eng.submit(prompt, 4)
        out = eng.run()
        return dict(streams=[out[rid]], statuses=[eng.status(rid)])

    jmodel, model = models
    seen = []
    for cls, mdl, faults, clear in (
            (jserving.ServingEngine, jmodel, jfaults, jclear_cache),
            (tserving.ServingEngine, model, tfaults,
             clear_decode_program_cache)):
        with faults.armed("program_build:every=1:times=1",
                          serving_retry_backoff=0.001):
            clear()                             # rebind the armed site
            try:
                eng = clocked(cls, mdl, clock, max_batch=1, page_size=8,
                              max_seq_len=32)
                seen.append(script(eng))
            finally:
                clear()
    want, got = seen
    _check(models, want, got, [prompt], 4)


# ---------------------------------------------------------- sites beyond
def test_kv_spill_faults_with_a_host_tier(models, clock):
    """Spill and restore faults (checked before anything changes) recover
    by replay: every request OK, streams equal a fault-free engine's."""
    rng = np.random.default_rng(24)
    orgs = [np.concatenate([tokens(rng, 24), tokens(rng, 8)])
            for _ in range(4)]
    rounds = orgs * 2

    def script(eng):
        out, statuses = [], []
        for p in rounds:
            rid = eng.submit(p.copy(), 4)
            out.append(eng.run(max_wall=60.0)[rid])
            statuses.append(eng.status(rid))
        return dict(streams=out, statuses=statuses,
                    spilled=eng.pool.ledger()["pages_spilled"])

    kw = dict(max_batch=1, page_size=8, max_seq_len=64, prefix_cache=True,
              num_pages=12, host_tier_pages=64)
    want, got = _both(models, clock, script, spec="kv_spill:every=3:times=2",
                      **kw)
    _check(models, want, got, rounds, 4)
    assert got["fires"] == {"kv_spill": 2}
    _, clean = _both(models, clock, script, **kw)
    assert clean["streams"] == got["streams"] and not clean["fires"]


def test_preempt_fault_replays_everything(models, clock):
    """A preemption fault (before the victim is unseated) replays every
    request in flight; each ends OK with its solo stream."""
    rng = np.random.default_rng(31)
    prompts = [tokens(rng, n) for n in (6, 9, 7)]

    def script(eng):
        rids = [eng.submit(p, 8) for p in prompts[:2]]
        eng.step()
        eng.step()
        rids.append(eng.submit(prompts[2], 3, deadline=0.5))
        out = eng.run(max_wall=60.0)
        return dict(streams=[out[r] for r in rids],
                    statuses=[eng.status(r) for r in rids],
                    preemptions=eng.preemptions)

    want, got = _both(models, clock, script, spec="preempt:every=1:times=1",
                      max_batch=2, page_size=8, max_seq_len=48,
                      bucket_ladder=(2,), prefill_chunk=0)
    assert got == want
    jmodel, _ = models
    assert got["streams"] == [solo(jmodel, p, n)
                              for p, n in zip(prompts, (8, 8, 3))]
    assert got["statuses"] == ["OK"] * 3
    assert got["fires"] == {"preempt": 1}
    assert got["counters"]["serving_recoveries"] == 1
    assert got["counters"]["serving_retries_total"] == 2


def test_nothing_in_flight_spends_the_engine_budget(models, clock):
    """A migration that always fails before any admission loses no
    request: each step backs off, and after max_retries such steps the
    failure raises instead of spinning."""
    prompts = [tokens(np.random.default_rng(3), 5) for _ in range(3)]

    def script(eng):
        for p in prompts:
            eng.submit(p, 2)
        steps = 0
        with pytest.raises(RuntimeError, match="injected fault"):
            while True:
                steps += 1
                eng.step()
        return dict(steps=steps, queued=len(eng._queue),
                    consec=eng._consec_failures)

    want, got = _both(models, clock, script, spec="bucket_migrate:every=1",
                      max_batch=4, page_size=8, max_seq_len=32,
                      bucket_ladder=(2, 4), prefill_chunk=0)
    assert got == want
    assert got["steps"] == 4 and got["queued"] == 3 and got["consec"] == 3
    assert got["counters"]["serving_recoveries"] == 3


# ------------------------------------------------------------- port only
@pytest.mark.parametrize("error", [
    KernelError("injected KernelError"),
    torch.AcceleratorError("injected AcceleratorError"),
], ids=["KernelError", "AcceleratorError"])
def test_kernel_and_cuda_errors_are_not_replayed(models, error):
    _, model = models
    eng = tserving.ServingEngine(model, max_batch=2, page_size=8,
                                 max_seq_len=32)
    prompt = tokens(np.random.default_rng(9), 5)
    rid = eng.submit(prompt, 6)
    eng.step()
    eng.step()

    def broken(*a, **k):
        raise error

    eng._decode_fns[eng.bucket] = broken
    with pytest.raises(type(error),
                       match=f"injected {type(error).__name__}"):
        eng.step()
    assert eng._consec_failures == 0 and eng.status(rid) == "PENDING"


def test_recovery_resets_the_pools_in_place(models, clock):
    """Recovery keeps the pool tensors (a CUDA graph names their
    addresses), traces no program again, and leaves a ledger that balances
    after the drain; the streams equal a fault-free run's."""
    _, model = models
    rng = np.random.default_rng(8)
    prompts = [tokens(rng, n) for n in (20, 6, 13)]

    def run(spec):
        with tfaults.armed(spec, serving_retry_backoff=0.001):
            eng = clocked(tserving.ServingEngine, model, clock, max_batch=2,
                          page_size=8, max_seq_len=48, prefill_chunk=8,
                          prefix_cache=True)
        ptrs = tserving._pool_ptrs(zip(eng.pool.k_pages, eng.pool.v_pages))
        rids = [eng.submit(p, 5) for p in prompts]
        out = eng.run()
        assert tserving._pool_ptrs(
            zip(eng.pool.k_pages, eng.pool.v_pages)) == ptrs
        led = eng.pool.ledger()
        assert led["pages_in_use"] == len(eng._prefix._nodes)
        assert led["pages_shared"] == 0 == eng._prefix.pinned_page_count()
        return eng, [out[r] for r in rids]

    clear_decode_program_cache()
    cache = decode_program_cache()
    _, clean = run("")
    traces = dict(cache.stats()["traces"])
    eng, chaos = run("decode_dispatch:every=4:times=3;"
                     "chunk_prefill:every=3:times=2")
    assert chaos == clean
    assert eng._f_decode.fires >= 1 and eng._f_chunk.fires == 2
    assert cache.stats()["traces"] == traces


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_pool_reset_equals_a_fresh_cache(kv_dtype):
    geom = dict(num_layers=2, num_pages=10, page_size=8, num_kv_heads=2,
                head_dim=4, max_batch=2, max_seq_len=32,
                reserve_null_page=True, dtype=torch.float32,
                kv_dtype=kv_dtype, device="cpu")
    pool, fresh = tpa.PagedKVCache(**geom), tpa.PagedKVCache(**geom)
    parts = [t for pair in zip(pool.k_pages, pool.v_pages) for p in pair
             for t in tpa._parts(p)]
    for t in parts:
        t.fill_(3)
    pool.allocate(0, 20)
    pool.ref_page(int(pool.block_tables[0, 0]))
    pool.seq_lens[0] = 20
    host = pool.spill_page(int(pool.block_tables[0, 1]))
    assert host is not None and pool.ledger()["pages_spilled"] == 1
    pool.take_pools()                  # a step raised with them detached
    pool.reset()
    assert all(k is not None for k in pool.k_pages)
    assert [t for pair in zip(pool.k_pages, pool.v_pages) for p in pair
            for t in tpa._parts(p)] == parts           # the same tensors
    assert all(not t.any() for t in parts)
    want, got = fresh.ledger(), pool.ledger()
    assert got.pop("epoch") > want.pop("epoch")
    assert got == want
    assert pool._free == fresh._free
    for name in ("block_tables", "seq_lens", "_pages_used", "_page_rc"):
        np.testing.assert_array_equal(getattr(pool, name),
                                      getattr(fresh, name))
