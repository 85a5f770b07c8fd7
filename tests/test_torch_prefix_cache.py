"""The port's prefix cache, its host-memory tier and the chunk program
against the JAX package.

Both packages serve the tiny GQA Llama in fp32 from the same seeded numpy
weights (``load_numpy_state``). Held equal, exactly:

- the page pool's reference counts, free list, block tables and
  ``ledger()`` after each op of one scripted sequence (allocate, shared
  adoption, refs, single-page takes, spill, restore, forget, row moves,
  frees), on native and int8 pools;
- a spilled page, restored into another page, bit for bit (native fp32
  and bf16, int8 payload and scale), written in place (the pool tensors
  keep their addresses), and its host copy equal to the JAX package's;
- ``PrefixCache``'s trie (every node's page, parent, children, tick, pins
  and residence), ``peek``, ``evictable_page_count`` and the pool under
  one register / lookup / pin / evict / spill / restore script, with and
  without a host tier;
- engine token streams with ``prefix_cache=True``, against the JAX
  engine's (token streams and what the scenario observes: seats, chunk
  dispatches, the ledger after drain, cached nodes, preemptions) and
  against solo greedy decoding of each prompt in a cold engine: a short
  suffix (teacher-forced), a long suffix chunked from the adopted cursor,
  an identical prompt resubmitted, chunking off with the coverage rule, a
  cached-prefix request passing a page-blocked head, a cached-prefix head
  that is not blocked, eviction under a small page budget, the host tier
  spilling and restoring (and dropping past its budget), preemption with
  evictable pages, an int8 pool, and a page shortfall at admission that
  backs the request off to the queue head.

Both engines run on one fake host clock (``test_torch_serving_sched.py``'s),
patched into both serving modules. The chunk program is held too: one
build per chunk length under the ``prefill_chunk`` key and none for a
second engine, and a device-tensor rotary offset gives the host-int
path's logits bit for bit.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import contextlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.generation import serving as jserving
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.generation.program_cache import (
    clear_decode_program_cache, decode_program_cache)
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

PAGE = 8
DT = 0.01          # fake seconds a step


@pytest.fixture(scope="module")
def models():
    paddle.seed(93)
    jmodel = JLlamaForCausalLM(JLlamaConfig.tiny())
    params, _ = jmodel.raw_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_numpy_state({k: np.asarray(v) for k, v in params.items()})
    return jmodel, model


class _Clock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    fake = types.SimpleNamespace(perf_counter=c.perf_counter,
                                 sleep=lambda s: None)
    monkeypatch.setattr(jserving, "time", fake)
    monkeypatch.setattr(tserving, "time", fake)
    return c


@contextlib.contextmanager
def both_flags(**kw):
    prev = {k: jflags.get_flag(k) for k in kw}
    jflags.set_flags(kw)
    tflags.set_flags(kw)
    try:
        yield
    finally:
        jflags.set_flags(prev)
        tflags.reset_flags()


def _tokens(rng, n):
    return rng.integers(0, 256, (n,)).astype(np.int32)


def _cat(*parts):
    return np.concatenate([np.asarray(p, np.int32) for p in parts])


# ------------------------------------------------------------ page pool
GEOM = dict(num_layers=2, num_pages=12, page_size=PAGE, num_kv_heads=2,
            head_dim=4, max_batch=4, max_seq_len=48, reserve_null_page=True)


def _pools(kv_dtype="native", geom=GEOM):
    return (jpa.PagedKVCache(dtype=jnp.float32, kv_dtype=kv_dtype, **geom),
            tpa.PagedKVCache(device="cpu", dtype=torch.float32,
                             kv_dtype=kv_dtype, **geom))


def _pool_state(pool):
    return dict(rc=pool._page_rc.tolist(), free=list(pool._free),
                ledger=pool.ledger(), bt=pool.block_tables.tolist(),
                seq_lens=pool.seq_lens.tolist(),
                used=pool._pages_used.tolist())


def _pool_script(pool):
    states = []

    def snap():
        states.append(_pool_state(pool))

    pool.allocate(0, 20)                        # 3 pages
    pool.allocate(1, 9)                         # 2 pages
    snap()
    shared = [int(p) for p in pool.block_tables[0, :2]]
    for pid in shared:                          # a cache holds them
        pool.ref_page(pid)
    snap()
    pool.free_sequence(0)                       # the third page frees
    snap()
    pool.adopt_shared(2, shared)
    pool.seq_lens[2] = 16
    pool.allocate(2, 5)
    snap()
    pid = pool.take_free_page()
    host = pool.spill_page(pid)
    freed = pool.unref_page(pid)
    snap()
    new = pool.take_free_page()
    pool.restore_page(host, new)
    snap()
    pool.move_sequence(2, 3)
    pool.free_sequence(1)
    snap()
    gone = pool.spill_page(new)
    pool.forget_spilled(gone)
    snap()
    pool.free_sequence(3)
    for p in shared:
        pool.unref_page(p)
    pool.unref_page(new)
    snap()
    return freed, states


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_pool_refcounts_and_ledger_match_jax(kv_dtype):
    jpool, tpool = _pools(kv_dtype)
    want, got = _pool_script(jpool), _pool_script(tpool)
    assert got == want
    freed, states = got
    assert freed
    assert [st["ledger"]["pages_shared"] for st in states[:4]] == \
        [0, 2, 0, 2]
    assert states[4]["ledger"]["pages_spilled"] == 1
    # everything back: one clean run of free pages
    last = states[-1]["ledger"]
    assert last["pages_in_use"] == 0 and last["pages_spilled"] == 0
    assert tpool._page_rc[0] == 1 << 30


def test_fragmentation_matches_jax():
    jpool, tpool = _pools()
    for pool in (jpool, tpool):
        for s in range(4):
            pool.allocate(s, 16)
        pool.free_sequence(1)
        pool.free_sequence(3)
    assert tpool.free_list_fragmentation() == \
        jpool.free_list_fragmentation() > 0
    assert tpool.ledger()["epoch"] == jpool.ledger()["epoch"]


def test_adopt_into_a_used_slot_raises():
    _, pool = _pools()
    pool.allocate(0, 3)
    with pytest.raises(RuntimeError, match="not empty"):
        pool.adopt_shared(0, [5])


def _random_parts(rng, shape, dtype):
    if dtype == torch.int8:
        return rng.integers(-127, 128, shape).astype(np.int8)
    return (rng.standard_normal(shape) * 50).astype(np.float32)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_spill_restore_is_bit_exact_and_in_place(kind):
    """Random pages; one spilled, its page freed and scribbled over by a
    new owner, restored into another page: every layer's K and V rows (an
    int8 pool's payload and scale) equal bit for bit, at the same
    addresses; the host copy equals the JAX package's spill of the same
    pool contents."""
    kv = "int8" if kind == "int8" else "native"
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if kind == "bf16"
                else (torch.float32, jnp.float32))
    pool = tpa.PagedKVCache(device="cpu", dtype=tdt, kv_dtype=kv, **GEOM)
    jpool = jpa.PagedKVCache(dtype=jdt, kv_dtype=kv, **GEOM)
    rng = np.random.default_rng(3)
    for name in ("k_pages", "v_pages"):
        for layer in range(GEOM["num_layers"]):
            parts = tpa._parts(getattr(pool, name)[layer])
            vals = [_random_parts(rng, tuple(t.shape), t.dtype)
                    for t in parts]
            for t, v in zip(parts, vals):
                t.copy_(torch.from_numpy(v).to(t.dtype))
            jvals = [jnp.asarray(v).astype(jnp.int8 if v.dtype == np.int8
                                           else (jdt if len(vals) == 1
                                                 else jnp.float32))
                     for v in vals]
            getattr(jpool, name)[layer] = (
                jpa.QuantizedPages(*jvals) if kv == "int8" else jvals[0])

    def page_rows(pid):
        return [t[:, pid].clone() for half in (pool.k_pages, pool.v_pages)
                for layer in half for t in tpa._parts(layer)]

    ptrs = tserving._pool_ptrs(zip(pool.k_pages, pool.v_pages))
    pid = pool.take_free_page()
    assert jpool.take_free_page() == pid
    want = page_rows(pid)
    host, jhost = pool.spill_page(pid), jpool.spill_page(pid)
    assert pool.ledger()["pages_spilled"] == 1
    assert host.nbytes == pool.bytes_per_page == jhost.nbytes
    for th, jh in ((host.k, jhost.k), (host.v, jhost.v)):
        for layer in range(GEOM["num_layers"]):
            jparts = jh[layer] if kv == "int8" else (jh[layer],)
            assert len(th) == len(jparts)
            for j, part in enumerate(jparts):
                np.testing.assert_array_equal(
                    th[j][layer].float().numpy(),
                    np.asarray(part).astype(np.float32))
    assert pool.unref_page(pid)
    assert pool.take_free_page() == pid         # a new owner scribbles
    for half in (pool.k_pages, pool.v_pages):
        for layer in half:
            for t in tpa._parts(layer):
                t[:, pid] = 7
    new = pool.take_free_page()
    pool.restore_page(host, new)
    assert pool.ledger()["pages_spilled"] == 0
    for a, b in zip(page_rows(new), want):
        assert torch.equal(a, b)
    assert tserving._pool_ptrs(zip(pool.k_pages, pool.v_pages)) == ptrs


def test_spill_refuses_detached_pools():
    _, pool = _pools()
    pid = pool.take_free_page()
    pairs = pool.take_pools()
    with pytest.raises(RuntimeError, match="detached"):
        pool.spill_page(pid)
    pool.install_pools(pairs)
    pool.spill_page(pid)


# ---------------------------------------------------------- prefix trie
def _nodes(cache):
    return {key: (n["page"], n["parent"], n["children"], n["tick"],
                  n["pins"], n["host"] is None)
            for key, n in cache._nodes.items()}


def _trie_script(cache, pool):
    rng = np.random.default_rng(17)
    a, b, c = _tokens(rng, 16), _tokens(rng, 8), _tokens(rng, 16)
    pa = _cat(a, [1, 2, 3])                     # 2 full pages
    pab = _cat(a, b, [4])                       # a's 2 pages + 1
    pc = _cat(c, [5])                           # 2 pages, other chain
    out = []

    def snap(tag, *extra):
        out.append((tag, _nodes(cache), cache.peek(pa), cache.peek(pab),
                    cache.peek(pab, include_spilled=True),
                    cache.evictable_page_count(), cache.pinned_page_count(),
                    cache.spilled_page_count(), _pool_state(pool), extra))

    for slot, p in ((0, pa), (1, pc)):
        pool.allocate(slot, len(p))
        cache.register(p, pool.block_tables[slot])
    pool.free_sequence(0)
    snap("registered")
    pages, n = cache.lookup(pab, max_cover=len(pab) - 1)
    pool.adopt_shared(2, pages)
    cache.pin(pages)
    pool.seq_lens[2] = n
    pool.allocate(2, len(pab) - n)
    cache.register(pab, pool.block_tables[2])   # deepens a's chain
    snap("adopted", pages, n)
    snap("evict-while-pinned", cache.evict(3))
    cache.unpin(pages)
    pool.free_sequence(2)
    pool.free_sequence(1)
    snap("released")
    snap("spill", cache.spill(2))
    snap("evict", cache.evict(2))
    pages, n = cache.lookup(pab, max_cover=len(pab) - 1)
    snap("lookup-restores", pages, n)
    snap("evict-all", cache.evict(20))
    return out


@pytest.mark.parametrize("tier", [0, 2, 8], ids=["no-tier", "tier-2",
                                                 "tier-8"])
def test_prefix_trie_matches_jax(tier):
    jpool, tpool = _pools()
    want = _trie_script(jserving.PrefixCache(jpool, host_tier_pages=tier),
                        jpool)
    got = _trie_script(tserving.PrefixCache(tpool, host_tier_pages=tier),
                       tpool)
    assert got == want
    tags = {t[0]: t for t in got}
    assert tags["adopted"][-1][1] == 16                 # 2 pages adopted
    assert len(tags["adopted"][1]) == 5                 # a, a+b, c chains
    if tier:
        assert tags["spill"][-1][0] == 2
        assert tags["spill"][7] == 2                    # in the host tier
        assert tags["lookup-restores"][-1][1] == 24
    else:
        assert tags["spill"][7] == 0


# -------------------------------------------------------------- engines
def _engine(cls, model, clock, **kw):
    clock.now = 1000.0
    eng = cls(model, **dict(dict(page_size=PAGE, prefix_cache=True), **kw))
    inner = eng.step

    def step():
        clock.now += DT
        inner()
    eng.step = step
    return eng


def _both(models, clock, script, flags=None, **kw):
    jmodel, model = models
    with both_flags(**(flags or {})):
        want = script(_engine(jserving.ServingEngine, jmodel, clock, **kw))
        got = script(_engine(tserving.ServingEngine, model, clock, **kw))
    return want, got


def _solo(model, prompt, new, kv_dtype="native"):
    """Greedy decoding of ``prompt`` alone in a cold engine (whole-prompt
    prefill, no prefix cache)."""
    eng = tserving.ServingEngine(model, max_batch=1, page_size=PAGE,
                                 max_seq_len=96, prefill_chunk=0,
                                 kv_dtype=kv_dtype)
    rid = eng.submit(prompt, new)
    return eng.run()[rid]


def _seats(eng):
    return [None if r is None else r.rid for r in eng._slots]


def _drained(eng):
    return dict(ledger=eng.pool.ledger(), nodes=len(eng._prefix._nodes),
                spilled=eng._prefix.spilled_page_count(),
                chunks=eng.chunk_dispatches)


def _sequential(prompts, new):
    """Each prompt submitted after the last one drained."""
    def script(eng):
        streams, cached, pendings = [], [], []
        for p in prompts:
            cached.append(eng._prefix.peek(p))
            rid = eng.submit(p, new)
            eng.step()
            pendings.append([len(r.pending) for r in eng._slots
                             if r is not None])
            streams.append(eng.run()[rid])
        return dict(streams=streams, cached=cached, pendings=pendings,
                    **_drained(eng))
    return script


def _check_solo(model, prompts, streams, new, kv_dtype="native"):
    for p, toks in zip(prompts, streams):
        assert toks == _solo(model, p, new, kv_dtype), len(p)


def test_short_suffix_is_teacher_forced(models, clock):
    rng = np.random.default_rng(7)
    prefix = _tokens(rng, 16)
    ps = [_cat(prefix, _tokens(rng, 3)), _cat(prefix, _tokens(rng, 5))]
    want, got = _both(models, clock, _sequential(ps, 6), max_batch=2,
                      max_seq_len=64)
    assert got == want
    # admitted with 4 pending, one fed by the admission step's decode
    assert got["cached"] == [0, 16] and got["pendings"][1] == [3]
    assert got["chunks"] == 0
    _check_solo(models[1], ps, got["streams"], 6)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_long_suffix_is_chunked_from_the_adopted_cursor(models, clock,
                                                        fused):
    rng = np.random.default_rng(3)
    prefix = _tokens(rng, 16)
    ps = [_cat(prefix, _tokens(rng, 3)), _cat(prefix, _tokens(rng, 30))]
    want, got = _both(models, clock, _sequential(ps, 5),
                      dict(fused_block_decode=fused), max_batch=2,
                      max_seq_len=64, prefill_chunk=8)
    assert got == want
    # the first prompt in 3 chunks, the second's 30-token suffix in 4
    assert got["cached"] == [0, 16] and got["chunks"] == 3 + 4
    _check_solo(models[1], ps, got["streams"], 5)


def test_identical_prompt_resubmission(models, clock):
    """A whole-prompt hit keeps its last page out: the first token is
    computed (the second submission adopts one page, 8 pending)."""
    p = _tokens(np.random.default_rng(8), 16)
    want, got = _both(models, clock, _sequential([p, p], 5), max_batch=2,
                      max_seq_len=64)
    assert got == want
    assert got["cached"] == [0, 16] and got["pendings"][1] == [6]
    _check_solo(models[1], [p, p], got["streams"], 5)


def test_chunking_off_applies_the_coverage_rule(models, clock):
    """With chunking off a one-page hit on a 48-token prompt prefills
    whole (the suffix would replay 40 steps); a covered one is taken."""
    rng = np.random.default_rng(13)
    prefix = _tokens(rng, 8)
    ps = [prefix, _cat(prefix, _tokens(rng, 40)),
          _cat(prefix, _tokens(rng, 3))]
    want, got = _both(models, clock, _sequential(ps, 4), max_batch=2,
                      max_seq_len=64, prefill_chunk=0)
    assert got == want
    assert got["pendings"][1] == [0] and got["pendings"][2] == [1]
    _check_solo(models[1], ps, got["streams"], 4)


def _bypass_script(eng):
    rng = np.random.default_rng(10)
    cached, hog = _tokens(rng, 16), _tokens(rng, 16)
    r0 = eng.submit(cached, 4)
    first = eng.run()[r0]
    holder = eng.submit(_cat(cached, [1]), 12)
    eng.step()                      # pins the 2 cached pages, owns 2 more
    big = eng.submit(hog, 8)        # 3 fresh pages: page-blocked
    rider = eng.submit(_cat(cached, [5]), 4)
    eng.step()
    seats = _seats(eng)
    bypassed = [r.bypassed for r in eng._queue]
    out = eng.run()
    return dict(first=first, seats=seats, bypassed=bypassed,
                streams=[out[r] for r in (holder, big, rider)],
                statuses=[eng.status(r) for r in (holder, big, rider)],
                prompts=[_cat(cached, [1]), hog, _cat(cached, [5])],
                **_drained(eng))


def test_cached_prefix_request_bypasses_a_page_blocked_head(models, clock):
    want, got = _both(models, clock, _bypass_script, max_batch=4,
                      num_pages=7, max_seq_len=32, prefill_chunk=0)
    assert {k: v for k, v in got.items() if k != "prompts"} == \
        {k: v for k, v in want.items() if k != "prompts"}
    assert got["seats"][:3] == [1, 3, None] and got["bypassed"] == [1]
    assert got["statuses"] == ["OK"] * 3
    assert got["streams"][0] == _solo(models[1], got["prompts"][0], 12)
    assert got["streams"][2] == _solo(models[1], got["prompts"][2], 4)
    assert got["streams"][1] == _solo(models[1], got["prompts"][1], 8)


def _cached_head_script(eng):
    rng = np.random.default_rng(16)
    cached = _tokens(rng, 16)
    r0 = eng.submit(cached, 4)
    first = eng.run()[r0]
    holder = eng.submit(_cat(cached, [1]), 12)
    eng.step()
    head = eng.submit(_cat(cached, [9]), 4)
    eng.step()
    seats = _seats(eng)
    out = eng.run()
    return dict(first=first, seats=seats,
                streams=[out[holder], out[head]],
                statuses=[eng.status(holder), eng.status(head)],
                **_drained(eng))


def test_cached_prefix_head_is_not_page_blocked(models, clock):
    rng = np.random.default_rng(16)
    cached = _tokens(rng, 16)
    want, got = _both(models, clock, _cached_head_script, max_batch=2,
                      num_pages=7, max_seq_len=32, prefill_chunk=0)
    assert got == want
    assert got["seats"] == [1, 2] and got["statuses"] == ["OK", "OK"]
    assert got["streams"][1] == _solo(models[1], _cat(cached, [9]), 4)
    assert got["streams"][0] == _solo(models[1], _cat(cached, [1]), 12)


def test_eviction_under_a_small_page_budget(models, clock):
    """Three usable pages: each request needs 3 and caches 2, so every
    admission after the first evicts."""
    rng = np.random.default_rng(10)
    ps = [_tokens(rng, 16) for _ in range(3)]
    want, got = _both(models, clock, _sequential(ps, 4), max_batch=1,
                      num_pages=4, max_seq_len=24)
    assert got == want
    assert got["nodes"] <= 2
    _check_solo(models[1], ps, got["streams"], 4)


def _org_prompts(n, prefix, body, seed):
    """One prompt per organisation: its own prefix, then a body."""
    rng = np.random.default_rng(seed)
    return [_cat(_tokens(rng, prefix), _tokens(rng, body)) for _ in range(n)]


def _count_calls(obj, name):
    """Count calls of ``obj.name`` from now on; returns the one-item
    counter list."""
    n, fn = [0], getattr(obj, name)

    def counted(*a, **k):
        n[0] += 1
        return fn(*a, **k)
    setattr(obj, name, counted)
    return n


@pytest.mark.parametrize("case", ["spill-restore", "budget"])
def test_host_tier_spills_and_restores(models, clock, case):
    """Round 1 spills cold prefixes to host memory, round 2 restores them
    on adoption (or, past a 2-page budget, finds them dropped); streams
    equal an untiered engine's and solo greedy."""
    if case == "spill-restore":
        ps, kw = _org_prompts(4, 24, 8, 21), dict(num_pages=12,
                                                   host_tier_pages=64)
    else:
        ps, kw = _org_prompts(6, 8, 8, 22), dict(num_pages=9,
                                                  host_tier_pages=2)
    rounds = ps * 2

    def script(eng):
        out, tier = [], []
        restores = _count_calls(eng.pool, "restore_page")
        for p in rounds:
            rid = eng.submit(p.copy(), 4)
            out.append(eng.run()[rid])
            tier.append((eng._prefix.spilled_page_count(),
                         eng.pool.ledger()["pages_spilled"]))
        return dict(streams=out, tier=tier, restores=restores[0],
                    **_drained(eng))

    want, got = _both(models, clock, script, max_batch=1, max_seq_len=64,
                      **kw)
    assert got == want
    counts = [s for s, _ in got["tier"]]
    assert all(s == p for s, p in got["tier"])
    if case == "spill-restore":
        assert max(counts) >= 1 and got["restores"] >= 1
    else:
        assert max(counts) <= 2 and max(counts) >= 1
    _, plain = _both(models, clock, script, max_batch=1, max_seq_len=64,
                     num_pages=64)
    assert plain["streams"] == got["streams"]
    _check_solo(models[1], ps, got["streams"][:len(ps)], 4)


def _preempt_script(eng):
    """A cached prefix (2 pages) and a seated request leave 2 free pages:
    a tight arrival needing 3 fits free + evictable with a slot open, so
    nothing is preempted and admission evicts; then a tight arrival into
    a full batch preempts the slackest request, whose pins drop."""
    rng = np.random.default_rng(31)
    prefix = _tokens(rng, 16)
    seed_p, long_p = _cat(prefix, [3]), _tokens(rng, 20)
    r0 = eng.submit(seed_p, 6)
    out0 = eng.run()[r0]
    ps = [long_p, _tokens(rng, 12), _cat(prefix, [4])]
    r1 = eng.submit(ps[0], 12)
    eng.step()
    r2 = eng.submit(ps[1], 8, deadline=0.5)
    eng.step()
    seats = [_seats(eng)]
    pre = eng.preemptions
    out = eng.run()
    statuses = eng.statuses()
    ps += [_tokens(rng, 9), _tokens(rng, 5)]
    r3 = eng.submit(ps[2], 12)
    r4 = eng.submit(ps[3], 10)
    eng.step()
    eng.step()
    r5 = eng.submit(ps[4], 4, deadline=0.5)
    while eng.has_work():
        eng.step()
        seats.append(_seats(eng))
    out.update(eng.run())
    statuses.update(eng.statuses())
    rids = (r1, r2, r3, r4, r5)
    return dict(first=out0, streams=[out[r] for r in rids], seats=seats,
                preempted_first=pre, preemptions=eng.preemptions,
                statuses=[statuses[r] for r in rids],
                prompts=[p.tolist() for p in ps], **_drained(eng))


def test_preemption_counts_evictable_pages(models, clock):
    want, got = _both(models, clock, _preempt_script, max_batch=2,
                      num_pages=9, max_seq_len=40, prefill_chunk=0)
    assert got == want
    assert got["preempted_first"] == 0 and got["preemptions"] >= 1
    assert got["statuses"] == ["OK"] * 5
    assert got["ledger"]["pages_in_use"] == got["nodes"]
    # the victim replayed, the evictions and adoptions left every stream
    # as the request's alone
    news = (12, 8, 12, 10, 4)
    for p, new, toks in zip(got["prompts"], news, got["streams"]):
        assert toks == _solo(models[1], np.asarray(p, np.int32), new)


@pytest.mark.parametrize("chunk", [0, 8], ids=["teacher-forced",
                                               "chunked"])
def test_int8_pool(models, clock, chunk):
    rng = np.random.default_rng(41)
    prefix = _tokens(rng, 16)
    ps = [_cat(prefix, _tokens(rng, 3)), _cat(prefix, _tokens(rng, 21)),
          _cat(prefix, _tokens(rng, 5))]
    want, got = _both(models, clock, _sequential(ps, 5), max_batch=2,
                      max_seq_len=64, prefill_chunk=chunk, kv_dtype="int8")
    assert got == want
    assert got["cached"][1:] == [16, 16]
    _check_solo(models[1], ps, got["streams"], 5, kv_dtype="int8")


def _backoff_script(eng):
    """A shared admission whose suffix allocation comes up short once (the
    pool raises as if pinned pages had been priced as evictable): the
    request backs off to the queue head with its pins and pages returned,
    and admits on the next step."""
    rng = np.random.default_rng(23)
    prefix = _tokens(rng, 16)
    r0 = eng.submit(_cat(prefix, [1]), 3)
    first = eng.run()[r0]
    allocate, calls = eng.pool.allocate, [0]

    def short_once(slot, n):
        calls[0] += 1
        if calls[0] == 1:
            raise RuntimeError("page pool exhausted")
        return allocate(slot, n)
    eng.pool.allocate = short_once
    rid = eng.submit(_cat(prefix, [2, 3, 4]), 5)
    eng.step()
    after = dict(seats=_seats(eng), queued=[r.rid for r in eng._queue],
                 pins=eng._prefix.pinned_page_count(),
                 pinned=[r.pinned for r in eng._queue],
                 ledger=eng.pool.ledger())
    out = eng.run()
    return dict(first=first, after=after, stream=out[rid],
                status=eng.status(rid), **_drained(eng))


def test_page_shortfall_backs_off_to_the_queue(models, clock):
    want, got = _both(models, clock, _backoff_script, max_batch=2,
                      max_seq_len=64)
    assert got == want
    assert got["after"]["seats"] == [None, None]
    assert got["after"]["queued"] == [1] and got["after"]["pins"] == 0
    assert got["after"]["pinned"] == [[]] and got["status"] == "OK"
    rng = np.random.default_rng(23)
    prefix = _tokens(rng, 16)
    assert got["stream"] == _solo(models[1], _cat(prefix, [2, 3, 4]), 5)


def test_export_unpins_adopted_pages(models, clock):
    _, model = models
    rng = np.random.default_rng(2)
    prefix = _tokens(rng, 16)
    eng = _engine(tserving.ServingEngine, model, clock, max_batch=2,
                  max_seq_len=64)
    eng.submit(prefix, 2)
    eng.run()
    eng.submit(_cat(prefix, [1, 2]), 6)
    eng.step()
    assert eng._prefix.pinned_page_count() == 2
    (req,) = eng.export_requests()
    assert req.pinned == [] and req.pending == [] and req.slot is None
    assert eng._prefix.pinned_page_count() == 0
    assert eng.pool.ledger()["pages_in_use"] == 2       # the cache's


def test_host_tier_flag_default_and_engine_option(models):
    assert tflags.get_flag("serving_kv_host_tier_pages") == \
        jflags.get_flag("serving_kv_host_tier_pages") == 0
    _, model = models
    eng = tserving.ServingEngine(model, max_batch=2, page_size=PAGE,
                                 max_seq_len=32, prefix_cache=True,
                                 host_tier_pages=5)
    assert eng._prefix.host_tier_pages == eng.host_tier_pages == 5
    tflags.set_flags({"serving_kv_host_tier_pages": 3})
    try:
        eng = tserving.ServingEngine(model, max_batch=2, page_size=PAGE,
                                     max_seq_len=32, prefix_cache=True)
    finally:
        tflags.reset_flags()
    assert eng._prefix.host_tier_pages == 3


# -------------------------------------------------------- chunk program
def test_chunk_program_one_build_per_length(models, clock):
    """The chunk program is the ``prefill_chunk`` key's (bucket 1, the
    chunk length in ``extra``), built once; a second engine adds no build,
    another chunk length builds its own."""
    _, model = models
    clear_decode_program_cache()
    cache = decode_program_cache()
    p = _tokens(np.random.default_rng(1), 30)
    keys = []
    for chunk in (8, 8, 16):
        eng = _engine(tserving.ServingEngine, model, clock, max_batch=2,
                      max_seq_len=48, prefill_chunk=chunk,
                      prefix_cache=False)
        eng.submit(p, 3)
        eng.run()
        key = eng.chunk_key
        assert key.kind == "prefill_chunk" and key.batch_bucket == 1
        assert key.extra[0] == chunk
        assert eng.chunk_dispatches == -(-30 // chunk)
        keys.append(key)
    assert keys[0] == keys[1] != keys[2]
    assert cache.trace_count(keys[0]) == cache.trace_count(keys[2]) == 1


@pytest.mark.parametrize("pos", [0, 5, 16])
def test_device_offset_equals_the_host_int(models, pos):
    """The chunk forward with its cursor as a device tensor gives the
    host-int path's logits and pools bit for bit."""
    _, model = models
    hkv, d = model.cache_spec()[0]
    layers = model.config.num_hidden_layers
    shape = (hkv, 9, PAGE, d)
    bt = torch.tensor([[5, 2, 7, 3]], dtype=torch.int32)
    ids = torch.from_numpy(_tokens(np.random.default_rng(pos), 8)
                           .astype(np.int64))[None]
    sl = torch.tensor([pos], dtype=torch.int32)
    outs = []
    for offset in (pos, sl):
        pools = [(torch.zeros(shape), torch.zeros(shape))
                 for _ in range(layers)]
        with torch.no_grad():
            hidden, states = model.llama(
                ids, caches=[tpa.PagedChunkState(k, v, bt, sl)
                             for k, v in pools], offset=offset)
        outs.append((model.logits(hidden), pools))
    (a, pa_), (b, pb_) = outs
    assert torch.equal(a, b)
    for (ka, va), (kb, vb) in zip(pa_, pb_):
        assert torch.equal(ka, kb) and torch.equal(va, vb)


@pytest.mark.parametrize("offset", [torch.tensor([3]), torch.tensor(3),
                                    torch.tensor([3, 6])],
                         ids=["one", "scalar", "per-row"])
def test_paged_position_ids_take_a_device_offset(offset):
    b = offset.numel()
    state = tpa.PagedDecodeState(None, None,
                                 torch.zeros((b, 2), dtype=torch.int32),
                                 torch.zeros((b,), dtype=torch.int32))
    got = tpa.paged_position_ids(4, offset, state)
    want = (torch.arange(4)[None] + offset.reshape(-1, 1))
    assert torch.equal(got, want) and got.dtype == torch.int64
    assert torch.equal(tpa.paged_position_ids(4, 3, state)[0],
                       torch.arange(3, 7))
