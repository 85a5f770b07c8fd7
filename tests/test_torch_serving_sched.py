"""The port's ServingEngine scheduler and request surface against the JAX
package's.

Both engines serve the tiny GQA Llama of ``test_torch_serving.py`` (JAX
weights carried into the port). Their host clock is a fake one, shared by
both and patched into both serving modules: it stands still inside a step
and advances a fixed ``DT`` before every ``step()``, so deadlines, slack
order and ``run(max_wall=)`` play out the same in both engines. Each case
drives both engines through the same script and holds what the script
observed (token streams, statuses, bucket rungs, seats, streaming events)
equal. The decode program cache's build counts, the page pool's row move,
the page budget and the new flags' defaults are held here too.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import contextlib
import types

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.generation import serving as jserving
from paddle_tpu.kernels.paged_attention import PagedKVCache as JPagedKVCache
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.generation.program_cache import (
    clear_decode_program_cache, decode_program_cache)
from paddle_tpu_torch.kernels.paged_attention import PagedKVCache
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

ENGINE = dict(page_size=8, max_seq_len=48, prefill_chunk=0)
PROMPT_LENS = (5, 9, 13, 7, 6, 11)
NEW = 6
DT = 0.01          # fake seconds a step


@pytest.fixture(scope="module")
def models():
    paddle.seed(91)
    jmodel = JLlamaForCausalLM(JLlamaConfig.tiny())
    params, _ = jmodel.raw_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_numpy_state({k: np.asarray(v) for k, v in params.items()})
    return jmodel, model


def _prompts(lens=PROMPT_LENS):
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


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
    """Set flags in both packages; restore them after."""
    prev = {k: jflags.get_flag(k) for k in kw}
    jflags.set_flags(kw)
    tflags.set_flags(kw)
    try:
        yield
    finally:
        jflags.set_flags(prev)
        tflags.reset_flags()


def _engine(cls, model, clock, **kw):
    """An engine whose every step first advances the clock by DT (the
    clock restarts at 1000 s for each engine)."""
    clock.now = 1000.0
    eng = cls(model, **dict(ENGINE, **kw))
    inner = eng.step

    def step():
        clock.now += DT
        inner()
    eng.step = step
    return eng


def _both(models, clock, script, flags=None, **kw):
    """``script(engine)`` on the JAX engine and on the port's engine, built
    alike under ``flags``; returns (JAX's observation, the port's)."""
    jmodel, model = models
    with both_flags(**(flags or {})):
        want = script(_engine(jserving.ServingEngine, jmodel, clock, **kw))
        got = script(_engine(tserving.ServingEngine, model, clock, **kw))
    return want, got


def _seats(eng):
    return [None if r is None else r.rid for r in eng._slots]


# ------------------------------------------------------- the bucket ladder
def _ladder_script(eng):
    ps = _prompts()
    buckets = [eng.bucket]
    rids = [eng.submit(ps[0], NEW), eng.submit(ps[1], NEW)]
    for _ in range(2):
        eng.step()
        buckets.append(eng.bucket)
    rids += [eng.submit(p, NEW) for p in ps[2:]]
    while eng.has_work():
        eng.step()
        buckets.append(eng.bucket)
    out = eng.run()
    return dict(streams=[out[r] for r in rids], buckets=buckets,
                migrations=eng.bucket_migrations,
                statuses=sorted(set(eng.statuses().values())))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_ladder_migrations_match_jax(models, clock, fused):
    clear_decode_program_cache()
    flags = dict(fused_block_decode=fused, serving_bucket_patience=2)
    want, got = _both(models, clock, _ladder_script, flags, max_batch=4,
                      bucket_ladder=(2, 4))
    assert got == want
    assert got["migrations"] >= 2                   # grew and shrank
    assert set(got["buckets"]) == {2, 4} and got["statuses"] == ["OK"]
    # a fixed-bucket run gives the same streams
    _, fixed = _both(models, clock, _ladder_script, flags, max_batch=4,
                     bucket_ladder=(4,))
    assert fixed["streams"] == got["streams"] and fixed["migrations"] == 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_one_build_per_rung_and_none_for_a_second_engine(models, clock,
                                                         fused):
    """Each rung's program is built once (the CPU's trace) and cached: the
    steps that follow and a second engine over the same model add none."""
    _, model = models
    clear_decode_program_cache()
    cache = decode_program_cache()
    with both_flags(fused_block_decode=fused, serving_bucket_patience=2):
        eng = _engine(tserving.ServingEngine, model, clock, max_batch=4,
                      bucket_ladder=(2, 4))
        _ladder_script(eng)
        keys = set(eng._decode_keys.values())
        assert [k.batch_bucket for k in keys] and \
            {k.batch_bucket for k in keys} == {2, 4}
        assert {k.kind for k in keys} == {
            "decode_fused" if fused else "decode_generic"}
        assert all(cache.trace_count(k) == 1 for k in keys)
        assert len(eng.decode_step_seconds) > 2
        before = cache.stats()["traces"]
        again = _engine(tserving.ServingEngine, model, clock, max_batch=4,
                        bucket_ladder=(2, 4))
        _ladder_script(again)
        assert set(again._decode_keys.values()) == keys
        assert cache.stats()["traces"] == before
    assert cache.stats()["misses"] == 2


def test_shrink_compacts_block_tables(models, clock):
    """After a shrink every live request sits below the rung, on the same
    pages it had."""
    _, model = models
    with both_flags(serving_bucket_patience=1):
        eng = _engine(tserving.ServingEngine, model, clock, max_batch=4,
                      bucket_ladder=(2, 4))
        ps = _prompts()
        rids = [eng.submit(p, 2 + 8 * (i % 2)) for i, p in
                enumerate(ps[:4])]
        grown = False
        for _ in range(100):
            pages = {r.rid: eng.pool.block_tables[r.slot].copy()
                     for r in eng._slots if r is not None}
            eng.step()
            grown |= eng.bucket == 4
            if grown and eng.bucket == 2:
                break
        assert grown and eng.bucket == 2 and eng.bucket_migrations == 2
        live = [r for r in eng._slots if r is not None]
        assert all(r.slot < 2 for r in live)
        moved = [r for r in live if r.rid in pages]
        assert moved
        for r in moved:
            np.testing.assert_array_equal(eng.pool.block_tables[r.slot],
                                          pages[r.rid])
        out = eng.run()
    assert sorted(out) == sorted(rids)


# --------------------------------------------------------- admission order
def _slack_script(eng):
    ps = _prompts()
    ra = eng.submit(ps[0], 3)
    rb = eng.submit(ps[1], 3, deadline=10.0)        # the tightest slack
    rc = eng.submit(ps[2], 3)
    rd = eng.submit(ps[3], 3, deadline=5.0)
    seats = []
    while eng.has_work():
        eng.step()
        seats.append(_seats(eng))
    out = eng.run()
    return dict(seats=seats, streams=[out[r] for r in (ra, rb, rc, rd)],
                statuses=eng.statuses())


def test_admission_order_by_deadline_slack(models, clock):
    want, got = _both(models, clock, _slack_script, max_batch=1)
    assert got == want
    # the deadline requests first (tightest first), then FIFO
    firsts = []
    for seat in got["seats"]:
        if seat[0] is not None and seat[0] not in firsts:
            firsts.append(seat[0])
    assert firsts == [3, 1, 0, 2]


# ----------------------------------------------------------------- timeouts
def _timeout_script(eng):
    ps = _prompts()
    ra = eng.submit(ps[0], 4, deadline=0)
    rb = eng.submit(ps[1], 4)
    eng.step()
    polled = eng.poll(ra)
    out = eng.run()
    first = dict(out=out, statuses=eng.statuses(), polled=polled)
    rids = [eng.submit(p, 4) for p in ps[2:5]]
    out = eng.run(max_wall=0)
    return dict(first=first, rb=rb, out=[out[r] for r in rids],
                statuses=[eng.status(r) for r in rids],
                has_work=eng.has_work())


def test_timeouts_match_jax(models, clock):
    want, got = _both(models, clock, _timeout_script, max_batch=2)
    assert got == want
    first = got["first"]
    assert first["out"][0] == [] and first["statuses"][0] == "TIMEOUT"
    assert first["statuses"][got["rb"]] == "OK"
    assert first["polled"] == {"status": "TIMEOUT", "tokens": [],
                               "done": True}
    assert got["statuses"] == ["TIMEOUT"] * 3 and not got["has_work"]


# ---------------------------------------------------------------- streaming
def _stream_script(eng):
    events = []
    ps = _prompts()

    def cb(rid, tok, done):
        events.append((rid, tok, done))

    rids = [eng.submit(p, 5, on_token=cb) for p in ps[:3]]
    polls, loads = [], []
    while eng.run_step():
        polls.append(eng.poll(rids[2]))
        loads.append(eng.load())
    statuses = eng.statuses()
    results = eng.results()
    taken = eng.take_results()
    with pytest.raises(KeyError):
        eng.poll(rids[0])
    return dict(events=events, polls=polls, loads=loads, statuses=statuses,
                results=results, taken=taken, after=eng.results(),
                after_statuses=eng.statuses())


def test_streaming_poll_and_take_results_match_jax(models, clock):
    want, got = _both(models, clock, _stream_script, max_batch=2)
    assert got == want
    for rid, toks in got["taken"].items():
        assert [t for r, t, d in got["events"] if r == rid and not d] == toks
        assert sum(1 for r, t, d in got["events"] if r == rid and d) == 1
    assert any(not p["done"] for p in got["polls"])
    assert got["after"] == {} and got["after_statuses"] == {}


def _raising_script(eng):
    def boom(rid, tok, done):
        raise ValueError("user callback bug")

    rid = eng.submit(_prompts()[0], 4, on_token=boom)
    with pytest.raises(ValueError, match="user callback bug"):
        eng.run()
    polled = eng.poll(rid)
    out = eng.run()          # the engine goes on; the next event raises
    return dict(polled=polled, out=out)


def test_raising_callback_surfaces(models, clock):
    with pytest.raises(ValueError, match="user callback bug"):
        _both(models, clock, _raising_script, max_batch=1)
    # each engine raised at its first event and kept its state
    for cls, model in zip((jserving.ServingEngine, tserving.ServingEngine),
                          models):
        eng = _engine(cls, model, clock, max_batch=1)
        rid = eng.submit(_prompts()[0], 4,
                         on_token=lambda *a: (_ for _ in ()).throw(
                             ValueError("user callback bug")))
        with pytest.raises(ValueError, match="user callback bug"):
            eng.run()
        assert eng.poll(rid)["tokens"] and not eng.poll(rid)["done"]


# --------------------------------------------------------------- preemption
def _preempt_script(eng, tight=True):
    ps = _prompts((5, 9, 6))
    rids = [eng.submit(ps[0], 10), eng.submit(ps[1], 10)]
    seats = []
    for _ in range(4):
        eng.step()
        seats.append(_seats(eng))
    if tight:
        rids.append(eng.submit(ps[2], 4, deadline=0.5))
    while eng.has_work():
        eng.step()
        seats.append(_seats(eng))
    out = eng.run()
    return dict(streams=[out[r] for r in rids], seats=seats,
                preemptions=eng.preemptions,
                statuses=[eng.status(r) for r in rids])


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
def test_preemption_matches_jax(models, clock, chunk):
    """A tight-deadline arrival into a full batch unseats the slackest
    request, which replays (prefill of prompt + tokens; in chunks when
    that is longer than the chunk) and continues its stream unchanged."""
    want, got = _both(models, clock, _preempt_script, max_batch=2,
                      prefill_chunk=chunk)
    assert got == want
    assert got["preemptions"] == 1 and got["statuses"] == ["OK"] * 3
    # the victim (rid 1, the later of two without a deadline) lost its
    # seat to the arrival (rid 2)
    assert got["seats"][3] == [0, 1] and got["seats"][4] == [0, 2]
    _, solo = _both(models, clock, lambda e: _preempt_script(e, False),
                    max_batch=2, prefill_chunk=chunk)
    assert solo["preemptions"] == 0
    assert got["streams"][:2] == solo["streams"]


def test_preemption_off_and_budget(models, clock):
    for flags in (dict(serving_preempt=False),
                  dict(serving_preempt_budget=0),
                  dict(serving_preempt_horizon=0.0)):
        want, got = _both(models, clock, _preempt_script, flags,
                          max_batch=2)
        assert got == want and got["preemptions"] == 0


# ---------------------------------------------------------- export / inject
def _export_script(eng):
    ps = _prompts()
    events = []

    def cb(rid, tok, done):
        events.append((rid, tok, done))

    rids = [eng.submit(p, NEW, on_token=cb) for p in ps[:3]]
    for _ in range(4):
        eng.step()
    done = eng.take_results()
    exported = eng.export_requests()
    callbacks = eng.take_callbacks()
    shipped = [(r.rid, r.prompt.tolist(), list(r.tokens), r.slot,
                r.prefill_pos) for r in exported]
    fresh = type(eng)(eng.model, **dict(ENGINE, max_batch=2))
    new = [fresh.inject_request(r, on_token=callbacks.get(r.rid))
           for r in exported]
    out = fresh.run()
    streams = {r: done[r] for r in done}
    for old, r in zip([s[0] for s in shipped], new):
        streams[old] = out[r]
    return dict(streams=[streams[r] for r in rids], shipped=shipped,
                left=(eng.has_work(), eng.pool.free_page_count()),
                events=len(events))


def test_export_inject_resumes_streams(models, clock):
    want, got = _both(models, clock, _export_script, max_batch=2)
    assert got == want
    assert all(slot is None and pos is None
               for *_, slot, pos in got["shipped"])
    _, model = models
    whole = _engine(tserving.ServingEngine, model, clock, max_batch=2)
    rids = [whole.submit(p, NEW) for p in _prompts()[:3]]
    out = whole.run()
    assert got["streams"] == [out[r] for r in rids]
    # every token streamed once and each request ended once, across both
    # engines
    assert got["events"] == 3 * (NEW + 1)
    assert got["left"] == (False, whole.pool.num_pages - 1)


# -------------------------------------------------------------- page pool
def test_move_sequence_matches_jax():
    geom = dict(num_layers=1, num_pages=12, page_size=8, num_kv_heads=2,
                head_dim=16, max_batch=4, max_seq_len=48,
                reserve_null_page=True)
    pools = (JPagedKVCache(**geom), PagedKVCache(device="cpu", **geom))
    for pool in pools:
        pool.allocate(1, 10)
        pool.allocate(3, 20)
        pool.seq_lens[3] = 17
        pool.move_sequence(3, 0)
        pool.allocate(0, 5)
        with pytest.raises(RuntimeError, match="not empty"):
            pool.move_sequence(1, 0)
        pool.move_sequence(1, 2)
    want, got = pools
    for name in ("block_tables", "seq_lens", "_pages_used"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.free_page_count() == want.free_page_count()
    assert got.seq_lens[0] == 17 and not got.block_tables[3].any()


@pytest.mark.parametrize("budget,num_pages,want_pages", [
    (9, None, 10), (0, None, 1 + 4 * 6), (9, 5, 5)],
    ids=["budget", "worst-case", "explicit"])
def test_page_budget_sizes_the_pool(models, budget, num_pages, want_pages):
    jmodel, model = models
    with both_flags(serving_page_budget=budget):
        engines = [cls(m, max_batch=4, page_size=8, max_seq_len=48,
                       num_pages=num_pages)
                   for cls, m in ((jserving.ServingEngine, jmodel),
                                  (tserving.ServingEngine, model))]
    assert [e.pool.num_pages for e in engines] == [want_pages] * 2
    assert engines[1].pool.free_page_count() == want_pages - 1


def _queueing_script(eng):
    rids = [eng.submit(p, 4) for p in _prompts((6, 6, 6))]
    seats = []
    while eng.has_work():
        eng.step()
        seats.append(_seats(eng))
    out = eng.run()
    return dict(streams=[out[r] for r in rids], seats=seats)


def test_small_page_budget_serves_by_queueing(models, clock):
    """A budget of one request's pages admits one request at a time."""
    want, got = _both(models, clock, _queueing_script,
                      dict(serving_page_budget=2), max_batch=2)
    assert got == want
    assert all(s.count(None) >= 1 for s in got["seats"])


# ------------------------------------------------------------------ flags
NEW_FLAGS = ("serving_bucket_ladder", "serving_bucket_patience",
             "serving_page_budget", "serving_preempt",
             "serving_preempt_budget", "serving_preempt_horizon",
             "serving_preempt_margin")


@pytest.mark.parametrize("name", NEW_FLAGS)
def test_new_flag_defaults_match_jax(name):
    got, want = tflags.get_flag(name), jflags.get_flag(name)
    assert got == want and type(got) is type(want)


def test_program_flags_snapshot():
    snap = tflags.snapshot(tflags.PROGRAM_FLAGS)
    assert snap.as_tuple() == (("fused_block_decode", True),
                               ("fused_block_layers", 1))
    assert snap.fused_block_layers == 1 and "FLAGS_fused_block_decode" in snap
    with pytest.raises(TypeError):
        snap.fused_block_layers = 2
    with pytest.raises(AttributeError):
        snap.serving_preempt
    tflags.set_flags({"fused_block_layers": 2})
    try:
        assert snap.fused_block_layers == 1           # resolved once
        assert tflags.snapshot(["fused_block_layers"])[
            "fused_block_layers"] == 2
    finally:
        tflags.reset_flags()


def test_decode_keys_separate_routes_and_rungs(models):
    """Keys differ by route, rung, kv dtype and N-layer grouping; a flag
    read by a program is part of its key."""
    _, model = models
    keys = {}
    for name, flags, kw in (
            ("fused", {}, {}), ("generic", dict(fused_block_decode=False), {}),
            ("nlayer", dict(fused_block_layers=2), {}),
            ("int8", {}, dict(kv_dtype="int8"))):
        with both_flags(**flags):
            eng = tserving.ServingEngine(model, max_batch=4,
                                         bucket_ladder=(2, 4), **ENGINE,
                                         **kw)
        keys[name] = (eng._key("decode_x", 2), eng._key("decode_x", 4))
    assert keys["fused"][0] != keys["fused"][1]
    assert len({k for pair in keys.values() for k in pair}) == 8
    assert ("kv", "int8") in keys["int8"][0].extra


def test_submit_checks(models):
    _, model = models
    eng = tserving.ServingEngine(model, max_batch=2, **ENGINE)
    with pytest.raises(ValueError, match="temperature must be >= 0"):
        eng.submit(_prompts()[0], 2, temperature=-1.0)
    rid = eng.submit(_prompts()[0], 2, temperature=0.0, top_k=5, seed=7)
    req = eng._queue[0]
    assert (req.rid, req.top_k, req.seed, req.status) == (rid, 5, 7,
                                                          "PENDING")
    with pytest.raises(ValueError, match="bucket ladder"):
        tserving.ServingEngine(model, max_batch=2, bucket_ladder=(0, 2),
                               **ENGINE)
