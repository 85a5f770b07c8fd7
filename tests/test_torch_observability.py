"""The port's telemetry against the JAX package's.

- The JAX package's registry and span unit cases, run on both packages:
  counters, gauges, labelled families, histogram buckets and quantiles,
  JSON round trips, Prometheus text, nested spans, the Chrome-trace schema,
  the decorator form and the bounded ring; the same script gives equal
  snapshots, Prometheus text and trace events in both.
- The same traffic (staggered arrivals, chunked prompts, a deadline that
  expires, bucket migrations; with and without a prefix cache) through the
  JAX engine and the port's, on the tiny Llama of ``torch_serving_twins``
  under a fake clock: every engine family (``serving_*``, ``kv_*``,
  ``prefix_cache_*``) equal in name, help, type and labels, counters and
  gauges equal in value (``kv_pool_pages{state}`` after the drain among
  them), histograms equal in count, and the same request spans and events.
- The port's program cache counters agree with its own stats, and spans
  reach ``torch.profiler`` only while it records.
- Telemetry off leaves nothing in the registry or the ring.
- The memory section reads like the JAX package's on the CPU.
"""

import collections
import itertools
import json

import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu import observability as jobs
from paddle_tpu.generation import serving as jserving
from paddle_tpu.generation.program_cache import \
    clear_decode_program_cache as jclear_cache
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.generation.program_cache import (
    clear_decode_program_cache, decode_program_cache)
from torch_serving_twins import (both_flags, clocked, patch_clock,
                                 tiny_llamas, tokens)

PACKAGES = {"jax": jobs, "port": tobs}
ENGINE_FAMILIES = ("serving_", "kv_", "prefix_cache_")
_TAGS = itertools.count()          # a replica label per engine pair


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    """Both registries and rings empty, telemetry on, the program caches
    dropped (they rebind their instruments)."""
    prior = jflags.get_flag("telemetry")
    jflags.set_flags({"telemetry": True})
    tflags.set_flags({"telemetry": True})
    for obs in PACKAGES.values():
        obs.registry().clear()
        obs.tracer().clear()
    jclear_cache()
    clear_decode_program_cache()
    yield
    jflags.set_flags({"telemetry": prior})
    tflags.reset_flags()
    for obs in PACKAGES.values():
        obs.registry().clear()
        obs.tracer().clear()
    jclear_cache()
    clear_decode_program_cache()


@pytest.fixture(scope="module")
def models():
    return tiny_llamas(99)


@pytest.fixture
def clock(monkeypatch):
    return patch_clock(monkeypatch)


def metric(snap, name):
    return snap["metrics"][name]["series"][0]


pkgs = pytest.mark.parametrize("obs", list(PACKAGES.values()),
                               ids=list(PACKAGES))


# -------------------------------------------------------------- registry
@pkgs
def test_counter_and_gauge(obs):
    r = obs.registry()
    c = r.counter("t_reqs", "help text")
    c.inc()
    c.inc(2.5)
    g = r.gauge("t_depth")
    g.set(7)
    g.inc()
    g.dec(3)
    snap = r.snapshot()
    assert metric(snap, "t_reqs")["value"] == 3.5
    assert snap["metrics"]["t_reqs"]["help"] == "help text"
    assert metric(snap, "t_depth")["value"] == 5


@pkgs
def test_families_are_idempotent_and_typed(obs):
    r = obs.registry()
    assert r.counter("t_same") is r.counter("t_same")
    with pytest.raises(ValueError):
        r.gauge("t_same")
    with pytest.raises(ValueError):
        r.counter("t_same", labels=("k",))
    h = r.histogram("t_same_h", buckets=(0.1, 1.0))
    assert r.histogram("t_same_h", buckets=(0.1, 1.0)) is h
    with pytest.raises(ValueError):
        r.histogram("t_same_h", buckets=(0.5, 5.0))


@pkgs
def test_labels(obs):
    r = obs.registry()
    fam = r.counter("t_hits", labels=("kind",))
    fam.labels(kind="a").inc()
    fam.labels(kind="a").inc()
    fam.labels(kind="b").inc(5)
    with pytest.raises(ValueError):
        fam.labels(wrong="x")
    series = {tuple(s["labels"].items()): s["value"]
              for s in r.snapshot()["metrics"]["t_hits"]["series"]}
    assert series[(("kind", "a"),)] == 2
    assert series[(("kind", "b"),)] == 5


@pkgs
def test_histogram_buckets_and_quantiles(obs):
    h = obs.registry().histogram(
        "t_lat", buckets=obs.exponential_buckets(0.001, 2.0, 10))
    for v in (0.0015, 0.003, 0.003, 0.1):
        h.observe(v)
    entry = metric(obs.registry().snapshot(), "t_lat")
    assert entry["count"] == 4
    assert entry["counts"][-1] == 0           # nothing overflowed
    assert sum(entry["counts"]) == 4
    assert entry["min"] == pytest.approx(0.0015)
    assert entry["max"] == pytest.approx(0.1)
    p50 = obs.series_quantile(entry, 0.5)
    assert 0.0015 <= p50 <= 0.004
    assert obs.series_quantile(entry, 0.99) <= 0.1
    assert h.quantile(0.5) == p50


@pkgs
def test_histogram_overflow_bucket(obs):
    h = obs.registry().histogram("t_over", buckets=(0.1, 0.2))
    h.observe(99.0)
    entry = metric(obs.registry().snapshot(), "t_over")
    assert entry["counts"] == [0, 0, 1]
    assert obs.series_quantile(entry, 0.5) == pytest.approx(99.0)


@pkgs
def test_snapshot_json_round_trip(obs):
    h = obs.registry().histogram("t_rt")
    h.observe(0.01)
    h.observe(0.02)
    snap = json.loads(json.dumps(obs.registry().snapshot()))
    entry = metric(snap, "t_rt")
    assert entry["count"] == 2
    assert obs.series_quantile(entry, 0.5) is not None


@pkgs
def test_prometheus_text(obs):
    r = obs.registry()
    r.counter("t_c", "a counter").inc(3)
    fam = r.histogram("t_h", labels=("k",), buckets=(0.1, 1.0))
    fam.labels(k="x").observe(0.5)
    text = obs.to_prometheus()
    assert "# TYPE t_c counter" in text
    assert "t_c 3" in text
    assert 't_h_bucket{k="x",le="0.1"} 0' in text
    assert 't_h_bucket{k="x",le="1"} 1' in text
    assert 't_h_bucket{k="x",le="+Inf"} 1' in text
    assert 't_h_count{k="x"} 1' in text


def _registry_script(obs):
    r = obs.MetricsRegistry()
    r.counter("s_reqs", "requests").inc(4)
    g = r.gauge("s_depth", "depth", labels=("replica",))
    g.labels(replica="0").set(3)
    g.labels(replica="1").set(1.5)
    h = r.histogram("s_lat", "latency", labels=("kind",))
    for v in (0.00005, 0.002, 0.3, 7.0, 500.0):
        h.labels(kind="a").observe(v)
    r.histogram("s_small", buckets=obs.exponential_buckets(0.5, 3.0, 4)) \
        .observe(2.0)
    snap = r.snapshot()
    snap.pop("ts")
    return snap, obs.to_prometheus(r.snapshot())


def test_same_script_gives_equal_snapshots_and_text():
    (jsnap, jtext), (tsnap, ttext) = (_registry_script(jobs),
                                      _registry_script(tobs))
    assert tsnap == jsnap and ttext == jtext
    assert tobs.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS
    entry = tsnap["metrics"]["s_lat"]["series"][0]
    assert tobs.series_quantile(entry, 0.5) == \
        jobs.series_quantile(entry, 0.5)


# ----------------------------------------------------------------- spans
@pkgs
def test_nesting_containment(obs):
    tr = obs.tracer()
    with tr.span("outer", a=1):
        with tr.span("inner"):
            pass
    ev = {e["name"]: e for e in tr.events()}
    o, i = ev["outer"], ev["inner"]
    assert o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    assert o["args"] == {"a": 1}


@pkgs
def test_chrome_trace_schema(obs, tmp_path):
    tr = obs.tracer()
    with tr.span("s1"):
        pass
    tr.event("retro", 1.0, 2.0, rid=4)
    path = tmp_path / "trace.json"
    tr.save(str(path))
    doc = json.loads(path.read_text())
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    for e in doc["traceEvents"]:
        assert e["ph"] == "X"
        assert {"name", "ts", "dur", "pid", "tid", "args"} <= set(e)
        assert e["dur"] >= 0
    retro = [e for e in doc["traceEvents"] if e["name"] == "retro"][0]
    assert retro["dur"] == pytest.approx(1e6)
    assert retro["args"]["rid"] == 4
    obs.save_chrome_trace(str(path))
    assert json.loads(path.read_text()) == obs.chrome_trace()


@pkgs
def test_decorator_form(obs):
    calls = []

    @obs.tracer().span("deco")
    def f(x):
        calls.append(x)
        return x + 1

    assert f(1) == 2 and f(2) == 3
    assert [e["name"] for e in obs.tracer().events()] == ["deco", "deco"]


@pkgs
def test_ring_is_bounded(obs):
    tr = obs.SpanTracer(capacity=4)
    for i in range(10):
        tr.event(f"e{i}", 0.0, 0.1)
    names = [e["name"] for e in tr.events()]
    assert names == ["e6", "e7", "e8", "e9"]


def _trace_script(obs):
    tr = obs.SpanTracer(capacity=8)
    with tr.span("a", rid=1):
        with tr.span("b"):
            pass
    tr.event("c", 2.0, 2.5, active=3)
    tr.counter("kv_pool", 3.0, pages_in_use=4, bytes_in_use=1024)
    return [{k: (v if k not in ("ts", "dur", "pid", "tid") else type(v))
             for k, v in e.items()} for e in tr.chrome_trace()["traceEvents"]]


def test_same_script_gives_equal_trace_events():
    assert _trace_script(tobs) == _trace_script(jobs)


def test_spans_reach_the_torch_profiler_only_while_it_records():
    from paddle_tpu_torch.observability import tracing
    assert not tracing._capture_active()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing._capture_active()
        with tobs.tracer().span("traced_span"):
            torch.ones(4).sum()
    assert "traced_span" in {e.key for e in prof.key_averages()}
    assert [e["name"] for e in tobs.tracer().events()] == ["traced_span"]


# ---------------------------------------------------------------- engine
def _traffic(eng):
    """Staggered arrivals, two prompts sharing a 16-token prefix, chunked
    prompts (chunk 8), a request whose deadline passes before it admits."""
    rng = np.random.default_rng(3)
    shared = tokens(rng, 16)
    ps = ([np.concatenate([shared, tokens(rng, n)]) for n in (3, 20, 5)]
          + [tokens(rng, n) for n in (6, 30, 9)])
    rids = [eng.submit(ps[0], 5)]
    for _ in range(3):
        eng.step()
    rids += [eng.submit(p, 5) for p in ps[1:4]]
    rids.append(eng.submit(ps[4], 5, deadline=0.0))
    eng.step()
    rids.append(eng.submit(ps[5], 5))
    out = eng.run()
    return [out[r] for r in rids], [eng.status(r) for r in rids]


def _engine_view(obs, tag):
    """Every engine family of replica ``tag``: (help, type, label names)
    and its series by labels (a histogram's count, else its value)."""
    fams = {}
    for name, fam in obs.snapshot()["metrics"].items():
        if not name.startswith(ENGINE_FAMILIES):
            continue
        series = {}
        for s in fam["series"]:
            if s["labels"].get("replica") != tag:
                continue
            key = tuple(sorted(s["labels"].items()))
            series[key] = s["count"] if fam["type"] == "histogram" \
                else s["value"]
        fams[name] = (fam["help"], fam["type"], series)
    return fams


def _events(obs):
    return collections.Counter((e["name"], e["ph"])
                               for e in obs.tracer().events())


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
def test_engine_telemetry_matches_jax(models, clock, prefix):
    jmodel, model = models
    tag = f"obs-{next(_TAGS)}"
    kw = dict(max_batch=4, page_size=8, max_seq_len=64, prefill_chunk=8,
              bucket_ladder=(2, 4), prefix_cache=prefix, replica=tag)
    seen = []
    for cls, mdl, obs in ((jserving.ServingEngine, jmodel, jobs),
                          (tserving.ServingEngine, model, tobs)):
        with both_flags(serving_bucket_patience=2):
            eng = clocked(cls, mdl, clock, **kw)
        streams, statuses = _traffic(eng)
        seen.append(dict(streams=streams, statuses=statuses,
                         families=_engine_view(obs, tag),
                         events=_events(obs)))
    want, got = seen
    assert got == want
    fams = got["families"]
    assert len(fams) == 34 + 8 * prefix
    assert sorted(set(got["statuses"])) == ["OK", "TIMEOUT"]

    def value(name, **labels):
        key = tuple(sorted(dict(replica=tag, tp="1", **labels).items()))
        return fams[name][2][key]
    assert value("serving_requests_timeout") == 1
    assert value("serving_requests_finished") == 5
    assert value("serving_decode_steps") > 0
    assert value("serving_bucket_migrations") >= 1
    assert value("serving_ttft_seconds") == 5
    assert value("serving_prefill_chunk_seconds") > 0
    assert value("kv_pool_pages", state="free") > 0
    assert value("serving_queue_depth") == 0
    if prefix:
        assert value("serving_shared_admissions") >= 1
        hits = fams["prefix_cache_hits"][2][(("replica", tag),)]
        assert hits >= 1
    names = {n for n, _ in got["events"]}
    assert {"request.queued", "request.prefill", "request.complete",
            "engine.decode_step", "kv_pool"} <= names


def test_program_cache_counters_agree_with_its_stats(models, clock):
    _, model = models
    cache = decode_program_cache()
    for _ in range(2):
        eng = clocked(tserving.ServingEngine, model, clock, max_batch=4,
                      page_size=8, max_seq_len=64, prefill_chunk=8,
                      bucket_ladder=(2, 4))
        _traffic(eng)
    stats = cache.stats()
    full = tobs.snapshot()
    snap = full["metrics"]
    assert metric(full, "program_cache_hits")["value"] == stats["hits"] > 0
    assert metric(full, "program_cache_misses")["value"] == \
        stats["misses"] == len(stats["traces"])
    traces = {s["labels"]["kind"]: s["value"]
              for s in snap["program_cache_traces"]["series"]}
    kinds = collections.Counter()
    for key, n in stats["traces"].items():
        kinds[key.kind] += n
    assert traces == dict(kinds)
    assert {s["labels"]["kind"]: s["count"]
            for s in snap["program_cache_compile_seconds"]["series"]} == \
        dict(kinds)
    assert all(s["labels"]["tp"] == "1" and len(s["labels"]["model"]) == 8
               for s in snap["program_cache_traces"]["series"])
    # timed on the serving module's clock (the fake one here)
    assert set(stats["compile_seconds"]) == set(stats["traces"])


def test_telemetry_off_leaves_zero_residue(models, clock):
    _, model = models
    tflags.set_flags({"telemetry": False})
    clear_decode_program_cache()
    eng = clocked(tserving.ServingEngine, model, clock, max_batch=4,
                  page_size=8, max_seq_len=64, prefill_chunk=8,
                  prefix_cache=True)
    streams, statuses = _traffic(eng)
    assert all(len(s) == 5 for s, st in zip(streams, statuses) if st == "OK")
    assert tobs.registry().snapshot()["metrics"] == {}
    assert len(tobs.tracer()) == 0
    assert decode_program_cache().compile_seconds(eng.decode_key) == 0.0
    assert decode_program_cache().stats()["compile_seconds"] == {}
    assert not eng._m.enabled and not eng._prefix._m.enabled
    assert eng.decode_step_seconds and eng.ttft_seconds   # probes stay


def test_memory_section_reads_like_jax():
    want, got = jobs.memory.section(), tobs.memory.section()
    assert set(got) == set(want) and got["schema"] == want["schema"]
    assert got["programs"] == []
    assert got["watermarks"]["devices"] == want["watermarks"]["devices"] \
        == {}
    assert got["watermarks"]["host"]["peak_rss"] > 0
    series = tobs.snapshot()["metrics"]["host_memory_bytes"]["series"]
    assert series == [{"labels": {"stat": "peak_rss"},
                       "value": float(got["watermarks"]["host"]
                                      ["peak_rss"])}]
    assert "device_memory_bytes" not in tobs.snapshot()["metrics"]


def test_flags_match_jax_and_stay_out_of_program_keys():
    for name in ("telemetry", "telemetry_ring", "fault_inject",
                 "serving_max_retries", "serving_retry_backoff"):
        assert tflags.get_flag(name) == jflags.get_flag(name), name
        assert name not in tflags.PROGRAM_FLAGS
    # the compiled-program capture it gates is not ported: setting the
    # flag raises like any other unported option
    with pytest.raises(KeyError, match="memwatch"):
        tflags.set_flags({"FLAGS_memwatch": False})
