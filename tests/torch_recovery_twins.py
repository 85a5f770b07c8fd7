"""The engine pair the replay-recovery tests share: each package's
ServingEngine on the tiny GQA Llama of ``torch_serving_twins`` under the
same ``FLAGS_fault_inject`` spec (``FLAGS_serving_retry_backoff`` 0.001)
and one fake host clock, with what the two observed (statuses, streams,
the recovery counters, the fires and every armed site's fire points).
``tests/test_torch_recovery{,_drill}.py`` import the fixtures and helpers
from here.
"""

import itertools

import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.generation import serving as jserving
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.testing import faults as tfaults
from torch_serving_twins import (both_flags, clocked, patch_clock, solo,
                                 tiny_llamas)

SITES = ("_f_prefill", "_f_chunk", "_f_decode", "_f_migrate", "_f_preempt")
COUNTERS = ("serving_retries_total", "serving_recoveries",
            "serving_requests_failed")
_TAGS = itertools.count()          # a replica label per engine pair


@pytest.fixture(scope="module")
def models():
    return tiny_llamas(97)


@pytest.fixture
def clock(monkeypatch):
    return patch_clock(monkeypatch)


def _series(obs, name, labels):
    fam = obs.snapshot()["metrics"].get(name)
    for s in (fam or {}).get("series", []):
        if s["labels"] == labels:
            return s["value"]
    return 0.0


def _injected(obs):
    return {site: _series(obs, "faults_injected", {"site": site})
            for site in sorted(tfaults.KNOWN_SITES)}


def _fire_points(eng):
    sites = [getattr(eng, n) for n in SITES]
    if eng._prefix is not None:
        sites.append(eng._prefix._f_spill)
    return [(s.calls, s.fires) if s.armed else None for s in sites]


def _both(models, clock, script, spec="", flags=None, **kw):
    """``script(engine)`` on an engine of each package built under ``spec``
    and ``flags`` (replica labels of their own); returns (JAX's
    observation, the port's), each with the recovery counters, the fires
    and the fire points added."""
    jmodel, model = models
    seen = []
    tag = f"recovery-{next(_TAGS)}"
    for cls, mdl, faults, obs in (
            (jserving.ServingEngine, jmodel, jfaults, jobs),
            (tserving.ServingEngine, model, tfaults, tobs)):
        before = _injected(obs)
        with both_flags(**(flags or {})), \
                faults.armed(spec, serving_retry_backoff=0.001):
            eng = clocked(cls, mdl, clock, replica=tag, **kw)
        got = script(eng)
        labels = {"replica": tag, "tp": "1"}
        got.update(
            counters={c: _series(obs, c, labels) for c in COUNTERS},
            fires={k: v - before[k] for k, v in _injected(obs).items()
                   if v != before[k]},
            fire_points=_fire_points(eng))
        seen.append(got)
    return seen


def _submit_run(prompts, new, step_first=0, max_wall=None, head=2):
    """Submit ``prompts`` (the first ``step_first`` steps with only the
    first ``head`` queued) and run; the streams and statuses in submit
    order."""
    def script(eng):
        rids = [eng.submit(p, new) for p in prompts[:head]]
        for _ in range(step_first):
            eng.step()
        rids += [eng.submit(p, new) for p in prompts[head:]]
        out = eng.run(max_wall=max_wall)
        return dict(streams=[out[r] for r in rids],
                    statuses=[eng.status(r) for r in rids],
                    drained=not eng.has_work(),
                    free=eng.pool.free_page_count())
    return script


def _check(models, want, got, prompts, new):
    assert got == want
    jmodel, _ = models
    assert got["streams"] == [solo(jmodel, p, new) for p in prompts]
    assert got["statuses"] == ["OK"] * len(prompts)
