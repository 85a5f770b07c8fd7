"""The port's fault-injection registry against the JAX package's.

``paddle_tpu_torch.testing.faults`` keeps the JAX package's grammar, site
names, schedules and seeds, so one ``FLAGS_fault_inject`` spec fires at the
same checks in both packages: a table of good and bad specs parses to equal
``SiteSpec``s or equal ``ValueError``s, and the fire schedules of ``every``,
``p``/``seed``, ``times`` and ``after`` agree over 200 checks. ``armed``
restores the flags it set, a disarmed site is the shared no-op stub, and
every fire lands on the ``faults_injected{site}`` counter.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import contextlib

import pytest

from paddle_tpu import flags as jflags
from paddle_tpu import observability as jobs
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.testing import faults as tfaults

PACKAGES = {"jax": (jfaults, jflags, jobs), "port": (tfaults, tflags, tobs)}

GOOD_SPECS = [
    "",
    "   ",
    "decode_dispatch:every=5",
    "prefill:p=0.1:seed=7",
    "prefill:p=0.25",
    "chunk_prefill:every=3:times=2",
    "kv_spill:every=2:after=3",
    "decode_dispatch:every=5;prefill:p=0.1:seed=7;preempt:every=1:times=1",
    " bucket_migrate : every = 2 : times = 3 ; ",
    "program_build:every=1:times=1",
    "checkpoint_save:p=1.0",
    "prefill:every=4:after=-2",
]
BAD_SPECS = [
    "not_a_site:every=1",
    "prefill",
    "prefill:every=2:p=0.5",
    "prefill:every=0",
    "prefill:p=0",
    "prefill:p=1.5",
    "prefill:every",
    "prefill:every=x",
    "prefill:p=zz",
    "prefill:bogus=1",
    "prefill:every=1;prefill:every=2",
    "prefill:every=2:times=y",
]


def _parsed(faults, text):
    try:
        return {name: repr(spec)
                for name, spec in faults.parse_spec(text).items()}
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("text", GOOD_SPECS + BAD_SPECS)
def test_parse_spec_matches_jax(text):
    want, got = _parsed(jfaults, text), _parsed(tfaults, text)
    assert got == want
    assert isinstance(got, tuple) == (text in BAD_SPECS)


def test_known_sites_match_jax():
    assert tfaults.KNOWN_SITES == jfaults.KNOWN_SITES


def _fires(faults, text, site, checks=200):
    spec = faults.parse_spec(text)[site]
    s = faults.FaultSite(spec)
    fired = []
    for i in range(checks):
        try:
            s.check(i=i)
        except faults.InjectedFault as e:
            assert e.site == site and e.ctx == {"i": i}
            fired.append(e.call_index)
    assert s.calls == checks and s.fires == len(fired)
    return fired


@pytest.mark.parametrize("text,site", [
    ("decode_dispatch:every=5", "decode_dispatch"),
    ("decode_dispatch:every=1", "decode_dispatch"),
    ("prefill:p=0.1:seed=7", "prefill"),
    ("prefill:p=0.3", "prefill"),              # the site name's digest
    ("chunk_prefill:p=0.9:seed=3", "chunk_prefill"),
    ("kv_spill:every=3:times=4", "kv_spill"),
    ("preempt:every=2:after=7", "preempt"),
    ("bucket_migrate:p=0.5:times=6:after=20", "bucket_migrate"),
])
def test_fire_schedules_match_jax(text, site):
    want, got = _fires(jfaults, text, site), _fires(tfaults, text, site)
    assert got == want and got


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_armed_restores_flags(pkg):
    faults, flags, _ = PACKAGES[pkg]
    prev = (flags.get_flag("fault_inject"),
            flags.get_flag("serving_retry_backoff"))
    with faults.armed("decode_dispatch:every=2",
                      serving_retry_backoff=0.001):
        assert flags.get_flag("fault_inject") == "decode_dispatch:every=2"
        assert flags.get_flag("serving_retry_backoff") == 0.001
        assert faults.enabled()
        assert faults.site("decode_dispatch").armed
        assert faults.site("prefill") is faults.NULL_SITE
    assert (flags.get_flag("fault_inject"),
            flags.get_flag("serving_retry_backoff")) == prev
    assert not faults.enabled()
    with contextlib.suppress(RuntimeError):
        with faults.armed("prefill:every=1"):
            raise RuntimeError("the block raised")
    assert flags.get_flag("fault_inject") == prev[0]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_disarmed_site_is_the_null_stub(pkg):
    faults, _, _ = PACKAGES[pkg]
    s = faults.site("decode_dispatch")
    assert s is faults.NULL_SITE and not s.armed
    for _ in range(100):
        s.check()
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.site("not_a_site")


def _injected(obs, site):
    fam = obs.snapshot()["metrics"].get("faults_injected")
    for s in (fam or {}).get("series", []):
        if s["labels"] == {"site": site}:
            return s["value"]
    return 0.0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_fires_land_on_the_registry(pkg):
    faults, _, obs = PACKAGES[pkg]
    with faults.armed("prefill:every=1:times=3"):
        before = _injected(obs, "prefill")
        s = faults.site("prefill")
        for _ in range(5):
            with contextlib.suppress(faults.InjectedFault):
                s.check()
        assert _injected(obs, "prefill") == before + 3


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_shared_check_counts_across_calls(pkg):
    faults, _, _ = PACKAGES[pkg]
    with faults.armed("checkpoint_save:every=3"):
        fired = 0
        for _ in range(6):
            try:
                faults.check("checkpoint_save")
            except faults.InjectedFault:
                fired += 1
        assert fired == 2
    faults.check("checkpoint_save")             # disarmed: a no-op


def test_each_site_call_gets_its_own_schedule():
    with tfaults.armed("decode_dispatch:every=2"):
        a, b = tfaults.site("decode_dispatch"), tfaults.site("decode_dispatch")
    a.check()
    with pytest.raises(tfaults.InjectedFault):
        a.check()
    b.check()                                   # b's first check
    assert (a.calls, a.fires, b.calls, b.fires) == (2, 1, 1, 0)


def test_injected_fault_message_matches_jax():
    j = jfaults.InjectedFault("kv_spill", 4, {"op": "spill", "page": 9})
    t = tfaults.InjectedFault("kv_spill", 4, {"op": "spill", "page": 9})
    assert str(t) == str(j) and isinstance(t, RuntimeError)
