"""The speculative engine pair the spec tests share: both packages serve
the tiny GQA Llama of ``torch_serving_twins`` in fp32 from the same seeded
numpy weights, with drafts built the same way (a divergent draft of the
same shape, a half-width one-layer draft, an all-zero draft that proposes
token 0 forever, and the target as its own draft), on one fake host clock.
``tests/test_torch_spec_{decode,replay,sampling}.py`` import the fixtures
and helpers from here.
"""

import itertools

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.generation import serving as jserving
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.testing import faults as tfaults
from torch_serving_twins import (both_flags, clocked, patch_clock,
                                 tiny_llamas, tokens)

PAGE = 8
_TAGS = itertools.count()          # a replica label per engine pair
SPEC_FAMILIES = ("serving_spec_rounds", "serving_spec_tokens_accepted",
                 "serving_spec_tokens_rejected", "serving_spec_gamma")


@pytest.fixture(scope="module")
def models():
    """The target pair and the drafts, each (JAX model, port model)."""
    target = tiny_llamas(11)
    zero = tiny_llamas(0)
    params, _ = zero[0].raw_state()
    zeros = {k: np.zeros_like(np.asarray(v)) for k, v in params.items()}
    zero[0].set_state_dict({k: paddle.to_tensor(v)
                            for k, v in zeros.items()})
    zero[1].load_numpy_state(zeros)
    return dict(
        target=target, draft=tiny_llamas(12),
        narrow=tiny_llamas(1, hidden_size=32, num_hidden_layers=1,
                           num_attention_heads=2, num_key_value_heads=1,
                           intermediate_size=64),
        zero=zero, same=target)


@pytest.fixture
def clock(monkeypatch):
    return patch_clock(monkeypatch)


def _series(obs, name, labels):
    fam = obs.snapshot()["metrics"].get(name)
    for s in (fam or {}).get("series", []):
        if s["labels"] == labels:
            return s.get("value", s.get("count"))
    return None


def _rounds(eng):
    """Log every round's (rid, γ) as the engine starts it."""
    log = []
    inner = eng._spec_round

    def spec_round(req, gamma):
        log.append((req.rid, gamma))
        inner(req, gamma)
    eng._spec_round = spec_round
    return log


def _both(models, clock, script, draft="draft", flags=None, spec="", **kw):
    """``script(engine)`` on a speculative engine of each package (built
    under ``flags`` and the fault ``spec``), with the rounds and the spec
    counters added; returns (JAX's observation, the port's)."""
    kw = dict(dict(max_batch=2, page_size=PAGE, max_seq_len=64), **kw)
    tag = f"spec-{next(_TAGS)}"
    seen = []
    for i, (cls, faults, obs) in enumerate((
            (jserving.ServingEngine, jfaults, jobs),
            (tserving.ServingEngine, tfaults, tobs))):
        with both_flags(**(flags or {})), \
                faults.armed(spec, serving_retry_backoff=0.001):
            eng = clocked(cls, models["target"][i], clock, replica=tag,
                          draft_model=models[draft][i], **kw)
        log = _rounds(eng)
        got = script(eng)
        labels = {"replica": tag, "tp": "1"}
        got.update(rounds=log, spec_rounds=eng.spec_rounds,
                   accepted=eng.spec_tokens_accepted,
                   rejected=eng.spec_tokens_rejected,
                   families={n: _series(obs, n, labels)
                             for n in SPEC_FAMILIES
                             + ("serving_spec_accept_rate",)})
        seen.append(got)
    return seen


def _plain(models, clock, script, flags=None, **kw):
    """``script`` on the port's plain engine (no draft)."""
    kw = dict(dict(max_batch=2, page_size=PAGE, max_seq_len=64), **kw)
    with both_flags(**(flags or {})):
        eng = clocked(tserving.ServingEngine, models["target"][1], clock,
                      **kw)
    return script(eng)


def _submit_run(lens, new, seed=1, stagger=0, head=2, eos=None):
    """Submit prompts of ``lens`` (after ``stagger`` steps with only the
    first ``head`` queued) and run."""
    def script(eng):
        rng = np.random.default_rng(seed)
        ps = [tokens(rng, n) for n in lens]
        rids = [eng.submit(p, new, eos_token_id=eos) for p in ps[:head]]
        for _ in range(stagger):
            eng.step()
        rids += [eng.submit(p, new, eos_token_id=eos) for p in ps[head:]]
        out = eng.run(max_wall=300.0)
        return dict(streams=[out[r] for r in rids],
                    statuses=[eng.status(r) for r in rids],
                    migrations=eng.bucket_migrations,
                    preemptions=eng.preemptions)
    return script


def _hold(models, clock, script, draft="draft", flags=None, spec="",
          **kw):
    """The port's spec engine equal to the JAX spec engine in every
    observation, and its streams to the port's plain engine's; returns
    the port's observation."""
    want, got = _both(models, clock, script, draft, flags, spec, **kw)
    assert got == want
    plain = _plain(models, clock, script, flags, **kw)
    assert got["streams"] == plain["streams"]
    assert set(got["statuses"]) == {"OK"}
    return got
