"""The card's replay-recovery drill (``chip_smoke.py``'s ``recovery``
phase) at its geometry on the tiny model, through the JAX engine and the
port's (the engine pair of ``torch_recovery_twins``; the other recovery
cases are ``test_torch_recovery.py``): max_batch 4, 64-token pages, a
1024-token context, the prefix cache, 256-token chunks, prompts of 17 to
700 tokens with 32 new tokens each, half submitted after 6 steps, under
the drill's ``FLAGS_fault_inject`` spec, at the default retry budget and
at the drill's. Statuses, streams, counters, fires and fire points equal.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from torch_recovery_twins import _both, _submit_run, clock  # noqa: F401
from torch_serving_twins import tiny_llamas, tokens


# ------------------------------------------------ chip_smoke.py's drill
DRILL_LENS = (17, 77, 130, 256, 300, 700, 33, 200)
DRILL_SPEC = "prefill:every=5;chunk_prefill:every=4;decode_dispatch:every=9"


@pytest.fixture(scope="module")
def long_models():
    return tiny_llamas(97, max_position_embeddings=1024)


@pytest.mark.parametrize("retries", [None, 20],
                         ids=["default_budget", "drill_budget"])
def test_recovery_drill_schedule_matches_the_jax_engine(long_models, clock,
                                                        retries):
    """The card's recovery drill (chip_smoke.py) at its geometry on the
    tiny model: max_batch 4, 64-token pages, a 1024-token context, the
    prefix cache, 256-token chunks; prompts of 17 to 700 tokens with 32 new
    tokens each, half submitted after 6 steps, under the drill's spec. The
    fault schedule depends on the traffic and the spec only, so both
    engines fire at the same checks and agree on statuses, streams and
    counters. At the default budget (3) the two chunked prompts (300 and
    700 tokens) end FAILED in both engines, since every fault replays
    every request in flight; at the drill's budget (20) every request ends
    OK with its fault-free stream."""
    rng = np.random.default_rng(13)
    prompts = [tokens(rng, n) for n in DRILL_LENS]
    kw = dict(max_batch=4, page_size=64, max_seq_len=1024, prefix_cache=True,
              prefill_chunk=256)
    flags = {} if retries is None else dict(serving_max_retries=retries)
    script = _submit_run(prompts, 32, step_first=6, head=4)
    want, got = _both(long_models, clock, script, spec=DRILL_SPEC,
                      flags=flags, **kw)
    assert got == want
    assert got["drained"]
    assert got["counters"]["serving_recoveries"] == sum(
        got["fires"].values())
    assert set(got["fires"]) == {"prefill", "chunk_prefill",
                                 "decode_dispatch"}
    if retries is None:
        assert got["statuses"] == ["FAILED" if n in (300, 700) else "OK"
                                   for n in DRILL_LENS]
        assert got["counters"]["serving_requests_failed"] == 2
        return
    assert got["statuses"] == ["OK"] * len(prompts)
    _, clean = _both(long_models, clock, script, **kw)
    assert clean["streams"] == got["streams"] and not clean["fires"]
