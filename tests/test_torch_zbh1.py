"""The zero-bubble (ZBH1) pipeline schedule across ranks against the JAX
package.

``PipelineTrainStep(schedule="zbh1")`` in gloo ranks on the CPU (worlds
spawned once for the file: 2 ranks for Llama at pp = 2 without and with
remat and the tied GPT at pp = 2, 4 ranks for pp = 2 x dp = 2 plain, with
ZeRO-1 over dp, and the tied GPT there), each 3 AdamW steps from the JAX
pipe's weights, held to the JAX serial ``TrainStep`` on the same pipe as
the reference holds
its zero-bubble engine (``tests/test_zbh1.py``): losses within 1e-5
relative, the gathered stages within 1e-5 (the AdamW-eps allowance of
``tests/test_torch_pipeline.py``). Each rank walks the reference's
``zbh1_schedule`` table; the scope's refusals (interleaved VPP, an uneven
split, ZeRO stage 3) raise the reference's ``NotImplementedError``.
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401
import torch_pp_ranks as ranks
from test_torch_pipeline import (REFUSALS, case_of, check_losses,
                                 check_params, gathered, jax_pipe,
                                 jax_refusals, jax_run, jax_weights)
from paddle_tpu.distributed.fleet.meta_parallel.pipeline_zbh1 import \
    zbh1_schedule as jzbh1_schedule
from paddle_tpu_torch.distributed import spawn

# remat=False: W takes each module's weight gradients from the outputs' B
# kept; remat=True: W backpropagates the kept graph again
Z, ZR = dict(schedule="zbh1", remat=False), dict(schedule="zbh1")
TWO = [case_of("zbh1_pp2", "llama", 2, 4, **Z),
       case_of("zbh1_pp2_remat", "llama", 2, 4, **ZR),
       case_of("zbh1_gpt_tied_pp2", "gpt4", 2, 4, model="gpt", **Z)]
FOUR = [case_of("zbh1_pp2_dp2", "llama", 2, 2, dp=2, **ZR),
        case_of("zbh1_pp2_dp2_zero1", "llama", 2, 2, dp=2, level=1,
                axis="dp", **Z),
        case_of("zbh1_gpt_tied_pp2_dp2", "gpt4", 2, 2, dp=2, model="gpt",
                **ZR)]
CASES = {c["name"]: c for c in TWO + FOUR}


@pytest.fixture(scope="module")
def runs():
    kinds = ("llama", "gpt4")
    weights = {k: jax_weights(jax_pipe(k)[0]) for k in kinds}
    worlds = [spawn(ranks.pp_rank, args=(cases, weights), nprocs=n,
                    join=False)
              for n, cases in ((2, TWO + [REFUSALS]), (4, FOUR))]
    try:
        jax = {k: jax_run(k) for k in kinds}
        refusals = jax_refusals()
        for w in worlds:
            w.join(ranks.JOIN_TIMEOUT_S)
    finally:
        for w in worlds:
            w.terminate()
    port = {}
    for w in worlds:
        for name in w.results[0]:
            port[name] = [r[name] for r in w.results]
    return dict(jax=jax, port=port, jax_refusals=refusals)


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax(runs, name):
    check_losses(runs["port"][name], runs["jax"][CASES[name]["weights"]][0])


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_params_match_jax(runs, name):
    check_params(name, gathered(runs["port"][name], CASES[name]),
                 runs["jax"][CASES[name]["weights"]][1])


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_walk_the_reference_table(runs, name):
    """Every rank ran as many ticks as the reference's table has."""
    c = CASES[name]
    want = jzbh1_schedule(c["pp"], c["M"])[0].shape[0]
    for r in runs["port"][name]:
        assert r["ticks"] == want


def test_tied_copies_stay_equal(runs):
    """The tied wte's copies on stages 0 and 1 are equal bit for bit after
    3 steps (gather_pipe_state raises otherwise) in both worlds."""
    for name in ("zbh1_gpt_tied_pp2", "zbh1_gpt_tied_pp2_dp2"):
        rs = runs["port"][name]
        last = [r for r in rs if r["coords"]["pp"] == 1]
        assert all(r["aliases"]["6.wte.weight"] == "0.wte.weight"
                   for r in last)
        got = gathered(rs, CASES[name])
        assert "6.wte.weight" not in got
        first = [r for r in rs if r["coords"]["pp"] == 0][0]
        np.testing.assert_array_equal(last[0]["state"]["6.wte.weight"],
                                      first["state"]["0.wte.weight"])


@pytest.mark.parametrize("name", ["zbh1_vpp", "zbh1_uneven", "zbh1_zero3"])
def test_scope_refusals(runs, name):
    want = runs["jax_refusals"][name]
    assert want == "NotImplementedError"
    assert runs["port"]["refusals"][0][name][0] == want
