"""The pipeline across ranks (``PipelineTrainStep``, ``PipelineParallel``)
against the JAX package.

Each case trains a pipe model 3 AdamW steps (warmup/cosine, weight decay,
a global-norm clip that binds) in gloo ranks on the CPU, each rank holding
only its stage, from the JAX pipe's seeded weights
(``convert.pipe_state``). The JAX package runs its serial ``TrainStep`` on
the same pipe and batches: the reference pins its ``PipelineTrainStep`` to
that serial step (``tests/test_pipeline.py``, ``test_hybrid_3axis.py``).
The worlds are spawned once for the file: 2 ranks (Llama at pp = 2 under
FThenB, 1F1B with remat, the interleaved VPP at V = 2, the fleet facade
and the reference's validations), 4 ranks (tied GPT at pp = 4, 6 GPT
blocks over 4 stages, Llama pp = 2 x mp = 2 with ``tensor_parallel=True``)
and 8 ranks (the three-axis dp 2 x mp 2 x pp 2 model, plain and with
ZeRO-1 over dp).

- Per-step losses within 1e-5 relative of JAX's, on every rank.
- The stages gathered back (``convert.gather_pipe_state``: dp replicas and
  tied copies equal bit for bit) within 1e-5 of JAX's parameters; an
  element whose gradient sits near AdamW's eps may move by up to about lr
  instead: at most 1e-3 of the elements may, by at most 3 lr.
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401
import torch_pp_ranks as ranks
import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed.fleet.base_topology import (
    _reset_hcg, create_hybrid_communicate_group)
from paddle_tpu.distributed.fleet.meta_parallel import (
    PipelineParallel as JPipelineParallel)
from paddle_tpu.distributed.fleet.meta_parallel import (
    PipelineTrainStep as JPipelineTrainStep)
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLMPipe as JGPTPipe
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLMPipe as JLlamaPipe
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JGPTCrit
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JLlamaCrit
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.convert import gather_pipe_state
from paddle_tpu_torch.distributed import spawn

LR, CLIP = 1e-2, 0.5
TOL = 1e-5


def _batches(seed, vocab, b=8, s=16):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, vocab, (2, b, s)))
            for _ in range(3)]


def _jax_cfg(kind):
    if kind == "llama":
        c = JLlamaConfig.tiny()
        c.num_hidden_layers = 4
        return c
    return JGPTConfig(vocab_size=64, hidden_size=32,
                      num_hidden_layers=6 if kind == "gpt6" else 4,
                      num_attention_heads=2, intermediate_size=64,
                      max_position_embeddings=32, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)


def jax_pipe(kind):
    """The JAX pipe of ``kind`` and its loss_fn on raw arrays."""
    if kind == "tp3":
        import test_hybrid_3axis as t3
        return t3.build_pipe(), (lambda o, y: t3._ce(o, y))
    cfg = _jax_cfg(kind)
    if kind == "llama":
        paddle.seed(17)
        pipe, crit = JLlamaPipe(cfg, num_stages=2), JLlamaCrit(cfg)
    else:
        paddle.seed(19)
        pipe, crit = JGPTPipe(cfg, num_stages=4), JGPTCrit(cfg)
    return pipe, (lambda o, y: crit(JTensor(o), JTensor(y))._value)


BATCHES = {"llama": _batches(5, 256), "gpt4": _batches(6, 64),
           "gpt6": _batches(7, 64), "tp3": _batches(8, 64)}


def case_of(name, weights, pp, M, model=None, **kw):
    return dict(name=name, weights=weights, model=model or weights, pp=pp,
                M=M, lr=LR, clip=CLIP, batches=BATCHES[weights], **kw)


TWO = [case_of("fthenb", "llama", 2, 2, schedule="FThenB", remat=False),
       case_of("1f1b_remat", "llama", 2, 4, schedule="1F1B", remat=True),
       case_of("vpp", "llama", 2, 2, V=2),
       case_of("fleet", "llama", 2, 2, kind="fleet")]
FOUR = [case_of("gpt_tied_pp4", "gpt4", 4, 4, model="gpt"),
        case_of("gpt_uneven", "gpt6", 4, 4, model="gpt", layers=6),
        case_of("pp2_mp2", "llama", 2, 2, mp=2)]
EIGHT = [case_of("dp_mp_pp", "tp3", 2, 2, dp=2, mp=2),
         case_of("dp_mp_pp_zero1", "tp3", 2, 2, dp=2, mp=2, level=1,
               axis="dp")]
CASES = {c["name"]: c for c in TWO + FOUR + EIGHT}
REFUSALS = dict(name="refusals", kind="refusals", model="llama", pp=2,
                lr=LR, clip=CLIP)
P2P = dict(name="p2p", kind="p2p", pp=4)


def jax_weights(pipe):
    return {k: np.asarray(v, np.float32)
            for k, v in pipe.raw_state()[0].items()}


def jax_run(kind):
    """3 serial steps of the JAX pipe: (losses, parameters)."""
    pipe, loss_fn = jax_pipe(kind)
    sched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(LR, T_max=10), 2,
                             LR / 10, LR)
    opt = paddle.optimizer.AdamW(
        sched, parameters=pipe.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP))
    step = JTrainStep(pipe, opt, loss_fn=loss_fn)
    losses = [float(step(paddle.to_tensor(x.astype(np.int32)),
                         paddle.to_tensor(y.astype(np.int32))))
              for x, y in BATCHES[kind]]
    step.sync_to_model()
    return losses, jax_weights(pipe)


def jax_refusals():
    """The JAX PipelineTrainStep's validations on the same inputs."""
    _reset_hcg()
    hcg = create_hybrid_communicate_group(pp_degree=2)
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:      # the type is the result
            out[name] = type(e).__name__

    def step(layers=4, **kw):
        cfg = _jax_cfg("llama")
        cfg.num_hidden_layers = layers
        pipe = JLlamaPipe(cfg, num_stages=2)
        return JPipelineTrainStep(pipe, paddle.optimizer.AdamW(1e-3),
                                  hcg.get_mesh(), **kw)

    attempt("microbatches_below_stages", lambda: step(num_microbatches=1))
    attempt("virtual_below_one", lambda: step(num_microbatches=2,
                                              virtual_pp_degree=0))
    attempt("interleaved_not_divisible", lambda: step(
        num_microbatches=3, virtual_pp_degree=2))
    attempt("too_few_blocks", lambda: step(layers=3, num_microbatches=2,
                                           virtual_pp_degree=2))
    attempt("unknown_schedule", lambda: step(num_microbatches=2,
                                             schedule="GPipe"))
    attempt("not_a_pipeline", lambda: JPipelineParallel(object(), hcg))
    attempt("zbh1_vpp", lambda: step(num_microbatches=2,
                                     virtual_pp_degree=2, schedule="zbh1"))
    attempt("zbh1_uneven", lambda: step(layers=3, num_microbatches=2,
                                        schedule="zbh1"))
    attempt("zbh1_zero3", lambda: step(num_microbatches=2, schedule="zbh1",
                                       sharding_level=3))
    _reset_hcg()
    return out


@pytest.fixture(scope="module")
def runs():
    kinds = ("llama", "gpt4", "gpt6", "tp3")
    weights = {k: jax_weights(jax_pipe(k)[0]) for k in kinds}
    worlds = [spawn(ranks.pp_rank, args=(cases, weights), nprocs=n,
                    join=False)
              for n, cases in ((2, TWO + [REFUSALS]), (4, FOUR + [P2P]),
                               (8, EIGHT))]
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
    return dict(weights=weights, jax=jax, port=port,
                jax_refusals=refusals)


def gathered(rs, case):
    """The ranks' stages of ``case`` gathered into the reference's flat
    dict."""
    specs, aliases = {}, {}
    for r in rs:
        specs.update(r["specs"])
        aliases.update(r["aliases"])
    sizes = {"dp": case.get("dp", 1), "pp": case["pp"],
             "mp": case.get("mp", 1)}
    return gather_pipe_state([r["state"] for r in rs], specs,
                             [r["coords"] for r in rs], sizes, aliases)


def check_losses(rs, jl):
    for r in rs:     # every rank reports the global loss
        rel = np.abs(np.subtract(r["losses"], jl)) / np.abs(jl)
        assert rel.max() <= TOL, (r["coords"], r["losses"], jl)


def check_params(name, got, jp):
    assert sorted(got) == sorted(jp)
    off = total = 0
    for k, want in jp.items():
        assert got[k].shape == want.shape, k
        diff = np.abs(got[k].astype(np.float64) - want)
        assert diff.max() <= 3 * LR, (k, diff.max())
        off += int((diff > TOL).sum())
        total += diff.size
    print(f"{name}: {off} of {total} elements beyond {TOL}")
    assert off <= 1e-3 * total


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax(runs, name):
    check_losses(runs["port"][name], runs["jax"][CASES[name]["weights"]][0])


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c.get("kind", "train") == "train"])
def test_stage_draws_equal_a_whole_build(runs, name):
    """Before the JAX weights are loaded, each rank's entries (a tied
    copy too) hold what a whole build of the pipe draws for them: a
    stage's weights do not depend on which stage built them."""
    for r in runs["port"][name]:
        assert r["own_draws"], r["coords"]


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_params_match_jax(runs, name):
    check_params(name, gathered(runs["port"][name], CASES[name]),
                 runs["jax"][CASES[name]["weights"]][1])


def test_tied_embedding_takes_both_uses(runs):
    """The tied wte lives on stage 0 and, as a copy, on stage 3: the
    copies stay equal bit for bit (gather_pipe_state holds them so), and
    rows of wte no input reads moved (only the head's use reaches
    them)."""
    rs = runs["port"]["gpt_tied_pp4"]
    holders = {r["coords"]["pp"]: r for r in rs
               if any(k.endswith("wte.weight") for k in r["state"])}
    assert sorted(holders) == [0, 3]
    assert holders[3]["aliases"] == {"6.wte.weight": "0.wte.weight",
                                     "6.wpe.weight": None}
    np.testing.assert_array_equal(holders[0]["state"]["0.wte.weight"],
                                  holders[3]["state"]["6.wte.weight"])
    w0 = runs["weights"]["gpt4"]["0.wte.weight"]
    seen = {int(t) for x, _ in BATCHES["gpt4"] for t in x.reshape(-1)}
    unused = sorted(set(range(64)) - seen)
    assert unused
    moved = np.abs(holders[0]["state"]["0.wte.weight"][unused]
                   - w0[unused]).max()
    assert moved > 0


def test_uneven_split_places_reference_blocks(runs):
    """6 blocks over 4 stages: stage_block_counts [2, 2, 1, 1]; the
    embedding on stage 0, ln_f and the tied head on stage 3."""
    by_stage = {r["coords"]["pp"]: sorted({int(k.split(".")[0])
                                           for k in r["state"]})
                for r in runs["port"]["gpt_uneven"]}
    assert by_stage == {0: [0, 1, 2], 1: [3, 4], 2: [5], 3: [6, 7, 8]}


def test_tensor_parallel_stages_hold_their_shards(runs):
    """pp = 2 x mp = 2: each rank's decoder layers and head are its mp
    shards (heads over 2, vocabulary over 2)."""
    for r in runs["port"]["pp2_mp2"]:
        st = r["state"]
        if r["coords"]["pp"] == 0:
            assert st["0.embed_tokens.weight"].shape == (128, 64)
            assert st["1.self_attn.q_proj.weight"].shape == (64, 32)
        else:
            assert st["6.weight"].shape == (64, 128)
            assert st["4.mlp.down_proj.weight"].shape == (64, 64)


def test_fleet_facade(runs):
    """fleet.distributed_model at pp_degree = 2 is a PipelineParallel whose
    train_batch trains (its losses are the Llama cases'), eval_batch
    gives the global loss before and after (after within 1e-5 of the JAX
    pipe's eager loss on its trained weights) and the last stage's
    logits, state_dict round-trips, and a batch that is not M x
    micro_batch_size raises."""
    rs = runs["port"]["fleet"]
    jl, jp = runs["jax"]["llama"]
    pipe, loss_fn = jax_pipe("llama")
    pipe.load_raw_state(jp)
    x0, y0 = BATCHES["llama"][0]
    want_after = float(loss_fn(pipe(paddle.to_tensor(x0.astype(np.int32)))
                               ._value, y0.astype(np.int32)))
    for r in rs:
        assert r["wrapper"] == "PipelineParallel"
        assert r["restored"]
        assert r["errors"] == {"micro_batch_size": "ValueError"}
        assert abs(r["eval_before"] - jl[0]) <= TOL * jl[0]
        assert abs(r["eval_after"] - want_after) <= TOL * want_after
    last = [r for r in rs if r["coords"]["pp"] == 1][0]
    assert last["logits"].shape == (8, 16, 256)
    assert [r["logits"] for r in rs if r["coords"]["pp"] == 0] == [None]
    assert sorted(rs[0]["names"] + rs[1]["names"]) == sorted(jp)


def test_validations_raise_as_the_reference(runs):
    """Each validation raises the reference's exception type;
    abstract / param_dtype / lower() raise NotImplementedError saying
    why."""
    port = runs["port"]["refusals"][0]
    for name, want in runs["jax_refusals"].items():
        if name.startswith("zbh1"):     # tests/test_torch_zbh1.py
            continue
        assert want is not None, name
        assert port[name][0] == want, (name, port[name], want)
    for name in ("abstract", "param_dtype", "lower"):
        kind, msg = port[name]
        assert kind == "NotImplementedError" and "lower" in msg, msg


def test_state_bytes_are_the_stage(runs):
    """per_device_state_bytes: this rank's parameters, AdamW's two slots
    (f32 parameters: no masters); the stages of pp = 2 together hold the
    whole model once."""
    rs = runs["port"]["fthenb"]
    jp = runs["jax"]["llama"][1]
    whole = sum(v.size * 4 for v in jp.values())
    assert sum(r["state_bytes"]["params"] for r in rs) == whole
    for r in rs:
        b = r["state_bytes"]
        assert b["slots"] == 2 * b["params"] and b["master"] == 0
        assert b["total"] == 3 * b["params"]


def test_p2p_surface(runs):
    """pp_utils at pp = 4: recv_forward / recv_backward give the neighbour's
    tensor (None at the ends), the first send_forward sends the shape
    meta once, and each paired form is one batch of a send and a receive;
    sends and receives are counted (none staged on the CPU)."""
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    # (sends, receives) a stage: the first stage sends the meta, its
    # activation and the pair's; a middle one adds the backward and both
    # pairs; the last receives the meta and the activation
    want = {0: (3, 2), 1: (5, 5), 2: (5, 5), 3: (2, 3)}
    for r in runs["port"]["p2p"]:
        s = r["stage"]
        for key, val in (("recv_forward", base + s - 1),
                         ("paired_forward", base * 0 + 10 + s - 1)):
            if s == 0:
                assert r[key] is None
            else:
                np.testing.assert_array_equal(r[key], val)
        for key, val in (("recv_backward", base - s - 1),
                         ("paired_backward", base * 0 + 100 + s + 1)):
            if s == 3:
                assert r[key] is None
            else:
                np.testing.assert_array_equal(r[key], val)
        c = r["counts"]
        assert (c.get("send", 0), c.get("recv", 0)) == want[s], (s, c)
        assert "p2p_host_staged" not in c
