"""Speculative decoding and sampling in the port's ServingEngine against
the JAX package's (``tests/test_spec_decode.py``'s contracts, on Llama).

Both packages serve the tiny GQA Llama of ``torch_serving_twins`` in fp32
from the same seeded numpy weights, with drafts built the same way: a
divergent draft of the same shape, a half-width one-layer draft, an
all-zero draft (it proposes token 0 forever) and the target as its own
draft (it always agrees), on one fake host clock. Held equal, exactly:

- greedy streams: the port's speculative engine against the JAX spec
  engine's, the port's plain engine's and the JAX model's solo decode,
  on the fused route and the generic one (``FLAGS_fused_block_decode=0``),
  native and int8 pools, through chunked prefill, bucket migration,
  preemption, prefix-cache hits, injected ``spec_draft`` / ``spec_verify``
  faults, an EOS inside a burst, occupancy pricing and a request that
  fills the whole table (``prompt + max_new_tokens == max_seq_len``);
- what the schedule observes: ``spec_rounds``, tokens accepted and
  rejected, every round's (request, γ), the statuses and the spec metric
  families, against the JAX engine's;
- sampled mode: the filtered law against the JAX package's
  ``_spec_filtered_probs`` (1e-6 abs, f32), ``_spec_accept_sample`` bit for
  bit, the emitted law against the analytic target law (TV < 0.12 over
  400 seeds), the same seed giving the same tokens (also under faults),
  and greedy rows beside a sampled one keeping their stream. The draft's
  draws come from torch uniforms, not ``jax.random``'s bits, so sampled
  streams are not compared across packages;
- the draft pool's table, which has room for a round past the longest
  span: such a round's writes land on the null page.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.generation import serving as jserving
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.generation import sampling as tsampling
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.generation.program_cache import decode_program_cache
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.testing import faults as tfaults
from torch_serving_twins import (both_flags, clocked, patch_clock, solo,
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


# ------------------------------------------------------- greedy parity
SCENARIOS = {
    # name: (script, engine kwargs, flags)
    "fused": (_submit_run((5, 8, 13), 10), {}, {}),
    "generic": (_submit_run((5, 8, 13), 10), {},
                dict(fused_block_decode=False)),
    "int8": (_submit_run((5, 8, 13), 10), dict(kv_dtype="int8"), {}),
    "int8-generic": (_submit_run((5, 8, 13), 10), dict(kv_dtype="int8"),
                     dict(fused_block_decode=False)),
    "chunked": (_submit_run((40, 7), 12, head=1, stagger=1),
                dict(max_seq_len=128, prefill_chunk=16), {}),
    "migration": (_submit_run((6, 9, 5, 7), 8, stagger=3),
                  dict(max_batch=4, bucket_ladder=(2, 4)), {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_greedy_streams_and_schedule_match_jax(models, clock, name):
    script, kw, flags = SCENARIOS[name]
    got = _hold(models, clock, script, flags=flags, **kw)
    assert got["spec_rounds"] > 0
    assert got["families"]["serving_spec_rounds"] == got["spec_rounds"]
    if name == "migration":
        assert got["migrations"] >= 1


def test_draft_key_names_route_and_mode(models, clock):
    def script(eng):
        _submit_run((5,), 6, head=1)(eng)
        return dict(draft=eng.spec_draft_key, verify=eng.spec_verify_key)
    for fused, route in ((True, "fused"), (False, "generic")):
        want, got = _both(models, clock, script,
                          flags=dict(fused_block_decode=fused))
        for k in ("draft", "verify"):
            assert got[k].kind == want[k].kind
            assert got[k].extra == want[k].extra
            assert got[k].batch_bucket == want[k].batch_bucket == 1
        assert got["verify"].page_budget == want["verify"].page_budget
        # the port's draft table has room for a round past the longest span
        assert got["draft"].page_budget[:2] == want["draft"].page_budget[:2]
        assert got["draft"].page_budget[2] == -(-(64 + 8 + 1) // PAGE)
        assert route in got["draft"].extra
        assert got["draft"].extra[:1] == (got["rounds"][-1][1],)


def test_one_program_per_key_shared_across_engines(models, clock):
    cache = decode_program_cache()
    _plain(models, clock, _submit_run((5,), 1, head=1))  # warm the target
    _both(models, clock, _submit_run((5, 8), 6))
    keys = set(cache.keys())
    traces = {k: cache.trace_count(k) for k in keys}
    _both(models, clock, _submit_run((5, 8), 6))
    assert set(cache.keys()) == keys
    assert {k: cache.trace_count(k) for k in keys} == traces
    kinds = {k.kind for k in keys}
    assert {"spec_draft", "spec_verify", "prefill_chunk"} <= kinds


def _preempt_script(eng):
    rng = np.random.default_rng(3)
    ps = [tokens(rng, n) for n in (5, 9, 6)]
    rids = [eng.submit(ps[0], 10), eng.submit(ps[1], 10)]
    for _ in range(4):
        eng.step()
    rids.append(eng.submit(ps[2], 4, deadline=0.5))
    out = eng.run(max_wall=300.0)
    return dict(streams=[out[r] for r in rids],
                statuses=[eng.status(r) for r in rids],
                preemptions=eng.preemptions)


def test_preemption_replays_the_draft(models, clock):
    """A tight arrival unseats a speculating request: its draft span goes
    back with its slot, and its replay re-syncs the draft."""
    got = _hold(models, clock, _preempt_script,
                flags=dict(serving_spec_max_slots=16))
    assert got["preemptions"] == 1


def _prefix_script(eng):
    rng = np.random.default_rng(4)
    shared = tokens(rng, 2 * PAGE)
    ps = [np.concatenate([shared, tokens(rng, n)]) for n in (3, 5, 9)]
    rids = [eng.submit(ps[0], 8)]
    out = eng.run(max_wall=300.0)
    rids += [eng.submit(p, 8) for p in ps[1:]]
    out.update(eng.run(max_wall=300.0))
    return dict(streams=[out[r] for r in rids],
                statuses=[eng.status(r) for r in rids[1:]],
                cached_pages=len(eng._prefix._nodes))


def test_prefix_hits_keep_the_plain_stream(models, clock):
    """Hits adopt cached pages and teacher-force their suffix through the
    plain step (a pending row keeps the step plain); speculation takes
    over once the suffix is fed."""
    got = _hold(models, clock, _prefix_script, prefix_cache=True)
    assert got["cached_pages"] >= 2


@pytest.mark.parametrize("spec", ["spec_draft:every=3",
                                  "spec_verify:every=4",
                                  "spec_draft:every=5;spec_verify:every=3"])
def test_spec_faults_replay_the_same_streams(models, clock, spec):
    def script(eng):
        out = _submit_run((5, 8, 13), 10)(eng)
        if eng.draft_model is not None:
            out["fires"] = [(s.calls, s.fires) if s.armed else None
                            for s in (eng._f_spec_draft,
                                      eng._f_spec_verify)]
            out["attached"] = all(k is not None
                                  for k in eng._draft_pool.k_pages)
        return out
    got = _hold(models, clock, script, spec=spec,
                flags=dict(serving_max_retries=20))
    assert got["attached"] and any(f and f[1] for f in got["fires"])


def test_divergent_draft_rejects(models, clock):
    got = _hold(models, clock, _submit_run((7,), 16, head=1), draft="narrow")
    assert got["rejected"] > 0


def test_zero_draft_falls_and_agreeing_draft_climbs(models, clock):
    flags = dict(serving_spec_max_slots=16)
    zero = _hold(models, clock, _submit_run((6,), 32, head=1), draft="zero",
                 flags=flags, max_batch=4, max_seq_len=96)
    gammas = [g for _, g in zero["rounds"]]
    assert max(gammas) <= 4 and gammas[-1] == 2
    assert zero["rejected"] > zero["accepted"]
    same = _hold(models, clock, _submit_run((6,), 48, head=1), draft="same",
                 flags=flags, max_batch=4, max_seq_len=96)
    assert max(g for _, g in same["rounds"]) == 8
    assert same["rejected"] == 0


def test_occupancy_prices_speculation_out(models, clock):
    """4 rows at γ + 1 = 3 slots each exceed max(max_batch, 3) = 4: the
    full batch decodes plain, so speculation serves fewer than all
    tokens."""
    got = _hold(models, clock, _submit_run((6, 6, 6, 6), 8, head=4),
                max_batch=4)
    total = sum(len(t) for t in got["streams"])
    assert 0 < got["accepted"] + got["spec_rounds"] < total


def test_eos_inside_a_burst_truncates(models, clock):
    """The target as its own draft accepts whole bursts: an EOS picked
    inside one ends the stream exactly where the plain engine does."""
    jmodel = models["target"][0]
    rng = np.random.default_rng(4)
    for _ in range(40):
        p = tokens(rng, 6)
        ref = solo(jmodel, p, 12)
        inner = [i for i in range(2, len(ref) - 1) if ref[i] not in ref[:i]]
        if inner:
            eos = ref[inner[0]]
            break
    else:
        pytest.fail("no prompt with an interior EOS candidate")

    def script(eng):
        rid = eng.submit(p, 12, eos_token_id=eos)
        out = eng.run(max_wall=300.0)
        return dict(streams=[out[rid]], statuses=[eng.status(rid)])
    got = _hold(models, clock, script, draft="same")
    assert got["streams"] == [ref[:ref.index(eos) + 1]]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_table_end_request(models, clock, fused):
    """prompt + max_new_tokens == max_seq_len (a whole number of pages):
    the last rounds' draft scans run past the slot's span (onto the draft
    table's null-page columns) and the verifies past the target's table
    (whose chunk writes drop)."""
    got = _hold(models, clock, _submit_run((22, 10), 10, head=2),
                flags=dict(fused_block_decode=fused), max_seq_len=32)
    assert got["spec_rounds"] > 0


def test_streams_equal_the_jax_model(models, clock):
    jmodel = models["target"][0]
    rng = np.random.default_rng(1)
    ps = [tokens(rng, n) for n in (5, 8, 13)]
    _, got = _both(models, clock, _submit_run((5, 8, 13), 10))
    assert got["streams"] == [solo(jmodel, p, 10) for p in ps]


# --------------------------------------------------------- construction
def test_engine_refusals(models):
    target, draft = models["target"][1], models["draft"][1]
    plain = tserving.ServingEngine(target, max_batch=2, page_size=PAGE,
                                   max_seq_len=64)
    with pytest.raises(ValueError, match="speculative engine"):
        plain.submit(np.arange(3, dtype=np.int32), 2, temperature=0.5)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tserving.ServingEngine(target, max_batch=2, page_size=PAGE,
                               max_seq_len=256, draft_model=draft)
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        tserving.ServingEngine(target, max_batch=2, page_size=PAGE,
                               max_seq_len=64, draft_model=draft,
                               tp_degree=2)
    eng = tserving.ServingEngine(target, max_batch=2, page_size=PAGE,
                                 max_seq_len=64, draft_model=draft)
    pool = eng._draft_pool
    assert pool.num_pages == 1 + 2 * (64 // PAGE) and pool.reserved_null_page
    assert (eng.spec_rungs, eng.spec_gamma_default, eng.spec_slots,
            eng.spec_sync_chunk) == ((2, 4, 8), 4, 3, 64)


# -------------------------------------------------------------- sampling
@pytest.mark.parametrize("top_k,top_p,temperature", [
    (0, 1.0, 1.0), (4, 1.0, 0.8), (50, 0.95, 0.8), (0, 0.5, 1.3),
    (1, 0.9, 0.7), (8, 0.0, 1.0)])
def test_filtered_probs_match_jax(top_k, top_p, temperature):
    rng = np.random.default_rng(top_k + int(100 * top_p))
    rows = (rng.standard_normal((5, 256)) * 3).astype(np.float32)
    rows[0, :12] = rows[0, 3]                  # ties at the threshold
    want = np.asarray(jserving._spec_filtered_probs(
        jnp.asarray(rows), jnp.float32(temperature), top_k,
        jnp.float32(top_p)))
    got = tsampling._spec_filtered_probs(
        torch.from_numpy(rows), torch.tensor([temperature]), top_k,
        torch.tensor([top_p])).numpy()
    assert np.abs(got - want).max() <= 1e-6


def _laws(rng, rows, vocab=64, keep=8):
    x = np.zeros((rows, vocab), np.float32)
    for r in range(rows):
        idx = rng.choice(vocab, keep, replace=False)
        x[r, idx] = rng.dirichlet(np.ones(keep)).astype(np.float32)
    return x


@pytest.mark.parametrize("seed", range(6))
def test_accept_sample_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    gamma = (2, 4, 8)[seed % 3]
    q, p = _laws(rng, gamma), _laws(rng, gamma + 1)
    props = np.array([rng.choice(64, p=row / row.sum()) for row in q])
    if seed % 2:
        p[:gamma] = q                          # an agreeing target
    req_j = jserving.Request(0, np.zeros(2, np.int32), 8, seed=seed)
    req_t = tserving.Request(0, np.zeros(2, np.int32), 8, seed=seed)
    for L in (3, 17):
        want = jserving.ServingEngine._spec_accept_sample(
            None, req_j, L, gamma, props, q, p)
        got = tserving.ServingEngine._spec_accept_sample(
            None, req_t, L, gamma, props, q, p)
        assert got == want


def test_race_sample_draws_the_law():
    q = torch.tensor([0.1, 0.2, 0.7, 0.0]).expand(100000, 4)
    u = torch.rand(q.shape, generator=torch.Generator().manual_seed(0))
    freq = torch.bincount(tsampling.race_sample(q, u), minlength=4) / 1e5
    assert float((freq - q[0]).abs().max()) < 0.01 and freq[3] == 0


def _sampled(models, prompt, new, seed, spec="", **law):
    with tfaults.armed(spec, serving_retry_backoff=0.001,
                       serving_max_retries=20):
        eng = tserving.ServingEngine(
            models["target"][1], max_batch=2, page_size=PAGE, max_seq_len=64,
            draft_model=models["draft"][1])
    rid = eng.submit(prompt, new, seed=seed, **law)
    out = eng.run(max_wall=300.0)[rid]
    fires = sum(s.fires for s in (eng._f_spec_draft, eng._f_spec_verify)
                if s.armed)
    return out, fires


def test_sampled_same_seed_same_tokens_also_under_faults(models):
    p = np.array([3, 5, 7, 11, 2, 9], np.int32)
    law = dict(temperature=0.8, top_k=16, top_p=0.95)
    a, _ = _sampled(models, p, 12, 5, **law)
    b, _ = _sampled(models, p, 12, 5, **law)
    c, _ = _sampled(models, p, 12, 6, **law)
    assert a == b and a != c and len(a) == 12
    faulted, fires = _sampled(
        models, p, 12, 5, spec="spec_draft:every=3;spec_verify:every=4",
        **law)
    assert fires > 0 and faulted == a


def test_sampled_replay_without_progress_fails_like_jax(models, clock):
    """A sampled replay emits nothing at its prefill (the verify samples
    that position), and once its draft needs two sync chunks an unbounded
    ``spec_draft:every=3`` fires within every replay: no progress, so the
    request ends FAILED in both engines, and a bounded spec serves it."""
    p = tokens(np.random.default_rng(0), 70)

    def script(eng):
        rid = eng.submit(p, 12, temperature=0.8, top_k=16, seed=3)
        out = eng.run(max_wall=300.0)
        return dict(status=eng.status(rid), tokens=len(out[rid]))
    for spec, status in (("spec_draft:every=3", "FAILED"),
                         ("spec_draft:every=3:times=2", "OK")):
        want, got = _both(models, clock, script, spec=spec, max_batch=1,
                          max_seq_len=128)
        assert got["status"] == want["status"] == status
        assert got["rounds"] == want["rounds"]


def test_rejection_sampling_emits_the_target_law(models):
    """The emitted token's law is the target's filtered softmax, whatever
    the (divergent) draft proposes: 400 single-token draws."""
    target = models["target"][1]
    p = np.array([3, 5, 7, 11, 2], np.int32)
    temp, top_k, n = 1.0, 4, 400
    with torch.no_grad():
        logits = target(torch.from_numpy(p[None].astype(np.int64)))
    lg = logits[0, -1].double().numpy() / temp
    lg = np.where(lg >= np.sort(lg)[-top_k], lg, -np.inf)
    expect = np.exp(lg - lg.max())
    expect /= expect.sum()
    eng = tserving.ServingEngine(target, max_batch=2, page_size=PAGE,
                                 max_seq_len=64,
                                 draft_model=models["draft"][1])
    counts = np.zeros(len(expect))
    for seed in range(n):
        rid = eng.submit(p, 1, temperature=temp, top_k=top_k, seed=seed)
        counts[eng.run()[rid][0]] += 1
    tv = 0.5 * np.abs(counts / n - expect).sum()
    assert tv < 0.12, (tv, np.nonzero(counts)[0].tolist())
    assert eng.spec_rounds == n


def test_mixed_batch_keeps_greedy_parity(models, clock):
    """A sampled row forces the step onto speculation; the greedy row
    beside it keeps the JAX spec engine's stream, and the sampled row
    parks its prefill one short (its first token is the verify's)."""
    rng = np.random.default_rng(6)
    pg, ps = tokens(rng, 6), tokens(rng, 5)

    def script(eng):
        rg = eng.submit(pg, 10)
        rs = eng.submit(ps, 10, temperature=1.0, top_k=8, seed=1)
        out = eng.run(max_wall=300.0)
        return dict(greedy=out[rg], sampled=len(out[rs]))
    want, got = _both(models, clock, script)
    assert got["greedy"] == want["greedy"] == solo(models["target"][0], pg,
                                                   10)
    assert got["sampled"] == 10


# ---------------------------------------------- writes past the span
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_draft_scan_past_the_span_lands_on_the_null_page(models, fused,
                                                         kv_dtype):
    """The draft pool's table has room for a round past the longest span:
    a γ = 8 scan from two tokens before the span's end writes those two
    into the slot's last page and the rest onto the null page, and leaves
    every other page as it was."""
    with both_flags(fused_block_decode=fused):
        eng = tserving.ServingEngine(
            models["target"][1], max_batch=2, page_size=PAGE,
            max_seq_len=32, draft_model=models["draft"][1],
            kv_dtype=kv_dtype)
    pool = eng._draft_pool
    assert pool.max_pages_per_seq == -(-(32 + 8 + 1) // PAGE)
    pool.allocate(0, 32)
    pool.allocate(1, 16)
    pool.seq_lens[0] = 30
    assert (pool.block_tables[0, 32 // PAGE:] == 0).all()
    before = [[p.clone() for p in tpa._parts(t)]
              for t in pool.k_pages + pool.v_pages]
    fn = eng._spec_draft_program(8, False, 0)
    (props, _), pairs = fn(np.array([[3]], np.int64),
                           pool.block_tables[0:1], pool.seq_lens[0:1],
                           pool.take_pools())
    pool.install_pools(pairs)
    assert props.shape == (8,)
    assert ((props >= 0) & (props < models["target"][1].config.vocab_size)
            ).all()
    last = int(pool.block_tables[0, 3])
    changed = set()
    for old, new in zip(before, pool.k_pages + pool.v_pages):
        for a, b in zip(old, tpa._parts(new)):
            pages = (a != b).movedim(1, 0).flatten(1).any(1)
            changed |= set(torch.nonzero(pages).flatten().tolist())
    assert changed == {0, last}


def test_draft_table_is_zero_past_each_span(models):
    """A span's allocation names pages for the span only: the table's
    spare columns stay on the null page through allocation, a move and
    a free."""
    eng = tserving.ServingEngine(
        models["target"][1], max_batch=2, page_size=PAGE, max_seq_len=32,
        draft_model=models["draft"][1])
    pool = eng._draft_pool
    pool.allocate(1, 32)
    assert (pool.block_tables[1, :4] > 0).all()
    assert (pool.block_tables[1, 4:] == 0).all()
    pool.move_sequence(1, 0)
    assert (pool.block_tables[0, 4:] == 0).all()
    pool.free_sequence(0)
    assert (pool.block_tables == 0).all()
