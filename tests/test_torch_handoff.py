"""The disaggregated handoff in the port (``ServingEngine.harvest_request``
/ ``adopt_request``, ``HostPage.from_layers`` / ``to_layers`` and
``testing.transport``) against its contracts and the JAX package's engine
(``tests/test_tp_decode.py``'s handoff, without tensor parallelism).

On the tiny GQA Llama in fp32, the same seeded numpy weights in both
packages (``torch_serving_twins``), held equal token for token:

- a request harvested after its first token from engine A and adopted by
  engine B continues the solo stream, on a native and an int8 pool, into
  a speculative engine, and when it holds prefix-cache pages (A's ledger
  balanced after);
- every refusal of both methods; the streaming callback left behind and
  re-bound at adoption;
- across packages: a JAX-harvested bundle converted through
  ``HostPage.from_layers`` and adopted by the port, and a port bundle
  converted through ``to_layers`` and adopted by the JAX engine, both
  equal to the JAX solo stream; a JAX page through ``from_layers``, the
  port's pool and ``spill_page`` back through ``to_layers`` equals the
  JAX ``spill_page`` bit for bit (native and int8), and bfloat16 layers
  convert bit for bit;
- transport: a port bundle survives a spawn byte for byte, and a spawned
  child's adoption continues the solo stream (native and int8); a
  device-backed tensor (a ``meta`` stand-in for a CUDA one) and a callable
  leaf are refused. Three spawns in all.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu.generation import serving as jserving
from paddle_tpu.kernels.paged_attention import HostPage as JHostPage
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.kernels.paged_attention import HostPage
from paddle_tpu_torch.testing import transport
from torch_serving_twins import tiny_llamas

PROMPT = np.array([1, 5, 9, 2, 7, 3, 3, 8, 4, 6, 2, 11], np.int32)
NEW = 8
ENGINE = dict(max_batch=4, max_seq_len=128, page_size=8)
SEED = 91                 # transport's child rebuilds this model


@pytest.fixture(scope="module")
def models():
    """The JAX/port tiny Llama pair, a draft pair, and the port's tiny
    Llama built from ``SEED`` as the transport child builds it."""
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    seeded = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                              generator=seed(SEED, "cpu"))
    return dict(pair=tiny_llamas(21), draft=tiny_llamas(22), seeded=seeded)


def _solo(cls, model, prompt=PROMPT, **kw):
    eng = cls(model, **{**ENGINE, **kw})
    rid = eng.submit(prompt, NEW)
    return eng.run()[rid]


def _midstream(eng, rid):
    """Step ``eng`` until request ``rid`` is seated past its prefill with
    at least one token."""
    for _ in range(64):
        eng.step()
        req = next((r for r in eng._slots
                    if r is not None and r.rid == rid), None)
        if (req is not None and req.tokens and req.prefill_pos is None
                and not req.pending):
            return req
    raise AssertionError("request never reached mid-stream state")


def _harvest(cls, model, prompt=PROMPT, on_token=None, **kw):
    eng = cls(model, **{**ENGINE, **kw})
    rid = eng.submit(prompt, NEW, on_token=on_token)
    _midstream(eng, rid)
    return eng, rid, eng.harvest_request(rid)


def _convert_request(req, cls):
    return cls(**{f.name: copy.deepcopy(getattr(req, f.name))
                  for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_harvest_adopt_bit_identical(models, kv_dtype):
    _, model = models["pair"]
    solo = _solo(tserving.ServingEngine, model, kv_dtype=kv_dtype)
    a, rid, bundle = _harvest(tserving.ServingEngine, model,
                              kv_dtype=kv_dtype)
    assert bundle["v"] == tserving.HANDOFF_SCHEMA_VERSION
    assert all(r is None or r.rid != rid for r in a._slots)
    assert a.pool.ledger()["pages_in_use"] == 0
    assert a.pool.ledger()["pages_spilled"] == 0
    assert len(bundle["pages"]) == -(-(len(PROMPT) + NEW) // 8)
    b = tserving.ServingEngine(model, kv_dtype=kv_dtype, **ENGINE)
    new_rid = b.adopt_request(bundle)
    assert b.run()[new_rid] == solo


def test_adopt_into_speculative_engine(models):
    _, model = models["pair"]
    _, draft = models["draft"]
    solo = _solo(tserving.ServingEngine, model)
    _, _, bundle = _harvest(tserving.ServingEngine, model)
    b = tserving.ServingEngine(model, draft_model=draft, **ENGINE)
    new_rid = b.adopt_request(bundle)
    assert b.run()[new_rid] == solo
    assert b.spec_rounds > 0


def test_harvest_with_prefix_cache_pages(models):
    _, model = models["pair"]
    second = np.concatenate([PROMPT[:8], PROMPT[8:][::-1]]).astype(np.int32)
    solo = _solo(tserving.ServingEngine, model, prompt=second)
    a = tserving.ServingEngine(model, prefix_cache=True, **ENGINE)
    a.submit(PROMPT, 2)
    a.run()
    rid = a.submit(second, NEW)
    req = _midstream(a, rid)
    assert req.pinned                      # it adopted a cached page
    bundle = a.harvest_request(rid)
    assert not bundle["request"].pinned
    # the pins went back: only the prefix cache holds pages now
    assert a._prefix.pinned_page_count() == 0
    assert a.pool.ledger()["pages_shared"] == 0
    assert a.pool.ledger()["pages_in_use"] == \
        a._prefix.evictable_page_count()
    b = tserving.ServingEngine(model, **ENGINE)
    new_rid = b.adopt_request(bundle)
    assert b.run()[new_rid] == solo


def test_callback_stripped_then_rebound(models):
    _, model = models["pair"]
    seen_a, seen_b = [], []
    a, rid, bundle = _harvest(tserving.ServingEngine, model,
                              on_token=lambda *ev: seen_a.append(ev))
    assert rid not in a._callbacks
    transport.export_payload_digests(bundle)   # no callable rides
    b = tserving.ServingEngine(model, **ENGINE)
    new_rid = b.adopt_request(bundle,
                              on_token=lambda *ev: seen_b.append(ev))
    toks = b.run()[new_rid]
    got = [ev[1] for ev in seen_b if ev[1] is not None]
    assert got == toks[len(toks) - len(got):] and len(got) >= 1


def test_harvest_refusals(models):
    _, model = models["pair"]
    eng = tserving.ServingEngine(model, prefill_chunk=8, **ENGINE)
    with pytest.raises(ValueError, match="not seated"):
        eng.harvest_request(12345)
    rid = eng.submit(PROMPT, NEW)              # 12 tokens: two chunks
    eng.step()
    assert eng._slots[0].prefill_pos is not None
    with pytest.raises(ValueError, match="mid-prefill"):
        eng.harvest_request(rid)
    _midstream(eng, rid)
    pools = eng.pool.take_pools()
    with pytest.raises(RuntimeError, match="detached"):
        eng.harvest_request(rid)
    eng.pool.install_pools(pools)
    eng.harvest_request(rid)


def test_harvest_refuses_sampled(models):
    _, model = models["pair"]
    _, draft = models["draft"]
    eng = tserving.ServingEngine(model, draft_model=draft, **ENGINE)
    rid = eng.submit(PROMPT, NEW, temperature=0.8, seed=3)
    eng.step()
    with pytest.raises(ValueError, match="sampled"):
        eng.harvest_request(rid)


def test_adopt_refusals(models):
    _, model = models["pair"]
    _, _, bundle = _harvest(tserving.ServingEngine, model)
    eng = tserving.ServingEngine(model, **ENGINE)
    with pytest.raises(ValueError, match="schema version"):
        eng.adopt_request({**bundle, "v": 0})
    int8 = tserving.ServingEngine(model, kv_dtype="int8", **ENGINE)
    with pytest.raises(ValueError, match="layout mismatch"):
        int8.adopt_request(bundle)
    short = copy.deepcopy(bundle)
    short["request"].prompt = PROMPT[:2]
    short["request"].max_new_tokens = 2
    with pytest.raises(ValueError, match="span only needs"):
        eng.adopt_request(short)
    assert eng.pool.ledger()["pages_in_use"] == 0
    full = tserving.ServingEngine(model, **{**ENGINE, "max_batch": 1})
    full.submit(PROMPT, NEW)
    full.step()
    with pytest.raises(RuntimeError, match="no free slot"):
        full.adopt_request(bundle)
    pools = eng.pool.take_pools()
    with pytest.raises(RuntimeError, match="detached"):
        eng.adopt_request(bundle)
    eng.pool.install_pools(pools)


# ------------------------------------------------------ across packages
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_jax_bundle_adopted_by_port(models, kv_dtype):
    jmodel, model = models["pair"]
    jsolo = _solo(jserving.ServingEngine, jmodel, kv_dtype=kv_dtype)
    _, _, jb = _harvest(jserving.ServingEngine, jmodel, kv_dtype=kv_dtype)
    bundle = dict(jb, request=_convert_request(jb["request"],
                                               tserving.Request),
                  pages=[HostPage.from_layers(p.k, p.v, p.nbytes)
                         for p in jb["pages"]])
    eng = tserving.ServingEngine(model, kv_dtype=kv_dtype, **ENGINE)
    new_rid = eng.adopt_request(bundle)
    assert eng.run()[new_rid] == jsolo


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_port_bundle_adopted_by_jax(models, kv_dtype):
    jmodel, model = models["pair"]
    jsolo = _solo(jserving.ServingEngine, jmodel, kv_dtype=kv_dtype)
    _, _, tb = _harvest(tserving.ServingEngine, model, kv_dtype=kv_dtype)
    bundle = dict(tb, request=_convert_request(tb["request"],
                                               jserving.Request),
                  pages=[JHostPage(*p.to_layers(), p.nbytes)
                         for p in tb["pages"]])
    eng = jserving.ServingEngine(jmodel, kv_dtype=kv_dtype, **ENGINE)
    new_rid = eng.adopt_request(bundle)
    assert eng.run()[new_rid] == jsolo


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_layer_converters_round_trip_jax_pages(models, kv_dtype):
    jmodel, model = models["pair"]
    jeng = jserving.ServingEngine(jmodel, kv_dtype=kv_dtype, **ENGINE)
    jeng.submit(PROMPT, 2)
    jeng.run()
    # page 1: the first one the JAX engine allocated (0 is the null page)
    want = jeng.pool.spill_page(1)
    teng = tserving.ServingEngine(model, kv_dtype=kv_dtype, **ENGINE)
    teng.pool.adopt_page(HostPage.from_layers(want.k, want.v, want.nbytes),
                         3)
    got_k, got_v = teng.pool.spill_page(3).to_layers()
    for got, ref in ((got_k, want.k), (got_v, want.v)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            for gp, rp in zip(g if kv_dtype == "int8" else (g,),
                              r if kv_dtype == "int8" else (r,)):
                rp = np.asarray(rp)
                assert gp.dtype == rp.dtype and gp.shape == rp.shape
                np.testing.assert_array_equal(gp, rp)


# -------------------------------------------------------------- transport
def test_spawn_roundtrip_and_child_decode(models):
    model = models["seeded"]
    solo = _solo(tserving.ServingEngine, model)
    _, _, bundle = _harvest(tserving.ServingEngine, model)
    report = transport.assert_bundle_transportable(bundle)
    # k and v of each page, and the prompt
    assert report.n_arrays == 2 * len(bundle["pages"]) + 1
    assert transport.adopt_and_decode_in_child(
        bundle, model_seed=SEED, engine_kw=ENGINE, device="cpu") == solo


def test_spawn_child_decode_int8(models):
    model = models["seeded"]
    solo = _solo(tserving.ServingEngine, model, kv_dtype="int8")
    _, _, bundle = _harvest(tserving.ServingEngine, model, kv_dtype="int8")
    assert transport.adopt_and_decode_in_child(
        bundle, model_seed=SEED,
        engine_kw=dict(ENGINE, kv_dtype="int8"), device="cpu") == solo


@pytest.mark.parametrize("leaf,what", [
    (torch.zeros(2, device="meta"), "device-backed"),
    (lambda: None, "callable")])
def test_untransportable_leaves_refused(models, leaf, what):
    _, _, bundle = _harvest(tserving.ServingEngine, models["pair"][1])
    bundle["extra"] = leaf
    with pytest.raises(AssertionError, match=what):
        transport.assert_bundle_transportable(bundle)


def test_layer_converters_carry_bf16_bits():
    import ml_dtypes
    rng = np.random.default_rng(4)
    layers = [rng.standard_normal((2, 8, 16)).astype(ml_dtypes.bfloat16)
              for _ in range(3)]
    page = HostPage.from_layers(layers, layers[::-1], 123)
    assert page.k[0].dtype == torch.bfloat16
    assert page.k[0].shape == (3, 2, 8, 16)
    k, v = page.to_layers()
    for got, want in zip(k + v, layers + layers[::-1]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint16),
                                      want.view(np.uint16))
