"""The PyTorch port's ServingEngine against the JAX package's.

Both engines serve the same tiny GQA Llama (JAX weights carried into the
port) with the same staggered admission: two requests up front, more
submitted while the first decode, and a batch of two slots so later
requests wait for freed slots and recycle freed pages. The greedy token
streams must be identical, with fused block decode and with the generic
decode, at tp = 1 and tensor-parallel at tp = 2. Every option the port
does not serve yet raises ``NotImplementedError`` (sampling the JAX engine's ``ValueError``: it needs
a speculative engine); the quantized options (int8 KV pool, int4
weights) are taken, and a value no version serves raises ``ValueError``. (Chunked prefill and N-layer decode have their
own files, ``test_torch_chunk_prefill.py`` and
``test_torch_nlayer_decode.py``; the scheduler, the request surface and
the bucket ladder ``test_torch_serving_sched.py``.)
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.generation.serving import ServingEngine as JServingEngine
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.generation.serving import ServingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

ENGINE = dict(max_batch=2, page_size=8, max_seq_len=32)
PROMPT_LENS = (5, 9, 13, 7, 16)
NEW = 6


@pytest.fixture(scope="module")
def models():
    paddle.seed(91)
    jmodel = JLlamaForCausalLM(JLlamaConfig.tiny())
    params, _ = jmodel.raw_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_numpy_state({k: np.asarray(v) for k, v in params.items()})
    return jmodel, model


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in PROMPT_LENS]


def _drive(eng):
    """Staggered admission; returns the token streams in submit order."""
    ps = _prompts()
    rids = [eng.submit(ps[0], NEW), eng.submit(ps[1], NEW)]
    eng.step()
    eng.step()
    rids += [eng.submit(ps[2], NEW), eng.submit(ps[3], NEW)]
    eng.step()
    rids.append(eng.submit(ps[4], NEW))
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_token_streams_identical_to_jax(models, fused):
    jmodel, model = models
    old = jflags.get_flag("fused_block_decode")
    jflags.set_flags({"fused_block_decode": fused})
    try:
        jeng = JServingEngine(jmodel, **ENGINE)
        assert (jeng._fused_spec() is not None) == fused
        want = _drive(jeng)
    finally:
        jflags.set_flags({"fused_block_decode": old})
    tflags.set_flags({"fused_block_decode": fused})
    try:
        eng = ServingEngine(model, **ENGINE)
        assert (eng._spec is not None) == fused
        got = _drive(eng)
    finally:
        tflags.reset_flags()
    assert all(len(t) == NEW for t in got)
    assert got == want
    # every page went back to the pool (the null page stays reserved)
    assert eng.pool.free_page_count() == eng.pool.num_pages - 1


def test_record_logits_and_probes(models):
    _, model = models
    eng = ServingEngine(model, record_logits=True, **ENGINE)
    ps = _prompts()[:2]
    rids = [eng.submit(p, 3) for p in ps]
    out = eng.run()
    for r in rids:
        rows = eng.logits[r]
        assert len(rows) == 3
        assert [int(np.argmax(row)) for row in rows] == out[r]
    assert len(eng.ttft_seconds) == 2 and len(eng.prefill_seconds) == 2
    assert len(eng.decode_step_seconds) >= 2


def test_eos_stops_a_request(models):
    _, model = models
    eng = ServingEngine(model, **ENGINE)
    p = _prompts()[0]
    rid = eng.submit(p, NEW)
    first = eng.run()[rid]
    rid = eng.submit(p, NEW, eos_token_id=first[1])
    assert eng.run()[rid] == first[:first.index(first[1]) + 1]


@pytest.mark.parametrize("kwargs,what", [
    (dict(draft_model=object()), "draft_model"),
])
def test_unported_engine_options_raise(models, kwargs, what):
    _, model = models
    args = dict(ENGINE, **kwargs)
    with pytest.raises(NotImplementedError, match=what):
        ServingEngine(model, **args)


@pytest.mark.parametrize("kwargs", [dict(kv_dtype="int8"),
                                    dict(weight_dtype="int4")],
                         ids=["kv_dtype-int8", "weight_dtype-int4"])
def test_quantized_engine_options_are_taken(models, kwargs):
    _, model = models
    eng = ServingEngine(model, **ENGINE, **kwargs)
    for name, value in kwargs.items():
        assert getattr(eng, name) == value
    assert eng.pool.kv_dtype == eng.kv_dtype


@pytest.mark.parametrize("name", ["kv_dtype", "weight_dtype"])
def test_unknown_quantized_engine_options_raise(models, name):
    _, model = models
    with pytest.raises(ValueError, match=name):
        ServingEngine(model, **ENGINE, **{name: "fp8"})


@pytest.mark.parametrize("kwargs,what", [
    (dict(temperature=0.7), "sampling"),
])
def test_unported_request_options_raise(models, kwargs, what):
    """Sampling needs a speculative engine, in the port as in the JAX
    package: both raise the same ValueError."""
    jmodel, model = models
    eng = ServingEngine(model, **ENGINE)
    with pytest.raises(ValueError, match="speculative engine") as got:
        eng.submit(_prompts()[0], 2, **kwargs)
    jeng = JServingEngine(jmodel, **ENGINE)
    with pytest.raises(ValueError) as want:
        jeng.submit(_prompts()[0], 2, **kwargs)
    assert str(got.value) == str(want.value)


def test_prompt_longer_than_prefill_chunk_raises(models):
    """A prompt longer than the chunk is served chunk by chunk; what still
    raises is a prompt past the engine's length or a negative chunk."""
    _, model = models
    eng = ServingEngine(model, prefill_chunk=8, **ENGINE)
    rid = eng.submit(_prompts()[1], 2)
    assert len(eng.run()[rid]) == 2 and eng.chunk_dispatches == 2
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(np.zeros(30, np.int32), 3)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(model, prefill_chunk=-1, **ENGINE)
    # prefill_chunk=0 turns chunking off: every prompt prefills whole
    eng = ServingEngine(model, prefill_chunk=0, **ENGINE)
    rid = eng.submit(_prompts()[4], 2)
    assert len(eng.run()[rid]) == 2 and eng.chunk_dispatches == 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_tensor_parallel_engine_matches_jax(models, fused):
    """``tp_degree=2`` (the port's shards on one device, JAX's on two host
    devices): the staggered streams equal the JAX engine's at tp = 2 and
    the port's at tp = 1."""
    jmodel, model = models
    jflags.set_flags({"fused_block_decode": fused})
    tflags.set_flags({"fused_block_decode": fused})
    try:
        want = _drive(JServingEngine(jmodel, tp_degree=2, **ENGINE))
        eng = ServingEngine(model, tp_degree=2, **ENGINE)
        got = _drive(eng)
        solo = _drive(ServingEngine(model, **ENGINE))
    finally:
        jflags.set_flags({"fused_block_decode": True})
        tflags.reset_flags()
    assert got == want == solo
    assert ("tp", 2) in eng.decode_key.extra


def test_tp_degree_flag_value_is_taken(models):
    _, model = models
    tflags.set_flags({"serving_tp_degree": 2})
    try:
        assert tflags.get_flag("serving_tp_degree") == 2
        assert ServingEngine(model, **ENGINE).tp_degree == 2
    finally:
        tflags.reset_flags()
    with pytest.raises(ValueError, match="serving_tp_degree"):
        tflags.set_flags({"serving_tp_degree": 0})


@pytest.mark.parametrize("flag,value", [("fused_weight_dtype", "int4"),
                                        ("serving_kv_dtype", "int8")])
def test_quantized_flag_values_are_taken(flag, value):
    tflags.set_flags({flag: value})
    try:
        assert tflags.get_flag(flag) == value
    finally:
        tflags.reset_flags()


@pytest.mark.parametrize("flag", ["fused_weight_dtype", "serving_kv_dtype"])
def test_unknown_quantized_flag_values_raise(flag):
    with pytest.raises(ValueError, match=flag):
        tflags.set_flags({flag: "fp8"})
    assert tflags.get_flag(flag) == "native"


def test_flags_read_environment(monkeypatch):
    monkeypatch.setenv("FLAGS_fused_block_decode", "0")
    assert tflags.get_flag("fused_block_decode") is False
    monkeypatch.setenv("FLAGS_serving_prefill_chunk", "64")
    assert tflags.get_flag("FLAGS_serving_prefill_chunk") == 64
    monkeypatch.setenv("FLAGS_fused_block_layers", "4")
    assert tflags.get_flag("fused_block_layers") == 4
    monkeypatch.setenv("FLAGS_fused_weight_dtype", "int4")
    assert tflags.get_flag("fused_weight_dtype") == "int4"
    monkeypatch.setenv("FLAGS_serving_kv_dtype", "fp8")
    with pytest.raises(ValueError):
        tflags.get_flag("serving_kv_dtype")
    with pytest.raises(KeyError):
        tflags.get_flag("use_pallas")


def test_generic_decode_on_paged_state_only(models):
    _, model = models
    ids = torch.zeros((1, 3), dtype=torch.int64)
    with pytest.raises(NotImplementedError):
        model.forward_with_cache(ids, [(torch.zeros(1), torch.zeros(1))] * 2,
                                 0)
