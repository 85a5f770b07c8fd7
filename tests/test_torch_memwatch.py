"""The port's memwatch against the JAX package's, on the CPU.

- Program capture: the same traffic through both packages' engines (the
  tiny Llama of ``torch_serving_twins`` on the fused and the generic
  route with a chunked prompt, and the tiny GPT) gives program rows of
  equal (kind, bucket, extra) and ``captures``; the JAX package's
  whole-prompt ``prefill`` program has no row here (the port's whole
  prefill is eager, not a cached program). The same batches through both
  ``TrainStep``s give equal ``train_step`` rows (one a batch signature;
  ``gradient_merge`` as extra). Two models' rows carry different model
  labels; telemetry off leaves nothing; memwatch off keeps the rest of
  telemetry; a failed measurement is counted and not raised.
- The estimator: every function returns exactly the JAX function's output
  over a grid (Llama-2-7B, Llama-2-70B with GQA and GPT-3 345M dims; bf16
  and int8 KV; ``tp`` 1 and 2; a draft; a host tier), and
  ``compare_program_rows`` gives the JAX findings on the same rows. None
  of it leans on the XLA memory numbers of ``tests/test_memwatch.py``.
- ``plan_fused_layers`` prices the Hopper kernel: the reference's keys, a
  scratch the same for every N, a verdict against the shared-memory limit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu import observability as jobs
from paddle_tpu.generation import serving as jserving
from paddle_tpu.generation.program_cache import \
    clear_decode_program_cache as jclear_cache
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu.kernels.paged_attention import PagedKVCache as JPagedKVCache
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JCriterion
from paddle_tpu.observability import memory as jmem
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.generation import serving as tserving
from paddle_tpu_torch.generation.program_cache import (
    clear_decode_program_cache, model_signature)
from paddle_tpu_torch.hapi import TrainStep
from paddle_tpu_torch.kernels.paged_attention import PagedKVCache
from paddle_tpu_torch.models import (GPTConfig, LlamaConfig,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.observability import memory as tmem
from paddle_tpu_torch.optimizer import AdamW
from torch_serving_twins import both_flags, tiny_gpts, tiny_llamas, tokens

ENGINE = dict(max_batch=4, page_size=8, max_seq_len=64, prefill_chunk=8,
              bucket_ladder=(2, 4))
# the JAX package's cached whole-prompt prefill (eager in the port)
JAX_ONLY_KINDS = {"prefill"}


@pytest.fixture(autouse=True)
def _memwatch_on():
    """Telemetry and memwatch on in both packages (the suite's conftest
    turns memwatch off), every registry, table and program cache empty."""
    prior = {k: jflags.get_flag(k) for k in ("telemetry", "memwatch")}
    on = {"telemetry": True, "memwatch": True}

    def clean():
        for obs in (jobs, tobs):
            obs.registry().clear()
            obs.tracer().clear()
        jmem.clear_program_table()
        tmem.clear_program_table()
        jclear_cache()
        clear_decode_program_cache()

    jflags.set_flags(on)
    tflags.set_flags(on)
    clean()
    yield
    jflags.set_flags(prior)
    tflags.reset_flags()
    clean()


@pytest.fixture(scope="module")
def llamas():
    return tiny_llamas(71)


@pytest.fixture(scope="module")
def gpts():
    return tiny_gpts(72)


def _traffic(eng):
    """Three prompts, one of 30 tokens (chunked at 8), one arriving late."""
    rng = np.random.default_rng(4)
    eng.submit(tokens(rng, 5), 4)
    eng.submit(tokens(rng, 30), 4)
    eng.step()
    eng.submit(tokens(rng, 9), 4)
    return eng.run()


def _rows(mem, drop=()):
    return sorted((r["kind"], r["bucket"], r["extra"], r["captures"])
                  for r in mem.program_table() if r["kind"] not in drop)


def _serve_both(jmodel, model, **flag_kw):
    # both_flags resets the port's flags on its way out: memwatch rides it
    for cls, mdl in ((jserving.ServingEngine, jmodel),
                     (tserving.ServingEngine, model)):
        with both_flags(telemetry=True, memwatch=True, **flag_kw):
            _traffic(cls(mdl, **ENGINE))
    tflags.set_flags({"telemetry": True, "memwatch": True})


# ------------------------------------------------------- program capture
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_engine_rows_match_jax(llamas, fused):
    _serve_both(*llamas, fused_block_decode=fused)
    got, want = _rows(tmem), _rows(jmem, JAX_ONLY_KINDS)
    assert got == want
    kinds = {r[0] for r in got}
    assert kinds == {"decode_fused" if fused else "decode_generic",
                     "prefill_chunk"}
    assert "prefill" in {r["kind"] for r in jmem.program_table()}
    _, model = llamas
    sig = model_signature(model)[:8]
    for r in tmem.program_table():
        assert r["model"] == sig
        assert r["temp"] == 0                 # the CPU: no private pool
        assert r["alias"] > 0 and r["argument"] > r["alias"]
        assert r["peak"] == (r["argument"] + r["output"] - r["alias"]
                             + r["temp"] + r["generated_code"])


def test_gpt_rows_match_jax_and_do_not_collide(llamas, gpts):
    _serve_both(*gpts)
    assert _rows(tmem) == _rows(jmem, JAX_ONLY_KINDS)
    _serve_both(*llamas)
    assert _rows(tmem) == _rows(jmem, JAX_ONLY_KINDS)
    labels = {r["model"] for r in tmem.program_table()}
    assert labels == {model_signature(llamas[1])[:8],
                      model_signature(gpts[1])[:8]}
    fam = tobs.snapshot()["metrics"]["program_memory_bytes"]
    assert {s["labels"]["model"] for s in fam["series"]} == labels
    # both models' rows of one (kind, bucket, extra) live side by side
    by_key = {}
    for r in tmem.program_table():
        by_key.setdefault((r["kind"], r["bucket"], r["extra"]), []).append(
            r["argument"])
    shared = [v for v in by_key.values() if len(v) == 2]
    assert shared and all(v[0] != v[1] for v in shared)    # the chunk
    assert tmem.section()["programs"] == tmem.program_table()


def test_rows_count_every_engine_capture_and_build_once(llamas):
    """A second engine over the same model reuses the cached programs on
    the CPU: no new capture (the card captures one graph an engine)."""
    _, model = llamas
    for _ in range(2):
        _traffic(tserving.ServingEngine(model, **ENGINE))
    assert all(r["captures"] == 1 for r in tmem.program_table())


def _batches():
    rng = np.random.default_rng(6)
    out = []
    for b in (4, 4, 2):
        ids = rng.integers(0, 256, (b, 17))
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


@pytest.mark.parametrize("merge", [1, 2], ids=["plain", "gradient_merge"])
def test_train_step_rows_match_jax(llamas, merge):
    jmodel, model = llamas
    jstep = JTrainStep(jmodel, paddle.optimizer.AdamW(
        1e-3, parameters=jmodel.parameters()),
        loss_fn=JCriterion(JLlamaConfig.tiny()), gradient_merge_k=merge)
    step = TrainStep(model, AdamW(1e-3, parameters=model.named_parameters()),
                     loss_fn=LlamaPretrainingCriterion(LlamaConfig.tiny()),
                     gradient_merge_k=merge)
    for x, y in _batches():
        jstep(paddle.to_tensor(x.astype(np.int32)),
              paddle.to_tensor(y.astype(np.int32)))
        step(torch.from_numpy(x), torch.from_numpy(y))
    jstep.sync()
    jstep.sync_to_model()
    step.sync()
    assert _rows(tmem) == _rows(jmem)
    assert {r["bucket"] for r in tmem.program_table()} == {4, 2}
    assert step.trace_count == jstep.trace_count == 2
    snap = tobs.snapshot()["metrics"]
    assert snap["train_step_traces"]["series"][0]["value"] == 2
    row = tmem.program_table()[0]
    assert row["model"] == model_signature(model)[:8]
    assert row["extra"] == ("gradient_merge" if merge > 1 else "")
    # the parameters and AdamW's two slots a parameter, updated in place
    params = sum(p.numel() * 4 for p in model.parameters())
    assert row["alias"] >= 3 * params and row["temp"] == 0


def test_telemetry_off_leaves_zero_residue(llamas):
    _, model = llamas
    tflags.set_flags({"telemetry": False})
    clear_decode_program_cache()
    out = _traffic(tserving.ServingEngine(model, **ENGINE))
    assert all(len(v) == 4 for v in out.values())
    step = TrainStep(model, AdamW(1e-3, parameters=model.named_parameters()),
                     loss_fn=LlamaPretrainingCriterion(LlamaConfig.tiny()))
    x, y = _batches()[0]
    step(torch.from_numpy(x), torch.from_numpy(y))
    step.sync()
    assert tobs.registry().snapshot()["metrics"] == {}
    assert tmem.program_table() == [] and len(tobs.tracer()) == 0
    assert not tmem.enabled()


def test_memwatch_off_keeps_the_other_telemetry(llamas):
    _, model = llamas
    tflags.set_flags({"memwatch": False})
    clear_decode_program_cache()
    _traffic(tserving.ServingEngine(model, **ENGINE))
    step = TrainStep(model, AdamW(1e-3, parameters=model.named_parameters()),
                     loss_fn=LlamaPretrainingCriterion(LlamaConfig.tiny()))
    x, y = _batches()[0]
    step(torch.from_numpy(x), torch.from_numpy(y))
    step.sync()
    snap = tobs.snapshot()["metrics"]
    assert "program_memory_bytes" not in snap
    assert tmem.program_table() == []
    for name in ("program_cache_traces", "serving_decode_steps",
                 "train_syncs", "train_step_traces"):
        assert name in snap, name
    assert tobs.enabled() and not tmem.enabled()


def test_a_failed_measurement_is_counted_not_raised():
    def broken():
        raise RuntimeError("no stats")

    for mem in (tmem,):
        assert mem.capture_program("decode_fused", 4, (), broken) is False
    fam = tobs.snapshot()["metrics"]["memwatch_capture_failures"]
    assert fam["series"] == [{"labels": {"kind": "decode_fused"},
                              "value": 1.0}]
    assert tmem.program_table() == []


def test_table_format_and_record_match_jax():
    stats = {"argument": 10, "output": 4, "temp": 3, "alias": 2,
             "generated_code": 0, "peak": 15}
    for mem in (jmem, tmem):
        mem.record_program("decode_fused", 4, stats, extra=(("kv", "int8"),),
                           model="abcd1234")
        mem.record_program("decode_fused", 4, stats, extra=(("kv", "int8"),),
                           model="abcd1234")
    assert tmem.program_table() == jmem.program_table()
    assert tmem.program_table()[0]["captures"] == 2
    assert tmem.format_program_table(tmem.program_table()) == \
        jmem.format_program_table(jmem.program_table())
    assert tmem.TABLE_COLUMNS == jmem.TABLE_COLUMNS
    assert tmem.SECTIONS == jmem.SECTIONS


# ------------------------------------------------------------- estimator
def _dims_pair(name):
    if name == "llama2_7b":
        jc, tc = JLlamaConfig.llama2_7b(), LlamaConfig.llama2_7b()
    elif name == "llama2_70b":
        jc = JLlamaConfig.llama2_70b()
        tc = LlamaConfig(**{f.name: getattr(jc, f.name)
                            for f in dataclasses.fields(LlamaConfig)})
    else:
        jc, tc = JGPTConfig.gpt3_345m(), GPTConfig.gpt3_345m()
    return jmem.ModelDims.of_config(jc), tmem.ModelDims.of_config(tc)


def _same(call_j, call_t):
    """Both calls return equal values, or raise the same error."""
    try:
        want = call_j()
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:30]):
            call_t()
        return None
    got = call_t()
    assert got == want
    return got


@pytest.mark.parametrize("extra", ["plain", "draft", "host_tier"])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", ["llama2_7b", "llama2_70b", "gpt3_345m"])
def test_engine_estimate_matches_jax(name, kv, tp, extra):
    jd, td = _dims_pair(name)
    kw = dict(page_size=64, max_batch=8, max_seq_len=4096, chunk=256,
              kv_dtype=kv, tp=tp, weight_dtype="bfloat16")
    if extra == "draft":
        jdraft, tdraft = _dims_pair("gpt3_345m" if name == "gpt3_345m"
                                    else "llama2_7b")
        got = _same(lambda: jmem.estimate_engine_memory(
            jd, draft_dims=jdraft, spec_gamma=4, draft_weight_dtype="int8",
            **kw), lambda: tmem.estimate_engine_memory(
            td, draft_dims=tdraft, spec_gamma=4, draft_weight_dtype="int8",
            **kw))
        assert got["breakdown"]["draft_kv_pool"] > 0
    elif extra == "host_tier":
        got = _same(lambda: jmem.estimate_engine_memory(
            jd, page_budget=300, host_tier_pages=96, **kw),
            lambda: tmem.estimate_engine_memory(
                td, page_budget=300, host_tier_pages=96, **kw))
        assert got["host_tier"]["bytes"] > 0
    else:
        got = _same(lambda: jmem.estimate_engine_memory(jd, **kw),
                    lambda: tmem.estimate_engine_memory(td, **kw))
    # the verdict against an 80 GB card
    assert tmem.fits(got, 80 * 10 ** 9) == jmem.fits(got, 80 * 10 ** 9)
    # int4 weights cannot shard: both refuse
    _same(lambda: jmem.estimate_engine_memory(
        jd, **{**kw, "weight_dtype": "int4"}),
        lambda: tmem.estimate_engine_memory(
            td, **{**kw, "weight_dtype": "int4"}))


@pytest.mark.parametrize("name", ["llama2_7b", "llama2_70b", "gpt3_345m"])
def test_program_estimates_match_jax(name):
    jd, td = _dims_pair(name)
    assert [getattr(td, s) for s in jmem.ModelDims.__slots__] == \
        [getattr(jd, s) for s in jmem.ModelDims.__slots__]
    assert (td.head_dim, td.kv_dim) == (jd.head_dim, jd.kv_dim)
    for quant in (False, True):
        jg = jmem.PoolGeometry(jd.layers, 129, 64, jd.kv_heads, jd.head_dim,
                               16, "int8" if quant else "float16",
                               kv_quant=quant)
        tg = tmem.PoolGeometry(td.layers, 129, 64, td.kv_heads, td.head_dim,
                               16, torch.int8 if quant else torch.bfloat16,
                               kv_quant=quant)
        assert tg.pool_bytes() == jg.pool_bytes()
        assert tg.tables_bytes(4) == jg.tables_bytes(4)
        assert tg.max_seq == jg.max_seq
        pb = 2 * (jd.param_count or 0)
        for fused_layers, int4 in ((1, False), (4, False), (4, True)):
            assert tmem.estimate_decode_program(
                td, tg, 4, pb, fused_layers=fused_layers,
                int4_weights=int4) == jmem.estimate_decode_program(
                jd, jg, 4, pb, fused_layers=fused_layers, int4_weights=int4)
        for s, chunked in ((77, False), (256, False), (256, True),
                           (5, True)):
            assert tmem.estimate_prefill_program(
                td, tg, s, pb, chunked=chunked) == \
                jmem.estimate_prefill_program(jd, jg, s, pb, chunked=chunked)


def test_small_functions_match_jax():
    avals = [((4, 128), "float32"), ((2, 3, 5), "int8"), ((7,), "int32")]
    touts = [torch.zeros(4, 128), torch.zeros((2, 3, 5), dtype=torch.int8),
             torch.zeros(7, dtype=torch.int32)]
    for i in range(3):
        assert tmem.aval_bytes(touts[i]) == jmem.aval_bytes(avals[i]) == \
            tmem.aval_bytes(avals[i])
    assert tmem.estimate_program(touts, touts[:1], donated=(0,), temp=9) == \
        jmem.estimate_program(avals, avals[:1], donated=(0,), temp=9)
    for n, dt in ((6_738_415_616, "bfloat16"), (6_738_415_616, "int8"),
                  (6_738_415_616, "int4"), (1_000, "float32")):
        assert tmem.weight_bytes(n, dt) == jmem.weight_bytes(n, dt)
    mesh = {"dp": 2, "mp": 4}
    for shape, spec in (((4096, 11008), (None, "mp")),
                        ((4097, 10), (("dp", "mp"), None)),
                        ((33,), None)):
        assert tmem.sharded_param_bytes(shape, "float32", spec, mesh) == \
            jmem.sharded_param_bytes(shape, "float32", spec, mesh)
    plan = {"total": 5 * 10 ** 9}
    assert tmem.fits(plan, 4 * 10 ** 9) == jmem.fits(plan, 4 * 10 ** 9)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_pool_geometry_of_a_live_pool_matches_jax(kv_dtype):
    args = (2, 17, 8, 2, 16, 4, 64)
    tg = tmem.PoolGeometry.of_pool(PagedKVCache(
        *args, dtype=torch.bfloat16, kv_dtype=kv_dtype, device="cpu"))
    jg = jmem.PoolGeometry.of_pool(JPagedKVCache(*args, kv_dtype=kv_dtype))
    for s in jmem.PoolGeometry.__slots__:
        if s != "dtype":
            assert getattr(tg, s) == getattr(jg, s), s
    assert tg.pool_bytes() == jg.pool_bytes()


def test_compare_program_rows_matches_jax():
    def row(kind, bucket, temp, peak, model="m", extra=""):
        return {"model": model, "kind": kind, "bucket": bucket,
                "extra": extra, "temp": temp, "peak": peak}

    banked = [row("decode_fused", 4, 100, 1000), row("decode_fused", 8, 0,
                                                      500),
              row("prefill_chunk", 1, 50, 700, extra="256"),
              row("train_step", 2, 10, 10)]
    current = [row("decode_fused", 4, 111, 1000), row("decode_fused", 8, 3,
                                                       500),
               row("prefill_chunk", 1, 50, 800, extra="256"),
               row("spec_verify", 1, 5, 5)]
    for tol in (0.10, 0.05, 0.5):
        want = jmem.compare_program_rows(banked, current, tolerance=tol)
        assert tmem.compare_program_rows(banked, current,
                                         tolerance=tol) == want
    verdicts = {f["verdict"] for f in tmem.compare_program_rows(banked,
                                                                current)}
    assert verdicts == {"grew", "missing", "new"}


# --------------------------------------------------------------- planner
def test_plan_fused_layers_prices_the_hopper_kernel():
    _, td = _dims_pair("llama2_7b")
    plans = [tmem.plan_fused_layers(td, fused_layers=n, batch=4,
                                    max_seq_len=1024) for n in (1, 2, 4, 8)]
    jd, _ = _dims_pair("llama2_7b")
    want_keys = set(jmem.plan_fused_layers(jd, fused_layers=2, batch=4))
    for p in plans:
        assert want_keys <= set(p)
        assert p["fits"] and p["total"] == p["breakdown"]["scratch"]
    # one scratch serves the group's layers in turn: no term grows with N
    assert len({(p["total"], p["shared_per_block"]) for p in plans}) == 1
    p = plans[0]
    assert p["breakdown"]["weight_stream_buffers"] == 8 * 256 * 4
    assert p["breakdown"]["kv_page_buffers"] == 8 * 1 * 130 * 4   # MHA
    assert tmem.plan_fused_layers(td, fused_layers=1, batch=4,
                                  vmem_limit=1024)["fits"] is False
    gqa = tmem.plan_fused_layers(_dims_pair("llama2_70b")[1],
                                 fused_layers=4, batch=8)
    assert gqa["breakdown"]["kv_page_buffers"] == 8 * 8 * 130 * 4
    int4 = tmem.plan_fused_layers(td, fused_layers=4, batch=4,
                                  int4_weights=True)
    assert int4["breakdown"]["activation_io_buffers"] == \
        p["breakdown"]["activation_io_buffers"]
    with pytest.raises(ValueError):
        tmem.plan_fused_layers(td, fused_layers=0)
