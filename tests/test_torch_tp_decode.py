"""Tensor-parallel decode of the port against the JAX package's, on the
CPU (arm for arm after ``tests/test_tp_decode.py``).

The port keeps every shard on the engine's one device (here the CPU), where
the JAX engine shards over host devices (the suite's conftest gives it 8):

- ``shard_block_weights`` equals the reference's bit for bit on the same
  numpy stack, and refuses int4 tiles and indivisible counts alike;
- ``fused_multi_block_decode_tp``'s shards, summed by ``_mp_allreduce_shards``,
  equal the reference's ``shard_map`` chain over two host devices (fp32,
  1e-5) in output and written pools;
- greedy streams at tp = 2 equal the port's tp = 1 and the JAX engine's
  tp = 2 on the fused, N-layer, int8-KV, spec-verify and generic (GPT)
  arms; keys carry ``("tp", 2)`` (tp = 1 keys unchanged) and a second
  wave retraces nothing;
- refusals, collective telemetry and the ``tp`` label, replay recovery
  under decode faults, harvest / adopt in process and through a spawned
  child, and ``FleetRouter(tp_degree=2)``'s replicas.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from paddle_tpu import flags as jflags
from paddle_tpu.generation.fleet import FleetRouter as JFleet
from paddle_tpu.generation.program_cache import \
    clear_decode_program_cache as jclear
from paddle_tpu.generation.serving import ServingEngine as JEngine
from paddle_tpu.kernels import fused_block_decode as jfbd
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.generation.fleet import FleetRouter
from paddle_tpu_torch.generation.program_cache import (
    clear_decode_program_cache, decode_program_cache)
from paddle_tpu_torch.generation.serving import ServingEngine
from paddle_tpu_torch.kernels import fused_block_decode as tfbd
from paddle_tpu_torch.kernels.paged_attention import shard_pool
from paddle_tpu_torch.testing import faults, transport
from torch_serving_twins import both_flags, tiny_gpts, tiny_llamas

PROMPTS = [[1, 5, 9, 2], [3, 7, 4], [2, 2, 8, 6, 1]]
KW = dict(max_batch=4, max_seq_len=128)
SEED = 91                 # transport's child rebuilds this model
# a wedged child fails its test after this long instead of stalling the
# run
CHILD_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def llamas():
    return tiny_llamas(SEED)


@pytest.fixture(scope="module")
def gpts():
    return tiny_gpts(SEED)


def _run(cls, model, prompts=PROMPTS, tokens=8, **kw):
    clear_decode_program_cache()
    jclear()
    eng = cls(model, **{**KW, **kw})
    rids = [eng.submit(np.array(p, np.int32), tokens) for p in prompts]
    res = eng.run()
    return eng, [res[r] for r in rids]


# ------------------------------------------------------------- weights
def _stack(rng, n=2, hidden=64, nh=4, nkv=2, d=16, inter=128):
    f = np.float32
    return dict(
        ln1=(1 + 0.1 * rng.standard_normal((n, hidden))).astype(f),
        wqkv=(0.1 * rng.standard_normal((n, hidden, (nh + 2 * nkv) * d))
              ).astype(f),
        wo=(0.1 * rng.standard_normal((n, nh * d, hidden))).astype(f),
        ln2=(1 + 0.1 * rng.standard_normal((n, hidden))).astype(f),
        wgu=(0.1 * rng.standard_normal((n, hidden, 2 * inter))).astype(f),
        wd=(0.1 * rng.standard_normal((n, inter, hidden))).astype(f))


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_block_weights_bit_for_bit(tp):
    w = _stack(np.random.default_rng(tp), nh=8, nkv=4)
    want = jfbd.shard_block_weights(
        jfbd.MultiBlockDecodeWeights(**{k: jnp.asarray(v)
                                        for k, v in w.items()}),
        tp, num_heads=8, num_kv_heads=4)
    got = tfbd.shard_block_weights(
        tfbd.MultiBlockDecodeWeights(**{k: torch.from_numpy(v)
                                        for k, v in w.items()}),
        tp, num_heads=8, num_kv_heads=4)
    for name in tfbd.MultiBlockDecodeWeights._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    shards = tfbd.split_block_shards(got, tp)
    assert len(shards) == tp
    for s, sh in enumerate(shards):
        cols = got.wqkv.shape[2] // tp
        assert torch.equal(sh.wqkv, got.wqkv[:, :, s * cols:(s + 1) * cols])
        assert sh.wd.is_contiguous() and sh.wd.shape[1] == 128 // tp


def test_shard_block_weights_refusals():
    w = tfbd.MultiBlockDecodeWeights(**{
        k: torch.from_numpy(v)
        for k, v in _stack(np.random.default_rng(0)).items()})
    with pytest.raises(ValueError, match="must all divide tp=3"):
        tfbd.shard_block_weights(w, 3, num_heads=4, num_kv_heads=2)
    packed = w._replace(wqkv=tfbd.pack_int4_tiles(w.wqkv, 16, 16))
    with pytest.raises(ValueError, match="Int4Tiles for wqkv"):
        tfbd.shard_block_weights(packed, 2, num_heads=4, num_kv_heads=2)
    assert tfbd.shard_block_weights(w, 1, num_heads=4,
                                    num_kv_heads=2) is w


def test_tp_chain_matches_the_shard_map_chain():
    rng = np.random.default_rng(7)
    n, nh, nkv, d, page, pages = 2, 4, 2, 16, 8, 9
    w = _stack(rng, n=n, nh=nh, nkv=nkv, d=d)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    kps = [rng.standard_normal((nkv, pages, page, d)).astype(np.float32)
           for _ in range(n)]
    vps = [rng.standard_normal((nkv, pages, page, d)).astype(np.float32)
           for _ in range(n)]
    bt = np.array([[1, 2, 0, 0], [3, 4, 5, 0], [6, 0, 0, 0]], np.int32)
    sl = np.array([5, 17, 0], np.int32)
    tp, theta, eps = 2, 10000.0, 1e-5

    jsh = jfbd.shard_block_weights(
        jfbd.MultiBlockDecodeWeights(**{k: jnp.asarray(v)
                                        for k, v in w.items()}),
        tp, num_heads=nh, num_kv_heads=nkv)
    mesh = Mesh(np.array(jax.devices()[:tp]), ("mp",))
    pool = P("mp", None, None, None)
    w_spec = jfbd.MultiBlockDecodeWeights(
        ln1=P(), wqkv=P(None, None, "mp"), wo=P(None, "mp", None),
        ln2=P(), wgu=P(None, None, "mp"), wd=P(None, "mp", None))

    def body(x, kp, vp, bt, sl, ws):
        return jfbd.fused_multi_block_decode_tp(
            x, ws, kp, vp, bt, sl, num_heads=nh // tp,
            num_kv_heads=nkv // tp, rope_theta=theta, epsilon=eps,
            axis_name="mp")

    chain = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), [pool] * n, [pool] * n, P(), P(), w_spec),
        out_specs=(P(), [pool] * n, [pool] * n), check_vma=False))
    jx, jk, jv = chain(jnp.asarray(x), [jnp.asarray(a) for a in kps],
                       [jnp.asarray(a) for a in vps], jnp.asarray(bt),
                       jnp.asarray(sl), jsh)

    shards = tfbd.split_block_shards(tfbd.shard_block_weights(
        tfbd.MultiBlockDecodeWeights(**{k: torch.from_numpy(v)
                                        for k, v in w.items()}),
        tp, num_heads=nh, num_kv_heads=nkv), tp)
    tk = [torch.from_numpy(a.copy()) for a in kps]
    tv = [torch.from_numpy(a.copy()) for a in vps]
    tx, _, _ = tfbd.fused_multi_block_decode_tp(
        torch.from_numpy(x), shards,
        [[shard_pool(k, s, tp) for k in tk] for s in range(tp)],
        [[shard_pool(v, s, tp) for v in tv] for s in range(tp)],
        torch.from_numpy(bt), torch.from_numpy(sl), num_heads=nh // tp,
        num_kv_heads=nkv // tp, rope_theta=theta, epsilon=eps)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    for a, b in zip(tk + tv, list(jk) + list(jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# ------------------------------------------------------------- parity
def test_fused_parity_keys_and_zero_retrace(llamas):
    jmodel, model = llamas
    _, ref = _run(ServingEngine, model)
    eng, out = _run(ServingEngine, model, tp_degree=2)
    _, jout = _run(JEngine, jmodel, tp_degree=2)
    assert out == ref == jout
    key = eng.decode_key
    assert key.kind == "decode_fused" and ("tp", 2) in key.extra
    cache = decode_program_cache()
    traced = cache.trace_count(key)
    for p in PROMPTS:
        eng.submit(np.array(p, np.int32), 8)
    eng.run()
    assert cache.trace_count(key) == traced


def test_tp1_keys_unchanged(llamas):
    eng, _ = _run(ServingEngine, llamas[1])
    assert eng.tp_degree == 1
    assert eng.decode_key.extra == (("kv", "native"), ("wt", "native"))


def test_nlayer_parity(llamas):
    jmodel, model = llamas
    with both_flags(fused_block_layers=2):
        _, ref = _run(ServingEngine, model)
        eng, out = _run(ServingEngine, model, tp_degree=2)
        _, jout = _run(JEngine, jmodel, tp_degree=2)
    assert out == ref == jout
    assert eng.decode_key.kind == "decode_fused_nlayer"
    assert eng.decode_key.extra[:2] == ("nlayer", (2,))
    assert ("tp", 2) in eng.decode_key.extra


def test_int8_kv_parity(llamas):
    jmodel, model = llamas
    _, ref = _run(ServingEngine, model, kv_dtype="int8")
    eng, out = _run(ServingEngine, model, kv_dtype="int8", tp_degree=2)
    _, jout = _run(JEngine, jmodel, kv_dtype="int8", tp_degree=2)
    assert out == ref == jout
    assert ("kv", "int8") in eng.decode_key.extra
    assert ("tp", 2) in eng.decode_key.extra


def test_spec_verify_parity(llamas):
    _, model = llamas
    _, draft = tiny_llamas(7)
    _, ref = _run(ServingEngine, model)
    eng, out = _run(ServingEngine, model, draft_model=draft, tp_degree=2)
    assert out == ref
    assert eng.spec_rounds > 0
    # the speculative keys carry no degree, as the JAX package's
    # _spec_program builds them
    assert not any(e[0] == "tp" for e in eng.spec_verify_key.extra
                   if isinstance(e, tuple))


def test_generic_parity(gpts):
    jmodel, model = gpts
    _, ref = _run(ServingEngine, model)
    eng, out = _run(ServingEngine, model, tp_degree=2)
    _, jout = _run(JEngine, jmodel, tp_degree=2)
    assert out == ref == jout
    assert eng.decode_key.kind == "decode_generic"
    assert ("tp", 2) in eng.decode_key.extra


def test_shards_on_one_device(llamas, monkeypatch):
    """A designed difference: the JAX engine refuses a degree above its
    device count; the port's shards all live on the engine's device."""
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    with pytest.raises(ValueError, match="needs that many devices"):
        JEngine(llamas[0], **KW, tp_degree=2)
    eng, out = _run(ServingEngine, llamas[1], tp_degree=2)
    assert eng.device.type == "cpu" and len(out) == len(PROMPTS)


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("kw,what", [
    (dict(weight_dtype="int4", tp_degree=2), "int4"),
    (dict(tp_degree=3), "kv-head"),
    (dict(tp_degree=0), "tp_degree must be >= 1"),
])
def test_refusals(llamas, kw, what):
    jmodel, model = llamas
    with pytest.raises(ValueError, match=what) as got:
        ServingEngine(model, **KW, **kw)
    with pytest.raises(ValueError, match=what):
        JEngine(jmodel, **KW, **kw)
    assert what in str(got.value)


def test_tp_degree_flag(llamas):
    with both_flags(serving_tp_degree=2):
        eng = ServingEngine(llamas[1], **KW)
        assert eng.tp_degree == 2 and eng._tp_shards is not None
    with pytest.raises(ValueError, match="serving_tp_degree"):
        tflags.set_flags({"serving_tp_degree": 0})
    assert tflags.get_flag("serving_tp_degree") == 1


# ------------------------------------------------------------ telemetry
def _series(name):
    fam = tobs.registry().snapshot()["metrics"].get(name)
    return fam["series"] if fam else []


def test_collective_histogram_and_tp_label(llamas):
    with both_flags(telemetry=True):
        tobs.registry().clear()
        _run(ServingEngine, llamas[1], tp_degree=2)
        rows = [s for s in _series("serving_collective_seconds")
                if s["labels"].get("tp") == "2"]
        assert rows and rows[0]["count"] >= 1
        traces = _series("program_cache_traces")
        assert traces and all(s["labels"]["tp"] == "2" for s in traces)
        tobs.registry().clear()
        _run(ServingEngine, llamas[1])
        assert all(s["count"] == 0
                   for s in _series("serving_collective_seconds"))
        assert all(s["labels"]["tp"] == "1"
                   for s in _series("program_cache_traces"))
        tobs.registry().clear()


# ------------------------------------------------------------- recovery
def test_fault_replay_parity(llamas):
    _, model = llamas
    _, ref = _run(ServingEngine, model, tp_degree=2)
    with faults.armed("decode_dispatch:every=3", serving_max_retries=8,
                      serving_retry_backoff=0.001):
        eng, out = _run(ServingEngine, model, tp_degree=2)
    assert out == ref
    assert not eng.has_work()


# -------------------------------------------------------------- handoff
def _midstream(eng, rid):
    for _ in range(64):
        eng.step()
        req = next((r for r in eng._slots
                    if r is not None and r.rid == rid), None)
        if (req is not None and req.tokens and req.prefill_pos is None
                and not req.pending):
            return
    raise AssertionError("request never reached mid-stream state")


def _harvest(model, **kw):
    _, (solo,) = _run(ServingEngine, model, prompts=PROMPTS[:1], **kw)
    a = ServingEngine(model, **KW, **kw)
    rid = a.submit(np.array(PROMPTS[0], np.int32), 8)
    _midstream(a, rid)
    return solo, a.harvest_request(rid)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_harvest_adopt_tp2(llamas, kv_dtype):
    solo, bundle = _harvest(llamas[1], kv_dtype=kv_dtype, tp_degree=2)
    b = ServingEngine(llamas[1], **KW, kv_dtype=kv_dtype, tp_degree=2)
    rid = b.adopt_request(bundle)
    assert b.run()[rid] == solo


def test_spawn_roundtrip_tp2():
    from paddle_tpu_torch.device import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             generator=seed(SEED, "cpu"))
    kw = dict(kv_dtype="int8", tp_degree=2)
    solo, bundle = _harvest(model, **kw)
    transport.assert_bundle_transportable(bundle)
    assert transport.adopt_and_decode_in_child(
        bundle, model_seed=SEED, engine_kw=dict(KW, **kw),
        device="cpu", timeout=CHILD_TIMEOUT_S) == solo


# ---------------------------------------------------------------- fleet
def test_fleet_tp_replicas(gpts):
    jmodel, model = gpts
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 9, 13, 7)]

    def drive(cls, m, **kw):
        clear_decode_program_cache()
        jclear()
        fleet = cls(m, replicas=2, max_batch=2, page_size=8,
                    max_seq_len=64, **kw)
        rids = [fleet.submit(p, 5) for p in prompts]
        out = fleet.run()
        return fleet, [out[r] for r in rids]

    _, ref = drive(FleetRouter, model)
    fleet, out = drive(FleetRouter, model, tp_degree=2)
    _, jout = drive(JFleet, jmodel, tp_degree=2)
    assert out == ref == jout
    assert all(e.tp_degree == 2 for e in fleet.engines)
    assert [e.replica for e in fleet.engines] == ["0", "1"]
    assert all(e._m.__class__.__name__.endswith("Telemetry")
               for e in fleet.engines)
    assert jflags.get_flag("serving_tp_degree") == 1
