"""N-layer fused decode in the PyTorch port against the JAX package.

On the same seeded numpy inputs:
  - ``stack_block_weights`` gives exactly JAX's stacked arrays (q|k|v and
    gate|up merged on the output axis, stacked on a leading layer axis);
  - ``fused_multi_block_decode_ref`` (what the kernel wrapper runs for a CPU
    tensor) matches JAX's ``fused_multi_block_decode_pallas`` (interpret
    mode) and ``fused_multi_block_decode_ref`` within 1e-5 in float32 (the
    output and every layer's pools), for groups of 1, 2 and 4 layers,
    ragged lengths including 0, GQA on and off;
  - it is bit for bit the chain of the port's per-layer
    ``fused_block_decode_ref`` (float32 and bfloat16): the merged
    projections contract the same columns;
  - ``block_decode_spec(fused_layers=N)`` publishes JAX's layer groups;
  - the engine's greedy streams under ``FLAGS_fused_block_layers`` 2 and 3
    (3 over 2 layers: one ragged group) equal the JAX engine's under the
    same flag and the port's per-layer (N = 1) streams, with and without
    chunked prefill.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.generation.serving import ServingEngine as JServingEngine
from paddle_tpu.kernels import fused_block_decode as jfb
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.generation.serving import ServingEngine
from paddle_tpu_torch.kernels import fused_block_decode as tfb
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

TOL = 1e-5
ENGINE = dict(max_batch=2, page_size=8, max_seq_len=40)
PROMPT_LENS = (5, 9, 13, 7, 16)
NEW = 6


def _t(a):
    return torch.from_numpy(np.array(a))


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _group(seed, n, b=3, hidden=64, nh=4, nkv=2, inter=128, page=8,
           num_pages=16, mp=4, seq_lens=(5, 8, 11)):
    """n layers' weights, x, n pool pairs, block tables and lengths as
    numpy float32, the JAX tests' shapes."""
    rng = np.random.default_rng(seed)
    d = hidden // nh

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)

    layers = [dict(ln1=norm(), wq=mk(hidden, nh * d), wk=mk(hidden, nkv * d),
                   wv=mk(hidden, nkv * d), wo=mk(nh * d, hidden), ln2=norm(),
                   wg=mk(hidden, inter), wu=mk(hidden, inter),
                   wd=mk(inter, hidden)) for _ in range(n)]
    x = mk(b, hidden)
    kps = [mk(nkv, num_pages, page, d) for _ in range(n)]
    vps = [mk(nkv, num_pages, page, d) for _ in range(n)]
    perm = rng.permutation(num_pages - 1)[:b * mp].reshape(b, mp) + 1
    bt = perm.astype(np.int32)
    sl = np.asarray(seq_lens, np.int32)
    kw = dict(num_heads=nh, num_kv_heads=nkv, rope_theta=10000.0,
              epsilon=1e-5)
    return layers, x, kps, vps, bt, sl, kw


def _jax_layers(layers, dtype=jnp.float32):
    return [jfb.BlockDecodeWeights(**{k: jnp.asarray(v, dtype)
                                      for k, v in w.items()}) for w in layers]


def _port_layers(layers, dtype=torch.float32):
    return [tfb.BlockDecodeWeights(**{k: _t(v).to(dtype)
                                      for k, v in w.items()}) for w in layers]


def test_stack_block_weights_equals_jax():
    layers, *_ = _group(0, 3)
    want = jfb.stack_block_weights(_jax_layers(layers))
    got = tfb.stack_block_weights(_port_layers(layers))
    assert isinstance(got, tfb.MultiBlockDecodeWeights)
    assert got.n_layers == 3
    for name in tfb.MultiBlockDecodeWeights._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_stack_block_weights_takes_int4_refuses_fp8():
    layers, *_ = _group(1, 1)
    got = tfb.stack_block_weights(_port_layers(layers), weight_dtype="int4")
    for name in ("wqkv", "wo", "wgu", "wd"):
        assert isinstance(getattr(got, name), tfb.Int4Tiles)
    with pytest.raises(ValueError):
        tfb.stack_block_weights(_port_layers(layers), weight_dtype="fp8")


@pytest.mark.parametrize("n,nkv,seq_lens", [
    (1, 2, (5, 8, 11)),
    (2, 2, (0, 8, 31)),      # an empty row, a page boundary, a full table
    (4, 2, (5, 8, 11)),
    (2, 4, (0, 8, 31)),      # MHA
    (4, 1, (16, 1, 0)),      # rep 4
], ids=["n1-gqa", "n2-gqa-ragged", "n4-gqa", "n2-mha-ragged",
        "n4-rep4-ragged"])
def test_multi_block_ref_matches_jax(n, nkv, seq_lens):
    layers, x, kps, vps, bt, sl, kw = _group(30 + n, n, nkv=nkv,
                                             seq_lens=seq_lens)
    jw = jfb.stack_block_weights(_jax_layers(layers))
    jargs = (jnp.asarray(x), jw, [jnp.asarray(a) for a in kps],
             [jnp.asarray(a) for a in vps], jnp.asarray(bt), jnp.asarray(sl))
    want = jfb.fused_multi_block_decode_pallas(*jargs, interpret=True, **kw)
    ref = jfb.fused_multi_block_decode_ref(*jargs, **kw)
    tw = tfb.stack_block_weights(_port_layers(layers))
    got = tfb.fused_multi_block_decode(
        _t(x), tw, [_t(a) for a in kps], [_t(a) for a in vps], _t(bt),
        _t(sl), **kw)
    for oracle in (want, ref):
        assert _max_err(got[0].numpy(), oracle[0]) <= TOL
        for i in range(n):
            assert _max_err(got[1][i].numpy(), oracle[1][i]) <= TOL
            assert _max_err(got[2][i].numpy(), oracle[2][i]) <= TOL


@pytest.mark.parametrize("n,dtype", [(1, torch.float32), (2, torch.float32),
                                     (4, torch.float32),
                                     (2, torch.bfloat16)],
                         ids=["n1-fp32", "n2-fp32", "n4-fp32", "n2-bf16"])
def test_multi_block_ref_is_the_per_layer_chain_bitwise(n, dtype):
    layers, x, kps, vps, bt, sl, kw = _group(10 + n, n,
                                             seq_lens=(0, 8, 11))
    ws = _port_layers(layers, dtype)
    xs = _t(x).to(dtype)
    pools = [(_t(k).to(dtype), _t(v).to(dtype)) for k, v in zip(kps, vps)]
    chain_pools = [(k.clone(), v.clone()) for k, v in pools]
    out = xs
    for w, (k, v) in zip(ws, chain_pools):
        out, _, _ = tfb.fused_block_decode_ref(out, w, k, v, _t(bt), _t(sl),
                                               **kw)
    got, gk, gv = tfb.fused_multi_block_decode_ref(
        xs, tfb.stack_block_weights(ws), [k for k, _ in pools],
        [v for _, v in pools], _t(bt), _t(sl), **kw)
    assert got.dtype == dtype
    assert torch.equal(got, out)
    for i, (k, v) in enumerate(chain_pools):
        assert torch.equal(gk[i], k) and torch.equal(gv[i], v)


@pytest.mark.parametrize("layers,n", [(2, 2), (2, 3), (5, 2), (4, 4)])
def test_layer_groups_match_jax(layers, n):
    paddle.seed(3)
    jcfg = JLlamaConfig.tiny()
    jcfg.num_hidden_layers = layers
    cfg = LlamaConfig.tiny()
    cfg.num_hidden_layers = layers
    want = JLlamaForCausalLM(jcfg).block_decode_spec(n)["layer_groups"]
    model = LlamaForCausalLM(cfg, device="cpu")
    assert model.block_decode_spec(n)["layer_groups"] == want
    assert "layer_groups" not in model.block_decode_spec(1)


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def models():
    paddle.seed(91)
    jmodel = JLlamaForCausalLM(JLlamaConfig.tiny())
    params, _ = jmodel.raw_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_numpy_state({k: np.asarray(v) for k, v in params.items()})
    return jmodel, model


def _drive(eng):
    rng = np.random.default_rng(7)
    ps = [rng.integers(0, 256, (n,)).astype(np.int32) for n in PROMPT_LENS]
    rids = [eng.submit(ps[0], NEW), eng.submit(ps[1], NEW)]
    eng.step()
    rids += [eng.submit(p, NEW) for p in ps[2:]]
    out = eng.run()
    return [out[r] for r in rids]


def _port_streams(model, n, chunk):
    tflags.set_flags({"fused_block_layers": n})
    try:
        eng = ServingEngine(model, prefill_chunk=chunk, **ENGINE)
        assert (eng._stacked is not None) == (n > 1)
        return _drive(eng)
    finally:
        tflags.reset_flags()


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
@pytest.mark.parametrize("n", [2, 3])
def test_nlayer_streams_identical_to_jax_and_per_layer(models, n, chunk):
    jmodel, model = models
    old = jflags.get_flag("fused_block_layers")
    jflags.set_flags({"fused_block_layers": n})
    try:
        jeng = JServingEngine(jmodel, prefill_chunk=chunk, **ENGINE)
        want = _drive(jeng)
        assert jeng.decode_key.kind == "decode_fused_nlayer"
    finally:
        jflags.set_flags({"fused_block_layers": old})
    got = _port_streams(model, n, chunk)
    assert all(len(t) == NEW for t in got)
    assert got == want
    assert got == _port_streams(model, 1, chunk)
