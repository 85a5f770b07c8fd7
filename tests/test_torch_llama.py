"""The PyTorch port's Llama against the JAX package's, on shared weights.

The JAX model is built from a seed; its ``raw_state()`` carries into the
port through ``load_numpy_state``. In float32 (the JAX side at
``jax_default_matmul_precision=highest``, set by conftest):
  - the carry-over is exact, parameter names and shapes included;
  - the no-cache forward's logits agree to 1e-4;
  - a paged whole-prompt prefill and one decode step through
    ``forward_with_cache`` agree to 1e-4, logits and pools.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.jit import functional_call
from paddle_tpu.kernels.paged_attention import \
    PagedDecodeState as JPagedDecodeState
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu_torch.convert import state_from_numpy
from paddle_tpu_torch.kernels.paged_attention import PagedDecodeState
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

TOL = 1e-4


def _pair(seed, **cfg_kw):
    """A JAX tiny Llama and the port's copy of it on the CPU."""
    paddle.seed(seed)
    jcfg = JLlamaConfig.tiny()
    for k, v in cfg_kw.items():
        setattr(jcfg, k, v)
    jmodel = JLlamaForCausalLM(jcfg)
    params, _ = jmodel.raw_state()
    named = {k: np.asarray(v) for k, v in params.items()}
    cfg = LlamaConfig.tiny()
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_numpy_state(named)
    return jmodel, model, named


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("tie", [False, True])
def test_weight_carry_over_is_exact(tie):
    _, model, named = _pair(11, tie_word_embeddings=tie)
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(named)
    for k, arr in named.items():
        assert got[k].shape == arr.shape, k
        np.testing.assert_array_equal(got[k], arr, err_msg=k)


def test_state_from_numpy_takes_bf16_arrays():
    import ml_dtypes
    arr = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    named = {"w": arr.astype(ml_dtypes.bfloat16)}
    out = state_from_numpy(named, "cpu")
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  named["w"].astype(np.float32))
    f32 = state_from_numpy(named, "cpu", torch.float32)["w"]
    assert f32.dtype == torch.float32


@pytest.mark.parametrize("seq", [5, 23])
def test_no_cache_logits_match_jax(seq):
    jmodel, model, _ = _pair(12)
    ids = np.random.default_rng(seq).integers(0, 256, (2, seq))
    want = np.asarray(jmodel(paddle.to_tensor(ids.astype(np.int32))).numpy())
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape
    assert _max_err(got, want) <= TOL


def test_paged_prefill_and_decode_step_match_jax():
    jmodel, model, _ = _pair(13)
    cfg = model.config
    hkv, d = model.cache_spec()[0]
    page, num_pages, maxp = 8, 9, 4
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (1, 13)).astype(np.int32)
    bt = np.array([[5, 2, 7, 0]], np.int32)          # shuffled, 0 unused
    shape = (hkv, num_pages, page, d)
    jparams, jbuffers = jmodel.raw_state()

    def jax_step(ids, pools, sl, offset):
        states = [JPagedDecodeState(k, v, jnp.asarray(bt), jnp.asarray(sl))
                  for k, v in pools]
        logits, states = functional_call(
            jmodel, jparams, jnp.asarray(ids), states, offset,
            buffers=jbuffers, method="forward_with_cache")
        return (np.asarray(logits),
                [(st.k_pages, st.v_pages) for st in states])

    def port_step(ids, pools, sl, offset):
        states = [PagedDecodeState(k, v, torch.from_numpy(bt),
                                   torch.from_numpy(sl)) for k, v in pools]
        with torch.no_grad():
            logits, states = model.forward_with_cache(
                torch.from_numpy(ids.astype(np.int64)), states, offset)
        return (logits.numpy(), [(st.k_pages, st.v_pages) for st in states],
                states)

    jpools = [(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
              for _ in range(cfg.num_hidden_layers)]
    tpools = [(torch.zeros(shape), torch.zeros(shape))
              for _ in range(cfg.num_hidden_layers)]
    sl0 = np.zeros((1,), np.int32)
    jl, jpools = jax_step(prompt, jpools, sl0, jnp.int32(0))
    tl, tpools, tstates = port_step(prompt, tpools, sl0, 0)
    assert _max_err(tl, jl) <= TOL
    assert int(tstates[0].seq_lens[0]) == prompt.shape[1]

    tok = np.argmax(jl[:, -1], axis=-1).astype(np.int32)[:, None]
    sl1 = np.array([prompt.shape[1]], np.int32)
    jl2, jpools = jax_step(tok, jpools, sl1, None)
    tl2, tpools, _ = port_step(tok, tpools, sl1, None)
    assert _max_err(tl2, jl2) <= TOL
    for (jk, jv), (tk, tv) in zip(jpools, tpools):
        assert _max_err(tk.numpy(), jk) <= TOL
        assert _max_err(tv.numpy(), jv) <= TOL


def test_block_decode_spec_names_live_parameters():
    _, model, _ = _pair(14)
    spec = model.block_decode_spec()
    params = dict(model.named_parameters())
    names = [spec["embed"], spec["final_norm"], spec["lm_head"]]
    for lw in spec["layers"]:
        names.extend(lw.values())
    assert all(n in params for n in names)
    assert "layer_groups" not in spec
    assert model.block_decode_spec(fused_layers=2)["layer_groups"] == [[0, 1]]
    with pytest.raises(ValueError):
        model.block_decode_spec(fused_layers=0)
