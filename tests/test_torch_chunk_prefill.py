"""Chunked prefill in the PyTorch port against the JAX package.

On the same seeded numpy inputs:
  - ``write_paged_prompt_at`` leaves pools equal to JAX's, exactly, for a
    chunk at a mid-page or page-aligned start, two sequences at once, and
    padded chunks that run past the block table (positions there are
    dropped, never clamped onto a live page), and the whole-prompt
    ``write_paged_prompt`` is exactly its start-0 case;
  - ``paged_chunk_attention_ref`` (what the kernel wrapper runs for a CPU
    tensor) matches JAX's ``paged_chunk_attention`` (Pallas, interpret mode
    off the TPU) and its XLA twin, within 1e-5 in float32 and 2e-2 in
    bfloat16 (the inputs are bf16, the sums f32 on both sides, the output
    rounds once to bf16): start 0, mid-page and page-aligned, MHA and GQA
    (rep 2), a padded final chunk whose real tail is ragged;
  - the Llama model's chunk-by-chunk forward under ``PagedChunkState``
    matches JAX's, logits and pools within 1e-4;
  - the engine's greedy streams with ``prefill_chunk=8`` equal the JAX
    engine's, token for token, with staggered admission and fused or
    generic decode, for prompts of exactly two chunks, a chunk plus one, a
    chunk and a half and under one chunk; ``chunk_dispatches`` equals
    JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.generation.serving import ServingEngine as JServingEngine
from paddle_tpu.jit import functional_call
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.generation.serving import ServingEngine
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF

TOL = {np.float32: 1e-5, "bf16": 2e-2}
CHUNK = 8
ENGINE = dict(max_batch=2, page_size=8, max_seq_len=40, prefill_chunk=CHUNK)
# two chunks exactly, a chunk plus one, under a chunk, a chunk and a half,
# three chunks
PROMPT_LENS = (16, 9, 5, 12, 24)
NEW = 6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _tables(rng, b, mp, num_pages):
    """Shuffled block tables over pages 1.. (page 0 is the null page)."""
    perm = rng.permutation(num_pages - 1)[:b * mp].reshape(b, mp) + 1
    return perm.astype(np.int32)


# ------------------------------------------------------------ pool writes
@pytest.mark.parametrize("start,s,mp", [
    ((5,), 8, 4),        # mid-page, spans two pages
    ((16,), 8, 4),       # page-aligned
    ((5, 11), 8, 4),     # two sequences at their own cursors
    ((24,), 8, 4),       # the JAX test's padded final chunk, up to the end
    ((29,), 8, 4),       # 5 positions past a 32-token table: dropped
    ((20,), 24, 4),      # 12 past, two of them onto the same last-page slot
    ((40,), 8, 4),       # wholly past the table: nothing lands
], ids=["mid-page", "aligned", "two-seqs", "to-the-end", "overflow",
        "overflow-wide", "all-past"])
def test_write_paged_prompt_at_matches_jax_exactly(start, s, mp):
    rng = np.random.default_rng(sum(start) + s)
    b, hkv, d, page, num_pages = len(start), 2, 16, 8, 13
    kp = rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
    k_new = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v_new = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    bt = _tables(rng, b, mp, num_pages)
    st = np.asarray(start, np.int32)
    jk, jv = jpa.write_paged_prompt_at(jnp.asarray(kp), jnp.asarray(vp),
                                       jnp.asarray(k_new), jnp.asarray(v_new),
                                       jnp.asarray(bt), jnp.asarray(st))
    tk, tv = tpa.write_paged_prompt_at(_t(kp), _t(vp), _t(k_new), _t(v_new),
                                       _t(bt), _t(st))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("s", [5, 32, 40], ids=["short", "whole-table",
                                                "past-the-table"])
def test_write_paged_prompt_is_the_start0_case(s):
    """The whole-prompt write (a plain scatter sized from the shapes) leaves
    the pools exactly as ``write_paged_prompt_at`` from start 0 does."""
    rng = np.random.default_rng(s)
    b, hkv, d, page, num_pages, mp = 2, 2, 16, 8, 13, 4
    kp = rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
    k_new = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v_new = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    bt = _t(_tables(rng, b, mp, num_pages))
    whole = tpa.write_paged_prompt(_t(kp), _t(kp), _t(k_new), _t(v_new), bt)
    at0 = tpa.write_paged_prompt_at(_t(kp), _t(kp), _t(k_new), _t(v_new), bt,
                                    torch.zeros(b, dtype=torch.int32))
    for a, c in zip(whole, at0):
        assert torch.equal(a, c)


# --------------------------------------------------------- chunk attention
def _chunk_case(seed, start, s=8, nh=4, nkv=2, d=16, page=8, num_pages=13,
                mp=6, dtype=np.float32):
    """q, pools (with the chunk written first, write-then-attend) and block
    tables; every tensor goes to both packages from the same numpy array."""
    rng = np.random.default_rng(seed)
    b = len(start)

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    q = mk(b, s, nh, d)
    k_new, v_new = mk(b, s, nkv, d), mk(b, s, nkv, d)
    kp, vp = mk(nkv, num_pages, page, d), mk(nkv, num_pages, page, d)
    bt = _tables(rng, b, mp, num_pages)
    st = np.asarray(start, np.int32)
    kp, vp = (np.array(a) for a in jpa.write_paged_prompt_at(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(bt), jnp.asarray(st)))
    return q, kp, vp, bt, st


@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("start,nkv,mp", [
    ((0,), 2, 6),        # first chunk, GQA rep 2
    ((5,), 2, 6),        # diagonal mid-page
    ((16,), 4, 6),       # page-aligned, MHA
    ((11, 3), 4, 6),     # two sequences, MHA
    ((29,), 2, 4),       # padded final chunk past a 32-token table
], ids=["start0-gqa", "mid-page-gqa", "aligned-mha", "two-seqs-mha",
        "padded-tail-gqa"])
def test_paged_chunk_attention_ref_matches_jax(dtype, start, nkv, mp):
    q, kp, vp, bt, st = _chunk_case(sum(start) + nkv, start, nkv=nkv, mp=mp)
    if dtype == "bf16":
        jcast = lambda a: jnp.asarray(a, jnp.bfloat16)        # noqa: E731
        tcast = lambda a: _t(a).to(torch.bfloat16)            # noqa: E731
    else:
        jcast, tcast = jnp.asarray, _t
    jargs = (jcast(q), jcast(kp), jcast(vp), jnp.asarray(bt), jnp.asarray(st))
    want = np.asarray(jpa.paged_chunk_attention(*jargs), np.float32)
    twin = np.asarray(jpa.paged_chunk_attention_xla(*jargs), np.float32)
    got = tpa.paged_chunk_attention(tcast(q), tcast(kp), tcast(vp), _t(bt),
                                    _t(st))
    assert got.dtype == (torch.bfloat16 if dtype == "bf16"
                         else torch.float32)
    got = got.float().numpy()
    assert _max_err(got, want) <= TOL[dtype]
    assert _max_err(got, twin) <= TOL[dtype]


def test_chunk_route_refuses_a_batch():
    q = torch.zeros(2, 4, 2, 8)
    kp = torch.zeros(2, 3, 8, 8)
    state = tpa.PagedChunkState(kp, kp.clone(),
                                torch.ones(2, 2, dtype=torch.int32),
                                torch.zeros(2, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="B = 1"):
        TF.paged_scaled_dot_product_attention(q, q, q, state)


# ------------------------------------------------------------------ model
def _models(seed):
    paddle.seed(seed)
    jmodel = JLlamaForCausalLM(JLlamaConfig.tiny())
    params, _ = jmodel.raw_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model.load_numpy_state({k: np.asarray(v) for k, v in params.items()})
    return jmodel, model


def test_llama_chunked_forward_matches_jax():
    """A 13-token prompt in chunks of 8 (the second padded) through
    ``forward_with_cache`` under ``PagedChunkState``, the cursor as the
    rotary offset: logits of every real row and both pools within 1e-4."""
    jmodel, model = _models(31)
    hkv, d = model.cache_spec()[0]
    page, num_pages = 8, 9
    bt = np.array([[5, 2, 7, 0]], np.int32)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 256, (13,)).astype(np.int32)
    shape = (hkv, num_pages, page, d)
    layers = model.config.num_hidden_layers
    jpools = [(jnp.zeros(shape, jnp.float32),) * 2 for _ in range(layers)]
    tpools = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(layers)]
    jparams, jbuffers = jmodel.raw_state()
    for pos in (0, CHUNK):
        ids = np.zeros((1, CHUNK), np.int32)
        real = min(CHUNK, len(prompt) - pos)
        ids[0, :real] = prompt[pos:pos + real]
        sl = np.array([pos], np.int32)
        jstates = [jpa.PagedChunkState(k, v, jnp.asarray(bt), jnp.asarray(sl))
                   for k, v in jpools]
        jl, jstates = functional_call(
            jmodel, jparams, jnp.asarray(ids), jstates, jnp.int32(pos),
            buffers=jbuffers, method="forward_with_cache")
        jpools = [(st.k_pages, st.v_pages) for st in jstates]
        tstates = [tpa.PagedChunkState(k, v, _t(bt), _t(sl))
                   for k, v in tpools]
        with torch.no_grad():
            tl, tstates = model.forward_with_cache(
                _t(ids.astype(np.int64)), tstates, pos)
        assert all(isinstance(st, tpa.PagedChunkState) for st in tstates)
        assert int(tstates[0].seq_lens[0]) == pos + CHUNK
        tpools = [(st.k_pages, st.v_pages) for st in tstates]
        assert _max_err(tl.numpy()[0, :real], np.asarray(jl)[0, :real]) <= 1e-4
    for (jk, jv), (tk, tv) in zip(jpools, tpools):
        assert _max_err(tk.numpy(), jk) <= 1e-4
        assert _max_err(tv.numpy(), jv) <= 1e-4


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def models():
    return _models(91)


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
def test_chunked_streams_identical_to_jax(models, fused):
    jmodel, model = models
    old = jflags.get_flag("fused_block_decode")
    jflags.set_flags({"fused_block_decode": fused})
    try:
        jeng = JServingEngine(jmodel, **ENGINE)
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
    # chunks of the prompts longer than the chunk: 2 + 2 + 2 + 3
    assert eng.chunk_dispatches == jeng.chunk_dispatches == 9
    assert eng.pool.free_page_count() == eng.pool.num_pages - 1
    assert sorted(eng.ttft_seconds) == list(range(len(PROMPT_LENS)))


def test_chunked_and_whole_prefill_serve_the_same_tokens(models):
    """Chunking off (``prefill_chunk=0``) prefills every prompt whole: the
    same greedy streams, no chunk dispatched."""
    _, model = models
    streams = []
    for chunk in (0, CHUNK):
        eng = ServingEngine(model, **dict(ENGINE, prefill_chunk=chunk))
        streams.append(_drive(eng))
        assert eng.chunk_dispatches == (9 if chunk else 0)
    assert streams[0] == streams[1]
