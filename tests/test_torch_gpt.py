"""The port's GPT (``models/gpt.py``) and the functions it brought
(``layer_norm``, ``gelu``, ``cross_entropy``, ``LayerNorm``, ``Dropout``)
against the JAX package on the CPU, both models built from the same numpy
weights (JAX's ``raw_state()`` through ``load_numpy_state``).

Tolerances (fp32; JAX at ``jax_default_matmul_precision=highest``): 1e-5
on the functions, logits and the loss; generation, the engine and
speculative decoding token for token (the reference promises greedy
bit-identity, and both sides pick the argmax of the same f32 rows up to
last-bit differences). Checked: the no-cache forward and loss; ``generate``
(greedy over the ring buffers, the prefill kernel's plain version);
``ServingEngine`` staggered admission and chunked prefill equal to solo
decode and to the JAX engine; a GPT target with a GPT draft (generic draft
scan and verify) equal to plain decoding and to the JAX spec engine; a
draft scan at the end of a budget whose positions pass the position table.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.generation.serving import ServingEngine as JEngine
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion
from paddle_tpu_torch.generation.serving import ServingEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.nn import Dropout, LayerNorm
from paddle_tpu_torch.nn import functional as F
from torch_serving_twins import solo, tiny_gpts

TOL = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rng_ids(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(
        np.int32)


# -------------------------------------------------------------- functions
@pytest.mark.parametrize("shape,norm", [((3, 5, 16), 16), ((2, 4, 6), (4, 6))])
def test_layer_norm_matches_jax(shape, norm):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 1
    n = norm if isinstance(norm, int) else int(np.prod(norm))
    w = rng.standard_normal(n).astype(np.float32).reshape(
        (norm,) if isinstance(norm, int) else norm)
    b = rng.standard_normal(w.shape).astype(np.float32)
    want = JF.layer_norm(paddle.to_tensor(x), norm, paddle.to_tensor(w),
                         paddle.to_tensor(b), 1e-5).numpy()
    got = F.layer_norm(torch.from_numpy(x), norm, torch.from_numpy(w),
                       torch.from_numpy(b), 1e-5).numpy()
    assert _err(got, want) <= TOL
    layer = LayerNorm(norm, device="cpu")
    assert torch.equal(layer.weight, torch.ones(w.shape))
    assert LayerNorm(norm, bias_attr=False, device="cpu").bias is None


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_matches_jax(approximate):
    x = np.linspace(-6, 6, 301).astype(np.float32)
    want = JF.gelu(paddle.to_tensor(x), approximate=approximate).numpy()
    got = F.gelu(torch.from_numpy(x), approximate=approximate).numpy()
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("kw", [
    {}, {"reduction": "sum"}, {"reduction": "none"},
    {"ignore_index": 3}, {"label_smoothing": 0.1}, {"weight": True},
    {"weight": True, "reduction": "none"}, {"soft_label": True},
    {"use_softmax": False}])
def test_cross_entropy_matches_jax(kw):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 7)).astype(np.float32)
    labels = np.array([0, 3, 6, 3, 1, 2], np.int64)
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("weight"):
        w = rng.random(7).astype(np.float32) + 0.5
        jkw["weight"], tkw["weight"] = paddle.to_tensor(w), torch.from_numpy(w)
    if kw.get("soft_label"):
        labels = rng.random((6, 7)).astype(np.float32)
        labels /= labels.sum(-1, keepdims=True)
    if kw.get("use_softmax") is False:
        logits = np.abs(logits) / np.abs(logits).sum(-1, keepdims=True)
    want = JF.cross_entropy(paddle.to_tensor(logits),
                            paddle.to_tensor(labels), **jkw).numpy()
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          **tkw).numpy()
    assert _err(got, want) <= TOL


def test_dropout_layer():
    x = torch.ones(4, 64)
    d = Dropout(0.5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(d.eval()(x), x)
    y = d.train()(x)
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    assert torch.equal(Dropout(0.0).train()(x), x)
    with pytest.raises(ValueError, match="generator"):
        Dropout(0.5).train()(x)


# ------------------------------------------------------------------ model
def test_logits_and_loss_match_jax():
    jmodel, model = tiny_gpts(3)
    ids = np.random.default_rng(0).integers(0, 512, (2, 20)).astype(np.int32)
    labels = np.random.default_rng(1).integers(0, 512, (2, 20))
    want = jmodel(paddle.to_tensor(ids)).numpy()
    tids = torch.from_numpy(ids).long()
    got = model(tids).detach().numpy()
    assert _err(got, want) <= TOL
    jloss = float(jmodel(paddle.to_tensor(ids),
                         labels=paddle.to_tensor(labels)).numpy())
    loss = model(tids, labels=torch.from_numpy(labels))
    assert abs(float(loss.detach()) - jloss) <= TOL
    loss.backward()
    assert model.gpt.wte.weight.grad is not None
    crit = GPTPretrainingCriterion(GPTConfig.tiny())
    jcrit = float(JCriterion(JGPTConfig.tiny())(
        paddle.to_tensor(want), paddle.to_tensor(labels)).numpy())
    assert abs(float(crit(torch.from_numpy(got),
                          torch.from_numpy(labels))) - jcrit) <= TOL
    assert model.cache_spec() == [(4, 16), (4, 16)]
    assert GPTConfig.gpt3_345m().num_params() == \
        JGPTConfig.gpt3_345m().num_params()


def test_untied_head_and_state_names():
    jmodel, model = tiny_gpts(4, tie_word_embeddings=False)
    assert model.lm_head is not None
    names = sorted(n for n, _ in model.named_parameters())
    assert names == sorted(jmodel.raw_state()[0])
    ids = np.random.default_rng(2).integers(0, 512, (1, 9)).astype(np.int32)
    assert _err(model(torch.from_numpy(ids).long()).detach().numpy(),
                jmodel(paddle.to_tensor(ids)).numpy()) <= TOL


def test_generate_matches_jax():
    jmodel, model = tiny_gpts(5)
    ids = np.random.default_rng(3).integers(0, 512, (2, 9)).astype(np.int32)
    want = jmodel.generate(paddle.to_tensor(ids), max_new_tokens=10,
                           do_sample=False,
                           return_full_sequence=False).numpy()
    got = model.generate(torch.from_numpy(ids).long(), max_new_tokens=10,
                         return_full_sequence=False).numpy()
    assert np.array_equal(got, want)


# ----------------------------------------------------------------- engine
@pytest.mark.parametrize("chunk", [0, 8])
def test_engine_staggered_admission_matches_solo_and_jax(chunk):
    jmodel, model = tiny_gpts(71)
    prompts = [_rng_ids(i, n) for i, n in enumerate((5, 9, 20, 7))]
    refs = [solo(jmodel, p, 6) for p in prompts]
    outs = []
    for cls, m in ((JEngine, jmodel), (ServingEngine, model)):
        eng = cls(m, max_batch=2, page_size=8, max_seq_len=32,
                  prefill_chunk=chunk)
        eng.submit(prompts[0], 6)
        eng.submit(prompts[1], 6)
        eng.step()
        eng.step()
        eng.submit(prompts[2], 6)
        eng.submit(prompts[3], 6)
        out = eng.run()
        outs.append([out[i] for i in range(4)])
        if chunk and cls is ServingEngine:
            assert eng.chunk_dispatches == 2 + 3     # 9 and 20 tokens
            assert eng._spec is None
    assert outs[1] == outs[0] == refs


def _spec_run(cls, target, draft, prompts, n, **kw):
    eng = cls(target, max_batch=kw.pop("max_batch", 2), page_size=8,
              max_seq_len=kw.pop("max_seq_len", 64), draft_model=draft,
              **kw)
    rids = [eng.submit(p, n) for p in prompts]
    out = eng.run(max_wall=300.0)
    return eng, [out[r] for r in rids]


@pytest.mark.parametrize("case", ["same_width", "half_width"])
def test_gpt_draft_matches_plain_and_jax(case):
    jt, tt = tiny_gpts(7)
    if case == "same_width":
        jd, td = tiny_gpts(99)
        lens, n = (6, 4, 9), 12
    else:
        jd, td = tiny_gpts(1, hidden_size=32, num_hidden_layers=1,
                           num_attention_heads=2)
        lens, n = (7,), 16
    prompts = [_rng_ids(10 + i, k) for i, k in enumerate(lens)]
    refs = [solo(jt, p, n) for p in prompts]
    _, plain = _spec_run(ServingEngine, tt, None, prompts, n)
    jeng, jspec = _spec_run(JEngine, jt, jd, prompts, n)
    teng, tspec = _spec_run(ServingEngine, tt, td, prompts, n)
    assert tspec == plain == jspec == refs
    assert teng.spec_rounds == jeng.spec_rounds > 0
    assert (teng.spec_tokens_accepted, teng.spec_tokens_rejected) == (
        jeng.spec_tokens_accepted, jeng.spec_tokens_rejected)
    assert "generic" in teng.spec_draft_key.extra


def test_draft_scan_past_the_position_table():
    """A GPT draft whose engine budget ends at max_position_embeddings: the
    last rounds' scans (γ + 1 steps from the cursor) reach positions past
    the table, whose rows land on the null page. The streams equal the
    JAX engine's and solo decode."""
    maxpos = 32
    jt, tt = tiny_gpts(21, max_position_embeddings=maxpos)
    jd, td = tiny_gpts(22, max_position_embeddings=maxpos)
    prompts = [_rng_ids(30, 20), _rng_ids(31, 13)]
    n = maxpos - 20
    refs = [solo(jt, p, n) for p in prompts]
    jeng, jspec = _spec_run(JEngine, jt, jd, prompts, n, max_seq_len=maxpos)
    teng, tspec = _spec_run(ServingEngine, tt, td, prompts, n,
                            max_seq_len=maxpos)
    assert tspec == jspec == refs
    assert teng.spec_rounds == jeng.spec_rounds > 0
    # the positions the scans reached
    assert int(teng._draft_pool.block_tables.shape[1]) * 8 > maxpos


def test_attention_kernels_get_contiguous_inputs(monkeypatch):
    """On the card the attention kernels refuse a strided query (their
    plain versions here take any layout): every attention call of GPT's
    prefill, chunk and decode gets contiguous q (and k, v)."""
    from paddle_tpu_torch.kernels import decode_attention as da
    seen = []

    def spy(fn):
        def call(q, *args, **kw):
            seen.append(all(t.is_contiguous() for t in (q,) + args[:2]
                            if isinstance(t, torch.Tensor)))
            return fn(q, *args, **kw)
        return call

    monkeypatch.setattr(F, "paged_attention", spy(F.paged_attention))
    monkeypatch.setattr(F, "paged_chunk_attention",
                        spy(F.paged_chunk_attention))
    monkeypatch.setattr(da, "flash_prefill", spy(da.flash_prefill))
    _, model = tiny_gpts(9)
    eng = ServingEngine(model, max_batch=4, page_size=8, max_seq_len=64,
                        prefill_chunk=8)
    for n in (5, 9, 20):
        eng.submit(_rng_ids(n, n), 3)
    eng.run()
    assert len(seen) > 10 and all(seen)


def test_draft_refusals():
    _, tt = tiny_gpts(7)
    _, other = tiny_gpts(8, vocab_size=256)
    with pytest.raises(ValueError, match="vocabulary"):
        ServingEngine(tt, max_batch=1, page_size=8, max_seq_len=32,
                      draft_model=other)
    with pytest.raises(NotImplementedError, match="forward_hidden"):
        ServingEngine(tt, max_batch=1, page_size=8, max_seq_len=32,
                      draft_model=torch.nn.Linear(2, 2))
