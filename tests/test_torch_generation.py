"""The port's generation (``GenerationMixin`` on the ring-buffer cache)
against the JAX package's, on the tiny Llama with the same seeded numpy
weights in both packages (``torch_serving_twins``), in fp32.

Held equal, token for token: greedy ``generate`` (MHA and GQA) against the
JAX ``generate`` and a no-cache argmax loop; eos/pad, the repetition
penalty and ``min_new_tokens``; beam search with and without eos;
``generate_paged`` against the JAX version and ``generate``;
``generate_speculative`` with a smaller draft, the model as its own draft,
γ = 1 and a GQA target, against ``generate`` and the JAX version. Within
1e-5: ``cached_scaled_dot_product_attention`` against the JAX function
(prefill and decode, GQA, an offset, junk past the valid length). Sampled
``generate`` draws from a ``torch.Generator`` (the JAX package's
``jax.random`` bits cannot be reproduced), so it is held by law: top_k = 1
equals greedy, one seed gives one stream, and at an 8-token vocabulary
the first token's empirical law over 4000 rows is within total variation
0.05 of the filtered softmax.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.generation import sampling as tsampling
from paddle_tpu_torch.nn import functional as TF
from torch_serving_twins import tiny_llamas

ATOL = 1e-5
MHA = dict(num_key_value_heads=4)


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) pairs: the tiny GQA Llama, its MHA twin, a
    second GQA one (a draft of the same shape) and a half-width 1-layer
    draft."""
    return dict(
        gqa=tiny_llamas(11), mha=tiny_llamas(12, **MHA),
        draft=tiny_llamas(13),
        narrow=tiny_llamas(14, hidden_size=32, num_hidden_layers=1,
                           num_attention_heads=2, num_key_value_heads=1,
                           intermediate_size=64))


def _prompt(seed, b, p, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, p)).astype(
        np.int32)


def _jax(jmodel, method, prompt, *args, **kw):
    return getattr(jmodel, method)(paddle.to_tensor(prompt), *args,
                                   **kw).numpy()


def _port(model, method, prompt, *args, **kw):
    return getattr(model, method)(torch.from_numpy(prompt), *args,
                                  **kw).numpy()


# ------------------------------------------------------------ cached SDPA
@pytest.mark.parametrize("s,offset,hkv", [(6, 0, 2), (1, 9, 2), (4, 5, 4),
                                          (1, 0, 4)])
def test_cached_sdpa_matches_jax(s, offset, hkv):
    rng = np.random.default_rng(s + 10 * offset + hkv)
    b, h, d, t = 2, 4, 16, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    # a written prefix, and junk (large values) past the valid length
    kc = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    kc[:, offset + s:] = 1e4
    vc[:, offset + s:] = -1e4
    jo, jk, jv = JF.cached_scaled_dot_product_attention(
        *(paddle.to_tensor(x) for x in (q, k, v, kc, vc)), offset)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, tk2, tv2 = TF.cached_scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), tk, tv, offset)
    assert tk2 is tk and tv2 is tv           # written in place
    np.testing.assert_allclose(to.numpy(), jo.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tk.numpy(), jk.numpy())
    np.testing.assert_array_equal(tv.numpy(), jv.numpy())


# --------------------------------------------------------------- generate
def _argmax_loop(model, prompt, n):
    """Greedy decode by the no-cache forward, one token at a time."""
    ids = torch.from_numpy(prompt).long()
    with torch.no_grad():
        for _ in range(n):
            nxt = model(ids)[:, -1].argmax(-1)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    return ids.numpy()


@pytest.mark.parametrize("which", ["gqa", "mha"])
def test_greedy_matches_jax_and_no_cache_loop(models, which):
    jmodel, model = models[which]
    prompt = _prompt(1, 2, 8)
    got = _port(model, "generate", prompt, max_new_tokens=6)
    assert got.shape == (2, 14) and got.dtype == np.int32
    np.testing.assert_array_equal(got, _jax(jmodel, "generate", prompt,
                                            max_new_tokens=6))
    np.testing.assert_array_equal(got, _argmax_loop(model, prompt, 6))
    tail = _port(model, "generate", prompt, max_new_tokens=6,
                 return_full_sequence=False)
    np.testing.assert_array_equal(tail, got[:, 8:])


def test_generate_restores_training_mode(models):
    _, model = models["gqa"]
    model.train()
    try:
        _port(model, "generate", _prompt(2, 1, 4), max_new_tokens=2)
        assert model.training
    finally:
        model.eval()


def _free_first(model, prompt):
    return int(_port(model, "generate", prompt, max_new_tokens=1)[0, -1])


@pytest.mark.parametrize("case", ["eos_pad", "repetition_penalty",
                                  "min_new_tokens"])
def test_logit_options_match_jax(models, case):
    jmodel, model = models["gqa"]
    prompt = _prompt(3, 2, 6)
    eos = _free_first(model, prompt)
    kw = dict(eos_pad=dict(eos_token_id=eos, pad_token_id=0),
              repetition_penalty=dict(repetition_penalty=1.8),
              min_new_tokens=dict(eos_token_id=eos, min_new_tokens=3))[case]
    got = _port(model, "generate", prompt, max_new_tokens=5, **kw)
    np.testing.assert_array_equal(
        got, _jax(jmodel, "generate", prompt, max_new_tokens=5, **kw))
    if case == "eos_pad":
        row = got[0, 6:]
        hit = np.flatnonzero(row == eos)[0]
        assert np.all(row[hit + 1:] == 0)
    if case == "min_new_tokens":
        assert not np.any(got[:, 6:9] == eos)


# ------------------------------------------------------------------- beam
@pytest.mark.parametrize("with_eos", [False, True])
def test_beam_matches_jax(models, with_eos):
    jmodel, model = models["gqa"]
    prompt = _prompt(4, 2, 5)
    kw = dict(max_new_tokens=5, num_beams=3, length_penalty=0.7,
              return_full_sequence=False)
    if with_eos:
        kw["eos_token_id"] = _free_first(model, prompt)
    got = _port(model, "generate", prompt, **kw)
    np.testing.assert_array_equal(got, _jax(jmodel, "generate", prompt,
                                            **kw))


def test_beam_refuses_sampling(models):
    _, model = models["gqa"]
    with pytest.raises(ValueError, match="beam"):
        _port(model, "generate", _prompt(5, 1, 4), max_new_tokens=2,
              num_beams=2, do_sample=True,
              generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("method,kw", [
    ("generate", {}), ("generate_paged", {"page_size": 8}),
    ("generate_speculative", {"num_speculative_tokens": 4})])
def test_max_position_refused(models, method, kw):
    _, model = models["gqa"]
    args = (model,) if method == "generate_speculative" else ()
    with pytest.raises(ValueError, match="max_position_embeddings"):
        _port(model, method, np.zeros((1, 120), np.int32), *args,
              max_new_tokens=9, **kw)


# ------------------------------------------------------------------ paged
@pytest.mark.parametrize("which", ["gqa", "mha"])
def test_generate_paged_matches_jax_and_generate(models, which):
    jmodel, model = models[which]
    prompt = _prompt(6, 3, 11)
    got = _port(model, "generate_paged", prompt, max_new_tokens=7,
                page_size=8)
    np.testing.assert_array_equal(
        got, _jax(jmodel, "generate_paged", prompt, max_new_tokens=7,
                  page_size=8))
    np.testing.assert_array_equal(got, _port(model, "generate", prompt,
                                             max_new_tokens=7))


def test_generate_paged_eos_pads(models):
    jmodel, model = models["gqa"]
    prompt = _prompt(7, 2, 5)
    eos = _free_first(model, prompt)
    kw = dict(max_new_tokens=4, page_size=8, eos_token_id=eos,
              pad_token_id=0)
    got = _port(model, "generate_paged", prompt, **kw)
    np.testing.assert_array_equal(got, _jax(jmodel, "generate_paged",
                                            prompt, **kw))
    assert np.all(got[0, 6:] == 0)


# ------------------------------------------------------------ speculative
@pytest.mark.parametrize("target,draft,gamma", [
    ("gqa", "narrow", 3), ("gqa", "gqa", 4), ("gqa", "draft", 1),
    ("mha", "draft", 3)])
def test_speculative_is_lossless(models, target, draft, gamma):
    jt, tt = models[target]
    jd, td = models[draft]
    prompt = _prompt(8, 1, 6)
    ref = _port(tt, "generate", prompt, max_new_tokens=9)
    got = _port(tt, "generate_speculative", prompt, td, max_new_tokens=9,
                num_speculative_tokens=gamma)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, _jax(jt, "generate_speculative", prompt, jd, max_new_tokens=9,
                  num_speculative_tokens=gamma))
    stats = tt.speculative_stats
    assert stats["proposed"] == stats["rounds"] * gamma
    if target == draft:
        # the model as its own draft agrees with itself every time
        assert stats["accepted"] == stats["proposed"]


def test_speculative_refuses_batch(models):
    _, model = models["gqa"]
    with pytest.raises(ValueError, match="batch=1"):
        _port(model, "generate_speculative", _prompt(9, 2, 4), model,
              max_new_tokens=2)


# ---------------------------------------------------------------- sampled
def test_sampled_top_k1_is_greedy_and_seeded(models):
    _, model = models["gqa"]
    prompt = _prompt(10, 2, 6)
    greedy = _port(model, "generate", prompt, max_new_tokens=6)
    top1 = _port(model, "generate", prompt, max_new_tokens=6,
                 do_sample=True, top_k=1, temperature=5.0,
                 generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(top1, greedy)
    law = dict(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=50,
               top_p=0.95)
    runs = [_port(model, "generate", prompt,
                  generator=torch.Generator().manual_seed(7), **law)
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="generator"):
        _port(model, "generate", prompt, max_new_tokens=2, do_sample=True)


def test_sampled_law_matches_filtered_softmax():
    _, model = tiny_llamas(15, vocab_size=8)
    rows, law = 4000, dict(temperature=0.8, top_k=5, top_p=0.9)
    prompt = np.tile(_prompt(11, 1, 4, vocab=8), (rows, 1))
    first = _port(model, "generate", prompt, max_new_tokens=1,
                  do_sample=True, generator=torch.Generator().manual_seed(5),
                  return_full_sequence=False, **law)[:, 0]
    with torch.no_grad():
        logits = model(torch.from_numpy(prompt[:1]).long())[0, -1]
    want = tsampling._spec_filtered_probs(
        logits.float()[None], law["temperature"], law["top_k"],
        law["top_p"])[0].numpy()
    got = np.bincount(first, minlength=8) / rows
    assert np.all(got[want == 0] == 0)
    assert 0.5 * np.abs(got - want).sum() < 0.05
