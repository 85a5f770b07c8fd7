"""The port's BERT (``models/bert.py``) against the JAX package on the CPU,
on the same seeded numpy weights (JAX's ``raw_state()`` through
``load_numpy_state``) and inputs: ragged rows padded with
``pad_token_id``, two token types, 15 % of the real tokens labelled for
the masked LM (the rest -100), next-sentence labels.

Tolerances (fp32; JAX at ``jax_default_matmul_precision=highest``):
  - ``BertModel(tiny)``'s sequence and pooled outputs under the padding
    mask within 1e-5; the real tokens' outputs do not move when the padded
    positions' ids change (the mask holds);
  - ``BertForPretraining`` + ``BertPretrainingCriterion``: the loss within
    1e-5, every gradient within 1e-4 of its largest element (the tied
    word embedding's sums the embedding's and the decoder's uses);
  - 3 ``TrainStep`` AdamW steps: losses within 1e-5; over the elements
    whose first gradient is at least 100 Adam eps, each parameter within
    1e-4 of its update in L2; every element within 2 lr a step (Adam
    turns the rounding of gradients near eps into steps of about lr);
  - ``BertForMaskedLM`` (ignore_index) and ``BertForSequenceClassification``
    within 1e-5.
Also the tied decoder (one parameter and one JAX state entry, two
``state_dict`` names), dropout drawn from the model's generator, no flash
launch (the mask takes SDPA's dense path), and ``ErnieModel``.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.hapi import TrainStep as JTrainStep
from paddle_tpu.jit import functional_call
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn.layer import Layer as JLayer
from paddle_tpu_torch.device import seed
from paddle_tpu_torch.hapi import TrainStep
from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                     BertForPretraining,
                                     BertForSequenceClassification,
                                     BertModel, BertPretrainingCriterion,
                                     ErnieModel)
from paddle_tpu_torch.optimizer import AdamW

TOL = 1e-5
GRAD_RTOL = 1e-4
LR = 1e-3
ADAM_FLOOR = 1e-6
STEP_RTOL = 1e-4
B, S = 3, 24
LENS = (24, 17, 9)
TIED = "bert.embeddings.word_embeddings.weight"


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return _err(a, b) / max(float(np.max(np.abs(b))), 1e-30)


def _np(t):
    return t.detach().float().numpy()


def _weights(jm, seed_value):
    """Seeded numpy weights for a lazily built JAX model: matrices N(0,
    0.05), the LayerNorm scales 1 + N(0, 0.05), biases N(0, 0.05)."""
    rng = np.random.default_rng(seed_value)
    out = {}
    for name, spec in jm.raw_state()[0].items():
        w = rng.standard_normal(tuple(spec.shape)).astype(np.float32) * 0.05
        is_scale = ("ln_" in name or "layer_norm" in name) and \
            name.endswith("weight")
        out[name] = w + 1.0 if is_scale else w
    return out


def _pair(jcls, tcls, cfg=None, **kw):
    """The JAX model (built lazily) and the port's, on the same weights."""
    cfg = cfg or BertConfig.tiny()
    with paddle.LazyGuard():
        jm = jcls(jbert.BertConfig(**vars(cfg)), **kw)
    named = _weights(jm, 7)
    jm.load_raw_state({k: jnp.asarray(v) for k, v in named.items()})
    tm = tcls(cfg, device="cpu", **kw)
    tm.load_numpy_state(named)
    return jm, tm, named


def _batch(seed_value, vocab=512):
    """ids (pads 0 past each row's length), token types, MLM labels (15 %
    of the real tokens), NSP labels."""
    rng = np.random.default_rng(seed_value)
    ids = rng.integers(1, vocab, (B, S))
    tt = np.zeros((B, S), np.int64)
    mlm = np.full((B, S), -100, np.int64)
    for i, n in enumerate(LENS):
        ids[i, n:] = 0
        tt[i, n // 2:n] = 1
        pick = rng.choice(n, max(1, round(0.15 * n)), replace=False)
        mlm[i, pick] = ids[i, pick]
    nsp = rng.integers(0, 2, (B,))
    return ids, tt, mlm, nsp


def _j(*arrays):
    return tuple(jnp.asarray(np.asarray(a).astype(np.int32)) for a in arrays)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a, np.int64)) for a in arrays)


class _JPretrain(JLayer):
    """The JAX pretraining model and criterion as one layer: ``forward(ids,
    token types, MLM labels, NSP labels)`` -> loss (what TrainStep
    steps)."""

    def __init__(self, model, crit):
        super().__init__()
        self.model, self.crit = model, crit

    def forward(self, ids, tt, mlm, nsp):
        pred, nsp_logits = self.model(ids, tt)
        return self.crit(pred, nsp_logits, mlm, nsp)


class _TPretrain(torch.nn.Module):
    def __init__(self, model, crit):
        super().__init__()
        self.model, self.crit = model, crit

    def forward(self, ids, tt, mlm, nsp):
        pred, nsp_logits = self.model(ids, tt)
        return self.crit(pred, nsp_logits, mlm, nsp)


# ------------------------------------------------------------------ encoder
def test_bert_model_outputs_match_jax_under_the_padding_mask():
    jm, tm, _ = _pair(jbert.BertModel, BertModel)
    ids, tt, _, _ = _batch(1)
    jseq, jpooled = jm(*(paddle.to_tensor(a) for a in _j(ids, tt)))
    seq, pooled = tm(*_t(ids, tt))
    assert seq.shape == (B, S, 64) and pooled.shape == (B, 64)
    assert _err(_np(seq), jseq.numpy()) <= TOL
    assert _err(_np(pooled), jpooled.numpy()) <= TOL
    # the padded keys are masked: other ids there, under the same mask,
    # leave every real token's output where it was
    mask = (ids != 0).astype(np.int64)
    junk = np.where(mask == 1, ids, 77)
    seq2, _ = tm(*_t(junk, tt), attention_mask=torch.from_numpy(mask))
    for i, n in enumerate(LENS):
        assert torch.allclose(seq2[i, :n], seq[i, :n], atol=1e-6, rtol=0)


# ------------------------------------------------------------- pretraining
def _pretrain_pair():
    jm, tm, named = _pair(jbert.BertForPretraining, BertForPretraining)
    cfg = BertConfig.tiny()
    jw = _JPretrain(jm, jbert.BertPretrainingCriterion(
        jbert.BertConfig(**vars(cfg))))
    tw = _TPretrain(tm, BertPretrainingCriterion(cfg))
    return jw, tw, named


def test_tied_decoder_is_one_parameter_and_one_state_entry():
    jw, tw, named = _pretrain_pair()
    tm = tw.model
    assert len(named) == 38 and TIED in named
    assert not any("decoder_weight" in k for k in named)
    params = dict(tm.named_parameters())
    assert sorted(params) == sorted(named)
    assert tm.cls.decoder_weight is tm.bert.embeddings.word_embeddings.weight
    sd = tm.state_dict()
    assert len(sd) == 39
    assert sd["cls.decoder_weight"].data_ptr() == sd[TIED].data_ptr()
    # a loaded value lands in both uses
    with torch.no_grad():
        params[TIED][0, 0] = 5.0
    assert float(tm.cls.decoder_weight.detach()[0, 0]) == 5.0


def test_pretraining_loss_and_grads_match_jax():
    jw, tw, named = _pretrain_pair()
    ids, tt, mlm, nsp = _batch(2)
    jparams = {f"model.{k}": jnp.asarray(v) for k, v in named.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: functional_call(jw, p, *_j(ids, tt, mlm, nsp))))(jparams)
    loss = tw(*_t(ids, tt, mlm, nsp))
    loss.backward()
    assert _err(float(loss.detach()), float(jloss)) <= TOL
    assert sorted(jgrads) == sorted(f"model.{k}" for k, _ in
                                    tw.model.named_parameters())
    for name, p in tw.model.named_parameters():
        assert _rel(_np(p.grad), np.asarray(jgrads[f"model.{name}"])) \
            <= GRAD_RTOL, name


def test_pretraining_steps_match_jax():
    jw, tw, init = _pretrain_pair()
    batches = [_batch(10 + i) for i in range(3)]
    jstep = JTrainStep(jw, paddle.optimizer.AdamW(
        LR, parameters=jw.parameters(), weight_decay=0.01))
    jl = [float(jstep(*(paddle.to_tensor(a) for a in _j(*bt))))
          for bt in batches]
    jstep.sync_to_model()
    jp = {k: np.asarray(v, np.float64)
          for k, v in jw.model.raw_state()[0].items()}
    tw(*_t(*batches[0])).backward()
    first = {k: p.grad.abs().numpy()
             for k, p in tw.model.named_parameters()}
    step = TrainStep(tw, AdamW(LR, parameters=tw.model.named_parameters(),
                               weight_decay=0.01))
    tl = [float(step(*_t(*bt))) for bt in batches]
    assert _err(tl, jl) <= TOL, (tl, jl)
    for name, p in tw.model.named_parameters():
        got, want = p.detach().double().numpy(), jp[name]
        assert np.abs(got - want).max() <= 2 * LR * len(batches), name
        keep = first[name] >= ADAM_FLOOR
        moved = np.linalg.norm((want - init[name])[keep])
        assert np.linalg.norm((got - want)[keep]) <= STEP_RTOL * moved, name


# ------------------------------------------------------------------- heads
def test_masked_lm_matches_jax_and_ignores_unlabelled_positions():
    jm, tm, _ = _pair(jbert.BertForMaskedLM, BertForMaskedLM)
    ids, tt, mlm, _ = _batch(3)
    jlogits, jloss = jm(*(paddle.to_tensor(a) for a in _j(ids, tt)),
                        labels=paddle.to_tensor(_j(mlm)[0]))
    logits, loss = tm(*_t(ids, tt), labels=_t(mlm)[0])
    assert _err(_np(logits), jlogits.numpy()) <= TOL
    assert _err(float(loss.detach()), float(jloss)) <= TOL
    assert torch.equal(tm(*_t(ids, tt)), logits)
    none = torch.full((B, S), -100, dtype=torch.int64)
    assert float(tm(*_t(ids, tt), labels=none)[1].detach()) == 0.0


def test_sequence_classification_matches_jax():
    jm, tm, _ = _pair(jbert.BertForSequenceClassification,
                      BertForSequenceClassification, num_classes=3)
    ids, tt, _, _ = _batch(4)
    jm.eval()
    tm.eval()
    want = jm(*(paddle.to_tensor(a) for a in _j(ids, tt))).numpy()
    got = tm(*_t(ids, tt))
    assert got.shape == (B, 3)
    assert _err(_np(got), want) <= TOL


def test_dropout_draws_from_the_model_generator():
    """At bert-base's dropout (0.1 hidden and attention) a training forward
    draws its masks from the model's generator: two models from one seed
    agree, another seed differs, eval mode drops nothing."""
    cfg = BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.1
    ids, tt, _, _ = _batch(5)

    def run(s, train=True):
        m = BertModel(cfg, device="cpu", generator=seed(s))
        m.train(train)
        return m(*_t(ids, tt))[0]

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, train=False), run(1, train=False))
    assert not torch.equal(run(1), run(1, train=False))


def test_attention_takes_the_dense_path(monkeypatch):
    """The additive padding mask routes SDPA to its dense composition: no
    flash wrapper runs, on the CPU or (by the same route) on the card."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F
    called = []
    monkeypatch.setattr(fa, "flash_attention_fwd_ref",
                        lambda *a, **k: called.append(1))
    real = F._sdpa_dense
    dense = []

    def spy(*a, **k):
        dense.append(1)
        return real(*a, **k)

    monkeypatch.setattr(F, "_sdpa_dense", spy)
    kernels.reset_launches()
    _, tw, _ = _pretrain_pair()
    tw(*_t(*_batch(6))).backward()
    assert not called and len(dense) == BertConfig.tiny().num_hidden_layers
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_ernie_alias_and_configs():
    assert ErnieModel is BertModel
    assert BertConfig.ernie_base().vocab_size == 18000
    base = BertConfig.bert_base()
    assert (base.hidden_size, base.num_hidden_layers, base.num_attention_heads,
            base.intermediate_size, base.vocab_size) == (768, 12, 12, 3072,
                                                         30522)
    assert vars(base) == vars(jbert.BertConfig.bert_base())
