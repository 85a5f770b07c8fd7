"""BERT / ERNIE encoders (counterpart of ``paddle_tpu/models/bert.py``):
word + position + token-type embeddings, post-LN blocks of bidirectional
attention and a GELU (tanh) MLP, the pooler, and the pretraining heads
(masked LM tied to the word embedding, next-sentence prediction) with
``BertPretrainingCriterion`` (ignore index -100).

Parameter names and shapes are the JAX model's, so ``raw_state()`` carries
across through ``load_numpy_state``. The masked-LM decoder weight is the
word embedding's ``nn.Parameter`` itself: ``named_parameters()`` (what the
optimizer steps and the loader fills) lists it once, as
``bert.embeddings.word_embeddings.weight``, as the JAX state does, and its
gradient sums both uses; ``state_dict()`` names the one tensor twice.

Attention always runs under the additive ``(B, 1, 1, S)`` padding mask,
so ``scaled_dot_product_attention`` takes its dense path (PyTorch
products, no flash kernel), as in the JAX package. Every dropout draws its
mask from the model's ``generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..convert import load_state
from ..device import DeviceLike, resolve_device, seed
from ..nn import functional as F
from ..nn.layers.common import Dropout, Embedding, LayerNorm, Linear

__all__ = [
    "BertConfig", "BertModel", "BertForPretraining", "BertForMaskedLM",
    "BertForSequenceClassification", "BertPretrainingCriterion",
    "ErnieModel",
]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-12
    pad_token_id: int = 0

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @staticmethod
    def bert_base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def ernie_base() -> "BertConfig":
        # ERNIE 1.0 zh: the same encoder, an 18000-word vocabulary
        return BertConfig(vocab_size=18000)

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab_size=512, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          max_position_embeddings=128,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)


def _kw(device, dtype, generator) -> dict:
    """The constructor keywords every layer takes: the device, the dtype
    and the generator (default: seed 0 on the device)."""
    dev = resolve_device(device)
    return dict(device=dev, dtype=dtype or torch.float32,
                generator=generator if generator is not None
                else seed(0, dev))


def _norm(config: BertConfig, kw) -> LayerNorm:
    return LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                     device=kw["device"], dtype=kw["dtype"])


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LN -> dropout."""

    def __init__(self, config: BertConfig, **kw):
        super().__init__()
        std, h = config.initializer_range, config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h, std=std, **kw)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h, std=std, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               std=std, **kw)
        self.layer_norm = _norm(config, kw)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=kw["generator"])

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, dtype=torch.int64,
                                        device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        std = config.initializer_range
        self.qkv_proj = Linear(h, 3 * h, std=std, **kw)
        self.out_proj = Linear(h, h, std=std, **kw)
        self.attn_drop_p = config.attention_probs_dropout_prob
        self.generator = kw["generator"]

    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=False,
            dropout_p=self.attn_drop_p if self.training else 0.0,
            training=self.training, generator=self.generator)
        return self.out_proj(out.reshape(b, s, h))


class BertLayer(nn.Module):
    """Post-LN block (BERT's residual order, ``LN(x + sublayer(x))``)."""

    def __init__(self, config: BertConfig, **kw):
        super().__init__()
        std = config.initializer_range
        self.attention = BertSelfAttention(config, **kw)
        self.ln_1 = _norm(config, kw)
        self.fc_in = Linear(config.hidden_size, config.intermediate_size,
                            std=std, **kw)
        self.fc_out = Linear(config.intermediate_size, config.hidden_size,
                             std=std, **kw)
        self.ln_2 = _norm(config, kw)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=kw["generator"])

    def forward(self, x, attn_mask=None):
        x = self.ln_1(x + self.dropout(self.attention(x, attn_mask)))
        mlp = self.fc_out(F.gelu(self.fc_in(x), approximate=True))
        return self.ln_2(x + self.dropout(mlp))


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig, **kw):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            std=config.initializer_range, **kw)

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """Returns ``(sequence_output, pooled_output)``. ``attention_mask``:
    ``(B, S)``, 1 a real token and 0 a pad (default: ``input_ids !=
    pad_token_id``), turned into an additive f32 ``(B, 1, 1, S)`` key mask
    of 0 and -1e30. Built on the card unless ``device`` says otherwise;
    weights and dropout masks come from ``generator`` (default: seed 0 on
    the model's device)."""

    def __init__(self, config: BertConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, dtype, generator)
        self.config = config
        self.embeddings = BertEmbeddings(config, **kw)
        self.encoder = nn.ModuleList(BertLayer(config, **kw)
                                     for _ in range(config.num_hidden_layers))
        self.pooler = BertPooler(config, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        if attention_mask is None:
            attention_mask = (input_ids != self.config.pad_token_id).long()
        add_mask = ((1.0 - attention_mask.float()) * -1e30)[:, None, None]
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            x = layer(x, add_mask)
        return x, self.pooler(x)

    def load_numpy_state(self, named: Mapping[str, np.ndarray]) -> None:
        """Copy every parameter from ``named`` (the JAX ``raw_state()[0]``),
        each cast to its parameter's dtype."""
        load_state(self, named)


class BertLMPredictionHead(nn.Module):
    """The MLM transform and the decoder, whose weight is
    ``embedding_weights`` itself (tied, ``(V, H)``)."""

    def __init__(self, config: BertConfig, embedding_weights: nn.Parameter,
                 **kw):
        super().__init__()
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                std=config.initializer_range, **kw)
        self.layer_norm = _norm(config, kw)
        self.decoder_weight = embedding_weights
        self.decoder_bias = nn.Parameter(torch.zeros(
            config.vocab_size, device=kw["device"], dtype=kw["dtype"]))

    def forward(self, hidden):
        h = self.layer_norm(F.gelu(self.transform(hidden), approximate=True))
        return h @ self.decoder_weight.T + self.decoder_bias


class _Headed(nn.Module):
    """A BertModel under heads: the shared constructor keywords and the
    JAX-state loader."""

    def __init__(self, config, device, dtype, generator):
        super().__init__()
        self._kw = _kw(device, dtype, generator)
        self.bert = BertModel(config, **self._kw)

    def load_numpy_state(self, named: Mapping[str, np.ndarray]) -> None:
        """Copy every parameter from ``named`` (the JAX ``raw_state()[0]``,
        the tied decoder weight once under the word embedding's name)."""
        load_state(self, named)


class BertForPretraining(_Headed):
    """The MLM and NSP heads: ``forward`` -> ``(prediction_logits,
    nsp_logits)``."""

    def __init__(self, config: BertConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(config, device, dtype, generator)
        self.cls = BertLMPredictionHead(
            config, self.bert.embeddings.word_embeddings.weight, **self._kw)
        self.nsp = Linear(config.hidden_size, 2,
                          std=config.initializer_range, **self._kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.cls(seq), self.nsp(pooled)


class BertPretrainingCriterion(nn.Module):
    """Mean cross entropy of the masked-LM logits over the labelled
    positions (label -100: unlabelled), plus the NSP cross entropy when
    its labels are given."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.vocab_size = config.vocab_size

    def forward(self, prediction_logits, nsp_logits, masked_lm_labels,
                next_sentence_labels=None):
        mlm = F.cross_entropy(
            prediction_logits.reshape(-1, self.vocab_size),
            masked_lm_labels.reshape(-1), ignore_index=-100,
            reduction="mean")
        if next_sentence_labels is None:
            return mlm
        nsp = F.cross_entropy(nsp_logits, next_sentence_labels.reshape(-1),
                              reduction="mean")
        return mlm + nsp


class BertForMaskedLM(_Headed):
    """The MLM head alone: logits, or with ``labels`` ``(logits, loss)``."""

    def __init__(self, config: BertConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(config, device, dtype, generator)
        self.cls = BertLMPredictionHead(
            config, self.bert.embeddings.word_embeddings.weight, **self._kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.cls(seq)
        if labels is None:
            return logits
        loss = F.cross_entropy(
            logits.reshape(-1, self.bert.config.vocab_size),
            labels.reshape(-1), ignore_index=-100, reduction="mean")
        return logits, loss


class BertForSequenceClassification(_Headed):
    """A linear classifier over the dropped-out pooled output."""

    def __init__(self, config: BertConfig, num_classes: int = 2,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(config, device, dtype, generator)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=self._kw["generator"])
        self.classifier = Linear(config.hidden_size, num_classes,
                                 std=config.initializer_range, **self._kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


# ERNIE 1.0 shares the BERT encoder exactly (its pretraining data and
# masking differ, not the module graph)
ErnieModel = BertModel
