"""GPT (counterpart of ``paddle_tpu/models/gpt.py``, the GPT-3 345M
exemplar): learned token and position embeddings, pre-LN blocks of
multi-head attention and a GELU (tanh) MLP, the LM head tied to the token
embedding by default, ``GPTPretrainingCriterion`` and the pipeline model
(``GPTEmbeddingPipe``, ``GPTForCausalLMPipe``).

Parameter names and shapes are the JAX model's (``Linear`` keeps the
``(in, out)`` layout), so ``raw_state()`` carries across through
:meth:`GPTForCausalLM.load_numpy_state`. The cached forward runs over the
paged KV pool (serving) or over ``(k_cache, v_cache)`` ring buffers
(:class:`~paddle_tpu_torch.generation.GenerationMixin`'s ``generate``); the
no-cache forward runs causal ``scaled_dot_product_attention`` on the flash
kernels, and with ``labels`` returns the chunked fused LM loss.

Positions past the position table (``max_position_embeddings``) read its
last row. Only a serving engine's rounds reach them: a draft scan or a
verify at the end of a token budget, and the padded tail of a chunk. The
rows written there land on the null page or past the block table, and
their outputs are never read, so the tokens are the JAX engine's (whose
``jnp.take`` gives NaN rows there); on the card an index out of range
would end the process.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..convert import load_state
from ..device import DeviceLike, resolve_device, seed
from ..generation import GenerationMixin
from ..incubate.nn import functional as FF
from ..kernels.paged_attention import is_paged_state, paged_position_ids
from ..nn import functional as F
from ..nn.layers.common import Dropout, Embedding, LayerNorm, Linear
from .llama import is_ring_cache


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @staticmethod
    def gpt3_345m() -> "GPTConfig":
        return GPTConfig(hidden_size=1024, num_hidden_layers=24,
                         num_attention_heads=16)

    @staticmethod
    def tiny() -> "GPTConfig":
        return GPTConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=128)

    def num_params(self) -> int:
        h, l, v = self.hidden_size, self.num_hidden_layers, self.vocab_size
        per_layer = 4 * h * h + 2 * h * self.intermediate_size  # attn + mlp
        per_layer += 4 * h + 2 * self.intermediate_size         # biases
        per_layer += 4 * h                                       # 2x LN
        emb = v * h + self.max_position_embeddings * h
        return l * per_layer + emb + 2 * h


def _deep_std(config: GPTConfig) -> float:
    """The output projections' init scale: range / sqrt(2 layers)."""
    return config.initializer_range / math.sqrt(2 * config.num_hidden_layers)


class GPTSelfAttention(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv_proj = Linear(h, 3 * h, std=config.initializer_range, **kw)
        self.out_proj = Linear(h, h, std=_deep_std(config), **kw)
        self.attn_drop_p = config.attention_probs_dropout_prob
        self.generator = kw["generator"]

    def forward(self, x, attn_mask=None, cache=None):
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        # one copy to (3, B, S, H, D): q, k and v come out contiguous, as
        # the attention kernels take them
        q, k, v = qkv.permute(2, 0, 1, 3, 4).contiguous().unbind(0)
        if cache is not None:
            state, offset = cache
            if is_ring_cache(state):
                out, kc, vc = F.cached_scaled_dot_product_attention(
                    q, k, v, state[0], state[1], offset)
                return self.out_proj(out.reshape(b, s, h)), (kc, vc)
            # a paged state; anything else reaches paged attention's refusal
            out, state = F.paged_scaled_dot_product_attention(q, k, v, state)
            return self.out_proj(out.reshape(b, s, h)), state
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None,
            dropout_p=self.attn_drop_p if self.training else 0.0,
            training=self.training, generator=self.generator)
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        self.fc_in = Linear(config.hidden_size, config.intermediate_size,
                            std=config.initializer_range, **kw)
        self.fc_out = Linear(config.intermediate_size, config.hidden_size,
                             std=_deep_std(config), **kw)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        norm_kw = {k: kw[k] for k in ("device", "dtype")}
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, eps, **norm_kw)
        self.attn = GPTSelfAttention(config, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, eps, **norm_kw)
        self.mlp = GPTMLP(config, **kw)
        self.drop = Dropout(config.hidden_dropout_prob,
                            generator=kw["generator"])

    def forward(self, x, attn_mask=None, cache=None):
        if cache is not None:
            attn, new_cache = self.attn(self.ln_1(x), attn_mask, cache)
            x = x + self.drop(attn)
            x = x + self.drop(self.mlp(self.ln_2(x)))
            return x, new_cache
        x = x + self.drop(self.attn(self.ln_1(x), attn_mask))
        return x + self.drop(self.mlp(self.ln_2(x)))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        self.config = config
        std = config.initializer_range
        self.wte = Embedding(config.vocab_size, config.hidden_size, std=std,
                             **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, std=std, **kw)
        self.drop = Dropout(config.hidden_dropout_prob,
                            generator=kw["generator"])
        self.h = nn.ModuleList(GPTBlock(config, **kw)
                               for _ in range(config.num_hidden_layers))
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              device=kw["device"], dtype=kw["dtype"])

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                caches=None, offset=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = self._position_ids(s, offset, caches,
                                              input_ids.device)
        # past the table: its last row (the module docstring)
        position_ids = position_ids.clamp(
            max=self.config.max_position_embeddings - 1)
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        if caches is None:
            for block in self.h:
                x = block(x, attn_mask)
            return self.ln_f(x)
        new_caches = []
        for block, entry in zip(self.h, caches):
            x, nc = block(x, attn_mask, cache=(entry, offset))
            new_caches.append(nc)
        return self.ln_f(x), new_caches

    @staticmethod
    def _position_ids(s, offset, caches, device):
        if caches and is_paged_state(caches[0]):
            return paged_position_ids(s, offset, caches[0])
        # a ring buffer's offset is a host int: no device read
        base = torch.arange(s, dtype=torch.int64, device=device).unsqueeze(0)
        return base if offset is None else base + int(offset)


class GPTForCausalLM(GenerationMixin, nn.Module):
    """GPT with its LM head (tied to ``wte`` unless the config says
    otherwise). Built on the card unless ``device`` says otherwise; weights
    are drawn from ``generator`` (default: seed 0 on the model's device),
    which also draws training dropout's masks. ``generate``,
    ``generate_paged`` and ``generate_speculative`` come from
    :class:`GenerationMixin`; the serving engine runs it through its
    generic route (``forward_hidden``)."""

    def __init__(self, config: GPTConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or torch.float32
        if generator is None:
            generator = seed(0, dev)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.config = config
        self.gpt = GPTModel(config, **kw)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size, False,
                               std=config.initializer_range, **kw))

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.wte.weight.dtype

    def logits(self, hidden):
        if self.lm_head is None:
            return hidden @ self.gpt.wte.weight.T
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None, attn_mask=None,
                position_ids=None):
        """Logits, or with ``labels`` the mean causal-LM loss through
        :func:`fused_linear_cross_entropy`. ``attn_mask`` replaces the
        causal mask and routes attention through SDPA's dense path."""
        hidden = self.gpt(input_ids, attn_mask, position_ids)
        if labels is None:
            return self.logits(hidden)
        if self.lm_head is None:
            return FF.fused_linear_cross_entropy(
                hidden, self.gpt.wte.weight, labels, transpose_y=True)
        return FF.fused_linear_cross_entropy(hidden, self.lm_head.weight,
                                             labels)

    def cache_spec(self):
        c = self.config
        return [(c.num_attention_heads,
                 c.hidden_size // c.num_attention_heads)
                for _ in range(c.num_hidden_layers)]

    def forward_hidden(self, input_ids, caches, offset):
        """The final hidden states (after ``ln_f``) and the updated caches:
        the cached forward without the LM head."""
        return self.gpt(input_ids, caches=caches, offset=offset)

    def forward_with_cache(self, input_ids, caches, offset):
        """Logits and the updated caches (``caches`` and ``offset`` as
        Llama's ``forward_with_cache``)."""
        hidden, new_caches = self.forward_hidden(input_ids, caches, offset)
        return self.logits(hidden), new_caches

    def load_numpy_state(self, named: Mapping[str, np.ndarray],
                         buffers: Optional[Mapping[str, np.ndarray]] = None
                         ) -> None:
        """Copy every parameter from ``named`` (e.g. the JAX model's
        ``raw_state()``) and with ``buffers`` every buffer, as Llama's
        :meth:`~paddle_tpu_torch.models.llama.LlamaForCausalLM.load_numpy_state`."""
        load_state(self, named, buffers)


class GPTPretrainingCriterion(nn.Module):
    """Mean cross entropy over all tokens of ``(logits, labels)``
    (:func:`~paddle_tpu_torch.nn.functional.cross_entropy`)."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.vocab_size = config.vocab_size

    def forward(self, logits, labels):
        return F.cross_entropy(logits.reshape(-1, self.vocab_size),
                               labels.reshape(-1), reduction="mean")


# ====================================================== pipeline-parallel pipe
class GPTEmbeddingPipe(nn.Module):
    """The pipeline's first entry: token + position embedding (+ dropout).
    Shared (tied) with the head through ``SharedLayerDesc("embed")``."""

    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        std = config.initializer_range
        self.wte = Embedding(config.vocab_size, config.hidden_size, std=std,
                             **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, std=std, **kw)
        self.drop = Dropout(config.hidden_dropout_prob,
                            generator=kw["generator"])

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device).unsqueeze(0)
        return self.drop(self.wte(input_ids) + self.wpe(pos))


def _embedding_as_head(layer: GPTEmbeddingPipe, hidden):
    """The tied head's forward: logits through ``wte`` transposed."""
    return hidden @ layer.wte.weight.T


def GPTForCausalLMPipe(config: GPTConfig, num_stages: Optional[int] = None,
                       topology=None, seg_method: str = "layer:GPTBlock",
                       recompute_interval: int = 0,
                       num_virtual_pipeline_stages: Optional[int] = None,
                       device: DeviceLike = None,
                       dtype: Optional[torch.dtype] = None,
                       generator: Optional[torch.Generator] = None):
    """The pipeline-parallel GPT: the shared embedding (entry 0), the
    blocks (1 .. n), ``ln_f`` (n + 1) and the head (n + 2): the embedding
    again through ``_embedding_as_head`` when tied, else a ``Linear``.
    Under a live pipeline topology the embedding is built on stage 0 and
    on the last stage, whose ``wte`` copies the step keeps equal."""
    from ..distributed.fleet.meta_parallel.pp_layers import (
        LayerDesc, PipelineLayer, SharedLayerDesc)
    descs = [SharedLayerDesc("embed", GPTEmbeddingPipe, None, "wte.weight",
                             config)]
    descs += [LayerDesc(GPTBlock, config)
              for _ in range(config.num_hidden_layers)]
    descs.append(LayerDesc(LayerNorm, config.hidden_size,
                           config.layer_norm_epsilon))
    if config.tie_word_embeddings:
        descs.append(SharedLayerDesc("embed", GPTEmbeddingPipe,
                                     _embedding_as_head, "wte.weight",
                                     config))
    else:
        descs.append(LayerDesc(Linear, config.hidden_size, config.vocab_size,
                               False, std=config.initializer_range))
    return PipelineLayer(
        descs, num_stages=num_stages, topology=topology,
        loss_fn=GPTPretrainingCriterion(config), seg_method=seg_method,
        recompute_interval=recompute_interval,
        num_virtual_pipeline_stages=num_virtual_pipeline_stages,
        device=device, dtype=dtype, generator=generator)
