"""MoE-GPT (counterpart of ``paddle_tpu/models/moe_gpt.py``): GPT blocks
whose FFN is a mixture of experts on every ``moe_every``-th block (an
ERNIE-3.0-style exemplar of the reference's ``MoELayer``).

The dense blocks and the attention are the port's GPT (``GPTBlock``,
``GPTSelfAttention``: causal flash attention without a mask); an MoE block
swaps the MLP for a GShard-gated :class:`MoELayer` of ``num_experts``
``Experts`` (exact GELU). Parameter names and shapes are the JAX model's,
so ``raw_state()`` carries across through :meth:`load_numpy_state`.

With ``labels`` the forward returns the mean causal-LM loss plus
``aux_loss_weight`` times the gates' aux losses, which
:meth:`MoEGPTForCausalLM.total_aux_loss` collects and clears (so no step
holds another's graph). The LM loss is
:func:`~paddle_tpu_torch.incubate.nn.functional.fused_linear_cross_entropy`
over the tied head, as the port's GPT computes it (f32 logits from the
hidden states; the JAX model forms the logits in the weights' dtype, the
same value in f32).

``expert_axis`` (e.g. "dp") puts every MoE block's experts under expert
parallelism: ``TrainStep(mesh=...)`` keeps each data rank's ``E / P`` of
them, and the blocks route the global batch (``MoELayer``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..convert import load_state
from ..device import DeviceLike, resolve_device, seed
from ..incubate.distributed.models.moe import MoELayer
from ..incubate.nn import functional as FF
from ..nn.layers.common import Dropout, Embedding, LayerNorm
from .gpt import GPTBlock, GPTConfig, GPTSelfAttention


@dataclasses.dataclass
class MoEGPTConfig(GPTConfig):
    num_experts: int = 8
    top_k: int = 2
    moe_every: int = 2           # every Nth block uses an MoE FFN
    capacity_factor: float = 1.2
    aux_loss_weight: float = 0.01
    expert_axis: Optional[str] = None   # mesh axis for EP (e.g. "dp")

    @staticmethod
    def tiny(**kw) -> "MoEGPTConfig":
        d = dict(vocab_size=512, hidden_size=64, num_hidden_layers=4,
                 num_attention_heads=4, max_position_embeddings=128,
                 num_experts=4)
        d.update(kw)
        return MoEGPTConfig(**d)


class MoEGPTBlock(nn.Module):
    def __init__(self, config: MoEGPTConfig, **kw):
        super().__init__()
        norm_kw = {k: kw[k] for k in ("device", "dtype")}
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, eps, **norm_kw)
        self.attn = GPTSelfAttention(config, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, eps, **norm_kw)
        self.moe = MoELayer(
            d_model=config.hidden_size, num_expert=config.num_experts,
            d_hidden=config.intermediate_size, top_k=config.top_k,
            gate="gshard", capacity_factor=config.capacity_factor,
            expert_axis=config.expert_axis, **kw)
        self.drop = Dropout(config.hidden_dropout_prob,
                            generator=kw["generator"])

    def forward(self, x, attn_mask=None):
        x = x + self.drop(self.attn(self.ln_1(x), attn_mask))
        return x + self.drop(self.moe(self.ln_2(x)))


class MoEGPTForCausalLM(nn.Module):
    """GPT causal LM with MoE FFNs and a tied head. Built on the card
    unless ``device`` says otherwise; weights are drawn from ``generator``
    (default: seed 0 on the model's device), which also draws training
    dropout's masks."""

    def __init__(self, config: MoEGPTConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or torch.float32
        if generator is None:
            generator = seed(0, dev)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.config = config
        std = config.initializer_range
        self.wte = Embedding(config.vocab_size, config.hidden_size, std=std,
                             **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, std=std, **kw)
        self.drop = Dropout(config.hidden_dropout_prob, generator=generator)
        self.h = nn.ModuleList(
            MoEGPTBlock(config, **kw)
            if config.moe_every and (i + 1) % config.moe_every == 0
            else GPTBlock(config, **kw)
            for i in range(config.num_hidden_layers))
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              device=dev, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wte.weight.dtype

    def total_aux_loss(self) -> Optional[torch.Tensor]:
        """The sum of every MoE block's stored gate loss, each cleared; None
        when no gate holds one."""
        total = None
        for block in self.h:
            gate = getattr(getattr(block, "moe", None), "gate", None)
            if gate is not None and gate.has_loss:
                loss = gate.get_loss()
                total = loss if total is None else total + loss
        return total

    def forward(self, input_ids, labels=None, attn_mask=None):
        """Logits ``(B, S, vocab)``, or with ``labels`` the mean causal-LM
        loss plus ``aux_loss_weight`` x the gates' aux losses.
        ``attn_mask`` replaces the causal mask and routes attention through
        SDPA's dense path."""
        _, s = input_ids.shape
        pos = torch.arange(s, dtype=torch.int64,
                           device=input_ids.device).unsqueeze(0)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for block in self.h:
            x = block(x, attn_mask)
        hidden = self.ln_f(x)
        if labels is None:
            return hidden @ self.wte.weight.T
        loss = FF.fused_linear_cross_entropy(hidden, self.wte.weight, labels,
                                             transpose_y=True)
        aux = self.total_aux_loss()
        if aux is not None:
            loss = loss + self.config.aux_loss_weight * aux
        return loss

    def load_numpy_state(self, named: Mapping[str, np.ndarray],
                         buffers: Optional[Mapping[str, np.ndarray]] = None
                         ) -> None:
        """Copy every parameter from ``named`` (e.g. the JAX model's
        ``raw_state()``)."""
        load_state(self, named, buffers)
