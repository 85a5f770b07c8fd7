"""Llama (counterpart of ``paddle_tpu/models/llama.py``, without the
pipeline classes and the tensor-parallel annotations): RMSNorm + rotary +
GQA + SwiGLU, and ``LlamaPretrainingCriterion``.

Parameter names and shapes are the JAX model's (``Linear`` keeps the
``(in, out)`` layout), so ``raw_state()`` carries across through
:meth:`LlamaForCausalLM.load_numpy_state`. The cached forward runs over the
paged KV pool (serving) or over ``(k_cache, v_cache)`` ring buffers
(:class:`~paddle_tpu_torch.generation.GenerationMixin`'s ``generate``); the
no-cache forward (training, and the serving parity reference) runs causal
``scaled_dot_product_attention`` on the flash kernels, and with ``labels``
returns the chunked fused LM loss.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..convert import state_from_numpy
from ..device import DeviceLike, resolve_device, seed
from ..generation import GenerationMixin
from ..incubate.nn import functional as FF
from ..kernels.paged_attention import is_paged_state, paged_position_ids
from ..nn import functional as F
from ..nn.layers.common import Embedding, Linear, RMSNorm


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           intermediate_size=128, max_position_embeddings=128)

    def num_params(self) -> int:
        h, l = self.hidden_size, self.num_hidden_layers
        kv = self.num_key_value_heads * (h // self.num_attention_heads)
        per_layer = h * h + 2 * h * kv + h * h          # q, k, v, o
        per_layer += 3 * h * self.intermediate_size      # gate, up, down
        per_layer += 2 * h                               # norms
        emb = self.vocab_size * h
        head = 0 if self.tie_word_embeddings else self.vocab_size * h
        return l * per_layer + emb + head + h


def is_ring_cache(entry) -> bool:
    """Whether a cache entry is a ``(k_cache, v_cache)`` ring buffer: two
    ``(B, T, Hkv, D)`` tensors (a paged state is a tuple too, so it is
    ruled out first)."""
    return (not is_paged_state(entry) and isinstance(entry, tuple)
            and len(entry) == 2
            and all(isinstance(t, torch.Tensor) and t.dim() == 4
                    for t in entry))


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // self.num_heads
        self.rope_theta = config.rope_theta
        std = config.initializer_range
        self.q_proj = Linear(h, self.num_heads * self.head_dim, False,
                             std=std, **kw)
        self.k_proj = Linear(h, self.num_kv_heads * self.head_dim, False,
                             std=std, **kw)
        self.v_proj = Linear(h, self.num_kv_heads * self.head_dim, False,
                             std=std, **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, h, False,
                             std=std, **kw)

    def forward(self, x, attn_mask=None, position_ids=None, cache=None):
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        ring = False
        if cache is not None:
            state, offset = cache
            ring = is_ring_cache(state)
            if not ring and not is_paged_state(state):
                # neither kind of cache: paged attention refuses it
                return F.paged_scaled_dot_product_attention(q, k, v, state)
            if position_ids is None and ring:
                # the ring buffer's offset is a host int: no device read
                position_ids = (torch.arange(s, device=x.device)
                                + int(offset)).unsqueeze(0)
            elif position_ids is None:
                position_ids = paged_position_ids(s, offset, state)
        elif position_ids is None:
            position_ids = torch.arange(s, device=x.device).expand(b, s)
        q, k, _ = FF.fused_rotary_position_embedding(
            q, k, None, position_ids=position_ids,
            rotary_emb_base=self.rope_theta)
        if ring:
            out, k_cache, v_cache = F.cached_scaled_dot_product_attention(
                q, k, v, state[0], state[1], offset)
            return self.o_proj(out.reshape(b, s, -1)), (k_cache, v_cache)
        if cache is not None:
            out, state = F.paged_scaled_dot_product_attention(q, k, v, state)
            return self.o_proj(out.reshape(b, s, -1)), state
        # GQA: kv stays unexpanded; the flash kernels read kv head h // rep.
        # A mask (which carries the causal order itself, as in the JAX
        # model) takes SDPA's dense path
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             is_causal=attn_mask is None,
                                             training=self.training)
        return self.o_proj(out.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        self.gate_proj = Linear(h, i, False, std=std, **kw)
        self.up_proj = Linear(h, i, False, std=std, **kw)
        self.down_proj = Linear(i, h, False, std=std, **kw)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        norm_kw = {k: kw[k] for k in ("device", "dtype")}
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **norm_kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps,
                                                **norm_kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, attn_mask=None, position_ids=None, cache=None):
        if cache is not None:
            attn, new_state = self.self_attn(self.input_layernorm(x),
                                             attn_mask, position_ids, cache)
            x = x + attn
            x = x + self.mlp(self.post_attention_layernorm(x))
            return x, new_state
        x = x + self.self_attn(self.input_layernorm(x), attn_mask,
                               position_ids)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      std=config.initializer_range, **kw)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, **kw)
            for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=kw["device"], dtype=kw["dtype"])
        # set by TrainStep(remat=True) around its forward and backward:
        # each decoder layer then runs under torch.utils.checkpoint
        self.remat = False

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                caches=None, offset=None):
        x = self.embed_tokens(input_ids)
        if caches is None:
            for layer in self.layers:
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(layer, x, attn_mask, position_ids,
                                   use_reentrant=False)
                else:
                    x = layer(x, attn_mask, position_ids)
            return self.norm(x)
        new_caches = []
        for layer, state in zip(self.layers, caches):
            x, state = layer(x, attn_mask, position_ids,
                             cache=(state, offset))
            new_caches.append(state)
        return self.norm(x), new_caches


class LlamaForCausalLM(GenerationMixin, nn.Module):
    """Llama with its LM head. Built on the card unless ``device`` says
    otherwise; weights are drawn from ``generator`` (default: seed 0 on the
    model's device). ``generate``, ``generate_paged`` and
    ``generate_speculative`` come from :class:`GenerationMixin`; the
    cached forward takes, per layer, a paged state or a ring buffer."""

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or torch.float32
        if generator is None:
            generator = seed(0, dev)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.config = config
        self.llama = LlamaModel(config, **kw)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size, False,
                               std=config.initializer_range, **kw))

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.llama.embed_tokens.weight.dtype

    def logits(self, hidden):
        if self.lm_head is None:
            return hidden @ self.llama.embed_tokens.weight.T
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None, attn_mask=None,
                position_ids=None):
        """Logits, or with ``labels`` the mean causal-LM loss through
        :func:`fused_linear_cross_entropy` (the (tokens, vocab) logits are
        never all live). ``attn_mask`` (bool, True keeps, or additive;
        broadcast to ``(B, H, S, S)``) replaces the causal mask, as in the
        JAX model, and routes attention through SDPA's dense path."""
        hidden = self.llama(input_ids, attn_mask, position_ids)
        if labels is None:
            return self.logits(hidden)
        if self.lm_head is None:
            return FF.fused_linear_cross_entropy(
                hidden, self.llama.embed_tokens.weight, labels,
                transpose_y=True)
        return FF.fused_linear_cross_entropy(hidden, self.lm_head.weight,
                                             labels)

    def cache_spec(self):
        c = self.config
        return [(c.num_key_value_heads,
                 c.hidden_size // c.num_attention_heads)
                for _ in range(c.num_hidden_layers)]

    def forward_with_cache(self, input_ids, caches, offset):
        """Logits and the updated caches: ``caches`` holds one entry per
        layer, a paged state (``offset``: a host int, a device tensor of
        starts, or None for each row's written length) or a
        ``(k_cache, v_cache)`` ring buffer (``offset``: the host int
        position of ``input_ids``' first token)."""
        hidden, new_caches = self.llama(input_ids, caches=caches,
                                        offset=offset)
        return self.logits(hidden), new_caches

    def block_decode_spec(self, fused_layers: int = 1):
        """Which named parameters form each layer's ``BlockDecodeWeights``
        for the fused decode step, plus the embedding / final-norm / lm-head
        names and the attention geometry. ``fused_layers=N > 1``
        (``FLAGS_fused_block_layers``) also publishes ``layer_groups``:
        consecutive layer indices, N a group (the last group ragged), which
        the engine stacks into one ``MultiBlockDecodeWeights`` each."""
        if int(fused_layers) < 1:
            raise ValueError(f"fused_layers must be >= 1, got {fused_layers}")
        c = self.config
        layers = []
        for i in range(c.num_hidden_layers):
            p = f"llama.layers.{i}."
            layers.append(dict(
                ln1=p + "input_layernorm.weight",
                wq=p + "self_attn.q_proj.weight",
                wk=p + "self_attn.k_proj.weight",
                wv=p + "self_attn.v_proj.weight",
                wo=p + "self_attn.o_proj.weight",
                ln2=p + "post_attention_layernorm.weight",
                wg=p + "mlp.gate_proj.weight",
                wu=p + "mlp.up_proj.weight",
                wd=p + "mlp.down_proj.weight"))
        spec = dict(
            arch="llama", layers=layers,
            embed="llama.embed_tokens.weight",
            final_norm="llama.norm.weight",
            lm_head=None if self.lm_head is None else "lm_head.weight",
            num_heads=c.num_attention_heads,
            num_kv_heads=c.num_key_value_heads,
            rope_theta=c.rope_theta,
            epsilon=c.rms_norm_eps)
        if fused_layers > 1:
            n, g = c.num_hidden_layers, int(fused_layers)
            spec["layer_groups"] = [list(range(i, min(i + g, n)))
                                    for i in range(0, n, g)]
        return spec

    @torch.no_grad()
    def load_numpy_state(self, named: Mapping[str, np.ndarray]) -> None:
        """Copy every parameter from ``named`` (name -> array, e.g. the JAX
        model's ``raw_state()``), cast to this model's dtype. Names must
        match exactly."""
        params = dict(self.named_parameters())
        missing = sorted(set(params) - set(named))
        extra = sorted(set(named) - set(params))
        if missing or extra:
            raise KeyError(f"state mismatch: missing {missing}, "
                           f"unexpected {extra}")
        for name, t in state_from_numpy(named, self.device,
                                        self.dtype).items():
            if t.shape != params[name].shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(params[name].shape)}")
            params[name].copy_(t)


class LlamaPretrainingCriterion(nn.Module):
    """Mean cross entropy over all tokens of ``(logits, labels)``, the
    logits taken in f32 (labels of -100 are ignored): the ``loss`` that
    ``Model.prepare`` and ``TrainStep(loss_fn=...)`` take."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.vocab_size = config.vocab_size

    def forward(self, logits, labels):
        return nn.functional.cross_entropy(
            logits.reshape(-1, self.vocab_size).float(),
            labels.reshape(-1).long(), ignore_index=-100)
