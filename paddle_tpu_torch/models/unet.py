"""Stable-Diffusion-style conditional UNet (counterpart of
``paddle_tpu/models/unet.py``, the SD-1.x exemplar): ``conv_in`` -> down
blocks (ResNet x N [+ a transformer of self- and cross-attention] +
stride-2 downsample) -> mid (ResNet, transformer, ResNet) -> up blocks
mirroring them with skip concatenations and nearest upsampling ->
GroupNorm / SiLU / ``conv_out``. Timesteps enter through a sinusoidal
embedding and an MLP, added inside every ResNet block.

Parameter names and shapes are the JAX model's (``Linear`` keeps the
``(in, out)`` layout, ``Conv2D`` ``(out, in, kh, kw)``), so ``raw_state()``
carries across through :meth:`UNet2DConditionModel.load_numpy_state`.
Attention runs ``scaled_dot_product_attention`` without a mask: the flash
kernels, not causal. At SD-1.5's widths the heads are 8 of 40, 80 and 160
(320, 640 and 1280 channels), over 4096 / 1024 / 256 / 64 latent tokens,
and cross-attention reads the 77 tokens of the text context. Convolutions
are PyTorch's (the JAX package's run in XLA, not in Pallas); GroupNorm
and SiLU are PyTorch elementwise work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import load_state
from ..device import DeviceLike, resolve_device, seed
from ..nn import functional as F
from ..nn.layers.common import Conv2D, GroupNorm, LayerNorm, Linear

__all__ = ["UNetConfig", "UNet2DConditionModel", "UNetDenoiseLoss"]


@dataclasses.dataclass
class UNetConfig:
    sample_size: int = 64              # latent H = W
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # which down blocks carry attention (mirrored by the up blocks); SD
    # 1.x: all but the last (lowest-resolution) one
    cross_attention_blocks: Optional[Sequence[bool]] = None
    cross_attention_dim: int = 768
    num_attention_heads: int = 8       # SD 1.x: 8 heads, head_dim = C // 8
    norm_num_groups: int = 32
    freq_shift: float = 0.0

    def __post_init__(self):
        if self.cross_attention_blocks is None:
            n = len(self.block_out_channels)
            self.cross_attention_blocks = tuple([True] * (n - 1) + [False])

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def tiny() -> "UNetConfig":
        return UNetConfig(sample_size=16, block_out_channels=(32, 64),
                          layers_per_block=1, cross_attention_dim=32,
                          num_attention_heads=4, norm_num_groups=8)


def _timestep_embedding(t: torch.Tensor, dim: int, freq_shift: float = 0.0,
                        max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding ``[cos(t f), sin(t f)]``, f32, with ``f =
    exp(-ln(max_period) i / (dim / 2 - freq_shift))``."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device)
                      * (-math.log(max_period) / (half - freq_shift)))
    args = t.float().unsqueeze(-1) * freqs.unsqueeze(0)
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _linear(i: int, o: int, kw, bias: bool = True) -> Linear:
    """The JAX ``Linear``'s default: XavierNormal, std sqrt(2 / (i + o))."""
    return Linear(i, o, bias, std=math.sqrt(2.0 / (i + o)), **kw)


def _norm_kw(kw):
    return {k: kw[k] for k in ("device", "dtype")}


class ResnetBlock2D(nn.Module):
    def __init__(self, in_c: int, out_c: int, temb_c: int, groups: int,
                 **kw):
        super().__init__()
        nkw = _norm_kw(kw)
        self.norm1 = GroupNorm(min(groups, in_c), in_c, **nkw)
        self.conv1 = Conv2D(in_c, out_c, 3, padding=1, **kw)
        self.time_emb_proj = _linear(temb_c, out_c, kw)
        self.norm2 = GroupNorm(min(groups, out_c), out_c, **nkw)
        self.conv2 = Conv2D(out_c, out_c, 3, padding=1, **kw)
        self.shortcut = Conv2D(in_c, out_c, 1, **kw) if in_c != out_c else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.shortcut is None else self.shortcut(x)
        return skip + h


class Attention(nn.Module):
    """Multi-head attention over flattened spatial tokens; with
    ``context_dim`` the keys and values come from the context
    (cross-attention)."""

    def __init__(self, query_dim: int, context_dim: Optional[int],
                 num_heads: int, **kw):
        super().__init__()
        self.heads = num_heads
        self.head_dim = query_dim // num_heads
        kv_dim = context_dim if context_dim is not None else query_dim
        self.to_q = _linear(query_dim, query_dim, kw, bias=False)
        self.to_k = _linear(kv_dim, query_dim, kw, bias=False)
        self.to_v = _linear(kv_dim, query_dim, kw, bias=False)
        self.to_out = _linear(query_dim, query_dim, kw)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, s, _ = x.shape
        t = ctx.shape[1]
        q = self.to_q(x).reshape(b, s, self.heads, self.head_dim)
        k = self.to_k(ctx).reshape(b, t, self.heads, self.head_dim)
        v = self.to_v(ctx).reshape(b, t, self.heads, self.head_dim)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.to_out(out.reshape(b, s, self.heads * self.head_dim))


class FeedForward(nn.Module):
    """GEGLU feed-forward: ``proj_out(h * gelu(gate))`` with ``h, gate``
    the halves of ``proj_in(x)``."""

    def __init__(self, dim: int, mult: int = 4, **kw):
        super().__init__()
        self.proj_in = _linear(dim, dim * mult * 2, kw)
        self.proj_out = _linear(dim * mult, dim, kw)

    def forward(self, x):
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, num_heads: int, **kw):
        super().__init__()
        nkw = _norm_kw(kw)
        self.norm1 = LayerNorm(dim, **nkw)
        self.attn1 = Attention(dim, None, num_heads, **kw)
        self.norm2 = LayerNorm(dim, **nkw)
        self.attn2 = Attention(dim, context_dim, num_heads, **kw)
        self.norm3 = LayerNorm(dim, **nkw)
        self.ff = FeedForward(dim, **kw)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm and a 1x1 projection in, one BasicTransformerBlock over
    the flattened spatial tokens, a 1x1 projection out, the residual."""

    def __init__(self, channels: int, context_dim: int, num_heads: int,
                 groups: int, **kw):
        super().__init__()
        self.norm = GroupNorm(min(groups, channels), channels,
                              **_norm_kw(kw))
        self.proj_in = Conv2D(channels, channels, 1, **kw)
        self.block = BasicTransformerBlock(channels, context_dim, num_heads,
                                           **kw)
        self.proj_out = Conv2D(channels, channels, 1, **kw)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x))
        y = y.reshape(b, c, h * w).transpose(1, 2)
        y = self.block(y, context)
        y = y.transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(y)


class Downsample2D(nn.Module):
    def __init__(self, channels: int, **kw):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, padding=1, **kw)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, **kw):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, padding=1, **kw)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _transformers(n, channels, cfg: UNetConfig, kw):
    return nn.ModuleList(
        Transformer2D(channels, cfg.cross_attention_dim,
                      cfg.num_attention_heads, cfg.norm_num_groups, **kw)
        for _ in range(n))


class DownBlock(nn.Module):
    def __init__(self, in_c, out_c, temb_c, cfg: UNetConfig, attn: bool,
                 downsample: bool, **kw):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_c if i == 0 else out_c, out_c, temb_c,
                          cfg.norm_num_groups, **kw)
            for i in range(cfg.layers_per_block))
        self.attentions = (_transformers(cfg.layers_per_block, out_c, cfg, kw)
                           if attn else None)
        self.downsample = Downsample2D(out_c, **kw) if downsample else None

    def forward(self, x, temb, context):
        skips = []
        for i, res in enumerate(self.resnets):
            x = res(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            skips.append(x)
        if self.downsample is not None:
            x = self.downsample(x)
            skips.append(x)
        return x, skips


class UpBlock(nn.Module):
    def __init__(self, in_c, skip_c_list, out_c, temb_c, cfg: UNetConfig,
                 attn: bool, upsample: bool, **kw):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D((in_c if i == 0 else out_c) + skip_c, out_c,
                          temb_c, cfg.norm_num_groups, **kw)
            for i, skip_c in enumerate(skip_c_list))
        self.attentions = (_transformers(len(skip_c_list), out_c, cfg, kw)
                           if attn else None)
        self.upsample = Upsample2D(out_c, **kw) if upsample else None

    def forward(self, x, skips, temb, context):
        for i, res in enumerate(self.resnets):
            x = res(torch.cat([x, skips.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsample is not None:
            x = self.upsample(x)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels, temb_c, cfg: UNetConfig, **kw):
        super().__init__()
        self.resnet1 = ResnetBlock2D(channels, channels, temb_c,
                                     cfg.norm_num_groups, **kw)
        self.attention = Transformer2D(channels, cfg.cross_attention_dim,
                                       cfg.num_attention_heads,
                                       cfg.norm_num_groups, **kw)
        self.resnet2 = ResnetBlock2D(channels, channels, temb_c,
                                     cfg.norm_num_groups, **kw)

    def forward(self, x, temb, context):
        x = self.resnet1(x, temb)
        x = self.attention(x, context)
        return self.resnet2(x, temb)


class UNet2DConditionModel(nn.Module):
    """The conditional denoiser: ``forward(sample, timestep,
    encoder_hidden_states)`` -> the noise prediction (NCHW latents). Built
    on the card unless ``device`` says otherwise; weights are drawn from
    ``generator`` (default: seed 0 on the model's device)."""

    def __init__(self, config: UNetConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = seed(0, dev)
        kw = dict(device=dev, dtype=dtype or torch.float32,
                  generator=generator)
        self.config = config
        ch = config.block_out_channels
        temb_c = ch[0] * 4
        self.time_proj_dim = ch[0]
        self.time_embedding = nn.ModuleList(
            [_linear(ch[0], temb_c, kw), _linear(temb_c, temb_c, kw)])
        self.conv_in = Conv2D(config.in_channels, ch[0], 3, padding=1, **kw)

        self.down_blocks = nn.ModuleList()
        in_c = ch[0]
        for i, out_c in enumerate(ch):
            self.down_blocks.append(DownBlock(
                in_c, out_c, temb_c, config,
                attn=config.cross_attention_blocks[i],
                downsample=i != len(ch) - 1, **kw))
            in_c = out_c

        self.mid_block = MidBlock(ch[-1], temb_c, config, **kw)

        # mirror the down path: skip channels in reverse order
        skip_channels = [ch[0]]                  # conv_in's output
        for i, out_c in enumerate(ch):
            skip_channels += [out_c] * config.layers_per_block
            if i != len(ch) - 1:
                skip_channels.append(out_c)
        self.up_blocks = nn.ModuleList()
        in_c = ch[-1]
        for i in reversed(range(len(ch))):
            skips = [skip_channels.pop()
                     for _ in range(config.layers_per_block + 1)]
            self.up_blocks.append(UpBlock(
                in_c, skips, ch[i], temb_c, config,
                attn=config.cross_attention_blocks[i], upsample=i != 0,
                **kw))
            in_c = ch[i]

        self.conv_norm_out = GroupNorm(min(config.norm_num_groups, ch[0]),
                                       ch[0], **_norm_kw(kw))
        self.conv_out = Conv2D(ch[0], config.out_channels, 3, padding=1,
                               **kw)

    def forward(self, sample, timestep, encoder_hidden_states):
        cfg = self.config
        temb = _timestep_embedding(timestep, self.time_proj_dim,
                                   cfg.freq_shift).to(sample.dtype)
        temb = self.time_embedding[1](F.silu(self.time_embedding[0](temb)))

        x = self.conv_in(sample)
        skips = [x]
        for blk in self.down_blocks:
            x, s = blk(x, temb, encoder_hidden_states)
            skips.extend(s)
        x = self.mid_block(x, temb, encoder_hidden_states)
        for blk in self.up_blocks:
            n = len(blk.resnets)
            take, skips = skips[-n:], skips[:-n]
            x = blk(x, list(take), temb, encoder_hidden_states)
        return self.conv_out(F.silu(self.conv_norm_out(x)))

    def load_numpy_state(self, named: Mapping[str, np.ndarray]) -> None:
        """Copy every parameter from ``named`` (e.g. the JAX model's
        ``raw_state()[0]``), each cast to its parameter's dtype."""
        load_state(self, named)


class UNetDenoiseLoss(nn.Module):
    """The epsilon-prediction MSE objective: ``forward(latents, timesteps,
    encoder_hidden_states, noise)`` -> ``mse(unet(...), noise)``, what
    ``TrainStep`` steps."""

    def __init__(self, unet: UNet2DConditionModel):
        super().__init__()
        self.unet = unet

    def forward(self, latents, timesteps, encoder_hidden_states, noise):
        pred = self.unet(latents, timesteps, encoder_hidden_states)
        return F.mse_loss(pred, noise)
