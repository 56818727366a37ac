"""SD AutoencoderKL (port of ``hedit_tpu/models/vae.py``).

``encode_mode`` is ``vae.encode(image).latent_dist.mode() * 0.18215`` and
``decode`` is ``vae.decode(w / 0.18215)`` (``text-guided/main_p2p.py:159,
262-266``); both take and return NHWC, and inside carry NCHW tensors in
``torch.channels_last``.  The mid-block attention is one head
of d = 512 over 4096 tokens at 512 px, which the CUDA flash kernel takes on
a GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from hedit_tpu_torch.control.base import LayerTag
from hedit_tpu_torch.models.blocks import (
    Conv2d, Downsample2D, ModuleBag, ResnetBlock2D, Upsample2D,
)
from hedit_tpu_torch.ops.attention import controlled_attention
from hedit_tpu_torch.ops.groupnorm import FusedGroupNorm

SD_VAE_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    sample_size: int = 512

    @staticmethod
    def sd() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(32, 32, 64, 64), sample_size=64)


class VAEAttention(nn.Module):
    """Single-head self-attention of the VAE mid block (biased projections)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = FusedGroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels), nn.Identity()])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)  # a view
        tag = LayerTag(place="vae", is_cross=False, num_pixels=h * w, index=-1)
        out, _ = controlled_attention(self.to_q(y), self.to_k(y), self.to_v(y),
                                      heads=1, layer=tag)
        out = self.to_out[0](out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x  # channels-last


class MidBlockVAE(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, None, groups, 1e-6),
                                      ResnetBlock2D(channels, channels, None, groups, 1e-6)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = chans[0]
        for bi, ch in enumerate(chans):
            blk = ModuleBag()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(cin, ch, None, g, 1e-6))
                cin = ch
            if bi != len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch, asymmetric_pad=True)])
            self.down_blocks.append(blk)
        self.mid_block = MidBlockVAE(chans[-1], g)
        self.conv_norm_out = FusedGroupNorm(g, chans[-1], eps=1e-6, act="silu")
        self.conv_out = Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for rn in blk.resnets:
                h = rn(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        return self.conv_out(self.conv_norm_out(self.mid_block(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlockVAE(rev[0], g)
        self.up_blocks = nn.ModuleList()
        cin = rev[0]
        for bi, ch in enumerate(rev):
            blk = ModuleBag()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(cin, ch, None, g, 1e-6))
                cin = ch
            if bi != len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = FusedGroupNorm(g, rev[-1], eps=1e-6, act="silu")
        self.conv_out = Conv2d(rev[-1], cfg.in_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for rn in blk.resnets:
                h = rn(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def _nchw(self, x):
        """NHWC -> logical NCHW in channels-last (a view of a contiguous x)."""
        return x.to(self.quant_conv.weight.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)

    def encode_mode(self, x):
        """NHWC images in [-1, 1] -> scaled posterior means, NHWC."""
        h = self.quant_conv(self.encoder(self._nchw(x)))
        return h[:, :self.cfg.latent_channels].permute(0, 2, 3, 1) * SD_VAE_SCALE

    def decode(self, z):
        """Scaled NHWC latents -> NHWC images."""
        h = self.decoder(self.post_quant_conv(self._nchw(z / SD_VAE_SCALE)))
        return h.permute(0, 2, 3, 1)

