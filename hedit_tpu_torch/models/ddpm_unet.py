"""The CelebA-HQ pixel-space DDPM UNet (SDEdit's "simple" model; port of
``hedit_tpu/models/ddpm_unet.py``).

GroupNorm(32, eps 1e-6) + swish, the fairseq sinusoidal timestep embedding,
resnet blocks with a timestep projection, single-head attention blocks of
1x1 convolutions, an asymmetrically padded stride-2 downsample and a nearest
upsample + conv.  CelebA-HQ: ch 128, ch_mult (1, 1, 2, 2, 4, 4), 2 resnets a
level, attention at 16x16, 256x256x3 images.

Parameter names are the reference checkpoint's torch keys (``temb.dense.0``,
``down.{i}.block.{j}``, ``down.{i}.attn.{j}``, ``down.{i}.downsample.conv``,
``mid.block_1`` / ``attn_1`` / ``block_2``, ``up.{i}.block.{j}``,
``up.{i}.upsample.conv``, ``norm_out``, ``conv_out``), which the JAX
package's ``convert_ddpm_ckpt`` reads, so ``celeba_hq.ckpt`` loads with
``load_state_dict``.

Every GroupNorm goes through ``FusedGroupNorm`` (the CUDA kernel on the
card, ``csrc/group_norm.cu``), with the SiLU fused where JAX applies
``nn.swish`` right after it.  Activations are carried channels-last, the
layout the kernel takes.  The attention is plain torch, as JAX's is (its
product in float32, the scale after it, softmax, then a cast to v's dtype):
JAX sends this model to no flash kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hedit_tpu_torch.models.blocks import Conv2d
from hedit_tpu_torch.ops.groupnorm import FusedGroupNorm


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    in_channels: int = 3
    resolution: int = 256
    resamp_with_conv: bool = True

    @staticmethod
    def celeba_hq() -> "DDPMConfig":
        return DDPMConfig()

    @staticmethod
    def tiny() -> "DDPMConfig":
        return DDPMConfig(ch=32, ch_mult=(1, 2), resolution=16, attn_resolutions=(8,))


def ddpm_timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Fairseq-style sinusoidal embedding: [sin, cos], denominator half - 1."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    emb = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    out = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


def _norm(channels: int, act=None) -> FusedGroupNorm:
    return FusedGroupNorm(32, channels, eps=1e-6, act=act)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int):
        super().__init__()
        self.norm1 = _norm(in_channels, "silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.temb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = _norm(out_channels, "silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.norm = _norm(channels)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)

        def tokens(t):  # [B, C, H, W] -> [B, HW, C]; a view of a channels-last t
            return t.permute(0, 2, 3, 1).reshape(b, hh * ww, c)

        q, k, v = tokens(self.q(h)), tokens(self.k(h)), tokens(self.v(h))
        w = torch.bmm(q.float(), k.float().transpose(1, 2))
        w = torch.softmax(w * (c ** -0.5), dim=2).to(v.dtype)
        h = torch.bmm(w, v).reshape(b, hh, ww, c).permute(0, 3, 1, 2)  # channels-last
        return x + self.proj_out(h)


class Downsample(nn.Module):
    def __init__(self, channels: int, with_conv: bool):
        super().__init__()
        if with_conv:
            self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        if hasattr(self, "conv"):
            # torch's asymmetric pad (right, bottom), then a stride-2 valid conv
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2, 2)


class Upsample(nn.Module):
    def __init__(self, channels: int, with_conv: bool):
        super().__init__()
        if with_conv:
            self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x) if hasattr(self, "conv") else x


class DDPMUNet(nn.Module):
    """eps(x [B, H, W, C] NHWC, t int or [B]) -> [B, H, W, C] NHWC."""

    def __init__(self, cfg: DDPMConfig):
        super().__init__()
        self.cfg = cfg
        ch, num_res = cfg.ch, len(cfg.ch_mult)
        temb_ch = ch * 4
        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([nn.Linear(ch, temb_ch), nn.Linear(temb_ch, temb_ch)])
        self.conv_in = Conv2d(cfg.in_channels, ch, 3, padding=1)

        curr_res = cfg.resolution
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        self.down = nn.ModuleList()
        block_in = ch
        for i_level in range(num_res):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_in, block_out = ch * in_ch_mult[i_level], ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, temb_ch))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != num_res - 1:
                level.downsample = Downsample(block_in, cfg.resamp_with_conv)
                curr_res //= 2
            self.down.append(level)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, temb_ch)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, temb_ch)

        ups = []
        for i_level in reversed(range(num_res)):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_out = skip_in = ch * cfg.ch_mult[i_level]
            for i_block in range(cfg.num_res_blocks + 1):
                if i_block == cfg.num_res_blocks:
                    skip_in = ch * in_ch_mult[i_level]
                level.block.append(ResnetBlock(block_in + skip_in, block_out, temb_ch))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != 0:
                level.upsample = Upsample(block_in, cfg.resamp_with_conv)
                curr_res *= 2
            ups.insert(0, level)  # up[i] is level i, as in the checkpoint
        self.up = nn.ModuleList(ups)
        self.norm_out = _norm(block_in, "silu")
        self.conv_out = Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        cfg = self.cfg
        b = x.shape[0]
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(b)
        dtype = self.conv_in.weight.dtype
        temb = self.temb.dense[0](ddpm_timestep_embedding(t, cfg.ch).to(dtype))
        temb = self.temb.dense[1](F.silu(temb))

        hs = [self.conv_in(x.to(dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))]
        for level in self.down:
            for i_block, block in enumerate(level.block):
                h = block(hs[-1], temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))

        h = hs[-1]
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h, temb)), temb)

        for level in reversed(self.up):
            for i_block, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h)).permute(0, 2, 3, 1)
