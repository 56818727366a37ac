"""SD-1.x UNet2DConditionModel (port of ``hedit_tpu/models/unet_sd.py``).

The public ``forward`` takes and returns NHWC latents, like the JAX model;
inside, activations are contiguous NCHW.  Every attention layer carries the
same static ``LayerTag`` as in the JAX model (``_build_tags``), so a control
addresses layers identically in both packages.  Parameter names are the
diffusers ``state_dict`` keys.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from hedit_tpu_torch.control.base import NO_CONTROL, LayerTag
from hedit_tpu_torch.models.blocks import (
    Downsample2D, ModuleBag, ResnetBlock2D, TimestepEmbedding, Transformer2D, Upsample2D,
    timestep_embedding,
)
from hedit_tpu_torch.ops.groupnorm import FusedGroupNorm


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    cross_attn_down: Tuple[bool, ...] = (True, True, True, False)
    cross_attn_up: Tuple[bool, ...] = (False, True, True, True)
    layers_per_block: int = 2
    num_heads: int = 8
    cross_attention_dim: int = 768

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def tiny(sample_size: int = 16) -> "UNetConfig":
        """Same topology as SD-1.5 at tiny widths (seeded-random test model)."""
        return UNetConfig(sample_size=sample_size, block_out_channels=(32, 64, 64, 64),
                          num_heads=2, cross_attention_dim=32)


def _build_tags(cfg: UNetConfig):
    """LayerTags of the attention layers in forward order (as the JAX model)."""
    tags = {"down": [], "mid": [], "up": []}
    counters: Dict[tuple, int] = {}
    index = 0

    def tag(place, is_cross, pixels, up_idx=-1, inner=-1):
        nonlocal index
        store_idx = -1
        if pixels <= 32 * 32:
            store_idx = counters.get((place, is_cross), 0)
            counters[(place, is_cross)] = store_idx + 1
        t = LayerTag(place=place, is_cross=is_cross, num_pixels=pixels, index=index,
                     store_index=store_idx, up_block_index=up_idx, inner_index=inner)
        index += 1
        return t

    res = cfg.sample_size
    for bi, has_attn in enumerate(cfg.cross_attn_down):
        layer = []
        if has_attn:
            for _ in range(cfg.layers_per_block):
                layer.append((tag("down", False, res * res), tag("down", True, res * res)))
        tags["down"].append(layer)
        if bi != len(cfg.block_out_channels) - 1:
            res //= 2
    tags["mid"] = [(tag("mid", False, res * res), tag("mid", True, res * res))]
    for bi, has_attn in enumerate(cfg.cross_attn_up):
        layer = []
        if bi > 0:
            res *= 2
        if has_attn:
            for li in range(cfg.layers_per_block + 1):
                layer.append((tag("up", False, res * res, bi, li),
                              tag("up", True, res * res, bi, li)))
        tags["up"].append(layer)
    return tags


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        tags = _build_tags(cfg)
        chans = cfg.block_out_channels
        b0 = chans[0]
        temb_dim = 4 * b0
        heads, ctx = cfg.num_heads, cfg.cross_attention_dim

        def transformer(ch, tag_pair):
            return Transformer2D(ch, heads, ch // heads, ctx, self_tag=tag_pair[0],
                                 cross_tag=tag_pair[1])

        self.conv_in = nn.Conv2d(cfg.in_channels, b0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(b0, temb_dim)

        skip_ch = [b0]
        cin = b0
        self.down_blocks = nn.ModuleList()
        for bi, ch in enumerate(chans):
            blk = ModuleBag()
            blk.resnets = nn.ModuleList()
            if cfg.cross_attn_down[bi]:
                blk.attentions = nn.ModuleList()
            for li in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(cin, ch, temb_dim))
                cin = ch
                if cfg.cross_attn_down[bi]:
                    blk.attentions.append(transformer(ch, tags["down"][bi][li]))
                skip_ch.append(ch)
            if bi != len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch)])
                skip_ch.append(ch)
            self.down_blocks.append(blk)

        mid = chans[-1]
        self.mid_block = ModuleBag()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock2D(mid, mid, temb_dim),
                                                ResnetBlock2D(mid, mid, temb_dim)])
        self.mid_block.attentions = nn.ModuleList([transformer(mid, tags["mid"][0])])

        self.up_blocks = nn.ModuleList()
        for bi, ch in enumerate(reversed(chans)):
            blk = ModuleBag()
            blk.resnets = nn.ModuleList()
            if cfg.cross_attn_up[bi]:
                blk.attentions = nn.ModuleList()
            for li in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(cin + skip_ch.pop(), ch, temb_dim))
                cin = ch
                if cfg.cross_attn_up[bi]:
                    blk.attentions.append(transformer(ch, tags["up"][bi][li]))
            if bi != len(chans) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = FusedGroupNorm(32, b0, eps=1e-5, act="silu")
        self.conv_out = nn.Conv2d(b0, cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                control=NO_CONTROL,
                store: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """sample [B, H, W, C] NHWC; timesteps: int or [B]; context [B, 77, D].

        Returns eps [B, H, W, C] in the model's dtype.  Maps that the control
        stores are written into ``store``."""
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        b = sample.shape[0]
        t = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(b)
        temb = timestep_embedding(t, cfg.block_out_channels[0])
        temb = self.time_embedding(temb.to(dtype))
        ctx = encoder_hidden_states.to(dtype)

        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2).contiguous())
        skips = [h]
        for blk in self.down_blocks:
            for li, rn in enumerate(blk.resnets):
                h = rn(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[li](h, ctx, control, store)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, ctx, control, store)
        h = self.mid_block.resnets[1](h, temb)
        for blk in self.up_blocks:
            for li, rn in enumerate(blk.resnets):
                h = rn(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[li](h, ctx, control, store)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        h = self.conv_out(self.conv_norm_out(h))
        return h.permute(0, 2, 3, 1)
