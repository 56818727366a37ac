"""Building blocks of the SD UNet and VAE (port of ``hedit_tpu/models/blocks.py``).

Inside the models activations are logical NCHW tensors in
``torch.channels_last`` (physically [B, H, W, C], the JAX package's NHWC):
cuDNN's convolutions take them without a layout transpose, and the
GroupNorm kernel takes exactly that layout.  Every op here keeps the format
of its input (``Conv2d`` convolves in NCHW on the CPU only); the
transformer blocks work on [B, HW, C] tokens, which are a view of such a
tensor.  Module and parameter names are the diffusers
``state_dict`` keys (``down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_q``),
which ``io_utils/weights.py`` maps to and from the JAX parameter trees.

Numerics kept from the JAX package (each was a real deviation from
diffusers once): GEGLU uses the exact erf GELU in float32 and the tanh form
in bfloat16; the transformer LayerNorms use eps 1e-5; GroupNorm eps is 1e-5
in the UNet resnets and 1e-6 in ``Transformer2D`` and the VAE; the VAE
encoder's downsamplers pad (0, 1, 0, 1).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hedit_tpu_torch.control.base import NO_CONTROL, LayerTag
from hedit_tpu_torch.ops.attention import controlled_attention
from hedit_tpu_torch.ops.groupnorm import FusedGroupNorm


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal embedding computed in ``dtype``, [cos, sin] (diffusers
    ``get_timestep_embedding`` with SD-1.x's flip_sin_to_cos=True and
    freq_shift=0); dim is even.  float32 for every model but a float64 one,
    whose sinusoid JAX's UNet computes in float64."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=dtype, device=timesteps.device)
    emb = timesteps.to(dtype)[:, None] * torch.exp(exponent / half)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose output keeps its input's memory format.  On the
    card it convolves channels-last (cuDNN's NHWC kernels, no transposes).
    On the CPU it convolves in NCHW: PyTorch's CPU channels-last
    convolution sums in another order that lands further from the float64
    result, so the CPU numerics stay those the tests' tolerances were set
    on."""

    def forward(self, x):
        if x.is_cuda:
            return super().forward(x)
        y = self._conv_forward(x.contiguous(), self.weight.contiguous(), self.bias)
        if x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous():
            return y.contiguous(memory_format=torch.channels_last)
        return y


class ResnetBlock2D(nn.Module):
    """GN32+SiLU+conv twice, optional timestep projection and skip conv.

    ``feature_site`` names this block for the control's ``map_features``
    hook, applied to the conv branch after conv2 and before the skip add:
    PnP's conv-feature injection point."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: Optional[int] = None,
                 groups: int = 32, eps: float = 1e-5, feature_site: str = ""):
        super().__init__()
        self.feature_site = feature_site
        self.norm1 = FusedGroupNorm(groups, in_channels, eps, act="silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = FusedGroupNorm(groups, out_channels, eps, act="silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb=None, control=NO_CONTROL):
        h = self.conv1(self.norm1(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.feature_site:
            h = control.map_features(h, self.feature_site)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 conv; ``asymmetric_pad`` is the SD VAE encoder's (0, 1, 0, 1)."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = Conv2d(channels, channels, 3, stride=2,
                              padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class CrossAttention(nn.Module):
    """diffusers ``Attention`` (to_q / to_k / to_v / to_out.0) with control hooks."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, layer_tag: Optional[LayerTag] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.layer_tag = heads, layer_tag
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Identity()])

    def forward(self, x, context=None, control=NO_CONTROL,
                store: Optional[Dict[str, torch.Tensor]] = None):
        ctx = x if context is None else context
        out, maps = controlled_attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                                         heads=self.heads, layer=self.layer_tag,
                                         control=control)
        if store is not None:
            store.update(maps)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        # exact erf GELU in float32 (diffusers); the tanh form in bfloat16,
        # where the two round to the same value for 99.4% of inputs
        approx = "tanh" if gate.dtype == torch.bfloat16 else "none"
        return h * F.gelu(gate, approximate=approx)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention (attn1), cross-attention (attn2), GEGLU FF."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 self_tag: Optional[LayerTag] = None, cross_tag: Optional[LayerTag] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head, layer_tag=self_tag)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, layer_tag=cross_tag)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context, control=NO_CONTROL, store=None):
        x = x + self.attn1(self.norm1(x), None, control, store)
        x = x + self.attn2(self.norm2(x), context, control, store)
        return x + self.ff(self.norm3(x))


class ModuleBag(nn.Module):
    """A named container of submodules (a diffusers block whose forward the
    parent model writes out), so the state_dict keys nest as in diffusers."""


class Transformer2D(nn.Module):
    """GN -> 1x1 conv proj_in -> transformer blocks -> 1x1 conv proj_out + skip."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 depth: int = 1, self_tag: Optional[LayerTag] = None,
                 cross_tag: Optional[LayerTag] = None):
        super().__init__()
        inner = heads * dim_head
        self.norm = FusedGroupNorm(32, channels, eps=1e-6)
        self.proj_in = Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, context_dim, self_tag, cross_tag)
            for _ in range(depth)])
        self.proj_out = Conv2d(inner, channels, 1)

    def forward(self, x, context, control=NO_CONTROL, store=None):
        b, _, h, w = x.shape
        t = self.proj_in(self.norm(x))
        t = t.permute(0, 2, 3, 1).reshape(b, h * w, -1)  # a view: t is channels-last
        for blk in self.transformer_blocks:
            t = blk(t, context, control, store)
        t = t.reshape(b, h, w, -1).permute(0, 3, 1, 2)  # channels-last again, a view
        return self.proj_out(t) + x
