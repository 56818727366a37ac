"""The face-parsing U-Net (CelebAMask-HQ), frozen inference (port of
``hedit_tpu/models/face_parser.py``).

``unetConv2`` (conv-BN-ReLU twice), a max-pool encoder of filters
[16, 32, 64, 128, 256] (feature_scale 4), ``unetUp`` with a
ConvTranspose2d(k=2, s=2) and the skip concatenated before it, a final 1x1
conv to 19 classes and the argmax.  Module names are the torch keys that the
JAX package's ``convert_face_parser`` reads; the transposed convolutions keep
torch's kernels (the JAX converter flips them for Flax's ``ConvTranspose``,
``io_utils/weights.py:face_parser_state_dict`` flips them back).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from hedit_tpu_torch.models.blocks import Conv2d
from hedit_tpu_torch.models.frozen_layers import FrozenBatchNorm

FILTERS: Tuple[int, ...] = (16, 32, 64, 128, 256)  # 64..1024 / feature_scale 4


class UnetConv2(nn.Module):
    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.conv1 = nn.Sequential(Conv2d(in_size, out_size, 3, padding=1),
                                   FrozenBatchNorm(out_size), nn.ReLU())
        self.conv2 = nn.Sequential(Conv2d(out_size, out_size, 3, padding=1),
                                   FrozenBatchNorm(out_size), nn.ReLU())

    def forward(self, x):
        return self.conv2(self.conv1(x))


class UnetUp(nn.Module):
    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_size, out_size, 2, stride=2)
        self.conv = UnetConv2(2 * out_size, out_size)

    def forward(self, skip, x):
        # the reference pads the skip where sizes differ; power-of-two inputs match
        return self.conv(torch.cat([skip, self.up(x)], dim=1))


class FaceParsing(nn.Module):
    def __init__(self, n_classes: int = 19):
        super().__init__()
        f = FILTERS
        self.conv1, self.conv2 = UnetConv2(3, f[0]), UnetConv2(f[0], f[1])
        self.conv3, self.conv4 = UnetConv2(f[1], f[2]), UnetConv2(f[2], f[3])
        self.center = UnetConv2(f[3], f[4])
        self.up_concat4, self.up_concat3 = UnetUp(f[4], f[3]), UnetUp(f[3], f[2])
        self.up_concat2, self.up_concat1 = UnetUp(f[2], f[1]), UnetUp(f[1], f[0])
        self.final = Conv2d(f[0], n_classes, 1)
        self.pool = nn.MaxPool2d(2, 2)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] NHWC in [-1, 1] -> [B, H, W, n_classes] logits."""
        dtype = self.final.weight.dtype
        x = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        c1 = self.conv1(x)
        c2 = self.conv2(self.pool(c1))
        c3 = self.conv3(self.pool(c2))
        c4 = self.conv4(self.pool(c3))
        center = self.center(self.pool(c4))
        u = self.up_concat4(c4, center)
        u = self.up_concat3(c3, u)
        u = self.up_concat2(c2, u)
        u = self.up_concat1(c1, u)
        return self.final(u).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] NHWC in [-1, 1] -> [B, H, W] class map."""
        return self.logits(x).argmax(dim=-1)
