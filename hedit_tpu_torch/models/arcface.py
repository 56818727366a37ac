"""IR-SE-50 ArcFace backbone, frozen and differentiable: the face-swap
guidance takes its gradient with respect to the image (port of
``hedit_tpu/models/arcface.py``).

Input conv / BN / PReLU, four stages of bottleneck IR-SE blocks ((64, 64) x 3,
(64, 128) x 4, (128, 256) x 14, (256, 512) x 3, the first block of each
stage at stride 2), then BN2d -> flatten -> Linear(512 7 7 -> 512) -> BN1d
and an l2 norm.  IDLoss (``extract_feats``): pool to 256, crop
[35:223, 32:220], pool to 112, embed; the cosine similarity against a
reference embedding.

Module names are the torch keys that the JAX package's ``convert_irse50``
reads (``input_layer.{0,1,2}``, ``body.N.shortcut_layer.{0,1}``,
``body.N.res_layer.{0..5}`` with ``.fc1`` / ``.fc2`` in the SE block,
``output_layer.{0,3,4}``), so ``model_ir_se50.pth`` loads with
``load_state_dict``.  Images come in NHWC in [-1, 1], as the JAX package
takes them; inside the network activations are channels-last.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hedit_tpu_torch.models.blocks import Conv2d
from hedit_tpu_torch.models.frozen_layers import FrozenBatchNorm

IR_SE_50_BLOCKS: Tuple[Tuple[int, int, int], ...] = tuple(
    [(64, 64, 2)] + [(64, 64, 1)] * 2
    + [(64, 128, 2)] + [(128, 128, 1)] * 3
    + [(128, 256, 2)] + [(256, 256, 1)] * 13
    + [(256, 512, 2)] + [(512, 512, 1)] * 2
)


class SEModule(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))


class BottleneckIRSE(nn.Module):
    def __init__(self, in_channel: int, depth: int, stride: int):
        super().__init__()
        self.stride = stride
        if in_channel != depth:
            self.shortcut_layer = nn.Sequential(
                Conv2d(in_channel, depth, 1, stride=stride, bias=False), FrozenBatchNorm(depth))
        self.res_layer = nn.Sequential(
            FrozenBatchNorm(in_channel), Conv2d(in_channel, depth, 3, padding=1, bias=False),
            nn.PReLU(depth), Conv2d(depth, depth, 3, stride=stride, padding=1, bias=False),
            FrozenBatchNorm(depth), SEModule(depth))

    def forward(self, x):
        if hasattr(self, "shortcut_layer"):
            shortcut = self.shortcut_layer(x)
        else:  # MaxPool2d(1, stride): plain subsampling
            shortcut = x[:, :, ::self.stride, ::self.stride]
        return self.res_layer(x) + shortcut


class IRSE50(nn.Module):
    """[B, 112, 112, 3] NHWC in [-1, 1] -> l2-normalised [B, 512] embeddings."""

    def __init__(self):
        super().__init__()
        self.input_layer = nn.Sequential(Conv2d(3, 64, 3, padding=1, bias=False),
                                         FrozenBatchNorm(64), nn.PReLU(64))
        self.body = nn.Sequential(*(BottleneckIRSE(*blk) for blk in IR_SE_50_BLOCKS))
        # indices 1 and 2 are the reference's Dropout (eval: the identity) and Flatten
        self.output_layer = nn.Sequential(FrozenBatchNorm(512), nn.Identity(), nn.Flatten(),
                                          nn.Linear(512 * 7 * 7, 512), FrozenBatchNorm(512))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.input_layer[0].weight.dtype
        h = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        # the flatten reads the logical [B, C, H, W] order, as torch's (and
        # JAX's transposed flatten) does, whatever the memory format
        h = self.output_layer(self.body(self.input_layer(h)))
        return h / torch.linalg.vector_norm(h, dim=1, keepdim=True)


def extract_feats(model: IRSE50, image: torch.Tensor) -> torch.Tensor:
    """IDLoss.extract_feats: image [B, H, W, 3] in [-1, 1] pooled to 256 (unless
    it is 256 already), cropped to [35:223, 32:220], pooled to 112, embedded."""
    x = image.permute(0, 3, 1, 2)
    if x.shape[2] != 256:
        x = F.adaptive_avg_pool2d(x, 256)
    x = F.adaptive_avg_pool2d(x[:, :, 35:223, 32:220], 112)
    return model(x.permute(0, 2, 3, 1))


def cosine_sim(model: IRSE50, image: torch.Tensor, ref_embed: torch.Tensor) -> torch.Tensor:
    """[B] cosine similarity of the images' embeddings to ``ref_embed``, both
    normalised again."""
    feats = extract_feats(model, image)
    feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    ref = ref_embed / torch.linalg.vector_norm(ref_embed, dim=-1, keepdim=True)
    return (feats * ref).sum(dim=-1)


def cosine_loss(model: IRSE50, image: torch.Tensor, ref_embed: torch.Tensor) -> torch.Tensor:
    return (1.0 - cosine_sim(model, image, ref_embed)).mean()
