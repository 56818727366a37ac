"""VGG16-LPIPS perceptual distance, frozen and differentiable (port of
``hedit_tpu/models/lpips_vgg.py``).

The ``lpips.LPIPS(net='vgg')`` critic of the face-swap workload: inputs in
[-1, 1] shifted and scaled by the ImageNet constants, VGG16 features tapped
after relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3, each tap normalised
over its channels, the squared difference mapped through a learned 1x1
"lin" layer, averaged over the pixels and summed over the taps.  The unit
normalisation is JAX's ``x / sqrt(sum x^2 + 1e-10)``, not the ``lpips``
package's ``x / (sqrt(sum x^2) + eps)``.

Keys: the ``lpips`` package's layout, ``net.slice{k}.{torchvision index}``
and ``lin{i}.model.1``, which the JAX package's ``convert_lpips_vgg`` reads;
``lpips_state`` maps the torchvision (``net.features.N``) and ``lins.N``
layouts that it also reads onto them.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from hedit_tpu_torch.models.blocks import Conv2d

# VGG16 conv plan: (channels, convs) a stage; a tap after each stage
VGG16_STAGES: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class VGG16Features(nn.Module):
    """[B, 3, H, W] (already scaled) -> the 5 stage activations.  Stage k is
    ``slice{k}``, torchvision's ``features`` modules under their own
    indices: a max pool first from stage 2 on, then conv + ReLU pairs."""

    def __init__(self):
        super().__init__()
        idx, cin = 0, 3
        for si, (ch, n) in enumerate(VGG16_STAGES):
            layers = []
            if si:
                layers.append((str(idx), nn.MaxPool2d(2, 2)))
                idx += 1
            for _ in range(n):
                layers += [(str(idx), Conv2d(cin, ch, 3, padding=1)),
                           (str(idx + 1), nn.ReLU())]
                idx, cin = idx + 2, ch
            setattr(self, f"slice{si + 1}", nn.Sequential(OrderedDict(layers)))

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for si in range(len(VGG16_STAGES)):
            x = getattr(self, f"slice{si + 1}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    """The 1x1 "lin" layer; index 0 is the reference's Dropout (eval: the identity)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), Conv2d(channels, 1, 1, bias=False))


class LPIPSVgg(nn.Module):
    """LPIPS distance [B] between two NHWC images in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for i, (ch, _) in enumerate(VGG16_STAGES):
            setattr(self, f"lin{i}", NetLinLayer(ch))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The unit-normalised taps of an NHWC image in [-1, 1]."""
        dtype = self.net.slice1[0].weight.dtype
        shift = torch.from_numpy(SHIFT).to(x.device)
        scale = torch.from_numpy(SCALE).to(x.device)
        x = ((x - shift) / scale).to(dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return [a / torch.sqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
                for a in self.net(x)]

    def distance(self, fx: List[torch.Tensor], fy: List[torch.Tensor]) -> torch.Tensor:
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            w = getattr(self, f"lin{i}").model((a - b) ** 2)
            total = total + w.mean(dim=(1, 2, 3))
        return total

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.distance(self.features(x), self.features(y))


# torchvision's vgg16.features conv indices, and the slices lpips cuts them into
TV_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
SLICE_BOUNDS = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))


def slice_key(tv_idx: int) -> str:
    """``net.slice{k}.{tv_idx}``: the lpips slice that holds torchvision index tv_idx."""
    k = next((si for si, (lo, hi) in enumerate(SLICE_BOUNDS) if lo <= tv_idx < hi), 4)
    return f"net.slice{k + 1}.{tv_idx}"


def lpips_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The tensors ``convert_lpips_vgg`` reads, under the port's keys: the
    convs from ``net.features.N`` (torchvision) or ``net.sliceK.N`` (lpips),
    the lin layers from ``lin{i}.model.1`` or ``lins.{i}.model.1``; every
    other key (the scaling layer's buffers, ...) is dropped."""
    out = {}
    for key, t in state.items():
        m = re.fullmatch(r"net\.(?:features|slice\d)\.(\d+)\.(weight|bias)", key)
        if m and int(m.group(1)) in TV_CONV_IDX:
            out[f"{slice_key(int(m.group(1)))}.{m.group(2)}"] = t
        m = re.fullmatch(r"lins?\.?(\d)\.model\.1\.weight", key)
        if m:
            out[f"lin{m.group(1)}.model.1.weight"] = t
    return out
