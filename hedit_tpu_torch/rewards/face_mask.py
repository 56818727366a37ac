"""Face mask: segmentation encoding and soft erosion (port of
``hedit_tpu/rewards/face_mask.py``).

``encode_segmentation``: a class-id map -> (face, mouth, hair) binary maps,
the no-neck part ids [1..7, 10, 11, 12].  ``soft_erosion``: a radial-distance
kernel, iterated min-convolution, the threshold raised to 1 and the rest
renormalised by its largest value.  The face-swap blend takes
soft_erode(face + mouth) with kernel 13, threshold 0.9, 7 iterations.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NO_NECK_IDS = (1, 2, 3, 4, 5, 6, 7, 10, 11, 12)
WITH_NECK_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 13, 14)
MOUTH_ID = 10
HAIR_ID = 13


def encode_segmentation(seg: torch.Tensor, no_neck: bool = True) -> torch.Tensor:
    """seg [B, H, W] int -> [B, H, W, 3] float32 (face, mouth, hair)."""
    ids = torch.tensor(NO_NECK_IDS if no_neck else WITH_NECK_IDS, device=seg.device)
    face = torch.isin(seg, ids).float()
    mouth = (seg == MOUTH_ID).float()
    hair = (seg == HAIR_ID).float()
    return torch.stack([face, mouth, hair], dim=-1)


def _erosion_kernel(kernel_size: int) -> np.ndarray:
    r = kernel_size // 2
    y, x = np.meshgrid(np.arange(kernel_size), np.arange(kernel_size), indexing="ij")
    dist = np.sqrt((x - r) ** 2 + (y - r) ** 2)
    k = dist.max() - dist
    return (k / k.sum()).astype(np.float32)


def soft_erosion(x: torch.Tensor, kernel_size: int = 15, threshold: float = 0.6,
                 iterations: int = 1):
    """x [B, H, W, 1] -> (soft mask, bool mask).  The renormalisation divides
    by the largest value below the threshold over the WHOLE batch, as JAX
    does: blend one image at a time for one-image results."""
    k = torch.from_numpy(_erosion_kernel(kernel_size)).to(x.device)[None, None]
    pad = kernel_size // 2
    v = x.permute(0, 3, 1, 2)

    def conv(v):
        return F.conv2d(v, k, padding=pad)

    for _ in range(iterations - 1):
        v = torch.minimum(v, conv(v))
    v = conv(v).permute(0, 2, 3, 1)
    mask = v >= threshold
    below_max = torch.clamp(torch.where(mask, -torch.inf, v).max(), min=1e-12)
    return torch.where(mask, 1.0, v / below_max), mask


def build_face_mask(seg: torch.Tensor, *, kernel_size: int = 13, threshold: float = 0.9,
                    iterations: int = 7) -> torch.Tensor:
    """The face + mouth soft mask [B, H, W, 1] of a class map [B, H, W]."""
    enc = encode_segmentation(seg)
    fm = (enc[..., 0] + enc[..., 1])[..., None]
    return soft_erosion(fm, kernel_size, threshold, iterations)[0]
