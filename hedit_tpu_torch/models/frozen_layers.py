"""Inference-mode BatchNorm of the frozen critics (port of
``hedit_tpu/models/frozen_layers.py``; its ``PReLU`` is ``nn.PReLU`` here and
its ``adaptive_avg_pool_2d`` ``F.adaptive_avg_pool2d``, the same torch
semantics the JAX package builds as separable matrices).

The reward networks (ArcFace, VGG-LPIPS, the face parser) are frozen in
the reference: BatchNorm runs in eval mode on its stored running statistics
and never updates them.  Only the image they score receives a gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1 of a [B, C] or [B, C, H, W] tensor,
    with torch's keys (``weight``, ``bias``, ``running_mean``,
    ``running_var``) and no ``num_batches_tracked``: the statistics are
    never updated, in ``train()`` as in ``eval()``."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)
