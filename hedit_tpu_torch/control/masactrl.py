"""MasaCtrl (mutual self-attention) as a k/v row remap (port of
``hedit_tpu/control/masactrl.py``).

For the self-attention layers whose pair index ``LayerTag.index // 2`` is at
least ``start_layer`` (of the 16 self/cross pairs of SD-1.5: the up blocks at
32^2 and 64^2 latent pixels from the default 10 on), and from editing step
``start_step`` on, every row of a CFG half attends to the keys and values of
the half's first row (the source).  Both halves are edited.  No probabilities
are materialised: the remapped k / v ride the fused attention path.

Rows are grouped by image, ``num_images`` groups of ``num_halves`` halves
each (``ops/attention.py``): a row takes the k / v of the first row of its own
half of its own image.  The step is a host-side Python int, so the gate is a
Python comparison where the JAX package uses ``jnp.where``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from hedit_tpu_torch.control.base import LayerTag

# Self-attention pair count per backbone: start_layer indexes into this range.
# Only SD is built; the SDXL constant is carried for the range check.
MODEL_TYPE_LAYERS: Dict[str, int] = {"SD": 16, "SDXL": 70}


@dataclasses.dataclass(frozen=True)
class MasaCtrlControl:
    step: int = 0              # editing-step index after --skip
    start_step: int = 4        # --step
    start_layer: int = 10      # --layer
    num_halves: int = 2        # CFG halves in an image's rows
    total_layers: int = MODEL_TYPE_LAYERS["SD"]
    num_images: int = 1

    def __post_init__(self):
        if not 0 <= self.start_layer < self.total_layers:
            raise ValueError(f"start_layer={self.start_layer} out of range for a backbone "
                             f"with {self.total_layers} self-attention layers")

    def _applies(self, layer: LayerTag) -> bool:
        return (not layer.is_cross and layer.place in ("down", "mid", "up")
                and layer.index // 2 >= self.start_layer)

    def map_qkv(self, q, k, v, layer: LayerTag):
        if not self._applies(layer) or self.step < self.start_step:
            return q, k, v
        rows = k.shape[0]
        group = rows // self.num_images
        if rows % self.num_images or group % self.num_halves:
            raise ValueError(f"{rows} rows do not hold {self.num_images} images of "
                             f"{self.num_halves} halves")
        shape = (self.num_images, self.num_halves, group // self.num_halves)

        def first_of_half(t):
            """Each row replaced by the first row of its half (one copy)."""
            t = t.reshape(*shape, *t.shape[1:])
            return t[:, :, :1].expand(t.shape).reshape(rows, *t.shape[3:])

        return q, first_of_half(k), first_of_half(v)

    def linear_token_edit(self, layer: LayerTag):
        return None

    def needs_probs(self, layer: LayerTag) -> bool:
        return False

    def map_features(self, h, site: str):
        return h
