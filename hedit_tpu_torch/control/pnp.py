"""Plug-and-Play feature and attention injection (port of
``hedit_tpu/control/pnp.py``).

Semantics of the reference's ``plug_n_play/pnp_utils.py``:

* q / k injection on the self-attentions of the up blocks at
  ``PNP_ATTN_SITES`` (up block, inner index): while the gate is on, the target
  row attends with the source row's queries and keys; v is untouched, and so
  are the cross-attentions;
* conv-feature injection at ``PNP_CONV_SITE`` (``up_blocks[1].resnets[1]``):
  the target row's conv branch (after conv2, before the skip add) becomes the
  source row's.

Rows are grouped by image, ``num_images`` groups of [source, target] (the JAX
package's control sees one image's pair).  The gates are host-side Python
bools, ``i < int(N * frac)`` of the editing step (``pnp_step_gates``), where
the JAX package carries traced booleans.  Every write goes into a copy: a
caller may still hold the tensors it passed in.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Tuple

import torch

from hedit_tpu_torch.control.base import LayerTag

PNP_ATTN_SITES: FrozenSet[Tuple[int, int]] = frozenset(
    {(1, 1), (1, 2), (2, 0), (2, 1), (2, 2), (3, 0), (3, 1), (3, 2)}
)
PNP_CONV_SITE = "up_1_resnet_1"


def _inject(x: torch.Tensor, num_images: int) -> torch.Tensor:
    """A copy of x [rows, ...] in which row 1 of each image's group takes
    row 0's values.  The copy keeps x's strides (channels-last stays
    channels-last): splitting the row axis is a view."""
    rows = x.shape[0]
    if rows % num_images or rows // num_images < 2:
        raise ValueError(f"{rows} rows do not hold {num_images} [source, target] pairs")
    out = x.clone()
    g = out.view(num_images, rows // num_images, *x.shape[1:])
    g[:, 1] = g[:, 0]
    return out


@dataclasses.dataclass(frozen=True)
class PnPControl:
    qk_on: bool = False      # step < int(N * pnp_attn_t)
    conv_on: bool = False    # step < int(N * pnp_f_t)
    num_images: int = 1

    def map_qkv(self, q, k, v, layer: LayerTag):
        if (not self.qk_on or layer.is_cross
                or (layer.up_block_index, layer.inner_index) not in PNP_ATTN_SITES):
            return q, k, v
        return _inject(q, self.num_images), _inject(k, self.num_images), v

    def linear_token_edit(self, layer: LayerTag):
        return None

    def needs_probs(self, layer: LayerTag) -> bool:
        return False

    def map_features(self, h, site: str):
        if not self.conv_on or site != PNP_CONV_SITE:
            return h
        return _inject(h, self.num_images)


def pnp_step_gates(after_skip_steps: int, pnp_attn_t: float, pnp_f_t: float
                   ) -> Tuple[List[bool], List[bool]]:
    """(qk gates, conv gates) over the editing loop: step i is inside the
    schedule iff i < int(N * frac) (``main_plugnplay.py:189-194``)."""
    N = after_skip_steps
    qk_until, conv_until = int(N * pnp_attn_t), int(N * pnp_f_t)
    return [i < qk_until for i in range(N)], [i < conv_until for i in range(N)]
