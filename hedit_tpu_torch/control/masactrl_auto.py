"""Auto-mask MasaCtrl: foreground masks from cross-attention maps (port of
``hedit_tpu/control/masactrl_auto.py``).

A store pass over the full UNet (``CrossMapStore``) collects the head-meaned
cross-attention maps at one resolution (16^2 latent pixels in SD-1.5);
``aggregate_token_mask`` averages them over layers, sums the chosen tokens,
and min-max normalises; thresholded, they are the source and target masks of
``MasaCtrlMaskControl``.  As in the JAX package the maps come from a whole
store pass, so every self layer sees the complete step's mask, and the
masked attention itself is ``MasaCtrlMaskControl``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from hedit_tpu_torch.control.base import LayerTag
from hedit_tpu_torch.control.masactrl_mask import MasaCtrlMaskControl


@dataclasses.dataclass(frozen=True)
class CrossMapStore:
    """Store-only control: head-meaned cross-attention maps [B, Q, 77] of the
    cross layers with ``px`` nominal query pixels."""

    px: int = 256

    def map_qkv(self, q, k, v, layer: LayerTag):
        return q, k, v

    def linear_token_edit(self, layer: LayerTag):
        return None

    def needs_probs(self, layer: LayerTag) -> bool:
        return layer.is_cross and layer.num_pixels == self.px

    def map_features(self, h, site: str):
        return h

    def edit_probs(self, probs: torch.Tensor, layer: LayerTag
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return probs, {f"cross16_{layer.place}_{layer.store_index}": probs.mean(dim=1)}


def aggregate_token_mask(maps: Dict[str, torch.Tensor], token_idx: Sequence[int],
                         row: int) -> torch.Tensor:
    """Mean of the maps over layers at one row, summed over ``token_idx`` and
    min-max normalised: maps [B, Q, K] each -> [res, res]."""
    mean = torch.stack([v for _, v in sorted(maps.items())]).mean(dim=0)[row]   # [Q, K]
    res = int(mean.shape[0] ** 0.5)
    img = mean[:, list(token_idx)].sum(dim=-1).reshape(res, res)
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo + 1e-12)


@torch.no_grad()
def masactrl_auto_masks(unet, x4: torch.Tensor, t, ctx4: torch.Tensor, *,
                        ref_token_idx: Sequence[int] = (1,),
                        cur_token_idx: Sequence[int] = (1,), thres: float = 0.1,
                        px: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the store pass and return binarised (mask_s, mask_t) [n, res, res].

    x4 [4n, H, W, C], ctx4 [4n, 77, D]: rows [u_src, u_tar, c_src, c_tar] an
    image.  The masks read each image's conditional rows (source row 2,
    target row 3)."""
    store: Dict[str, torch.Tensor] = {}
    unet(x4, t, ctx4, CrossMapStore(px=px), store)
    n = x4.shape[0] // 4
    maps = {k: v.float() for k, v in store.items()}
    mask_s = torch.stack([aggregate_token_mask(maps, ref_token_idx, 4 * i + 2) for i in range(n)])
    mask_t = torch.stack([aggregate_token_mask(maps, cur_token_idx, 4 * i + 3) for i in range(n)])
    return (mask_s >= thres).float(), (mask_t >= thres).float()


def auto_mask_control(step: int, mask_s: torch.Tensor, mask_t: torch.Tensor, *,
                      start_step: int = 4, start_layer: int = 10) -> MasaCtrlMaskControl:
    return MasaCtrlMaskControl(mask_s=mask_s, mask_t=mask_t, step=step,
                               start_step=start_step, start_layer=start_layer)
