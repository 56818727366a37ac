"""Mask-guided MasaCtrl with explicit foreground / background masks (port of
``hedit_tpu/control/masactrl_mask.py``).

For the qualifying self-attention layers (as ``MasaCtrlControl``) and from
``start_step`` on, in each image's rows [u_src, u_tar, c_src, c_tar]:

* the source rows attend to their own k / v;
* a target row attends to its half's SOURCE k / v twice, with the source
  mask applied in logit space: the foreground pass adds ``NEG`` (float32) to
  the background keys' logits, the background pass to the foreground keys';
* the two results are blended per query pixel by the target mask.

Before ``start_step`` every row is plain attention.  The intervention is
pre-softmax, so it runs through the ``override_attention`` hook on head-split
views, in plain tensor code as in the JAX package.  Masks carry a leading
image axis ([n, H, W]); they are brought to the layer's grid by JAX's
nearest-neighbour index rule (``jax.image.resize(..., "nearest")`` samples
source pixel floor((i + 0.5) * in / out), where ``F.interpolate`` samples
floor(i * in / out): the two differ on some size ratios).
"""

from __future__ import annotations

import dataclasses

import torch

from hedit_tpu_torch.control.base import LayerTag

NEG = -1e30


def resize_nearest(mask: torch.Tensor, res: int) -> torch.Tensor:
    """[n, H, W] -> [n, res, res] by JAX's nearest rule (offsets in float32)."""
    def index(n_in):
        pos = (torch.arange(res, dtype=torch.float32) + 0.5) * n_in / res
        return torch.floor(pos).long().to(mask.device)

    return mask[:, index(mask.shape[1])][:, :, index(mask.shape[2])]


def _attention(q, k, v, bias=None):
    """softmax(q k^T / sqrt(d) + bias) v with float32 logits: q [n, H, L, D],
    k / v [n, H, Lk, D], bias [n, Lk] float32 or None."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / q.shape[-1] ** 0.5
    if bias is not None:
        s = s + bias[:, None, None, :]
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


@dataclasses.dataclass(frozen=True)
class MasaCtrlMaskControl:
    mask_s: torch.Tensor      # [n, H, W] float source masks
    mask_t: torch.Tensor      # [n, H, W] float target masks
    step: int = 0
    start_step: int = 4
    start_layer: int = 10

    @property
    def num_images(self) -> int:
        return self.mask_s.shape[0]

    def _applies(self, layer: LayerTag) -> bool:
        return (not layer.is_cross and layer.place in ("down", "mid", "up")
                and layer.index // 2 >= self.start_layer)

    def map_qkv(self, q, k, v, layer: LayerTag):
        return q, k, v

    def linear_token_edit(self, layer: LayerTag):
        return None

    def needs_probs(self, layer: LayerTag) -> bool:
        return False

    def map_features(self, h, site: str):
        return h

    def override_attention(self, q, k, v, layer: LayerTag):
        """q / k / v [4n, heads, L, D] with rows [u_src, u_tar, c_src, c_tar]
        an image; returns [4n, heads, L, D], or None off the qualifying
        layers."""
        if not self._applies(layer):
            return None
        if self.step < self.start_step:
            return _attention(q, k, v)
        n = self.num_images
        if q.shape[0] != 4 * n:
            raise ValueError(f"{q.shape[0]} rows are not [u_src, u_tar, c_src, c_tar] "
                             f"of {n} images")
        res = int(layer.num_pixels ** 0.5)
        if res * res != q.shape[2]:
            raise ValueError(f"{q.shape[2]} queries are not the layer's {res}x{res} grid")
        m_s = resize_nearest(self.mask_s, res).reshape(n, -1).float()       # [n, L]
        m_t = resize_nearest(self.mask_t, res).reshape(n, 1, -1, 1)         # [n, 1, L, 1]
        qg, kg, vg = (t.reshape(n, 4, *t.shape[1:]) for t in (q, k, v))
        fg_bias = torch.where(m_s == 0, NEG, 0.0)   # foreground pass: drop background keys
        bg_bias = torch.where(m_s == 1, NEG, 0.0)

        def target(r):
            fg = _attention(qg[:, r], kg[:, 0], vg[:, 0], fg_bias)
            bg = _attention(qg[:, r], kg[:, 0], vg[:, 0], bg_bias)
            return fg * m_t.to(fg.dtype) + bg * (1 - m_t).to(fg.dtype)

        out = torch.stack([_attention(qg[:, 0], kg[:, 0], vg[:, 0]), target(1),
                           _attention(qg[:, 2], kg[:, 2], vg[:, 2]), target(3)], dim=1)
        return out.reshape(q.shape)
