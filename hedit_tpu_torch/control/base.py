"""Attention-control protocol of the port (mirrors ``hedit_tpu/control/base.py``).

Each attention layer of the UNet carries a static ``LayerTag`` and asks the
control object, per call:

1. ``map_qkv``           - pre-attention row remapping of q/k/v (the P2P self
                           edit is a q/k row-select);
2. ``linear_token_edit`` - the P2P cross edit as a linear map over the token
                           axis, or None;
3. ``needs_probs``       - whether this layer must materialise attention
                           probabilities (the P2P store layers, and a store
                           control's, whose ``edit_probs`` returns the maps).

A control that intervenes in logit space (mask-guided MasaCtrl) also has
``override_attention``: it gets the head-split views of q / k / v before
``map_qkv`` and returns the attention output, or None to take the paths
above.

Every control also has ``map_features(h, site)``, called by the UNet's up
block resnets on their conv branch (after conv2, before the skip add) with
the block's site name ``up_{block}_resnet_{layer}``: PnP writes its conv
features there, every other control returns ``h`` unchanged.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerTag:
    """Static identity of one attention layer inside the UNet.

    place: 'down' | 'mid' | 'up' | 'vae'; is_cross: text keys or self keys;
    num_pixels: the config-nominal query length; index: position in forward
    order; store_index: index among the (place, kind) layers with
    num_pixels <= 32*32 (-1 otherwise); up_block_index / inner_index: PnP's
    injection-site coordinates."""

    place: str
    is_cross: bool
    num_pixels: int
    index: int
    store_index: int = -1
    up_block_index: int = -1
    inner_index: int = -1

    @property
    def store_name(self) -> str:
        kind = "cross" if self.is_cross else "self"
        return f"{self.place}_{kind}_{self.store_index}"


class NoControl:
    """Identity control: plain attention everywhere, nothing stored."""

    def map_qkv(self, q, k, v, layer: LayerTag):
        return q, k, v

    def linear_token_edit(self, layer: LayerTag):
        return None

    def needs_probs(self, layer: LayerTag) -> bool:
        return False

    def map_features(self, h, site: str):
        return h


NO_CONTROL = NoControl()
