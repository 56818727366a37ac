"""Prompt-to-Prompt control and LocalBlend (port of ``hedit_tpu/control/p2p.py``).

Every array of a ``P2PControl`` or ``LocalBlendState`` carries a leading
image axis of size ``num_images``: one batched UNet call holds the rows of
several images, grouped by image, and each image's edit reads and writes its
own group only (see ``ops/attention.py``).  ``stack_controls`` and
``stack_blends`` build a batch from per-image objects.

The editing step is a host-side Python int here (the loop is a Python loop),
so the step gates are plain branches where the JAX package uses
``jnp.where``; the results are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from hedit_tpu_torch.control import p2p_prep
from hedit_tpu_torch.control.base import LayerTag

MAX_LEN = 77


@dataclasses.dataclass(frozen=True)
class P2PControl:
    """Per-image P2P arrays [n, ...] plus the static configuration."""

    cross_alpha: torch.Tensor      # [n, num_steps + 1, 77] time-word alphas
    refine_mapper: torch.Tensor    # [n, 77] int64 (refine) or zeros
    refine_alphas: torch.Tensor    # [n, 77] float32 (refine) or ones
    replace_mapper: torch.Tensor   # [n, 77, 77] float32 (replace) or eye
    equalizer: torch.Tensor        # [n, 77] float32 multiplier
    step: int = 0
    mode: str = "refine"           # 'replace' | 'refine'
    use_reweight: bool = False
    self_replace_until: int = 0    # int(sa * num_steps)
    cond_start: int = 1            # row of the cond base within an image's group
    save_attn: bool = True         # False: apply the edits, store nothing
    blend_px: int = 256            # nominal (sample / 4)^2 store filter

    @property
    def num_images(self) -> int:
        return self.cross_alpha.shape[0]

    def to(self, device) -> "P2PControl":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in
            ("cross_alpha", "refine_mapper", "refine_alphas", "replace_mapper", "equalizer")})

    def map_qkv(self, q, k, v, layer: LayerTag):
        """Self-attention replace as a q/k row-select: inside the window the
        edit row attends with the base row's queries and keys
        (``softmax(q_base k_base^T) @ v_edit``)."""
        if (layer.is_cross or layer.place not in ("down", "mid", "up")
                or layer.num_pixels > 32 * 32 or self.step >= self.self_replace_until):
            return q, k, v
        n, cs = self.num_images, self.cond_start
        q = q.reshape(n, -1, *q.shape[1:]).clone()
        k = k.reshape(n, -1, *k.shape[1:]).clone()
        q[:, cs + 1] = q[:, cs]
        k[:, cs + 1] = k[:, cs]
        return q.reshape(-1, *q.shape[2:]), k.reshape(-1, *k.shape[2:]), v

    def needs_probs(self, layer: LayerTag) -> bool:
        return self._is_store_layer(layer)

    def linear_token_edit(self, layer: LayerTag):
        """The cross edit as ``new_repl = base @ A + repl * b`` over the token
        axis: returns (A [n, 77, 77], b [n, 77]) in float32, or None where
        the edit does not apply (self layers, store layers)."""
        if (not layer.is_cross or layer.place not in ("down", "mid", "up")
                or self._is_store_layer(layer)):
            return None
        alpha_t = self.cross_alpha[:, self.step].float()                # [n, 77]
        eq = self.equalizer.float() if self.use_reweight else torch.ones_like(alpha_t)
        if self.mode == "replace":
            A = self.replace_mapper.float() * (eq * alpha_t)[:, None, :]
            b = 1.0 - alpha_t
        else:
            # M[w, m] = [mapper[m] == w]
            M = F.one_hot(self.refine_mapper.long(), MAX_LEN).transpose(1, 2).float()
            ra = self.refine_alphas.float()
            A = M * (ra * eq * alpha_t)[:, None, :]
            b = (1.0 - ra) * eq * alpha_t + (1.0 - alpha_t)
        return A, b

    def _is_store_layer(self, layer: LayerTag) -> bool:
        return (self.save_attn and layer.is_cross and layer.num_pixels == self.blend_px
                and layer.place in ("down", "up"))

    def edit_pair(self, base: torch.Tensor, repl: torch.Tensor, layer: LayerTag):
        """The P2P edit on each image's (cond base, cond edit) probabilities
        [n, H, Q, K]; returns (new edit-row probabilities, store)."""
        if layer.is_cross:
            if self.mode == "replace":
                new_base = torch.einsum("nhpw,nwm->nhpm", base, self.replace_mapper.float())
            else:
                idx = self.refine_mapper.long()[:, None, None, :].expand(base.shape)
                ra = self.refine_alphas.float()[:, None, None, :]
                new_base = torch.gather(base, 3, idx) * ra + repl * (1.0 - ra)
            if self.use_reweight:
                new_base = new_base * self.equalizer.float()[:, None, None, :]
            alpha = self.cross_alpha[:, self.step].float()[:, None, None, :]
            new_repl = new_base * alpha + (1.0 - alpha) * repl
        else:
            new_repl = base if self.step < self.self_replace_until else repl
        store: Dict[str, torch.Tensor] = {}
        if self._is_store_layer(layer):
            store[layer.store_name] = torch.stack([base, new_repl], dim=1)  # [n, 2, H, Q, 77]
        return new_repl, store


def _stack(items, fields):
    return {f: torch.cat([getattr(x, f) for x in items]) for f in fields}


def stack_controls(controls: Sequence[P2PControl]) -> P2PControl:
    """One control over the images of ``controls`` (their static fields must agree)."""
    statics = {(c.mode, c.use_reweight, c.self_replace_until, c.cond_start, c.blend_px)
               for c in controls}
    if len(statics) != 1:
        raise ValueError(f"controls differ in static configuration: {statics}")
    return dataclasses.replace(controls[0], **_stack(controls, (
        "cross_alpha", "refine_mapper", "refine_alphas", "replace_mapper", "equalizer")))


def build_p2p_control(*, num_steps: int, cross_replace_steps, self_replace_steps,
                      prompts, tokenizer, is_replace: bool, eq_params: Optional[dict] = None,
                      cond_start: int = 1, blend_px: int = 256) -> P2PControl:
    """One image's control (``make_controller``, ``ptp_controller_utils.py:106-134``)."""
    cross_alpha = p2p_prep.get_time_words_attention_alpha(
        prompts, num_steps, cross_replace_steps, tokenizer)[:, 0, :]
    if is_replace:
        replace_mapper = p2p_prep.get_replacement_mapper(prompts, tokenizer)[0]
        refine_mapper = np.zeros(MAX_LEN, dtype=np.int64)
        refine_alphas = np.ones(MAX_LEN, dtype=np.float32)
    else:
        rm, ra = p2p_prep.get_refinement_mapper(prompts, tokenizer)
        refine_mapper, refine_alphas = rm[0], ra[0]
        replace_mapper = np.eye(MAX_LEN, dtype=np.float32)
    if eq_params is not None:
        equalizer = p2p_prep.get_equalizer(prompts[1], eq_params["words"],
                                           eq_params["values"], tokenizer)
    else:
        equalizer = np.ones(MAX_LEN, dtype=np.float32)
    if isinstance(self_replace_steps, float):
        self_replace_until = int(num_steps * self_replace_steps)
    else:
        self_replace_until = int(num_steps * self_replace_steps[1])
    t = lambda a: torch.from_numpy(np.asarray(a))[None]  # noqa: E731
    return P2PControl(
        cross_alpha=t(cross_alpha.astype(np.float32)), refine_mapper=t(refine_mapper),
        refine_alphas=t(refine_alphas), replace_mapper=t(replace_mapper),
        equalizer=t(equalizer), mode="replace" if is_replace else "refine",
        use_reweight=eq_params is not None, self_replace_until=self_replace_until,
        cond_start=cond_start, blend_px=blend_px)


def neutral_control(num_steps: int, blend_px: int, cond_start: int = 1) -> P2PControl:
    """A control whose every edit is the identity (alphas zero, equalizer
    ones), for batching controller-less images with controlled ones
    (``parallel/sweep.py:neutral_control``)."""
    return P2PControl(
        cross_alpha=torch.zeros(1, num_steps + 1, MAX_LEN),
        refine_mapper=torch.arange(MAX_LEN)[None],
        refine_alphas=torch.ones(1, MAX_LEN),
        replace_mapper=torch.eye(MAX_LEN)[None],
        equalizer=torch.ones(1, MAX_LEN),
        cond_start=cond_start, blend_px=blend_px)


# ------------------------------------------------------------- local blend #

@dataclasses.dataclass(frozen=True)
class LocalBlendState:
    """LocalBlend inputs (``ptp_classes.py:17-72``), per image."""

    alpha_layers: torch.Tensor   # [n, 2, 77] word mask per prompt row
    store_sum: torch.Tensor      # [n, 5, 2, H, px, 77] accumulated post-edit maps
    start_blend: torch.Tensor    # [n] int64: blend active when step + 1 > start_blend
    threshold: float = 0.3
    res: int = 16                # store grid side (runtime latent side / 4)

    def to(self, device) -> "LocalBlendState":
        return dataclasses.replace(self, alpha_layers=self.alpha_layers.to(device),
                                   store_sum=self.store_sum.to(device),
                                   start_blend=self.start_blend.to(device))


def init_local_blend(prompts, words, tokenizer, *, num_steps: int, heads: int,
                     res: int = 16, start_blend: float = 0.2,
                     threshold: float = 0.3) -> LocalBlendState:
    alpha = np.zeros((len(prompts), MAX_LEN), dtype=np.float32)
    for i, (prompt, words_) in enumerate(zip(prompts, words)):
        if isinstance(words_, str):
            words_ = [words_]
        for word in words_:
            alpha[i, p2p_prep.get_word_inds(prompt, word, tokenizer)] = 1.0
    return LocalBlendState(
        alpha_layers=torch.from_numpy(alpha)[None],
        store_sum=torch.zeros(1, 5, 2, heads, res * res, MAX_LEN),
        start_blend=torch.tensor([int(start_blend * num_steps)]),
        threshold=threshold, res=res)


def neutral_blend(num_steps: int, heads: int, res: int) -> LocalBlendState:
    """A LocalBlend that never activates (start_blend > num_steps)."""
    return LocalBlendState(
        alpha_layers=torch.zeros(1, 2, MAX_LEN),
        store_sum=torch.zeros(1, 5, 2, heads, res * res, MAX_LEN),
        start_blend=torch.tensor([num_steps + 2]), res=res)


def stack_blends(blends: Sequence[LocalBlendState]) -> LocalBlendState:
    statics = {(b.threshold, b.res) for b in blends}
    if len(statics) != 1:
        raise ValueError(f"blends differ in static configuration: {statics}")
    return dataclasses.replace(blends[0], **_stack(
        blends, ("alpha_layers", "store_sum", "start_blend")))


def accumulate_store(lb: LocalBlendState, store: Dict[str, torch.Tensor]) -> LocalBlendState:
    """Add this step's stored maps into the running sum, in the reference's
    ``down_cross[2:4] + up_cross[:3]`` order (store_index ascending)."""
    def ordered(prefix):
        return sorted((k for k in store if k.startswith(prefix)),
                      key=lambda s: int(s.rsplit("_", 1)[1]))

    names = ordered("down_cross") + ordered("up_cross")
    if not names:
        return lb
    maps = torch.stack([store[n] for n in names], dim=1).float()  # [n, 5, 2, H, Q, 77]
    return dataclasses.replace(lb, store_sum=lb.store_sum + maps)


def apply_local_blend(lb: LocalBlendState, x_pair: torch.Tensor, step: int) -> torch.Tensor:
    """Blend the edited latent into the original outside the word mask (:44-72).

    x_pair: [n, 2, H, W, C] = [x_orig, x_edit] per image (NHWC)."""
    n, r = lb.store_sum.shape[0], lb.res
    maps = lb.store_sum.transpose(1, 2).reshape(n, 2, -1, r, r, MAX_LEN)
    m = (maps * lb.alpha_layers[:, :, None, None, None, :]).sum(-1).mean(2)  # [n, 2, r, r]
    m = F.max_pool2d(m.reshape(n * 2, 1, r, r), 3, stride=1, padding=1)
    H, W = x_pair.shape[2], x_pair.shape[3]
    m = F.interpolate(m, size=(H, W), mode="nearest").reshape(n, 2, H, W)
    m = m / m.amax(dim=(2, 3), keepdim=True)
    mask = m > lb.threshold
    mask = mask[:, :1] | mask
    mask = mask[..., None].to(x_pair.dtype)
    blended = x_pair[:, :1] + mask * (x_pair - x_pair[:, :1])
    active = (step + 1 > lb.start_blend).reshape(n, 1, 1, 1, 1)
    return torch.where(active, blended, x_pair)
