"""The flagship h-Edit-R + P2P implicit edit, batched over images
(port of ``hedit_tpu/parallel/sweep.py:make_flagship_runner``).

Configuration: implicit, cfg_src == 1, one optimisation step, eta > 0, the
source branch indexed from the stored trajectory ``xts`` and the inversion
residuals derived inside the loop (``derive_zs``).  Per step, for B images:

1. one base call of B rows: eps(x_edit, t, src);
2. the residual z from the previous step's controller-source eps (step 0:
   the base eps, since x_edit == x_orig == x_T there), and
   x_opt = reverse_step(eps_src, t, x_edit, z);
3. one controlled call of 4B rows, [x_opt, x_opt, x_prev_orig, x_opt] per
   image with contexts [uncond, src, src, tar] and cond_start = 2; its row 2
   (src at x_prev_orig, untouched by P2P) is the next step's eps_orig;
4. x_opt += coeff * (eps_tar - eps_src_edit), then LocalBlend on
   [x_prev_orig, x_opt].

This equals ``hedit_tpu/edit/h_edit_p2p.py:h_edit_p2p(..., xts=xts,
derive_zs=True)`` for each image under that configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from hedit_tpu_torch.control.p2p import (
    LocalBlendState, P2PControl, accumulate_store, apply_local_blend,
)
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit.h_edit import HEditConfig


@torch.no_grad()
def h_edit_p2p_flagship(unet, schedule: Schedule, cfg: HEditConfig, *, xts: torch.Tensor,
                        ctx4: torch.Tensor, control: P2PControl,
                        local_blend: LocalBlendState, after_skip_steps: int) -> torch.Tensor:
    """Edit B images at once.

    xts: [B, S+1, H, W, C] q-sampled trajectories (NHWC, xts[:, 0] the source
    latents), S = after_skip_steps.  ctx4: [B, 4, 77, D] rows [uncond, src,
    src, tar].  control / local_blend: per-image state with B images.
    Returns the edited latents [B, H, W, C] in float32."""
    if cfg.eta <= 0:
        raise ValueError(f"h-Edit-R needs eta > 0 (DDPM), got {cfg.eta}")
    S = after_skip_steps
    B = xts.shape[0]
    if xts.shape[1] != S + 1 or ctx4.shape[:2] != (B, 4):
        raise ValueError(f"xts {tuple(xts.shape)} / ctx4 {tuple(ctx4.shape)} do not "
                         f"match {B} images and {S} steps")
    if control.num_images != B or local_blend.store_sum.shape[0] != B:
        raise ValueError(f"control / local_blend must hold {B} images")
    xts = xts.float()
    src_ctx = ctx4[:, 1]
    ctx4c = ctx4.reshape(4 * B, *ctx4.shape[2:])
    ts = schedule.timesteps[-S:].tolist()
    tts = ts[1:] + [0]
    lb = local_blend
    x_edit = xts[:, S]
    eps_orig = None
    for i in range(S):
        t, tt = ts[i], tts[i]
        x_orig_t, x_prev_orig = xts[:, S - i], xts[:, S - 1 - i]
        eps_src = unet(x_edit, t, src_ctx).float()
        if eps_orig is None:
            eps_orig = eps_src
        mu = schedule.reverse_step(eps_orig, t, x_orig_t, eta=cfg.eta)
        z = (x_prev_orig - mu) / (cfg.eta * torch.sqrt(schedule.variance(t)))
        x_opt = schedule.reverse_step(eps_src, t, x_edit, eta=cfg.eta, variance_noise=z)

        ctrl = dataclasses.replace(control, step=i, cond_start=2)
        xin4 = torch.stack([x_opt, x_opt, x_prev_orig, x_opt], dim=1)
        store: Dict[str, torch.Tensor] = {}
        eps4 = unet(xin4.reshape(4 * B, *xin4.shape[2:]), tt, ctx4c, ctrl, store)
        eps4 = eps4.float().reshape(B, 4, *eps4.shape[1:])
        lb = accumulate_store(lb, store)
        u_tar, cond_src, c_tar = eps4[:, 0], eps4[:, 1], eps4[:, 3]
        eps_se = u_tar + cfg.cfg_src_edit * (cond_src - u_tar)
        eps_ta = u_tar + cfg.cfg_tar * (c_tar - u_tar)
        x_opt = x_opt + schedule.h_edit_coeff(t, tt, cfg.eta) * (eps_ta - eps_se)
        pair = apply_local_blend(lb, torch.stack([x_prev_orig, x_opt], dim=1), i)
        x_edit, eps_orig = pair[:, 1], eps4[:, 2]
    return x_edit
