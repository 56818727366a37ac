"""Noise Map Guidance + P2P, batched over images
(port of ``hedit_tpu/edit/baselines.py:nmg_p2p``).

Parity: the reference's ``inversion/p2p_baselines.py:195-293``.  eta = 0
throughout.  Per step, for B images:

1. the NMG gradient step on the reconstruction branch: the L1 distance
   between the DDIM-predicted x_{t-1} and the inversion's stored x_{t-1}^orig,
   differentiated with respect to x THROUGH one uncond UNet call of B rows
   (``torch.autograd.grad`` on a leaf copy of x_orig; the UNet's parameters are
   frozen, so only the activations' gradient is built).  The eps of that same
   call, detached, is the step's uncond eps at x_orig: the JAX function
   evaluates the UNet twice on the same input for the same value;
2. eps_nmg = eps_u + guidance * (eps_cond - eps_u) with
   eps_cond = eps_u + sqrt(1 - abar_t) * grad * grad_scale, and the eta = 0
   step of x_orig;
3. one controlled call of 4B rows, [x_orig, x_edit, x_orig, x_edit] per image
   with contexts [uncond, uncond, src, tar] and cond_start = 2; the TARGET cfg
   scale on both rows (the reference's quirk, kept); eta = 0 steps of both
   branches; LocalBlend on the pair.

``ef_or_pnp_inv_p2p`` of the same JAX module is still to be ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from hedit_tpu_torch.control.p2p import (
    LocalBlendState, P2PControl, accumulate_store, apply_local_blend,
)
from hedit_tpu_torch.core.schedule import Schedule


def nmg_gradient(unet, schedule: Schedule, x: torch.Tensor, t: int, uncond_ctx: torch.Tensor,
                 x_prev_gt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d loss / d x, eps_u): loss is, per image, mean |reverse_step(eps_u(x), t,
    x, eta=0) - x_prev_gt| with eps_u the uncond UNet output at x [B, H, W, C].
    Each image's loss sees its own row only, so the batch's summed loss gives
    every image its own gradient."""
    with torch.enable_grad():
        x_in = x.detach().requires_grad_(True)
        eps_u = unet(x_in, t, uncond_ctx).float()
        x_pred = schedule.reverse_step(eps_u, t, x_in, eta=0.0)
        loss = (x_pred - x_prev_gt).abs().mean(dim=(1, 2, 3)).sum()
        grad, = torch.autograd.grad(loss, x_in)
    return grad, eps_u.detach()


@torch.no_grad()
def nmg_p2p(unet, schedule: Schedule, *, xts: torch.Tensor, ctx3: torch.Tensor, cfg_tar: float,
            control: P2PControl, local_blend: LocalBlendState, after_skip_steps: int,
            guidance_noise_map: float = 10.0, grad_scale: float = 5e3
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edit B images at once.

    xts: [B, S+1, H, W, C] DDIM-inversion trajectories (NHWC, xts[:, 0] the
    source latents, xts[:, S] the start), S = after_skip_steps.  ctx3:
    [B, 3, 77, D] rows [uncond, src, tar].  control / local_blend: per-image
    state with B images.  Returns (x_edit, x_orig) [B, H, W, C] in float32."""
    S = after_skip_steps
    B = xts.shape[0]
    if xts.shape[1] != S + 1 or ctx3.shape[:2] != (B, 3):
        raise ValueError(f"xts {tuple(xts.shape)} / ctx3 {tuple(ctx3.shape)} do not "
                         f"match {B} images and {S} steps")
    if control.num_images != B or local_blend.store_sum.shape[0] != B:
        raise ValueError(f"control / local_blend must hold {B} images")
    xts = xts.float()
    uncond = ctx3[:, 0]
    ctx4 = ctx3[:, [0, 0, 1, 2]].reshape(4 * B, *ctx3.shape[2:])
    ts = schedule.timesteps[-S:].tolist()
    lb = local_blend
    x_orig = x_edit = xts[:, S]
    for i, t in enumerate(ts):
        grad, eps_u = nmg_gradient(unet, schedule, x_orig, t, uncond, xts[:, S - 1 - i])
        eps_cond = eps_u - torch.sqrt(1.0 - schedule.abar(t)) * (-grad) * grad_scale
        eps_nmg = eps_u + guidance_noise_map * (eps_cond - eps_u)
        x_orig = schedule.reverse_step(eps_nmg, t, x_orig, eta=0.0)

        ctrl = dataclasses.replace(control, step=i, cond_start=2)
        xin4 = torch.stack([x_orig, x_edit, x_orig, x_edit], dim=1)
        store: Dict[str, torch.Tensor] = {}
        eps4 = unet(xin4.reshape(4 * B, *xin4.shape[2:]), t, ctx4, ctrl, store)
        eps4 = eps4.float().reshape(B, 4, *eps4.shape[1:])
        lb = accumulate_store(lb, store)
        # the target scale on BOTH rows (the reference's quirk, kept)
        eps_src = eps4[:, 0] + cfg_tar * (eps4[:, 2] - eps4[:, 0])
        eps_tar = eps4[:, 1] + cfg_tar * (eps4[:, 3] - eps4[:, 1])
        pair = torch.stack([schedule.reverse_step(eps_src, t, x_orig, eta=0.0),
                            schedule.reverse_step(eps_tar, t, x_edit, eta=0.0)], dim=1)
        pair = apply_local_blend(lb, pair, i)
        x_orig, x_edit = pair[:, 0], pair[:, 1]
    return x_edit, x_orig
