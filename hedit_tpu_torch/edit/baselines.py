"""Baseline editing methods with P2P, batched over images: EF / PnP-Inv pair
sampling and Noise Map Guidance (port of ``hedit_tpu/edit/baselines.py``).

``ef_or_pnp_inv_p2p``: the reference's ``inversion/p2p_baselines.py:102-188``.
Per step one controlled call of 4 rows an image, [x_orig, x_edit, x_orig,
x_edit] under [uncond, uncond, src, tar] with cond_start = 2: both uncond
rows are consumed (a CFG combination for each branch).  The source branch
steps with eta; the edited branch with eta = 0 for PnP-Inv
(``is_ddim_inversion``) and with eta otherwise (:176-181).  With a stored
trajectory ``xts`` the source branch is indexed and the call drops to 3 rows,
[x_edit, x_orig, x_edit] under [uncond, src, tar] with cond_start = 1.

``nmg_p2p``: the reference's ``inversion/p2p_baselines.py:195-293``.  eta = 0
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

The EF baseline without control is ``edit/h_edit.py:ef_sample``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from hedit_tpu_torch.control.p2p import (
    LocalBlendState, P2PControl, accumulate_store, apply_local_blend,
)
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit.h_edit import _check_batch, cfg_pair, make_step_grid, traj_inputs
from hedit_tpu_torch.edit.h_edit_p2p import rows


def _with_step(control, i: int, **kw):
    """dataclasses.replace(control, step=i, **kw) keeping only the fields the
    control has, so the pair baselines drive P2P and MasaCtrl (whose only
    per-step field is ``step``) through one path."""
    fields = {f.name for f in dataclasses.fields(control)}
    return dataclasses.replace(
        control, **{k: v for k, v in dict(step=i, **kw).items() if k in fields})


@torch.no_grad()
def ef_or_pnp_inv_p2p(unet, schedule: Schedule, xT: torch.Tensor, zs: Optional[torch.Tensor], *,
                      ctx3: torch.Tensor, cfg_src: float, cfg_tar: float, eta: float = 1.0,
                      is_ddim_inversion: bool = False, after_skip_steps: int, control,
                      local_blend: Optional[LocalBlendState] = None,
                      xts: Optional[torch.Tensor] = None, derive_zs: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EF + P2P, or PnP-Inv + P2P with ``is_ddim_inversion``, for B images;
    with a ``MasaCtrlControl`` (``num_images`` B) the modes ``ef_masactrl``
    and ``pnp_inv_masactrl``.

    xT [B, H, W, C] (NHWC); zs [B, S, H, W, C] or None with ``derive_zs``; ctx3
    [B, 3, 77, D] rows [uncond, src, tar]; control / local_blend: per-image
    state with B images (no blend when None).

    xts: optional stored inversion trajectories [B, N+1, H, W, C] with
    xts[:, N] == xT.  The source branch is then indexed (the reconstruction
    identity of ``h_edit_p2p``) and the call drops from 4 to 3 rows an image:
    the controller-base row stays (P2P reads its attention, LocalBlend stores
    its maps), the two rows that only fed the source branch's CFG step go.
    Exact for P2P only: a control that consumes the uncond source row must not
    be given xts.

    derive_zs (needs xts): the controller-base row's output is
    eps(xts[t], t, src), which P2P leaves untouched: this step's inversion
    evaluation.  The residual z is rebuilt from it and the inversion's residual
    pass is not needed (zs=None).  The inversion took its residuals from CFG
    source noise and this row is pure cond(src), so the two agree only at
    cfg_src == 1; after a DDIM inversion the edit branch is an eta = 0 step
    that reads no z."""
    N = after_skip_steps
    B = _check_batch(xT, zs, ctx3, N)
    traj = traj_inputs(xts, N)
    if traj is not None and not hasattr(control, "edit_pair"):
        raise ValueError("indexed-source fast path (xts) is only exact for P2P: MasaCtrl "
                         "consumes the uncond source row, so it takes the 4-row pair step "
                         "(give no xts)")
    if derive_zs and not (traj is not None and (is_ddim_inversion
                                                or (eta > 0 and cfg_src == 1.0))):
        raise ValueError("derive_zs needs xts and, for DDPM, eta > 0 and cfg_src == 1.0")
    if zs is None and not derive_zs:
        raise ValueError("no residuals: give zs or derive them in the loop (derive_zs)")
    if control.num_images != B or (local_blend is not None
                                   and local_blend.store_sum.shape[0] != B):
        raise ValueError(f"control / local_blend must hold {B} images")
    grid = make_step_grid(schedule, zs, N)
    unc, src, tar = ctx3[:, 0], ctx3[:, 1], ctx3[:, 2]
    ctx = rows(unc, src, tar) if traj is not None else rows(unc, unc, src, tar)
    lb = local_blend
    x_orig = x_edit = xT.float()
    for i, t in enumerate(grid.ts):
        z = None if grid.zs is None else grid.zs[:, i]
        store: Dict[str, torch.Tensor] = {}
        if traj is not None:
            x_orig, x_prev_orig = traj[0][:, i], traj[1][:, i]
            ctrl = _with_step(control, i, save_attn=True, cond_start=1)
            eps3 = unet(rows(x_edit, x_orig, x_edit), t, ctx, ctrl, store).float()
            eps3 = eps3.reshape(B, 3, *eps3.shape[1:])
            eps_tar = cfg_pair(eps3[:, 0], eps3[:, 2], cfg_tar)
            if derive_zs and eta > 0:
                # both denominators scale with eta; at eta == 0 the edit step
                # below reads no z, so nothing is divided
                mu = schedule.reverse_step(eps3[:, 1], t, x_orig, eta=eta,
                                           is_ddim_inversion=is_ddim_inversion)
                denom = eta if is_ddim_inversion else eta * torch.sqrt(schedule.variance(t))
                z = (x_prev_orig - mu) / denom
        else:
            ctrl = _with_step(control, i, save_attn=True, cond_start=2)
            eps4 = unet(rows(x_orig, x_edit, x_orig, x_edit), t, ctx, ctrl, store).float()
            eps4 = eps4.reshape(B, 4, *eps4.shape[1:])
            eps_src = cfg_pair(eps4[:, 0], eps4[:, 2], cfg_src)
            eps_tar = cfg_pair(eps4[:, 1], eps4[:, 3], cfg_tar)
            x_prev_orig = schedule.reverse_step(eps_src, t, x_orig, eta=eta, variance_noise=z,
                                                is_ddim_inversion=is_ddim_inversion)
        if is_ddim_inversion:
            # PnP-Inv's edited branch: a pure DDIM step, eta = 0 (:176-178)
            x_prev_edit = schedule.reverse_step(eps_tar, t, x_edit, eta=0.0)
        else:
            x_prev_edit = schedule.reverse_step(eps_tar, t, x_edit, eta=eta, variance_noise=z)
        x_orig, x_edit = x_prev_orig, x_prev_edit
        if lb is not None:
            lb = accumulate_store(lb, store)
            pair = apply_local_blend(lb, torch.stack([x_orig, x_edit], dim=1), i)
            x_orig, x_edit = pair[:, 0], pair[:, 1]
    return x_edit, x_orig


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
