"""h-Edit-D / h-Edit-R with Prompt-to-Prompt control, batched over images
(port of ``hedit_tpu/edit/h_edit_p2p.py`` and, under the flagship
configuration, of ``hedit_tpu/parallel/sweep.py:make_flagship_runner``).

Semantics of the reference's ``inversion/p2p_h_edit.py``:
``h_Edit_p2p_explicit`` (:380-523) and ``h_Edit_p2p_implicit`` (:529-701).
Per step, for B images:

1. base pass, controller off: the CFG source eps at cfg_src (the uncond rows
   are skipped at cfg_src == 1, where u + 1.0 * (c - u) == c) and
   reverse_step with the inversion residual z.  Without a stored trajectory
   it covers both branches, [x_orig, x_edit] an image; with ``xts`` the source
   branch is indexed from the trajectory (reverse_step on xts[t] with the
   inversion residual reproduces xts[t-1]) and the pass covers x_edit alone.
   With ``derive_zs`` the residual is rebuilt in the loop from the previous
   step's controller-source eps (step 0: the base eps, since x_edit ==
   x_orig == x_T there), and the inversion needs no UNet pass.
2. explicit: one controlled call at (x_t, t); implicit: for each of K
   optimisation steps one controlled call at (x_{t-1}, tt).  A controlled
   call holds 4 rows an image, [x_opt, x_opt, x_base, x_opt] under [uncond,
   src, src, tar] with cond_start = 2; its row 2 (src at the base latent,
   untouched by P2P, which writes the target row only) is the
   controller-source eps.  CFG combinations against the uncond row,
   x_opt = rec_term + coeff * (eps_tar - eps_src_edit), with the
   L1-reconstruction pull in rec_term for k > 0 (:670-686).  Only the last
   optimisation step stores attention (:636-640).
3. LocalBlend on [x_{t-1}^orig, x_{t-1}^edit] (:698-699).

The flagship configuration (implicit, cfg_src == 1, one optimisation step,
eta > 0, ``xts`` and ``derive_zs``) is this loop with one base call of B rows
and one controlled call of 4B rows a step: ``h_edit_p2p_flagship``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from hedit_tpu_torch.control.p2p import (
    LocalBlendState, P2PControl, accumulate_store, apply_local_blend,
)
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit.h_edit import (
    HEditConfig, _check_batch, cfg_pair, make_step_grid, reconstruction_pull, traj_inputs,
)


def rows(*per_image: torch.Tensor) -> torch.Tensor:
    """Rows of one UNet call grouped by image: tensors [B, ...] -> [len * B, ...]
    with image b's rows at b * len .. (b + 1) * len."""
    stacked = torch.stack(per_image, dim=1)
    return stacked.reshape(-1, *stacked.shape[2:])


@torch.no_grad()
def h_edit_p2p(unet, schedule: Schedule, xT: torch.Tensor, zs: Optional[torch.Tensor], *,
               ctx3: torch.Tensor, cfg: HEditConfig, after_skip_steps: int,
               control: P2PControl, local_blend: Optional[LocalBlendState] = None,
               xts: Optional[torch.Tensor] = None, derive_zs: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h-Edit + P2P, explicit or implicit by cfg.implicit, for B images.

    xT [B, H, W, C] (NHWC); zs [B, S, H, W, C] or None with ``derive_zs``;
    ctx3 [B, 3, 77, D] rows [uncond, src, tar]; control / local_blend: per-image
    state with B images (no blend when None); xts: optional stored inversion
    trajectories [B, N+1, H, W, C] with xts[:, N] == xT.  derive_zs needs xts,
    implicit, cfg_src == 1 and eta > 0.  Returns (edited, reconstructed)
    [B, H, W, C] in float32."""
    N = after_skip_steps
    B = _check_batch(xT, zs, ctx3, N)
    if control.num_images != B or (local_blend is not None
                                   and local_blend.store_sum.shape[0] != B):
        raise ValueError(f"control / local_blend must hold {B} images")
    if derive_zs and not (xts is not None and cfg.implicit and cfg.cfg_src == 1.0
                          and cfg.eta > 0):
        raise ValueError("derive_zs needs xts + implicit + cfg_src == 1.0 + eta > 0")
    if zs is None and not derive_zs:
        raise ValueError("no residuals: give zs or derive them in the loop (derive_zs)")
    grid = make_step_grid(schedule, zs, N)
    traj = traj_inputs(xts, N)
    ddim = cfg.is_ddim_inversion
    lb = local_blend

    unc, src, tar = ctx3[:, 0], ctx3[:, 1], ctx3[:, 2]
    ctx4c = rows(unc, src, src, tar)

    def base_eps(x, t):
        """The CFG source eps at cfg_src, controller off; x [n, B, ...] holds n
        latents an image."""
        n = x.shape[0]
        xin = rows(*x)
        if cfg.cfg_src == 1.0:
            eps = unet(xin, t, rows(*[src] * n)).float()
            return eps.reshape(B, n, *eps.shape[1:]).transpose(0, 1)
        eps = unet(torch.cat([xin, xin]), t, torch.cat([rows(*[unc] * n), rows(*[src] * n)]))
        e_u, e_c = eps.float().chunk(2)
        eps = cfg_pair(e_u, e_c, cfg.cfg_src)
        return eps.reshape(B, n, *eps.shape[1:]).transpose(0, 1)

    def controlled_call(i, x_base, x_opt, t_eval, save: bool):
        """-> (uncond_out_tar, cond_out_src, cond_out_tar, cond_src_at_base, store)"""
        ctrl = dataclasses.replace(control, step=i, save_attn=save, cond_start=2)
        store: Dict[str, torch.Tensor] = {}
        eps4 = unet(rows(x_opt, x_opt, x_base, x_opt), t_eval, ctx4c, ctrl, store).float()
        eps4 = eps4.reshape(B, 4, *eps4.shape[1:])
        return eps4[:, 0], eps4[:, 1], eps4[:, 3], eps4[:, 2], store

    def step(x, eps, t, z):
        return schedule.reverse_step(eps, t, x, eta=cfg.eta, variance_noise=z,
                                     is_ddim_inversion=ddim)

    x_orig = x_edit = xT.float()
    eps_orig = None   # the controller-source eps of the previous step, float32
    for i, (t, tt) in enumerate(zip(grid.ts, grid.tts)):
        z = None if grid.zs is None else grid.zs[:, i]
        # ---- 1. base: x_{t-1}^orig and x_{t-1}^base (controller off) ---------- #
        if traj is not None:
            x_orig, x_prev_orig = traj[0][:, i], traj[1][:, i]
            eps_src_base, = base_eps(x_edit[None], t)
            if derive_zs:
                if i == 0:
                    eps_orig = eps_src_base
                mu = schedule.reverse_step(eps_orig, t, x_orig, eta=cfg.eta,
                                           is_ddim_inversion=ddim)
                denom = cfg.eta if ddim else cfg.eta * torch.sqrt(schedule.variance(t))
                z = (x_prev_orig - mu) / denom
            x_prev_base = step(x_edit, eps_src_base, t, z)
        else:
            eps_o, eps_e = base_eps(torch.stack([x_orig, x_edit]), t)
            x_prev_orig, x_prev_base = step(x_orig, eps_o, t, z), step(x_edit, eps_e, t, z)

        coeff = schedule.h_edit_coeff(t, tt, cfg.eta, is_ddim_inversion=ddim)
        if not cfg.implicit:
            # ---- explicit (:475-514): the correction at (x_t, t) -------------- #
            u_tar, c_src, c_tar, _, store = controlled_call(i, x_orig, x_edit, t, True)
            x_opt = x_prev_base + coeff * (cfg_pair(u_tar, c_tar, cfg.cfg_tar)
                                           - cfg_pair(u_tar, c_src, cfg.cfg_src_edit))
        else:
            # ---- implicit (:631-692): optimise x_{t-1} at tt ------------------ #
            x_opt = x_prev_base
            K = cfg.optimization_steps
            for k in range(K):
                u_tar, c_src, c_tar, eps_orig, store = controlled_call(
                    i, x_prev_orig, x_opt, tt, k == K - 1)
                correction = (cfg_pair(u_tar, c_tar, cfg.cfg_tar)
                              - cfg_pair(u_tar, c_src, cfg.cfg_src_edit))
                rec_term = x_opt if k == 0 else reconstruction_pull(
                    x_opt, x_prev_base, correction, cfg.weight_reconstruction)
                x_opt = rec_term + coeff * correction
        # ---- 3. LocalBlend (:698-699) ----------------------------------------- #
        x_orig, x_edit = x_prev_orig, x_opt
        if lb is not None:
            lb = accumulate_store(lb, store)
            pair = apply_local_blend(lb, torch.stack([x_orig, x_edit], dim=1), i)
            x_orig, x_edit = pair[:, 0], pair[:, 1]
    return x_edit, x_orig


def h_edit_p2p_flagship(unet, schedule: Schedule, cfg: HEditConfig, *, xts: torch.Tensor,
                        ctx4: torch.Tensor, control: P2PControl,
                        local_blend: LocalBlendState, after_skip_steps: int) -> torch.Tensor:
    """The flagship h-Edit-R + P2P implicit edit of B images: ``h_edit_p2p`` with
    the source branch indexed from ``xts`` and the residuals derived in the loop.

    xts: [B, S+1, H, W, C] q-sampled trajectories (NHWC, xts[:, 0] the source
    latents), S = after_skip_steps.  ctx4: [B, 4, 77, D] rows [uncond, src,
    src, tar].  cfg must be the flagship configuration (implicit, cfg_src == 1,
    eta > 0, DDPM).  Returns the edited latents [B, H, W, C] in float32."""
    if cfg.eta <= 0 or cfg.is_ddim_inversion:
        raise ValueError(f"h-Edit-R needs eta > 0 (DDPM), got {cfg.eta}")
    S = after_skip_steps
    if xts.shape[1] != S + 1 or ctx4.shape[:2] != (xts.shape[0], 4):
        raise ValueError(f"xts {tuple(xts.shape)} / ctx4 {tuple(ctx4.shape)} do not "
                         f"match {xts.shape[0]} images and {S} steps")
    return h_edit_p2p(unet, schedule, xts[:, S], None, ctx3=ctx4[:, [0, 1, 3]], cfg=cfg,
                      after_skip_steps=S, control=control, local_blend=local_blend,
                      xts=xts, derive_zs=True)[0]
