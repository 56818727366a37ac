"""h-Edit with MasaCtrl control, implicit form, batched over images (port of
``hedit_tpu/edit/h_edit_ctrl.py:h_edit_masactrl``).

Semantics of the reference's ``inversion/masactrl_h_edit.py:14-155``.  Per
step, for B images:

1. base pass, controller off: the CFG source eps at cfg_src (the uncond rows
   are skipped at cfg_src == 1, where u + 1.0 * (c - u) == c) and
   reverse_step with the inversion residual z.  With a stored trajectory
   ``xts`` the source branch is indexed from it and the pass covers x_edit
   alone (1 row an image, 2 at cfg_src != 1); without, it covers
   [x_orig, x_edit] (2 rows, 4 at cfg_src != 1).
2. for each of ``optimization_steps``: one uncontrolled 1-row call,
   cond_out_src = eps(x_opt, tt, src), and the MasaCtrl call of 4 rows,
   [x_prev_orig, x_opt, x_prev_orig, x_opt] under [uncond, uncond, src, tar]:
   MasaCtrl reads both CFG halves' source rows, so both uncond rows are
   needed.  eps_src_edit is built against the TARGET's uncond row (row 1),
   and x_opt += coeff * (eps_tar - eps_src_edit).

The MasaCtrl source-prompt convention (an empty source prompt) is the
caller's: ctx3's src rows are what the caller encoded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hedit_tpu_torch.control.masactrl import MasaCtrlControl
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit.h_edit import (
    HEditConfig, _check_batch, cfg_pair, make_step_grid, traj_inputs,
)
from hedit_tpu_torch.edit.h_edit_p2p import rows


@torch.no_grad()
def h_edit_masactrl(unet, schedule: Schedule, xT: torch.Tensor, zs: torch.Tensor, *,
                    ctx3: torch.Tensor, cfg: HEditConfig, after_skip_steps: int,
                    start_step: int = 4, start_layer: int = 10,
                    xts: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """h-Edit + MasaCtrl for B images.

    xT [B, H, W, C] (NHWC); zs [B, S, H, W, C]; ctx3 [B, 3, 77, D] rows
    [uncond, src, tar]; xts: optional stored inversion trajectories
    [B, N+1, H, W, C] with xts[:, N] == xT.  Returns (edited, source branch)
    [B, H, W, C] in float32."""
    N = after_skip_steps
    if zs is None:
        raise ValueError("h_edit_masactrl needs the inversion's residuals zs")
    B = _check_batch(xT, zs, ctx3, N)
    grid = make_step_grid(schedule, zs, N)
    traj = traj_inputs(xts, N)
    ddim = cfg.is_ddim_inversion
    unc, src, tar = ctx3[:, 0], ctx3[:, 1], ctx3[:, 2]
    ctx_edit = rows(unc, unc, src, tar)

    def base_eps(x, t):
        """The CFG source eps at cfg_src, controller off; x [n, B, ...] holds n
        latents an image."""
        n = x.shape[0]
        xin = rows(*x)
        if cfg.cfg_src == 1.0:
            eps = unet(xin, t, rows(*[src] * n)).float()
        else:
            eps = unet(torch.cat([xin, xin]), t,
                       torch.cat([rows(*[unc] * n), rows(*[src] * n)])).float()
            e_u, e_c = eps.chunk(2)
            eps = cfg_pair(e_u, e_c, cfg.cfg_src)
        return eps.reshape(B, n, *eps.shape[1:]).transpose(0, 1)

    def step(x, eps, t, z):
        return schedule.reverse_step(eps, t, x, eta=cfg.eta, variance_noise=z,
                                     is_ddim_inversion=ddim)

    x_orig = x_edit = xT.float()
    for i, (t, tt) in enumerate(zip(grid.ts, grid.tts)):
        z = grid.zs[:, i]
        if traj is not None:
            # source branch = the stored inversion trajectory
            x_prev_orig = traj[1][:, i]
            eps_src_base, = base_eps(x_edit[None], t)
            x_prev_base = step(x_edit, eps_src_base, t, z)
        else:
            eps_o, eps_e = base_eps(torch.stack([x_orig, x_edit]), t)
            x_prev_orig, x_prev_base = step(x_orig, eps_o, t, z), step(x_edit, eps_e, t, z)

        coeff = schedule.h_edit_coeff(t, tt, cfg.eta, is_ddim_inversion=ddim)
        ctrl = MasaCtrlControl(step=i, start_step=start_step, start_layer=start_layer,
                               num_images=B)
        x_opt = x_prev_base
        for _ in range(cfg.optimization_steps):
            cond_out_src = unet(x_opt, tt, src).float()
            eps_c = unet(rows(x_prev_orig, x_opt, x_prev_orig, x_opt), tt, ctx_edit, ctrl).float()
            eps_c = eps_c.reshape(B, 4, *eps_c.shape[1:])
            uncond_out_tar, cond_out_tar = eps_c[:, 1], eps_c[:, 3]
            eps_src_edit = cfg_pair(uncond_out_tar, cond_out_src, cfg.cfg_src_edit)
            eps_tar = cfg_pair(uncond_out_tar, cond_out_tar, cfg.cfg_tar)
            x_opt = x_opt + coeff * (eps_tar - eps_src_edit)
        x_orig, x_edit = x_prev_orig, x_opt
    return x_edit, x_orig
