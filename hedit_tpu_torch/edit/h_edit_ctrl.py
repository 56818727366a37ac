"""h-Edit with MasaCtrl or PnP control, implicit form, batched over images
(port of ``hedit_tpu/edit/h_edit_ctrl.py``: ``h_edit_masactrl`` and
``h_edit_pnp``).

Both loops share the base pass (``_base_pass``): per step, for B images, the
CFG source eps at cfg_src with the controller off (the uncond rows are
skipped at cfg_src == 1, where u + 1.0 * (c - u) == c) and reverse_step with
the inversion residual z.  With a stored trajectory ``xts`` the source branch
is indexed from it and the pass covers x_edit alone (1 row an image, 2 at
cfg_src != 1); without, it covers [x_orig, x_edit] (2 rows, 4 at
cfg_src != 1).  Then, for each of ``optimization_steps``, the correction
x_opt += coeff * (eps_tar - eps_src_edit), eps_src_edit built against the
TARGET's uncond eps:

* MasaCtrl (the reference's ``inversion/masactrl_h_edit.py:14-155``): one
  uncontrolled 1-row call, cond_out_src = eps(x_opt, tt, src), and the
  MasaCtrl call of 4 rows, [x_prev_orig, x_opt, x_prev_orig, x_opt] under
  [uncond, uncond, src, tar]: MasaCtrl reads both CFG halves' source rows,
  so both uncond rows are needed.  The MasaCtrl source-prompt convention (an
  empty source prompt) is the caller's: ctx3's src rows are what the caller
  encoded.
* PnP (the reference's ``inversion/pnp_h_edit.py:33-167``): the two
  uncontrolled evaluations at x_opt, cond_out_src = eps(x_opt, tt, src) and
  uncond_out_tar = eps(x_opt, tt, uncond), as ONE call of 2 rows an image
  (the JAX package makes two 1-row calls of the same function), then the PnP
  pair call [x_prev_orig, x_opt] under [src, tar]: 3 UNet calls a step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from hedit_tpu_torch.control.masactrl import MasaCtrlControl
from hedit_tpu_torch.control.pnp import PnPControl
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit.h_edit import (
    HEditConfig, _check_batch, cfg_pair, make_step_grid, traj_inputs,
)
from hedit_tpu_torch.edit.h_edit_p2p import rows


def _base_pass(unet, schedule: Schedule, cfg: HEditConfig, ctx3: torch.Tensor,
               traj: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    """The base pass of a step, controller off, as ``fn(i, t, z, x_orig,
    x_edit) -> (x_prev_orig, x_prev_base)``: with ``traj`` (``traj_inputs``)
    x_prev_orig is the stored trajectory's and only x_edit is stepped."""
    B = ctx3.shape[0]
    unc, src = ctx3[:, 0], ctx3[:, 1]

    def base_eps(x, t):
        """The CFG source eps at cfg_src; x [n, B, ...] holds n latents an image."""
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
                                     is_ddim_inversion=cfg.is_ddim_inversion)

    def run(i, t, z, x_orig, x_edit):
        if traj is not None:
            eps_src_base, = base_eps(x_edit[None], t)
            return traj[1][:, i], step(x_edit, eps_src_base, t, z)
        eps_o, eps_e = base_eps(torch.stack([x_orig, x_edit]), t)
        return step(x_orig, eps_o, t, z), step(x_edit, eps_e, t, z)

    return run


def _check_inputs(xT, zs, ctx3, N: int, what: str) -> int:
    if zs is None:
        raise ValueError(f"{what} needs the inversion's residuals zs")
    return _check_batch(xT, zs, ctx3, N)


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
    B = _check_inputs(xT, zs, ctx3, N, "h_edit_masactrl")
    grid = make_step_grid(schedule, zs, N)
    base = _base_pass(unet, schedule, cfg, ctx3, traj_inputs(xts, N))
    ddim = cfg.is_ddim_inversion
    unc, src, tar = ctx3[:, 0], ctx3[:, 1], ctx3[:, 2]
    ctx_edit = rows(unc, unc, src, tar)

    x_orig = x_edit = xT.float()
    for i, (t, tt) in enumerate(zip(grid.ts, grid.tts)):
        x_prev_orig, x_prev_base = base(i, t, grid.zs[:, i], x_orig, x_edit)
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


@torch.no_grad()
def h_edit_pnp(unet, schedule: Schedule, xT: torch.Tensor, zs: torch.Tensor, *,
               ctx3: torch.Tensor, cfg: HEditConfig, after_skip_steps: int,
               qk_mask: Sequence[bool], conv_mask: Sequence[bool],
               xts: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """h-Edit + PnP for B images; arguments as ``h_edit_masactrl``, with the
    step gates of ``pnp_step_gates`` ([N] bools each) in place of MasaCtrl's
    start step and layer.

    The reference gates injection on the time the UNet is called at: the
    correction's pair call runs at tt = timesteps[i+1], so step i's gates are
    mask[i+1] and the last step's (tt = 0) are off.  The baseline loops'
    pair calls run at t and keep the unshifted masks."""
    N = after_skip_steps
    B = _check_inputs(xT, zs, ctx3, N, "h_edit_pnp")
    if len(qk_mask) != N or len(conv_mask) != N:
        raise ValueError(f"the gates must hold {N} steps (got {len(qk_mask)} and "
                         f"{len(conv_mask)})")
    qk_gates = [bool(g) for g in qk_mask[1:]] + [False]
    conv_gates = [bool(g) for g in conv_mask[1:]] + [False]
    grid = make_step_grid(schedule, zs, N)
    base = _base_pass(unet, schedule, cfg, ctx3, traj_inputs(xts, N))
    ddim = cfg.is_ddim_inversion
    unc, src, tar = ctx3[:, 0], ctx3[:, 1], ctx3[:, 2]
    ctx_plain, ctx_pair = rows(src, unc), rows(src, tar)

    x_orig = x_edit = xT.float()
    for i, (t, tt) in enumerate(zip(grid.ts, grid.tts)):
        x_prev_orig, x_prev_base = base(i, t, grid.zs[:, i], x_orig, x_edit)
        coeff = schedule.h_edit_coeff(t, tt, cfg.eta, is_ddim_inversion=ddim)
        ctrl = PnPControl(qk_on=qk_gates[i], conv_on=conv_gates[i], num_images=B)
        x_opt = x_prev_base
        for _ in range(cfg.optimization_steps):
            # the two uncontrolled evaluations at x_opt in one call
            plain = unet(rows(x_opt, x_opt), tt, ctx_plain).float()
            plain = plain.reshape(B, 2, *plain.shape[1:])
            cond_out_src, uncond_out_tar = plain[:, 0], plain[:, 1]
            eps_c = unet(rows(x_prev_orig, x_opt), tt, ctx_pair, ctrl).float()
            cond_out_tar = eps_c.reshape(B, 2, *eps_c.shape[1:])[:, 1]
            eps_src_edit = cfg_pair(uncond_out_tar, cond_out_src, cfg.cfg_src_edit)
            eps_tar = cfg_pair(uncond_out_tar, cond_out_tar, cfg.cfg_tar)
            x_opt = x_opt + coeff * (eps_tar - eps_src_edit)
        x_orig, x_edit = x_prev_orig, x_opt
    return x_edit, x_orig
