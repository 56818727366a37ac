"""Baseline editing methods under Plug-and-Play injection, batched over
images (port of ``hedit_tpu/edit/pnp_baselines.py``).

Semantics of the reference's ``inversion/pnp_baselines.py``.  Each step's
pair call holds 2 rows an image, [x_orig, x_edit] under [src, tar], with the
step's ``PnPControl``: the source row's q / k and conv features go into the
target row.  The unconditional evaluations are injection-free (in the
reference PnP fires only at batch size 2), and the rows that need them go as
one uncontrolled call.  ctx3 [B, 3, 77, D] holds [uncond, src, tar] an image;
latents are NHWC [B, H, W, C]; the gates are ``pnp_step_gates``'s, unshifted
(the pair calls run at t).

* ``ef_or_pnp_inv_w_pnp`` (:317-392): EF + PnP, or PnP-Inv + PnP after a
  DDIM inversion, whose edit step is eta = 0.  With a stored trajectory the
  source branch is indexed and its uncond row goes: 3 rows an image a step.
* ``nmg_pnp_loop`` (:32-126): the NMG gradient step on the reconstruction
  branch (``nmg_gradient``, the gradient through the UNet), then the PnP pair
  step, eta = 0, the target cfg scale on both rows.
* ``null_text_pnp`` (:130-238): a step's Adam loop (``null_text_adam``, up to
  10 iterations, each a one-row UNet forward and backward with respect to the
  uncond embedding) pulls the source branch's CFG step onto the stored
  x_{t-1}^orig, then the pair step with the optimised embedding as uncond.
* ``negative_prompt_pnp`` (:244-309): the pair step with the source prompt as
  the "uncond" context.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from hedit_tpu_torch.control.pnp import PnPControl
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit.baselines import nmg_gradient
from hedit_tpu_torch.edit.h_edit import _check_batch, cfg_pair, make_step_grid, traj_inputs
from hedit_tpu_torch.edit.h_edit_p2p import rows


def _gates(qk_mask: Sequence[bool], conv_mask: Sequence[bool], N: int):
    if len(qk_mask) != N or len(conv_mask) != N:
        raise ValueError(f"the gates must hold {N} steps (got {len(qk_mask)} and "
                         f"{len(conv_mask)})")
    return [bool(g) for g in qk_mask], [bool(g) for g in conv_mask]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in float32, or in float64 where it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _pairs(eps: torch.Tensor) -> torch.Tensor:
    """[2B, ...] UNet output -> [B, 2, ...] in float32 (float64 kept)"""
    return _wide(eps).reshape(-1, 2, *eps.shape[1:])


def _pnp_pair_eps(unet, x_orig, x_edit, t, ctx3, cfg_tar: float, qk_on: bool, conv_on: bool,
                  uncond: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eps_src, eps_tar) [B, ...]: the conditional pair under PnP, and both
    rows' unconditional eps from one injection-free call with ``uncond``
    (default ctx3's uncond rows); the target cfg scale on both rows."""
    B = x_orig.shape[0]
    ctrl = PnPControl(qk_on=qk_on, conv_on=conv_on, num_images=B)
    pair = rows(x_orig, x_edit)
    cond = _pairs(unet(pair, t, rows(ctx3[:, 1], ctx3[:, 2]), ctrl))
    u = ctx3[:, 0] if uncond is None else uncond
    unc = _pairs(unet(pair, t, rows(u, u)))
    return cfg_pair(unc[:, 0], cond[:, 0], cfg_tar), cfg_pair(unc[:, 1], cond[:, 1], cfg_tar)


@torch.no_grad()
def ef_or_pnp_inv_w_pnp(unet, schedule: Schedule, xT: torch.Tensor, zs: Optional[torch.Tensor],
                        *, ctx3: torch.Tensor, cfg_src: float, cfg_tar: float, eta: float,
                        is_ddim_inversion: bool, after_skip_steps: int,
                        qk_mask: Sequence[bool], conv_mask: Sequence[bool],
                        xts: Optional[torch.Tensor] = None, derive_zs: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EF + PnP, or PnP-Inv + PnP with ``is_ddim_inversion``, for B images.

    xT [B, H, W, C]; zs [B, S, H, W, C] or None with ``derive_zs``.  xts:
    optional stored inversion trajectories [B, N+1, H, W, C] with
    xts[:, N] == xT: the source branch is then indexed, the pair's source row
    stays (PnP injects from it) and its uncond row goes.

    derive_zs (needs xts): the pair's source row is plain eps(xts[t], t, src),
    since PnP writes only the target row, so the inversion's residual is
    rebuilt in the loop and the inversion's residual pass is not needed
    (zs=None).  The inversion took its residuals from CFG source noise, so the
    two agree only at cfg_src == 1; after a DDIM inversion the edit step is
    eta = 0 and reads no z.  Returns (edited, source branch) in float32."""
    N = after_skip_steps
    B = _check_batch(xT, zs, ctx3, N)
    traj = traj_inputs(xts, N)
    if derive_zs:
        if traj is None:
            raise ValueError("derive_zs requires the stored trajectory (xts)")
        if not (eta > 0 or is_ddim_inversion):
            raise ValueError("derive_zs needs eta > 0 (DDPM)")
        if not (cfg_src == 1.0 or is_ddim_inversion):
            raise ValueError("derive_zs (DDPM) requires cfg_src == 1.0")
    elif zs is None:
        raise ValueError("no residuals: give zs or derive them in the loop (derive_zs)")
    qk, conv = _gates(qk_mask, conv_mask, N)
    grid = make_step_grid(schedule, zs, N)
    unc, src, tar = ctx3[:, 0], ctx3[:, 1], ctx3[:, 2]
    x_orig = x_edit = xT.float()
    for i, t in enumerate(grid.ts):
        z = None if grid.zs is None else grid.zs[:, i]
        if traj is not None:
            x_orig = traj[0][:, i]
        ctrl = PnPControl(qk_on=qk[i], conv_on=conv[i], num_images=B)
        cond = _pairs(unet(rows(x_orig, x_edit), t, rows(src, tar), ctrl))
        if traj is not None:
            u_tar = unet(x_edit, t, unc).float()
            x_prev_orig = traj[1][:, i]
            if derive_zs and eta > 0:
                # both denominators scale with eta; at eta == 0 the edit step
                # below reads no z, so nothing is divided
                mu = schedule.reverse_step(cond[:, 0], t, x_orig, eta=eta,
                                           is_ddim_inversion=is_ddim_inversion)
                denom = eta if is_ddim_inversion else eta * torch.sqrt(schedule.variance(t))
                z = (x_prev_orig - mu) / denom
        else:
            u = _pairs(unet(rows(x_orig, x_edit), t, rows(unc, unc)))
            u_tar = u[:, 1]
            eps_src = cfg_pair(u[:, 0], cond[:, 0], cfg_src)
            x_prev_orig = schedule.reverse_step(eps_src, t, x_orig, eta=eta, variance_noise=z,
                                                is_ddim_inversion=is_ddim_inversion)
        eps_tar = cfg_pair(u_tar, cond[:, 1], cfg_tar)
        if is_ddim_inversion:
            x_prev_edit = schedule.reverse_step(eps_tar, t, x_edit, eta=0.0)
        else:
            x_prev_edit = schedule.reverse_step(eps_tar, t, x_edit, eta=eta, variance_noise=z)
        x_orig, x_edit = x_prev_orig, x_prev_edit
    return x_edit, x_orig


@torch.no_grad()
def nmg_pnp_loop(unet, schedule: Schedule, *, xts: torch.Tensor, ctx3: torch.Tensor,
                 cfg_tar: float, after_skip_steps: int, qk_mask: Sequence[bool],
                 conv_mask: Sequence[bool], guidance_noise_map: float = 10.0,
                 grad_scale: float = 5e3) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMG + PnP for B images, eta = 0 throughout.

    xts: [B, S+1, H, W, C] DDIM-inversion trajectories (xts[:, 0] the source
    latents, xts[:, S] the start), S = after_skip_steps; step i's guidance
    target is x_{t-1}^orig = xts[:, S-1-i].  Returns (x_edit, x_orig) in
    float32."""
    S = after_skip_steps
    B = xts.shape[0]
    if xts.shape[1] != S + 1 or ctx3.shape[:2] != (B, 3):
        raise ValueError(f"xts {tuple(xts.shape)} / ctx3 {tuple(ctx3.shape)} do not "
                         f"match {B} images and {S} steps")
    qk, conv = _gates(qk_mask, conv_mask, S)
    xts = xts.float()
    ts = schedule.timesteps[-S:].tolist()
    x_orig = x_edit = xts[:, S]
    for i, t in enumerate(ts):
        grad, eps_u = nmg_gradient(unet, schedule, x_orig, t, ctx3[:, 0], xts[:, S - 1 - i])
        eps_cond = eps_u - torch.sqrt(1.0 - schedule.abar(t)) * (-grad) * grad_scale
        eps_nmg = eps_u + guidance_noise_map * (eps_cond - eps_u)
        x_orig = schedule.reverse_step(eps_nmg, t, x_orig, eta=0.0)
        eps_src, eps_tar = _pnp_pair_eps(unet, x_orig, x_edit, t, ctx3, cfg_tar, qk[i], conv[i])
        x_orig, x_edit = (schedule.reverse_step(eps_src, t, x_orig, eta=0.0),
                          schedule.reverse_step(eps_tar, t, x_edit, eta=0.0))
    return x_edit, x_orig


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def null_text_adam(loss_grad, u0: torch.Tensor, *, optimization_steps: int, lr: torch.Tensor,
                   thresh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Null-text's Adam loop over B images' uncond embeddings u0 [B, 77, D],
    JAX's rule (``hedit_tpu/edit/pnp_baselines.py:195-227``): iteration j takes
    the loss and its gradient at u_j, applies the update (b1 0.9, b2 0.999,
    eps 1e-8, bias correction at j + 1), and only then stops if that loss was
    under ``thresh``: the stopping iteration's update lands.  Each image stops
    on its own loss; a stopped image keeps its u and Adam state and leaves the
    later iterations' calls, so an image's result does not depend on the batch
    it runs in.

    loss_grad(u, rows) -> (loss [n], d loss / d u [n, 77, D]) of the images
    ``rows`` (an index tensor) at their embeddings u.  lr, thresh: float32
    scalars, which JAX computes from the step index in float32.

    Dtypes are JAX's: u, m and v take u0's dtype (float32 under the CLIs'
    default, bfloat16 under ``--bf16``: the text model's output), and so do
    Adam's constants, which JAX takes as weak types, so m, v and their bias
    corrections are computed in u0's dtype.  ``lr * mhat / (sqrt(vhat) +
    eps)`` is float32 (or float64) as in JAX, whose float32 ``lr`` promotes
    it.  Under ``--bf16`` JAX's while_loop refuses that float32 update of its
    bfloat16 carry (a TypeError: the carry changes dtype); the port keeps the
    carry's dtype and rounds the updated u to bfloat16.

    Returns (u_opt, losses [optimization_steps, B]: each iteration's loss, NaN
    where the image had stopped)."""
    B = u0.shape[0]
    u = u0.clone()
    m, v = torch.zeros_like(u0), torch.zeros_like(u0)
    wide = torch.promote_types(u.dtype, torch.float32)
    c = lambda s: torch.tensor(s, dtype=u.dtype, device=u.device)  # noqa: E731
    losses = torch.full((optimization_steps, B), float("nan"), dtype=torch.float64)
    active = torch.arange(B, device=u.device)
    for j in range(optimization_steps):
        if active.numel() == 0:
            break
        loss, g = loss_grad(u[active], active)
        m_a = c(ADAM_B1) * m[active] + c(1 - ADAM_B1) * g
        v_a = c(ADAM_B2) * v[active] + c(1 - ADAM_B2) * g * g
        mhat = m_a / c(1 - ADAM_B1 ** (j + 1))
        vhat = v_a / c(1 - ADAM_B2 ** (j + 1))
        step = lr.to(wide) * mhat.to(wide) / (torch.sqrt(vhat) + c(ADAM_EPS)).to(wide)
        u[active] = (u[active].to(wide) - step).to(u.dtype)
        m[active], v[active] = m_a, v_a
        losses[j, active.cpu()] = loss.detach().double().cpu()
        active = active[~(loss < thresh)]
    return u, losses


def null_text_loss(unet, schedule: Schedule, x: torch.Tensor, t: int, cond_src: torch.Tensor,
                   target: torch.Tensor, cfg_tar: float):
    """``null_text_adam``'s loss_grad at step t: per image, mean((reverse_step(
    eps_u + cfg_tar (cond_src - eps_u), t, x, eta=0) - target)^2) with eps_u the
    UNet at x under the embedding u, and its gradient with respect to u, from
    one UNet forward and backward of the images' rows."""
    def loss_grad(u, rows):
        with torch.enable_grad():
            leaf = u.detach().requires_grad_(True)
            eps = cfg_pair(_wide(unet(x[rows], t, leaf)), cond_src[rows], cfg_tar)
            pred = schedule.reverse_step(eps, t, x[rows], eta=0.0)
            loss = ((pred - target[rows]) ** 2).mean(dim=(1, 2, 3))
            grad, = torch.autograd.grad(loss.sum(), leaf)
        return loss.detach(), grad
    return loss_grad


@torch.no_grad()
def null_text_pnp(unet, schedule: Schedule, xT: torch.Tensor, *, xts: torch.Tensor,
                  ctx3: torch.Tensor, cfg_tar: float, after_skip_steps: int,
                  qk_mask: Sequence[bool], conv_mask: Sequence[bool],
                  optimization_steps: int = 10, epsilon: float = 1e-5, lr_base: float = 1e-2
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Null-text + PnP for B images from xT [B, H, W, C] (a DDIM inversion's
    end), eta = 0 throughout.

    xts: [B, S+1, H, W, C] the inversion's trajectories, S = after_skip_steps;
    step i's target is x_{t-1}^orig = xts[:, S-1-i].  Step i: one uncontrolled
    1-row call cond_src = eps(x_orig, t, src); ``null_text_adam`` from the
    uncond embedding at lr = lr_base (1 - i/100) and threshold epsilon +
    i 2e-5 (both float32, as in JAX), the target cfg scale in the loss; then
    the pair step with the optimised embedding as uncond on both rows.
    Returns (x_edit, x_orig), float32 (float64 kept)."""
    S = after_skip_steps
    B = _check_batch(xT, None, ctx3, S)
    if xts.shape[:2] != (B, S + 1):
        raise ValueError(f"xts {tuple(xts.shape)} does not hold {S} steps for {B} images")
    qk, conv = _gates(qk_mask, conv_mask, S)
    x_orig = x_edit = _wide(xT)
    xts = xts.to(x_orig.dtype)
    for i, t in enumerate(schedule.timesteps[-S:].tolist()):
        u_opt = ctx3[:, 0]
        if optimization_steps > 0:
            step = torch.tensor(float(i), dtype=torch.float32, device=xT.device)
            cond_src = _wide(unet(x_orig, t, ctx3[:, 1]))
            u_opt, _ = null_text_adam(
                null_text_loss(unet, schedule, x_orig, t, cond_src, xts[:, S - 1 - i], cfg_tar),
                u_opt, optimization_steps=optimization_steps,
                lr=lr_base * (1.0 - step / 100.0), thresh=epsilon + step * 2e-5)
        eps_src, eps_tar = _pnp_pair_eps(unet, x_orig, x_edit, t, ctx3, cfg_tar, qk[i], conv[i],
                                         uncond=u_opt)
        x_orig, x_edit = (schedule.reverse_step(eps_src, t, x_orig, eta=0.0),
                          schedule.reverse_step(eps_tar, t, x_edit, eta=0.0))
    return x_edit, x_orig


@torch.no_grad()
def negative_prompt_pnp(unet, schedule: Schedule, xT: torch.Tensor, *, ctx3: torch.Tensor,
                        cfg_tar: float, after_skip_steps: int, qk_mask: Sequence[bool],
                        conv_mask: Sequence[bool]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Negative-prompt + PnP for B images from xT [B, H, W, C] (a DDIM
    inversion's end): the pair step, eta = 0, with the source prompt as the
    uncond context.  Returns (x_edit, x_orig) in float32."""
    N = after_skip_steps
    _check_batch(xT, None, ctx3, N)
    qk, conv = _gates(qk_mask, conv_mask, N)
    x_orig = x_edit = xT.float()
    for i, t in enumerate(schedule.timesteps[-N:].tolist()):
        eps_src, eps_tar = _pnp_pair_eps(unet, x_orig, x_edit, t, ctx3, cfg_tar, qk[i], conv[i],
                                         uncond=ctx3[:, 1])
        x_orig, x_edit = (schedule.reverse_step(eps_src, t, x_orig, eta=0.0),
                          schedule.reverse_step(eps_tar, t, x_edit, eta=0.0))
    return x_edit, x_orig
