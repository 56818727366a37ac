"""h-Edit sampling loops without attention control, batched over images
(port of ``hedit_tpu/edit/h_edit.py``).

Semantics of the reference's ``inversion/p2p_h_edit.py``: ``h_Edit_R_explicit``
(:21-156) and ``h_Edit_R_implicit`` (:162-362), with the step-0
pre-optimisation at ``time_ahead`` when skip > 0 (:216-267) and the
L1-reconstruction pull with an RMS-normalised step size for optimisation steps
after the first (:328-344); and the edit-friendly baseline ``ef_sample``
(``p2p_baselines.py:19-95``).

As in the JAX package one call of 3 rows an image, [x, x, x] under [uncond,
src, tar], gives the three distinct eps of the reference's batch-2 plus
batch-4 calls.  Per step:

  base:        x_{t-1}^base = reverse_step(eps_src(x_edit), t, x, eta, z_t)
  correction:  f = eps_tar - eps_src_edit              (three CFG combinations)
  coeff:       h_edit_coeff(t, tt)
  update:      x_{t-1} = rec_term + coeff * f

Every loop takes B images: latents [B, H, W, C] (NHWC), residuals
[B, S, H, W, C], contexts ``ctx3`` [B, 3, 77, D] with rows [uncond, src, tar].
Per-image quantities (the RMS, the L1 gradient's 1 / size) are taken over one
image, never over the batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch

from hedit_tpu_torch.core.schedule import Schedule


@dataclasses.dataclass(frozen=True)
class HEditConfig:
    """Static editing configuration (CLI parity: ``main_p2p.py:49-70``)."""

    cfg_src: float = 1.0        # w^orig      (--cfg_src)
    cfg_src_edit: float = 5.0   # \\hat{w}^orig (--cfg_src_edit)
    cfg_tar: float = 7.5        # w^edit      (--cfg_tar)
    eta: float = 1.0
    is_ddim_inversion: bool = False
    optimization_steps: int = 1      # --optimization_steps
    weight_reconstruction: float = 0.1  # --weight_reconstruction
    implicit: bool = True


class StepGrid(NamedTuple):
    """Per-step inputs of the after-skip editing loop."""

    ts: List[int]                 # [N] current timesteps
    tts: List[int]                # [N] next timesteps (ts shifted; last = 0)
    zs: Optional[torch.Tensor]    # [B, N, H, W, C] posterior noise, loop order


def make_step_grid(schedule: Schedule, zs: Optional[torch.Tensor],
                   after_skip_steps: int) -> StepGrid:
    """ts = timesteps[-N:]; z at loop position i is zs[:, N-1-i]
    (index algebra of ``p2p_h_edit.py:83-84``)."""
    N = after_skip_steps
    ts = schedule.timesteps[-N:].tolist()
    return StepGrid(ts=ts, tts=ts[1:] + [0],
                    zs=None if zs is None else zs[:, :N].flip(1).float())


def traj_inputs(xts: Optional[torch.Tensor], n_steps: int
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(x_orig_seq, x_prev_seq), both [B, N, H, W, C] in loop order, for the
    stored-trajectory fast path, or None without ``xts``.

    When the inversion's xts [B, N+1, H, W, C] are supplied (xts[:, N] the
    start), the source branch of an edit loop is the stored trajectory itself:
    reverse_step on xts[t] with the inversion residual reproduces xts[t-1]
    exactly, so the loop indexes the source latents instead of spending UNet
    rows on recomputing them."""
    if xts is None:
        return None
    if xts.shape[1] != n_steps + 1:
        raise ValueError(f"xts must hold {n_steps + 1} trajectory points "
                         f"(got {xts.shape[1]})")
    xts = xts.float()
    return xts[:, 1:].flip(1), xts[:, :-1].flip(1)


def _rms(x: torch.Tensor) -> torch.Tensor:
    """Root mean square of each image: [B, H, W, C] -> [B, 1, 1, 1]."""
    return torch.sqrt(torch.mean(x * x, dim=(1, 2, 3), keepdim=True))


def _l1_grad(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Gradient of each image's mean |x - ref| with respect to x: the closed
    form of the reference's autograd through ``F.l1_loss`` (:331-334), with
    sign(0) = 0."""
    return torch.sign(x - ref) / x[0].numel()


def cfg_pair(e_u, e_c, scale: float):
    return e_u + scale * (e_c - e_u)


def reconstruction_pull(x_opt, x_prev_base, correction, weight: float):
    """x_opt moved towards x_prev_base by the L1 gradient, its step size the
    correction's RMS over the gradient's (:328-344); per image."""
    g = _l1_grad(x_opt, x_prev_base)
    rho = _rms(correction) / (_rms(g) + 1e-8) * weight
    return x_opt - rho * g


def _check_batch(xT, zs, ctx3, n_steps: int) -> int:
    B = xT.shape[0]
    if ctx3.shape[:2] != (B, 3):
        raise ValueError(f"ctx3 {tuple(ctx3.shape)} does not hold [uncond, src, tar] "
                         f"for {B} images")
    if zs is not None and (zs.shape[0] != B or zs.shape[1] < n_steps):
        raise ValueError(f"zs {tuple(zs.shape)} does not hold {n_steps} residuals "
                         f"for {B} images")
    return B


@torch.no_grad()
def h_edit_r(unet, schedule: Schedule, xT: torch.Tensor, zs: torch.Tensor, *,
             ctx3: torch.Tensor, cfg: HEditConfig, after_skip_steps: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h-Edit-R without attention control; explicit or implicit by cfg.implicit.

    xT [B, H, W, C]; zs [B, S, H, W, C] from the DDPM inversion.  Returns
    (edited latents, the along-for-the-ride branch) as the reference's
    ``return xt[1], xt[0]`` (:156, :362)."""
    if cfg.is_ddim_inversion:
        raise ValueError("h-Edit-R requires DDPM inversion (:50)")
    N = after_skip_steps
    S = schedule.num_inference_steps
    B = _check_batch(xT, zs, ctx3, N)
    grid = make_step_grid(schedule, zs, N)
    ctx = ctx3.reshape(3 * B, *ctx3.shape[2:])

    def three_eps(x, t):
        """eps at (x, t) under [uncond, src, tar] -> (eps_src_orig, eps_src_edit,
        eps_tar), the three CFG combinations."""
        xin = torch.stack([x, x, x], dim=1).reshape(3 * B, *x.shape[1:])
        eps = unet(xin, t, ctx).float().reshape(B, 3, *x.shape[1:])
        e_u, e_s, e_t = eps[:, 0], eps[:, 1], eps[:, 2]
        return (cfg_pair(e_u, e_s, cfg.cfg_src), cfg_pair(e_u, e_s, cfg.cfg_src_edit),
                cfg_pair(e_u, e_t, cfg.cfg_tar))

    x_orig = x_edit = xT.float()
    if cfg.implicit and N != S:
        # step-0 pre-optimisation (:238-267).  The UNet is evaluated at the
        # first after-skip timestep (:245); only the coefficient uses time_ahead.
        time_ahead = int(schedule.timesteps[-(N + 1)])
        _, eps_src_edit, eps_tar = three_eps(x_edit, grid.ts[0])
        x_edit = x_edit + schedule.h_edit_coeff(time_ahead, grid.ts[0], cfg.eta) * (
            eps_tar - eps_src_edit)

    for i, (t, tt) in enumerate(zip(grid.ts, grid.tts)):
        z = grid.zs[:, i]
        eps_src_orig, eps_src_edit, eps_tar = three_eps(x_edit, t)
        # the base step applies the x_edit-based eps to BOTH branches (:104-107)
        x_orig = schedule.reverse_step(eps_src_orig, t, x_orig, eta=cfg.eta, variance_noise=z)
        x_prev_base = schedule.reverse_step(eps_src_orig, t, x_edit, eta=cfg.eta,
                                            variance_noise=z)
        coeff = schedule.h_edit_coeff(t, tt, cfg.eta)
        if not cfg.implicit:
            # explicit (:130-147): the correction from the SAME (x_edit, t) eps
            x_edit = x_prev_base + coeff * (eps_tar - eps_src_edit)
            continue
        # implicit (:302-353): optimise x_{t-1} at time tt
        x_opt = x_prev_base
        for k in range(cfg.optimization_steps):
            _, eps_src_edit2, eps_tar2 = three_eps(x_opt, tt)
            correction = eps_tar2 - eps_src_edit2
            rec_term = x_opt if k == 0 else reconstruction_pull(
                x_opt, x_prev_base, correction, cfg.weight_reconstruction)
            x_opt = rec_term + coeff * correction
        x_edit = x_opt
    return x_edit, x_orig


@torch.no_grad()
def ef_sample(unet, schedule: Schedule, xT: torch.Tensor, zs: torch.Tensor, *,
              ctx3: torch.Tensor, cfg_tar: float, eta: float = 1.0, after_skip_steps: int,
              is_ddim_inversion: bool = False) -> torch.Tensor:
    """The edit-friendly baseline without P2P: plain CFG sampling on the target
    prompt with the inversion's residuals (``p2p_baselines.py:19-95``).  One
    call of 2 rows an image, [x, x] under [uncond, tar]."""
    N = after_skip_steps
    B = _check_batch(xT, zs, ctx3, N)
    grid = make_step_grid(schedule, zs, N)
    ctx = ctx3[:, [0, 2]].reshape(2 * B, *ctx3.shape[2:])
    x = xT.float()
    for i, t in enumerate(grid.ts):
        xin = torch.stack([x, x], dim=1).reshape(2 * B, *x.shape[1:])
        eps = unet(xin, t, ctx).float().reshape(B, 2, *x.shape[1:])
        x = schedule.reverse_step(cfg_pair(eps[:, 0], eps[:, 1], cfg_tar), t, x, eta=eta,
                                  variance_noise=grid.zs[:, i],
                                  is_ddim_inversion=is_ddim_inversion)
    return x
