"""Face-swapping loops: reward guidance by ArcFace identity and LPIPS (port of
``hedit_tpu/edit/face_swap.py``).

* ``h_edit_r_face`` (``face-swapping/inversion/h_edit_R.py:7-137``): each
  step takes the eta = 0.5-split posterior step to x_{t-1}^base, then K
  optimisation loops; each loop computes eps(x_{t-1}^k, t-1) without a
  gradient, Tweedie's x0, and descends the ID cosine loss, then (eps and x0
  computed again) the LPIPS loss, both with rho = sqrt(abar_{t-1}) weight.
  The gradient flows through Tweedie -> crop -> pool -> the critic only.
  The last step (t-1 = 0) takes no optimisation: JAX computes it and
  discards it, the reference skips it (:90-91), and so does this loop.
* ``ef_face`` (``face-swapping/inversion/ef.py:7-114``): the gradients are
  taken at x_t THROUGH the UNet, rho = sqrt(abar_t) weight.  The reference
  breaks at t-1 = 0 after computing the last step and before applying it,
  so it returns the step before the last; this loop stops there.

The loss functions map an x0 prediction [B, H, W, 3] in [-1, 1] to a scalar;
the face pipeline's sum over the batch, so each image descends its own loss.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from hedit_tpu_torch.invert.sde import face_step_coeffs, next_timesteps


def _grid(schedule, zs: torch.Tensor, after_skip_steps: int):
    """The last N timesteps, their t-1, and each step's residual [B, N, ...]
    (the inversion keeps zs[:, S-1] for the first step of the grid)."""
    N = after_skip_steps
    op = schedule.timesteps[-N:]
    return op, next_timesteps(op), zs[:, :N].flip(1)


def face_base_step(schedule, xt: torch.Tensor, eps_t: torch.Tensor, t: int, tm1: int,
                   z: torch.Tensor, eta: float = 1.0) -> torch.Tensor:
    """x_{t-1}^base, the eta = 0.5-split posterior step from x_t with the
    step's eps and residual z (both loops' step before their guidance)."""
    abar = schedule.alphas_cumprod
    x0_hat = (xt - torch.sqrt(1.0 - abar[t]) * eps_t) / torch.sqrt(abar[t])
    c1, c2, sq_abar = face_step_coeffs(schedule, t, tm1)
    return sq_abar * x0_hat + c2 * eps_t + eta * c1 * z


def _descend(loss_fn, x: torch.Tensor, x0_of, rho, mask=None) -> torch.Tensor:
    """x - rho * d loss_fn(x0_of(x)) / dx (times ``mask``)."""
    xg = x.detach().requires_grad_()
    with torch.enable_grad():
        g, = torch.autograd.grad(loss_fn(x0_of(xg)), xg)
    if mask is not None:
        g = g * mask
    return x - rho * g


def h_edit_r_face(eps_fn, schedule, xT: torch.Tensor, zs: torch.Tensor, *,
                  id_loss_fn: Optional[Callable] = None,
                  lpips_loss_fn: Optional[Callable] = None,
                  weight_edit_face: float = 50.0, eta: float = 1.0,
                  optimization_steps: int = 3, after_skip_steps: int,
                  soft_face_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xT [B, H, W, 3], zs [B, S, H, W, 3] -> the edited x0 [B, H, W, 3]."""
    op, tm1s, zs_loop = _grid(schedule, zs, after_skip_steps)
    abar = schedule.alphas_cumprod
    xt = xT
    B = xt.shape[0]
    for i in range(after_skip_steps):
        t, tm1 = int(op[i]), int(tm1s[i])
        with torch.no_grad():
            eps_t = eps_fn(xt, torch.full((B,), t, device=xt.device))
        x_opt = face_base_step(schedule, xt, eps_t, t, tm1, zs_loop[:, i], eta)
        if i == after_skip_steps - 1:  # t-1 = 0: no optimisation
            xt = x_opt
            break
        rho = torch.sqrt(abar[tm1]) * weight_edit_face
        tb = torch.full((B,), tm1, device=xt.device)
        for _ in range(optimization_steps):
            for loss_fn, mask in ((id_loss_fn, soft_face_mask), (lpips_loss_fn, None)):
                if loss_fn is None:
                    continue
                with torch.no_grad():
                    eps_tm1 = eps_fn(x_opt, tb)

                def x0_of(x, eps_tm1=eps_tm1):
                    return (x - torch.sqrt(1.0 - abar[tm1]) * eps_tm1) / torch.sqrt(abar[tm1])

                x_opt = _descend(loss_fn, x_opt, x0_of, rho, mask)
        xt = x_opt
    return xt


def ef_face(eps_fn, schedule, xT: torch.Tensor, zs: torch.Tensor, *,
            id_loss_fn: Optional[Callable] = None, lpips_loss_fn: Optional[Callable] = None,
            weight_edit_face: float = 100.0, eta: float = 1.0, after_skip_steps: int,
            soft_face_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xT [B, H, W, 3], zs [B, S, H, W, 3] -> the sample before the last step.

    With a loss, one UNet forward a step records the graph: its eps is the
    step's eps, and both losses' gradients go back through it
    (``retain_graph`` for the first)."""
    op, tm1s, zs_loop = _grid(schedule, zs, after_skip_steps)
    abar = schedule.alphas_cumprod
    losses = [(fn, mask) for fn, mask in ((id_loss_fn, soft_face_mask), (lpips_loss_fn, None))
              if fn is not None]
    xt = xT
    B = xt.shape[0]
    for i in range(after_skip_steps - 1):  # the reference breaks before the last step
        t, tm1 = int(op[i]), int(tm1s[i])
        tb = torch.full((B,), t, device=xt.device)
        x = xt.detach().requires_grad_(bool(losses))
        with torch.set_grad_enabled(bool(losses)):
            e = eps_fn(x, tb)
            x0 = (x - torch.sqrt(1.0 - abar[t]) * e) / torch.sqrt(abar[t])
        x_tm1 = face_base_step(schedule, xt, e.detach(), t, tm1, zs_loop[:, i], eta)
        rho = torch.sqrt(abar[t]) * weight_edit_face
        for k, (loss_fn, mask) in enumerate(losses):
            with torch.enable_grad():
                g, = torch.autograd.grad(loss_fn(x0), x, retain_graph=k < len(losses) - 1)
            if mask is not None:
                g = g * mask
            x_tm1 = x_tm1 - rho * g
        xt = x_tm1
    return xt
