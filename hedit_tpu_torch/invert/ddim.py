"""DDIM (deterministic) inversion (port of ``hedit_tpu/invert/ddim.py``).

Semantics of the reference's ``inversion/ddim_inversion.py:55-131``.  Phase 1: the
forward Euler inversion x0 -> xT with CFG noise, one UNet call a step, in
sequence.  Phase 2: the per-step un-normalised residuals z = x_{t-1} - mu(x_t)
against the phase-1 trajectory; the reference's "re-anchoring" is
algebraically the identity, so the steps are independent and run
``step_chunk`` rows a UNet call.

The residuals are consumed downstream with eta = 1 and
``is_ddim_inversion=True``.  A caller that reads only the trajectory (NMG, a
loop that derives its residuals itself) passes ``skip_zs=True`` and phase 2
does not run.
"""

from __future__ import annotations

import torch

from hedit_tpu_torch.invert.ddpm import InversionResult


@torch.no_grad()
def invert_ddim(unet, schedule, x0: torch.Tensor, *, uncond_ctx: torch.Tensor,
                src_ctx: torch.Tensor, cfg_scale: float = 1.0, step_chunk: int = 10,
                skip_zs: bool = False) -> InversionResult:
    """Invert B images at once.

    x0 [B, H, W, C] latents (NHWC); uncond_ctx, src_ctx [B, 77, D].  Each
    image's result equals the JAX function's on that image alone.
    skip_zs=True runs phase 1 only and returns zs=None."""
    S = schedule.num_inference_steps
    ts = schedule.timesteps.tolist()  # descending
    B = x0.shape[0]
    x0 = x0.float()

    def cfg_eps(x, t, unc, src):
        """x [n, ...]; t an int or [n]; unc / src [n, 77, D]."""
        if cfg_scale == 1.0:  # u + 1.0 * (c - u) == c: skip the uncond half
            return unet(x, t, src).float()
        t2 = t if isinstance(t, int) else torch.cat([t, t])
        eps = unet(torch.cat([x, x]), t2, torch.cat([unc, src])).float()
        e_unc, e_cond = eps.chunk(2)
        return e_unc + cfg_scale * (e_cond - e_unc)

    # phase 1: timesteps ascending; latents[i + 1] is the latent after step i
    latents = [x0]
    for t in reversed(ts):
        latents.append(schedule.next_step(cfg_eps(latents[-1], t, uncond_ctx, src_ctx), t,
                                          latents[-1]))
    xts = torch.stack(latents, dim=1)                       # [B, S+1, H, W, C]
    if skip_zs:
        return InversionResult(xT=xts[:, S], zs=None, xts=xts)

    # phase 2: position i (t = ts[i]) reads x_t = xts[S - i] and x_{t-1} = xts[S - i - 1]
    x_in = xts[:, 1:].flip(1)                               # [B, S, ...]
    x_prev = xts[:, :-1].flip(1)
    t_all = schedule.timesteps.to(x0.device)
    eps_all = torch.empty_like(x_in)
    for b in range(B):
        for lo in range(0, S, step_chunk):
            n = min(step_chunk, S - lo)
            eps_all[b, lo:lo + n] = cfg_eps(
                x_in[b, lo:lo + n], t_all[lo:lo + n],
                uncond_ctx[b:b + 1].expand(n, -1, -1), src_ctx[b:b + 1].expand(n, -1, -1))
    abar_t = schedule.abar(schedule.timesteps).to(x0.device).reshape(1, S, 1, 1, 1)
    abar_prev = schedule.abar_prev(schedule.timesteps).to(x0.device).reshape(1, S, 1, 1, 1)
    pred_x0 = (x_in - torch.sqrt(1.0 - abar_t) * eps_all) / torch.sqrt(abar_t)
    mu = torch.sqrt(abar_prev) * pred_x0 + torch.sqrt(1.0 - abar_prev) * eps_all
    zs = (x_prev - mu).flip(1)                              # un-normalised (the DDIM case)
    return InversionResult(xT=xts[:, S], zs=zs, xts=xts)
