"""DDPM "edit-friendly" inversion (port of ``hedit_tpu/invert/ddpm.py``).

Semantics of the reference's ``inversion/ddpm_inversion.py``: (1) independent
draws x_t ~ q(x_t | x0), one per inference step (:40-50).  Those independent
draws are the edit-friendly trick and must not become an ancestral chain.
(2) For each step the CFG eps at x_t, the posterior mean mu and the normalised
residual z = (x_{t-1} - mu) / (eta * sqrt(var)) (:144-158).  The reference's
"re-anchoring" is algebraically the identity, so the steps are independent
given the draws and run ``step_chunk`` rows a UNet call.

An edit loop that derives its residuals itself (``derive_zs``) needs step (1)
only: ``skip_zs=True`` runs no UNet pass.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch


class InversionResult(NamedTuple):
    """What an inversion returns (``hedit_tpu/invert/ddpm.py:InversionResult``),
    with a leading image axis B."""

    xT: torch.Tensor                # [B, H, W, C]: xts[:, S]
    zs: Optional[torch.Tensor]      # [B, S, H, W, C] residuals, zs[:, S-1] the first step's
    xts: torch.Tensor               # [B, S+1, H, W, C], xts[:, 0] = x0
    noise_added: Optional[torch.Tensor] = None  # [B, S+1, H, W, C] q-sampling noises


def _q_sample(schedule, x0: torch.Tensor, generator: Optional[torch.Generator]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x0 [1, H, W, C] -> (xts, noise), both [S+1, H, W, C]; noise[0] = 0."""
    S = schedule.num_inference_steps
    abar_t = schedule.alphas_cumprod[schedule.timesteps].to(x0.device)   # [S]
    noise = torch.randn((S,) + tuple(x0.shape[1:]), generator=generator,
                        dtype=x0.dtype, device=x0.device)
    a = torch.sqrt(abar_t).flip(0).reshape(S, 1, 1, 1)
    b = torch.sqrt(1.0 - abar_t).flip(0).reshape(S, 1, 1, 1)
    return (torch.cat([x0, x0[0][None] * a + noise * b], dim=0),
            torch.cat([torch.zeros_like(x0), noise], dim=0))


def sample_xts_from_x0(schedule, x0: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x0 [1, H, W, C] -> xts [S+1, H, W, C].

    xts[0] = x0 and xts[idx] is drawn at t = timesteps[S - idx] with the
    idx-th of S standard normal draws from ``generator``, which must live on
    x0's device."""
    return _q_sample(schedule, x0, generator)[0]


@torch.no_grad()
def invert_ddpm(unet, schedule, x0: Optional[torch.Tensor] = None, *,
                uncond_ctx: torch.Tensor, src_ctx: torch.Tensor,
                cfg_scale_src: float = 1.0, eta: float = 1.0,
                generator: Union[None, torch.Generator, Sequence[torch.Generator]] = None,
                xts: Optional[torch.Tensor] = None, step_chunk: int = 10,
                skip_zs: bool = False) -> InversionResult:
    """Invert B images at once (``inversion_forward_process_ddpm``, :54-167).

    x0 [B, H, W, C] latents (NHWC), drawn from ``generator`` image after
    image, or each image from its own of B generators; or ready draws ``xts``
    [B, S+1, H, W, C] (then ``noise_added`` is None).  uncond_ctx, src_ctx
    [B, 77, D].  The residual pass runs, for each image, ``step_chunk`` steps a UNet call: that many rows when
    cfg_scale_src == 1 (u + 1.0 * (c - u) == c, the uncond half is skipped),
    else twice as many.  skip_zs=True runs no UNet pass and returns zs=None."""
    if eta <= 0:
        raise ValueError(f"edit-friendly inversion needs eta > 0, got {eta}")
    if (x0 is None) == (xts is None):
        raise ValueError("give x0 (and a generator) or ready xts, not both")
    S = schedule.num_inference_steps
    noise = None
    if xts is None:
        gens = generator if isinstance(generator, (list, tuple)) else [generator] * len(x0)
        drawn = [_q_sample(schedule, x[None].float(), g) for x, g in zip(x0, gens)]
        xts = torch.stack([d[0] for d in drawn])
        noise = torch.stack([d[1] for d in drawn])
    xts = xts.float()
    B = xts.shape[0]
    if xts.shape[1] != S + 1 or uncond_ctx.shape[0] != B or src_ctx.shape[0] != B:
        raise ValueError(f"xts {tuple(xts.shape)} / contexts do not match {B} images "
                         f"and {S} steps")
    if skip_zs:
        return InversionResult(xT=xts[:, S], zs=None, xts=xts, noise_added=noise)

    # position i (t = ts[i]) reads x_t = xts[S - i] and x_{t-1} = xts[S - i - 1]
    x_in = xts[:, 1:].flip(1)                               # [B, S, ...]
    x_prev = xts[:, :-1].flip(1)
    t_all = schedule.timesteps.to(xts.device)
    eps_all = torch.empty_like(x_in)
    for b in range(B):
        for lo in range(0, S, step_chunk):
            n = min(step_chunk, S - lo)                     # the last call may be shorter
            x, t = x_in[b, lo:lo + n], t_all[lo:lo + n]
            src = src_ctx[b:b + 1].expand(n, -1, -1)
            if cfg_scale_src == 1.0:
                eps_all[b, lo:lo + n] = unet(x, t, src).float()
                continue
            unc = uncond_ctx[b:b + 1].expand(n, -1, -1)
            e_unc, e_cond = unet(torch.cat([x, x]), torch.cat([t, t]),
                                 torch.cat([unc, src])).float().chunk(2)
            eps_all[b, lo:lo + n] = e_unc + cfg_scale_src * (e_cond - e_unc)

    def per_step(table):
        return table.to(xts.device).reshape(1, S, 1, 1, 1)

    abar_t = per_step(schedule.abar(schedule.timesteps))
    abar_prev = per_step(schedule.abar_prev(schedule.timesteps))
    var = per_step(schedule.variance(schedule.timesteps))
    pred_x0 = (x_in - torch.sqrt(1.0 - abar_t) * eps_all) / torch.sqrt(abar_t)
    direction = torch.sqrt(1.0 - abar_prev - (eta**2) * var) * eps_all
    mu = torch.sqrt(abar_prev) * pred_x0 + direction
    z = (x_prev - mu) / (eta * torch.sqrt(var))
    return InversionResult(xT=xts[:, S], zs=z.flip(1), xts=xts, noise_added=noise)
