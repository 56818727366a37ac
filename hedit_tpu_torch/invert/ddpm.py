"""DDPM "edit-friendly" inversion: the q-sampled trajectory
(port of ``hedit_tpu/invert/ddpm.py:sample_xts_from_x0``).

The flagship edit derives its residuals inside the loop (``derive_zs``), so
the inversion needs no UNet pass: only independent draws x_t ~ q(x_t | x0),
one per inference step (``ddpm_inversion.py:40-50``).  Those independent
draws are the edit-friendly trick and must not become an ancestral chain.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_xts_from_x0(schedule, x0: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x0 [1, H, W, C] -> xts [S+1, H, W, C].

    xts[0] = x0 and xts[idx] is drawn at t = timesteps[S - idx] with the
    idx-th of S standard normal draws from ``generator``, which must live on
    x0's device."""
    S = schedule.num_inference_steps
    abar_t = schedule.alphas_cumprod[schedule.timesteps].to(x0.device)   # [S]
    noise = torch.randn((S,) + tuple(x0.shape[1:]), generator=generator,
                        dtype=x0.dtype, device=x0.device)
    a = torch.sqrt(abar_t).flip(0).reshape(S, 1, 1, 1)
    b = torch.sqrt(1.0 - abar_t).flip(0).reshape(S, 1, 1, 1)
    return torch.cat([x0, x0[0][None] * a + noise * b], dim=0)
