"""SDE ("edit-friendly") inversion of the pixel-space face DDPM (port of
``hedit_tpu/invert/sde.py``).

The DDPM inversion's structure with the face model's own eta = 0.5 split
(``face-swapping/inversion/sde_inversion.py:52-158``):

    c1 = sqrt(1 - abar_{t-1}) * 0.5
    c2 = sqrt(1 - abar_{t-1}) * sqrt(1 - 0.25)
    mu = sqrt(abar_{t-1}) * x0_hat + c2 * eps
    z  = (x_{t-1} - mu) / (eta * c1)

where t-1 is the NEXT timestep of the grid (0 after the last).  The draws
x_t ~ q(x_t | x0) are independent, so the steps are too and run
``step_chunk`` rows a UNet call: 1 by default, not JAX's 10.  Rows are
independent, so the size changes only rounding; at 2-10 float32 rows
cuDNN's heuristics pick an FFT tiling for the 128x128 level's 256 / 384 ->
128 channel convolutions (0.5-1.2 s a call and 17-29 GB on the H100), at
1 row a fast one (25 ms a call; ``probes/face_conv_rows.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from hedit_tpu_torch.invert.ddpm import InversionResult, _q_sample


def face_step_coeffs(schedule, t, tm1):
    """(c1, c2, sqrt(abar_tm1)) of the eta = 0.5 split (:140-145)."""
    abar_tm1 = schedule.alphas_cumprod[tm1]
    c1 = torch.sqrt(1.0 - abar_tm1) * 0.5
    # sqrt(0.75) rounded to float32 first, as JAX's jnp.sqrt(1.0 - 0.25)
    c2 = torch.sqrt(1.0 - abar_tm1) * torch.sqrt(torch.tensor(1.0 - 0.25))
    return c1, c2, torch.sqrt(abar_tm1)


def next_timesteps(ts: torch.Tensor) -> torch.Tensor:
    """t-1 of each step of a descending grid: the next timestep, 0 after the last."""
    return torch.cat([ts[1:], torch.zeros(1, dtype=ts.dtype)])


@torch.no_grad()
def invert_sde(eps_fn, schedule, x0: Optional[torch.Tensor] = None, *, eta: float = 1.0,
               generator: Union[None, torch.Generator, Sequence[torch.Generator]] = None,
               xts: Optional[torch.Tensor] = None, step_chunk: int = 1) -> InversionResult:
    """Invert B images: ``eps_fn(x [n, H, W, C], t [n]) -> eps`` the face UNet.

    x0 [B, H, W, C], drawn from ``generator`` image after image, or each image
    from its own of B generators; or ready draws ``xts`` [B, S+1, H, W, C]
    (then ``noise_added`` is None).  For each image the UNet runs
    ``step_chunk`` steps a call; the last call may be shorter.  Computes in
    float32, or in float64 where given float64."""
    if eta <= 0:
        raise ValueError(f"edit-friendly inversion needs eta > 0, got {eta}")
    if (x0 is None) == (xts is None):
        raise ValueError("give x0 (and a generator) or ready xts, not both")
    S = schedule.num_inference_steps
    dtype = torch.promote_types((x0 if xts is None else xts).dtype, torch.float32)
    noise = None
    if xts is None:
        gens = generator if isinstance(generator, (list, tuple)) else [generator] * len(x0)
        drawn = [_q_sample(schedule, x[None].to(dtype), g) for x, g in zip(x0, gens)]
        xts = torch.stack([d[0] for d in drawn])
        noise = torch.stack([d[1] for d in drawn])
    xts = xts.to(dtype)
    if xts.shape[1] != S + 1:
        raise ValueError(f"xts {tuple(xts.shape)} does not hold {S} steps")

    # position i (t = ts[i]) reads x_t = xts[S - i] and x_{t-1} = xts[S - i - 1]
    x_in = xts[:, 1:].flip(1)
    x_prev = xts[:, :-1].flip(1)
    ts = schedule.timesteps
    t_dev = ts.to(xts.device)
    eps_all = torch.empty_like(x_in)
    for b in range(xts.shape[0]):
        for lo in range(0, S, step_chunk):
            n = min(step_chunk, S - lo)
            eps_all[b, lo:lo + n] = eps_fn(x_in[b, lo:lo + n], t_dev[lo:lo + n])

    def per_step(table):
        return table.to(xts.device).reshape(1, S, 1, 1, 1)

    abar_t = per_step(schedule.alphas_cumprod[ts])
    x0_hat = (x_in - torch.sqrt(1.0 - abar_t) * eps_all) / torch.sqrt(abar_t)
    c1, c2, sq_abar = (per_step(c) for c in face_step_coeffs(schedule, ts, next_timesteps(ts)))
    mu = sq_abar * x0_hat + c2 * eps_all
    z = (x_prev - mu) / (eta * c1)
    return InversionResult(xT=xts[:, S], zs=z.flip(1), xts=xts, noise_added=noise)
