"""Diffusion schedule tables and posterior-step numerics
(port of ``hedit_tpu/core/schedule.py``).

The tables are float32 CPU tensors built with numpy exactly as the JAX
package builds them.  A timestep ``t`` is a Python int or an integer tensor;
a lookup at a Python int gives a 0-d CPU tensor, which PyTorch treats as a
scalar next to tensors on any device, so the step math runs where the
latents are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def scaled_linear_betas(num_train_timesteps: int, beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    """SD-1.x betas: linear in sqrt(beta), in float64, stored as float32."""
    return (np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                        dtype=np.float64) ** 2).astype(np.float32)


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int,
                      steps_offset: int = 1) -> np.ndarray:
    """Inference timesteps, descending, diffusers "leading" spacing:
    for (1000, 50, offset=1) -> [981, 961, ..., 21, 1]."""
    ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * ratio).round().astype(np.int64)
    ts += steps_offset
    return ts[::-1].copy()


@dataclasses.dataclass(frozen=True)
class Schedule:
    alphas_cumprod: torch.Tensor        # [T] float32
    final_alpha_cumprod: torch.Tensor   # 0-d: abar[0] (set_alpha_to_one=False)
    timesteps: torch.Tensor             # [S] int64, descending
    num_train_timesteps: int
    num_inference_steps: int

    @staticmethod
    def create(num_inference_steps: int, num_train_timesteps: int = 1000,
               steps_offset: int = 1) -> "Schedule":
        """steps_offset: 1 for the DDPM modes, 0 for the DDIM modes (the JAX CLI
        builds its pipeline so, ``hedit_tpu/cli/main_p2p.py:348-349``)."""
        betas = scaled_linear_betas(num_train_timesteps)
        alphas = (1.0 - betas).astype(np.float32)
        abar = np.cumprod(alphas, dtype=np.float32)
        timesteps = leading_timesteps(num_train_timesteps, num_inference_steps, steps_offset)
        return Schedule(
            alphas_cumprod=torch.from_numpy(abar),
            final_alpha_cumprod=torch.tensor(abar[0]),
            timesteps=torch.from_numpy(timesteps),
            num_train_timesteps=num_train_timesteps,
            num_inference_steps=num_inference_steps)

    @property
    def step_ratio(self) -> int:
        return self.num_train_timesteps // self.num_inference_steps

    def abar(self, t) -> torch.Tensor:
        return self.alphas_cumprod[t]

    def abar_prev(self, t) -> torch.Tensor:
        """alphas_cumprod[t - step_ratio], final_alpha_cumprod below zero."""
        prev_t = torch.as_tensor(t) - self.step_ratio
        return torch.where(prev_t >= 0, self.alphas_cumprod[prev_t.clamp(min=0)],
                           self.final_alpha_cumprod)

    def variance(self, t) -> torch.Tensor:
        """DDIM posterior variance omega^2_{t,t-1} (``inversion_utils.py:38-56``)."""
        abar_t = self.abar(t)
        abar_prev = self.abar_prev(t)
        return ((1.0 - abar_prev) / (1.0 - abar_t)) * (1.0 - abar_t / abar_prev)

    def reverse_step(self, eps, t, sample, *, eta: float = 0.0,
                     variance_noise: Optional[torch.Tensor] = None,
                     is_ddim_inversion: bool = False) -> torch.Tensor:
        """One posterior step x_t -> x_{t-1} (``inversion_utils.py:58-127``).

        is_ddim_inversion=False, the DDPM form: direction
        sqrt(1 - abar_prev - eta^2 var), noise + eta sqrt(var) z.  True:
        direction sqrt(1 - abar_prev), noise added un-normalised (+ eta z)."""
        abar_t = self.abar(t)
        abar_prev = self.abar_prev(t)
        pred_x0 = (sample - torch.sqrt(1.0 - abar_t) * eps) / torch.sqrt(abar_t)
        var = self.variance(t)
        if is_ddim_inversion:
            direction = torch.sqrt(1.0 - abar_prev) * eps
        else:
            direction = torch.sqrt(1.0 - abar_prev - (eta**2) * var) * eps
        mu = torch.sqrt(abar_prev) * pred_x0 + direction
        if variance_noise is None:
            return mu
        if is_ddim_inversion:
            return mu + eta * variance_noise
        return mu + eta * torch.sqrt(var) * variance_noise

    def next_step(self, eps, t, sample) -> torch.Tensor:
        """DDIM forward-inversion Euler step (``ddim_inversion.py:8-29``): maps x
        at timestep t - step_ratio to x at timestep t."""
        abar_cur = self.abar_prev(t)
        abar_next = self.abar(t)
        x0 = (sample - torch.sqrt(1.0 - abar_cur) * eps) / torch.sqrt(abar_cur)
        direction = torch.sqrt(1.0 - abar_next) * eps
        return torch.sqrt(abar_next) * x0 + direction

    def h_edit_coeff(self, t, tt, eta):
        """sqrt(1 - abar_tt - omega^2_{t,tt}) - sqrt(1 - abar_t) * sqrt(abar_tt) / sqrt(abar_t)
        (``inversion_utils.py:168-195``, ``p2p_h_edit.py:141-142``)."""
        abar_t = self.alphas_cumprod[t]
        abar_tt = self.alphas_cumprod[tt]
        sigma_t = torch.sqrt(1.0 - abar_t)
        sigma_tt = torch.sqrt(1.0 - abar_tt)
        omega = eta * (sigma_tt / (sigma_t * torch.sqrt(abar_tt))) * torch.sqrt(abar_tt - abar_t)
        full = torch.sqrt(1.0 - abar_tt - omega**2)
        ratio_alpha = torch.sqrt(abar_tt) / torch.sqrt(abar_t)  # JAX's association
        return full - sigma_t * ratio_alpha
