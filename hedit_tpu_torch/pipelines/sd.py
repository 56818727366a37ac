"""Stable-Diffusion pipeline bundle: UNet + VAE + CLIP text + schedule
(port of ``hedit_tpu/pipelines/sd.py``).

Weights come from a local diffusers-layout directory (``unet/``, ``vae/``,
``text_encoder/``), read in the JAX package's order (``*.safetensors``, then
``*.bin``) and with its legacy VAE attention names, or from a seeded random
init: every linear and conv weight N(0, 1/fan_in) with bias 0, embeddings
N(0, 0.02), norms weight 1 and bias 0, drawn in module order from one
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.io_utils.safetensors_io import load_safetensors
from hedit_tpu_torch.io_utils.weights import legacy_vae_state
from hedit_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from hedit_tpu_torch.models.unet_sd import UNet2DCondition, UNetConfig
from hedit_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from hedit_tpu_torch.ops.groupnorm import FusedGroupNorm


@dataclasses.dataclass
class SDPipeline:
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_model: CLIPTextModel
    schedule: Schedule
    device: torch.device

    @torch.no_grad()
    def encode_token_ids(self, ids) -> torch.Tensor:
        """[B, 77] token ids -> [B, 77, hidden] embeddings."""
        return self.text_model(torch.as_tensor(ids, dtype=torch.long, device=self.device))

    @torch.no_grad()
    def vae_encode(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [-1, 1] -> scaled latents [B, H/8, W/8, 4] (float32)."""
        return self.vae.encode_mode(images.to(self.device)).float()

    @torch.no_grad()
    def vae_decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, h, w, 4] -> images [B, 8h, 8w, 3] (float32)."""
        return self.vae.decode(latents.to(self.device)).float()


def seeded_init_(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from ``generator`` (see the module docstring)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
                fan_in = float(np.prod(m.weight.shape[1:]))
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (torch.nn.LayerNorm, FusedGroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()


# checkpoint file names, in the order the JAX package looks for them
CKPT_NAMES = ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
              "model.safetensors", "pytorch_model.bin")


def _find_ckpt(subdir: str) -> str:
    for name in CKPT_NAMES:
        path = os.path.join(subdir, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no checkpoint found under {subdir}")


def _read_ckpt(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file's tensors as float32: safetensors by the port's own
    reader, ``*.bin`` by ``torch.load`` with ``weights_only`` (tensors, no
    code), unwrapping a ``state_dict`` entry as the JAX package does."""
    if path.endswith(".safetensors"):
        return {k: torch.from_numpy(np.array(v, dtype=np.float32))
                for k, v in load_safetensors(path).items()}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().float() for k, v in obj.items()}


def load_sd_weights(weights_dir: str, unet, vae, text) -> None:
    """Load a local diffusers directory into the three towers (strict keys,
    after the VAE's legacy attention keys are renamed)."""
    for sub, model in (("unet", unet), ("vae", vae), ("text_encoder", text)):
        state = _read_ckpt(_find_ckpt(os.path.join(weights_dir, sub)))
        state = {k: v for k, v in state.items() if not k.endswith("position_ids")}
        if sub == "vae":
            state = legacy_vae_state(state)
        model.load_state_dict(state, strict=True)


def create_sd_pipeline(weights_dir: Optional[str] = None, *, tiny: bool = False,
                       num_inference_steps: int = 50, seed: int = 0,
                       dtype: torch.dtype = torch.float32,
                       device="cuda") -> SDPipeline:
    """Build the pipeline on ``device`` in ``dtype``.  The default device is
    the card; the CPU is taken only when asked for (``device="cpu"``).

    weights_dir: diffusers-layout directory, or None for the seeded init.
    tiny: the small test configuration of every tower."""
    device = torch.device(device)
    if tiny:
        ucfg, vcfg, tcfg = UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()
    else:
        ucfg, vcfg, tcfg = UNetConfig.sd15(), VAEConfig.sd(), CLIPTextConfig.sd15()
    with torch.device("meta"):
        unet, vae, text = UNet2DCondition(ucfg), AutoencoderKL(vcfg), CLIPTextModel(tcfg)
    towers = (unet, vae, text)
    for m in towers:
        m.to_empty(device=device)
    if weights_dir is not None:
        load_sd_weights(weights_dir, *towers)
    else:
        g = torch.Generator(device=device).manual_seed(seed)
        for m in towers:
            seeded_init_(m, g)
    for m in towers:
        # channels-last conv weights: the towers carry channels-last activations
        m.to(dtype, memory_format=torch.channels_last).eval().requires_grad_(False)
    return SDPipeline(unet=unet, vae=vae, text_model=text,
                      schedule=Schedule.create(num_inference_steps),
                      device=device)
