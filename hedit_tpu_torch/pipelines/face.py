"""Face-swapping pipeline bundle: the CelebA-HQ DDPM UNet and the three
critics (port of ``hedit_tpu/pipelines/face.py``).

The model and loss set-up of ``face-swapping/main_edit.py:84-171``: a linear
beta schedule 1e-4 -> 2e-2 over 1000 training steps, the leading grid with
offset 1; ArcFace's identity loss against a reference image's embedding;
LPIPS against the source image; the face parser for the blend mask.

Weights come from the reference checkpoints (``celeba_hq.ckpt``,
``model_ir_se50.pth``, the lpips VGG weights, the face parser's), read as the
JAX package reads them, or from a seeded random init
(``pipelines/sd.py:seeded_init_``).  The critics are frozen: ``eval()`` and
``requires_grad_(False)``; only the image they score gets a gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.io_utils.weights import load_known, load_torch_state
from hedit_tpu_torch.models.arcface import IRSE50, cosine_sim, extract_feats
from hedit_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
from hedit_tpu_torch.models.face_parser import FaceParsing
from hedit_tpu_torch.models.lpips_vgg import LPIPSVgg, lpips_state
from hedit_tpu_torch.pipelines.sd import seeded_init_


@dataclasses.dataclass
class FacePipeline:
    unet: DDPMUNet
    arcface: IRSE50
    lpips: LPIPSVgg
    parser: FaceParsing
    schedule: Schedule
    device: torch.device

    @torch.no_grad()
    def id_embed(self, image: torch.Tensor) -> torch.Tensor:
        return extract_feats(self.arcface, image.to(self.device))

    def id_loss_fn(self, ref_image: torch.Tensor):
        """IDLoss.get_cosine_loss (``arcface_model.py:48-67``) against
        ``ref_image``'s embedding, SUMMED over the batch: with one image it
        is JAX's ``cosine_loss``, and in a batch each image's gradient is its
        own one-image gradient (a mean would scale it by 1/B)."""
        ref = self.id_embed(ref_image)
        return lambda img: (1.0 - cosine_sim(self.arcface, img, ref)).sum()

    def lpips_loss_fn(self, src_image: torch.Tensor):
        """LPIPS against ``src_image``, summed over the batch (see
        ``id_loss_fn``); the source's features are computed once."""
        with torch.no_grad():
            fy = self.lpips.features(src_image.to(self.device))
        return lambda img: self.lpips.distance(self.lpips.features(img), fy).sum()

    @torch.no_grad()
    def parse(self, image: torch.Tensor) -> torch.Tensor:
        return self.parser(image.to(self.device))


def _load_ddpm(unet: DDPMUNet, path: str) -> None:
    """The reference checkpoint: a DataParallel ``module.`` prefix stripped
    and ``logvar`` skipped, as ``convert_ddpm_ckpt`` does."""
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in load_torch_state(path).items()}
    load_known(unet, {k: v for k, v in state.items() if not k.startswith("logvar")},
               "celeba_ddpm")


def create_face_pipeline(*, tiny: bool = False, num_inference_steps: int = 100,
                         celeba_ckpt: Optional[str] = None, arcface_ckpt: Optional[str] = None,
                         lpips_ckpt: Optional[str] = None, parser_ckpt: Optional[str] = None,
                         seed: int = 0, device="cuda") -> FacePipeline:
    """Build the pipeline on ``device`` in float32.  The default device is the
    card; the CPU is taken only when asked for (``device="cpu"``).  Without a
    checkpoint a model takes seeded random weights, all drawn from one
    generator in the order UNet, ArcFace, LPIPS, parser."""
    device = torch.device(device)
    cfg = DDPMConfig.tiny() if tiny else DDPMConfig.celeba_hq()
    g = torch.Generator(device=device).manual_seed(seed)

    def build(make, ckpt, load):
        with torch.device(device):
            model = make()
        if ckpt:
            load(model, ckpt)
        else:
            seeded_init_(model, g)
        # channels-last conv weights: the models carry channels-last activations
        return model.to(memory_format=torch.channels_last).eval().requires_grad_(False)

    unet = build(lambda: DDPMUNet(cfg), celeba_ckpt, _load_ddpm)
    arc = build(IRSE50, arcface_ckpt,
                lambda m, p: load_known(m, load_torch_state(p), "ir_se50"))
    lp = build(LPIPSVgg, lpips_ckpt,
               lambda m, p: load_known(m, lpips_state(load_torch_state(p)), "lpips_vgg"))
    par = build(FaceParsing, parser_ckpt,
                lambda m, p: load_known(m, load_torch_state(p), "face_parser"))
    sched = Schedule.create(num_inference_steps, beta_schedule="linear", beta_start=1e-4,
                            beta_end=2e-2, steps_offset=1)
    return FacePipeline(unet=unet, arcface=arc, lpips=lp, parser=par, schedule=sched,
                        device=device)
