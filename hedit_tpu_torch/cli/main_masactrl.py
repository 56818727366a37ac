"""MasaCtrl editing CLI (port of ``hedit_tpu/cli/main_masactrl.py``).

    python -m hedit_tpu_torch.cli.main_masactrl --mode h_edit_R_masactrl \\
        --image img.jpg --target_prompt "a dog" [--tiny] [--device cpu]

The modes, flags and defaults are those of the JAX CLI: ``h_edit_R_masactrl``
and ``ef_masactrl`` after a DDPM inversion, ``h_edit_D_masactrl`` and
``pnp_inv_masactrl`` after a DDIM inversion (a DDIM inversion is taken
whenever ``--eta 0`` is given or the mode is a D or PnP-Inv mode; the grid
then has no step offset and the edit runs at eta = 1).  The source prompt is
empty (MasaCtrl's null-source convention); MasaCtrl starts at editing step
``--step`` and self-attention pair ``--layer``.  The h-Edit modes index their
source branch from the inversion's trajectory; EF / PnP-Inv + MasaCtrl take
the 4-row pair step.  ``--data_parallel B`` edits B images per UNet call on
one device, with one fixed generator an image, so the outputs are those of
one run an image.  It runs on the card (``--device cuda``, the default) and
raises without one; ``--device cpu`` asks for the CPU.  Reading prompts
needs the ``regex`` package (the CLIP tokenizer) and image files PIL.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from hedit_tpu_torch.cli.common import (
    add_common_args, build_pipeline, clean_prompt, dataset_samples, run_batches, token_ids,
)

MODES = ["h_edit_D_masactrl", "h_edit_R_masactrl", "pnp_inv_masactrl", "ef_masactrl"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="h-edit MasaCtrl editing (PyTorch port)")
    p.add_argument("--mode", type=str, default="h_edit_R_masactrl", choices=MODES)
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--cfg_src", type=float, default=1.0)
    p.add_argument("--cfg_src_edit", type=float, default=5.0)
    p.add_argument("--cfg_tar", type=float, default=7.5)
    p.add_argument("--optimization_steps", type=int, default=1)
    p.add_argument("--step", type=int, default=4, help="MasaCtrl start step")
    p.add_argument("--layer", type=int, default=10, help="MasaCtrl start layer")
    p.add_argument("--step_chunk", type=int, default=10,
                   help="inversion steps a UNet call in the residual pass")
    add_common_args(p)
    return p.parse_args(argv)


def is_ddim_mode(args) -> bool:
    return args.eta == 0 or "D" in args.mode or "pnp_inv" in args.mode


def iter_samples(args):
    if args.image is not None:
        yield "single", {"image_path": args.image, "editing_prompt": args.target_prompt or ""}
        return
    yield from dataset_samples(args)


def edit_batch(args, pipe, batch, img_size, tokenizer):
    """Edit a list of (key, item) samples in one batched run of the mode's
    inversion and loop; returns the decoded images [B, H, W, 3] in [-1, 1]."""
    from hedit_tpu_torch.control.masactrl import MasaCtrlControl
    from hedit_tpu_torch.edit.baselines import ef_or_pnp_inv_p2p
    from hedit_tpu_torch.edit.h_edit import HEditConfig
    from hedit_tpu_torch.edit.h_edit_ctrl import h_edit_masactrl
    from hedit_tpu_torch.invert.ddim import invert_ddim
    from hedit_tpu_torch.invert.ddpm import invert_ddpm
    from hedit_tpu_torch.io_utils.images import load_image

    is_ddim = is_ddim_mode(args)
    eta = 1.0 if is_ddim else args.eta
    N = args.num_diffusion_steps - args.skip
    images = np.concatenate([load_image(it["image_path"], size=img_size) for _, it in batch])
    x0s = pipe.vae_encode(torch.from_numpy(images))
    # [uncond, src, tar] with the empty source prompt (MasaCtrl's null source)
    ids = np.concatenate([token_ids(tokenizer, pipe, ["", "", clean_prompt(it["editing_prompt"])],
                                    args.tiny) for _, it in batch])
    ctx3 = pipe.encode_token_ids(ids).reshape(len(batch), 3, 77, -1)
    unc, src = ctx3[:, 0], ctx3[:, 1]
    if is_ddim:
        inv = invert_ddim(pipe.unet, pipe.schedule, x0s, uncond_ctx=unc, src_ctx=src,
                          cfg_scale=args.cfg_src, step_chunk=args.step_chunk)
    else:
        # one fixed generator an image: results do not depend on batching
        gens = [torch.Generator(device=pipe.device).manual_seed(0) for _ in batch]
        inv = invert_ddpm(pipe.unet, pipe.schedule, x0s, uncond_ctx=unc, src_ctx=src,
                          cfg_scale_src=args.cfg_src, eta=args.eta, generator=gens,
                          step_chunk=args.step_chunk)
    xT, zs = inv.xts[:, N], inv.zs
    if args.mode in ("h_edit_R_masactrl", "h_edit_D_masactrl"):
        cfg = HEditConfig(cfg_src=args.cfg_src, cfg_src_edit=args.cfg_src_edit,
                          cfg_tar=args.cfg_tar, eta=eta, is_ddim_inversion=is_ddim,
                          optimization_steps=args.optimization_steps)
        edited, _ = h_edit_masactrl(pipe.unet, pipe.schedule, xT, zs, ctx3=ctx3, cfg=cfg,
                                    after_skip_steps=N, start_step=args.step,
                                    start_layer=args.layer, xts=inv.xts[:, : N + 1])
    else:
        control = MasaCtrlControl(start_step=args.step, start_layer=args.layer,
                                  num_images=len(batch))
        edited, _ = ef_or_pnp_inv_p2p(pipe.unet, pipe.schedule, xT, zs, ctx3=ctx3,
                                      cfg_src=args.cfg_src, cfg_tar=args.cfg_tar, eta=eta,
                                      is_ddim_inversion=is_ddim, after_skip_steps=N,
                                      control=control)
    return pipe.vae_decode(edited)


def main(argv=None):
    args = parse_args(argv)
    from hedit_tpu_torch.models.tokenizer import CLIPTokenizer

    pipe = build_pipeline(args, steps_offset=0 if is_ddim_mode(args) else 1)
    tokenizer = CLIPTokenizer()
    out_dir = os.path.join(args.output_path,
                           f"{args.mode}_steps_{args.num_diffusion_steps}_skip_{args.skip}")
    img_size = pipe.vae.cfg.sample_size if args.tiny else 512
    run_batches(args, iter_samples(args), out_dir,
                lambda batch: edit_batch(args, pipe, batch, img_size, tokenizer))
    return 0


if __name__ == "__main__":
    sys.exit(main())
