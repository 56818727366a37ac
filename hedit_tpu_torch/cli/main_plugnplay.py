"""Plug-and-Play editing CLI (port of ``hedit_tpu/cli/main_plugnplay.py``).

    python -m hedit_tpu_torch.cli.main_plugnplay --mode h_edit_R_pnp \\
        --image img.jpg --source_prompt "a cat" --target_prompt "a dog" \\
        [--tiny] [--device cpu]

The modes, flags and defaults are those of the JAX CLI: ``h_edit_R_pnp`` and
``ef_pnp`` after a DDPM inversion; ``h_edit_D_pnp``, ``pnp_inv_w_pnp``,
``np_pnp`` and ``nmg_pnp`` after a DDIM inversion (taken whenever ``--eta 0``
is given or the mode is one of those; the grid then has no step offset and
the edit runs at eta = 1).  PnP injects the source row's conv features over
the first ``int(N * pnp_f_t)`` editing steps and its self-attention q / k
over the first ``int(N * pnp_attn_t)``.  The h-Edit modes index their source
branch from the inversion's trajectory; EF / PnP-Inv + PnP derive the
inversion's residuals in the loop where they can (cfg_src 1 or a DDIM
inversion), and then, like NMG, null-text and negative-prompt + PnP, which
read none, run the inversion without its residual pass (the JAX CLI runs it
for ``nmg_pnp``, ``nt_pnp`` and ``np_pnp`` and drops its residuals).
``nt_pnp`` runs ``null_text_pnp`` at its defaults (up to 10 Adam iterations a
step, epsilon 1e-5, lr 1e-2), as the JAX CLI passes no
``--optimization_steps`` to it.

``--data_parallel B`` edits B images per UNet call on one device, with one
fixed generator an image, so the outputs are those of one run an image.  It
runs on the card (``--device cuda``, the default) and raises without one;
``--device cpu`` asks for the CPU.  Reading prompts needs the ``regex``
package (the CLIP tokenizer) and image files PIL.
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

MODES = ["h_edit_R_pnp", "h_edit_D_pnp", "ef_pnp", "pnp_inv_w_pnp", "nt_pnp", "np_pnp",
         "nmg_pnp"]
DDIM_MODES = ("h_edit_D_pnp", "pnp_inv_w_pnp", "nt_pnp", "np_pnp", "nmg_pnp")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="h-edit PnP editing (PyTorch port)")
    p.add_argument("--mode", type=str, default="h_edit_R_pnp", choices=MODES)
    p.add_argument("--source_prompt", type=str, default=None)
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--cfg_src", type=float, default=1.0)
    p.add_argument("--cfg_src_edit", type=float, default=5.0)
    p.add_argument("--cfg_tar", type=float, default=7.5)
    p.add_argument("--optimization_steps", type=int, default=1)
    p.add_argument("--pnp_f_t", type=float, default=0.45)
    p.add_argument("--pnp_attn_t", type=float, default=0.35)
    p.add_argument("--step_chunk", type=int, default=10,
                   help="inversion steps a UNet call in the residual pass")
    add_common_args(p)
    return p.parse_args(argv)


def is_ddim_mode(args) -> bool:
    return args.eta == 0 or args.mode in DDIM_MODES


def derives_zs(args) -> bool:
    """EF / PnP-Inv + PnP rebuild the inversion's residuals in the loop."""
    ddim = is_ddim_mode(args)
    return (args.mode in ("ef_pnp", "pnp_inv_w_pnp") and (args.cfg_src == 1.0 or ddim)
            and (args.eta > 0 or ddim))


def out_dir_name(args) -> str:
    return (f"{args.mode}_steps_{args.num_diffusion_steps}_skip_{args.skip}"
            f"_ft_{args.pnp_f_t}_attnt_{args.pnp_attn_t}")


def iter_samples(args):
    if args.image is not None:
        yield "single", {"image_path": args.image, "original_prompt": args.source_prompt or "",
                         "editing_prompt": args.target_prompt or ""}
        return
    yield from dataset_samples(args)


def edit_batch(args, pipe, batch, img_size, tokenizer):
    """Edit a list of (key, item) samples in one batched run of the mode's
    inversion and loop; returns the decoded images [B, H, W, 3] in [-1, 1]."""
    from hedit_tpu_torch.control.pnp import pnp_step_gates
    from hedit_tpu_torch.edit import h_edit_ctrl, pnp_baselines
    from hedit_tpu_torch.edit.h_edit import HEditConfig
    from hedit_tpu_torch.invert.ddim import invert_ddim
    from hedit_tpu_torch.invert.ddpm import invert_ddpm
    from hedit_tpu_torch.io_utils.images import load_image

    is_ddim = is_ddim_mode(args)
    eta = 1.0 if is_ddim else args.eta
    derive = derives_zs(args)
    N = args.num_diffusion_steps - args.skip
    qk_mask, conv_mask = pnp_step_gates(N, args.pnp_attn_t, args.pnp_f_t)
    images = np.concatenate([load_image(it["image_path"], size=img_size) for _, it in batch])
    x0s = pipe.vae_encode(torch.from_numpy(images))
    ids = np.concatenate([token_ids(tokenizer, pipe, ["", clean_prompt(it["original_prompt"]),
                                                      clean_prompt(it["editing_prompt"])],
                                    args.tiny) for _, it in batch])
    ctx3 = pipe.encode_token_ids(ids).reshape(len(batch), 3, 77, -1)
    unc, src = ctx3[:, 0], ctx3[:, 1]
    skip_zs = derive or args.mode in ("nmg_pnp", "nt_pnp", "np_pnp")
    if is_ddim:
        inv = invert_ddim(pipe.unet, pipe.schedule, x0s, uncond_ctx=unc, src_ctx=src,
                          cfg_scale=args.cfg_src, step_chunk=args.step_chunk, skip_zs=skip_zs)
    else:
        # one fixed generator an image: results do not depend on batching
        gens = [torch.Generator(device=pipe.device).manual_seed(0) for _ in batch]
        inv = invert_ddpm(pipe.unet, pipe.schedule, x0s, uncond_ctx=unc, src_ctx=src,
                          cfg_scale_src=args.cfg_src, eta=args.eta, generator=gens,
                          step_chunk=args.step_chunk, skip_zs=skip_zs)
    xts = inv.xts[:, : N + 1]
    xT = xts[:, N]
    gates = dict(after_skip_steps=N, qk_mask=qk_mask, conv_mask=conv_mask)
    if args.mode in ("h_edit_R_pnp", "h_edit_D_pnp"):
        cfg = HEditConfig(cfg_src=args.cfg_src, cfg_src_edit=args.cfg_src_edit,
                          cfg_tar=args.cfg_tar, eta=eta, is_ddim_inversion=is_ddim,
                          optimization_steps=args.optimization_steps)
        edited, _ = h_edit_ctrl.h_edit_pnp(pipe.unet, pipe.schedule, xT, inv.zs, ctx3=ctx3,
                                           cfg=cfg, xts=xts, **gates)
    elif args.mode in ("ef_pnp", "pnp_inv_w_pnp"):
        edited, _ = pnp_baselines.ef_or_pnp_inv_w_pnp(
            pipe.unet, pipe.schedule, xT, inv.zs, ctx3=ctx3, cfg_src=args.cfg_src,
            cfg_tar=args.cfg_tar, eta=eta, is_ddim_inversion=is_ddim, xts=xts,
            derive_zs=derive, **gates)
    elif args.mode == "nmg_pnp":
        edited, _ = pnp_baselines.nmg_pnp_loop(pipe.unet, pipe.schedule, xts=xts, ctx3=ctx3,
                                               cfg_tar=args.cfg_tar, **gates)
    elif args.mode == "nt_pnp":
        edited, _ = pnp_baselines.null_text_pnp(pipe.unet, pipe.schedule, xT, xts=xts, ctx3=ctx3,
                                                cfg_tar=args.cfg_tar, **gates)
    else:
        edited, _ = pnp_baselines.negative_prompt_pnp(pipe.unet, pipe.schedule, xT, ctx3=ctx3,
                                                      cfg_tar=args.cfg_tar, **gates)
    return pipe.vae_decode(edited)


def main(argv=None):
    args = parse_args(argv)
    from hedit_tpu_torch.models.tokenizer import CLIPTokenizer

    pipe = build_pipeline(args, steps_offset=0 if is_ddim_mode(args) else 1)
    tokenizer = CLIPTokenizer()
    img_size = pipe.vae.cfg.sample_size if args.tiny else 512
    run_batches(args, iter_samples(args), os.path.join(args.output_path, out_dir_name(args)),
                lambda batch: edit_batch(args, pipe, batch, img_size, tokenizer))
    return 0


if __name__ == "__main__":
    sys.exit(main())
