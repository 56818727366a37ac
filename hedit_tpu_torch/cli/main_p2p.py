"""Text-guided editing CLI, P2P family (port of ``hedit_tpu/cli/main_p2p.py``).

    python -m hedit_tpu_torch.cli.main_p2p --mode h_edit_R_p2p --implicit \\
        --image img.jpg --source_prompt "a cat" --target_prompt "a dog" [--tiny]
    python -m hedit_tpu_torch.cli.main_p2p --mode nmg_p2p --eta 0 --image ...

The modes, flags and defaults are those of the JAX CLI: ``h_edit_R``,
``h_edit_R_p2p``, ``ef``, ``ef_p2p`` after a DDPM inversion (eta > 0), and
``h_edit_D_p2p``, ``pnp_inv_p2p``, ``nmg_p2p`` (alias ``nmg``, which runs
without a P2P edit) after a DDIM inversion (``--eta 0``).  Every loop is
batched over images: ``--data_parallel B`` edits B images per UNet call on one
device.  ``--save_trajectory`` / ``--load_trajectory`` capture and inject one
image's inversion.  It runs on the card (``--device cuda``, the default) and
raises without one; ``--device cpu`` asks for the CPU.  Reading prompts needs
the ``regex`` package (the CLIP tokenizer) and reading or writing images needs
PIL; both are imported only here, when the CLI runs.
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

MODES = ["h_edit_R", "h_edit_D_p2p", "h_edit_R_p2p", "ef", "ef_p2p", "nmg", "nmg_p2p",
         "pnp_inv_p2p"]
# PieBench keys for which the Replace controller may be used (main_p2p.py:179-188),
# and only by the h_edit modes
DDIM_REPLACE_KEYS = {"111000000001", "111000000004", "111000000009", "121000000007",
                     "122000000006", "121000000000", "121000000001"}
DDPM_REPLACE_KEYS = {"122000000005", "122000000006", "000000000099", "214000000009"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="h-edit text-guided editing (PyTorch port)")
    p.add_argument("--mode", type=str, default="h_edit_R_p2p", choices=MODES)
    p.add_argument("--device_num", type=int, default=0)
    p.add_argument("--source_prompt", type=str, default=None)
    p.add_argument("--blended_word", type=str, default="")
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--cfg_src", type=float, default=1.0)
    p.add_argument("--cfg_src_edit", type=float, default=5.0)
    p.add_argument("--cfg_tar", type=float, default=7.5)
    p.add_argument("--implicit", action="store_true")
    p.add_argument("--optimization_steps", type=int, default=1)
    p.add_argument("--weight_reconstruction", type=float, default=0.1)
    p.add_argument("--xa", type=float, default=0.4)
    p.add_argument("--sa", type=float, default=0.35)
    p.add_argument("--step_chunk", type=int, default=10,
                   help="inversion steps a UNet call when an inversion computes "
                        "residuals (twice as many rows when --cfg_src != 1); a "
                        "loop that derives them itself runs no such pass")
    p.add_argument("--save_trajectory", type=str, default=None, metavar="NPZ",
                   help="capture the inversion trajectory (xts, zs, q-noises) to an npz")
    p.add_argument("--load_trajectory", type=str, default=None, metavar="NPZ",
                   help="inject a captured trajectory instead of inverting (this "
                        "package's, the JAX package's or an NCHW capture)")
    add_common_args(p)
    args = p.parse_args(argv)
    if args.mode in ("h_edit_R", "h_edit_R_p2p", "ef", "ef_p2p"):
        assert args.eta > 0, f"{args.mode} requires eta > 0 (DDPM inversion)"
    if args.mode in ("nmg", "nmg_p2p", "pnp_inv_p2p", "h_edit_D_p2p"):
        assert args.eta == 0, f"{args.mode} requires eta == 0 (DDIM inversion)"
    # A trajectory encodes ONE source image (xts[0] is its encoded latent):
    # injected into a dataset sweep it would edit every sample against the
    # wrong trajectory, and a capture over a sweep would keep the last sample.
    if args.save_trajectory or args.load_trajectory:
        if args.image is None:
            p.error("--save_trajectory/--load_trajectory encode a single source image; "
                    "use single-image mode (--image ...)")
        if args.data_parallel > 0:
            p.error("trajectory capture/inject is not supported with --data_parallel")
    return args


def iter_samples(args):
    if args.image is not None:
        yield "single", {"image_path": args.image,
                         "original_prompt": args.source_prompt or "",
                         "editing_prompt": args.target_prompt or "",
                         "blended_word": args.blended_word, "editing_type_id": "0"}
        return
    yield from dataset_samples(args)


def build_sample_controls(args, pipe, key, item, N, tokenizer, blend_res):
    """One image's (P2P control, LocalBlend) as ``build_sample_controls``
    builds them (``hedit_tpu/cli/main_p2p.py:128-188``).  The loops set
    ``cond_start`` themselves.  Where the JAX CLI passes no control or no
    blend, a neutral one stands in: every image of a batch carries both."""
    from hedit_tpu_torch.control.p2p import (
        build_p2p_control, init_local_blend, neutral_blend, neutral_control,
    )

    nominal = pipe.unet.cfg.sample_size // 4
    heads = pipe.unet.cfg.num_heads
    if args.tiny or not args.mode.endswith("p2p"):
        return (neutral_control(N, nominal * nominal, cond_start=2),
                neutral_blend(N, heads, blend_res))
    src, tar = clean_prompt(item["original_prompt"]), clean_prompt(item["editing_prompt"])
    blended = item.get("blended_word", "")
    blended = blended.split(" ") if blended else []
    prompts = [src, tar]
    h_edit = args.mode in ("h_edit_R_p2p", "h_edit_D_p2p")
    keys = DDIM_REPLACE_KEYS if args.eta == 0 else DDPM_REPLACE_KEYS
    is_replace = h_edit and key in keys and len(src.split(" ")) == len(tar.split(" "))
    eq_val = 1.25 if h_edit and args.optimization_steps > 1 else 2.0
    eq_params = {"words": (blended[1],), "values": (eq_val,)} if len(blended) >= 2 else None
    # the store filter compares against the config-nominal num_pixels of the
    # LayerTags; only the LocalBlend buffer takes the runtime grid
    control = build_p2p_control(
        num_steps=N, cross_replace_steps=args.xa, self_replace_steps=args.sa,
        prompts=prompts, tokenizer=tokenizer, is_replace=is_replace, eq_params=eq_params,
        blend_px=nominal * nominal, cond_start=2)
    if len(blended) >= 2:
        blend = init_local_blend(prompts, ((blended[0],), (blended[1],)), tokenizer,
                                 num_steps=N, heads=heads, res=blend_res)
    else:
        blend = neutral_blend(N, heads, blend_res)
    return control, blend


def load_injected(args, pipe, x0s):
    """The trajectory of ``--load_trajectory``, cross-checked against THIS
    image's encoded latent: a trajectory replayed onto another source image
    breaks the reconstruction identity and gives silent garbage."""
    from hedit_tpu_torch.io_utils.trajectory import load_trajectory

    traj = load_trajectory(args.load_trajectory, expect_steps=args.num_diffusion_steps,
                           device=pipe.device)
    if traj.xts.shape[2:] == x0s.shape[1:]:
        drift = float((traj.xts[:, 0] - x0s).abs().max())
        if drift > 0.05:
            print(f"WARNING: injected trajectory xts[0] differs from this image's "
                  f"encoded latent (max|diff|={drift:.3f}); the capture came from a "
                  f"different image or encoder", file=sys.stderr)
    return traj


def invert_batch(args, pipe, x0s, ctx3, skip_zs: bool):
    """The mode's inversion of the encoded images x0s [B, H, W, C]."""
    from hedit_tpu_torch.invert.ddim import invert_ddim
    from hedit_tpu_torch.invert.ddpm import invert_ddpm

    if args.eta == 0:
        return invert_ddim(pipe.unet, pipe.schedule, x0s, uncond_ctx=ctx3[:, 0],
                           src_ctx=ctx3[:, 1], cfg_scale=args.cfg_src,
                           step_chunk=args.step_chunk, skip_zs=skip_zs)
    # one fixed generator per sample: results do not depend on batching
    gens = [torch.Generator(device=pipe.device).manual_seed(args.device_num) for _ in x0s]
    return invert_ddpm(pipe.unet, pipe.schedule, x0s, uncond_ctx=ctx3[:, 0],
                       src_ctx=ctx3[:, 1], cfg_scale_src=args.cfg_src, eta=args.eta,
                       generator=gens, step_chunk=args.step_chunk, skip_zs=skip_zs)


def edit_batch(args, pipe, batch, img_size, tokenizer):
    """Edit a list of (key, item) samples in one batched run of the mode's
    inversion and loop (``run_sample``, ``hedit_tpu/cli/main_p2p.py:191-342``);
    returns the decoded images [B, H, W, 3] in [-1, 1]."""
    from hedit_tpu_torch.control.p2p import stack_blends, stack_controls
    from hedit_tpu_torch.edit.baselines import ef_or_pnp_inv_p2p, nmg_p2p
    from hedit_tpu_torch.edit.h_edit import HEditConfig, ef_sample, h_edit_r
    from hedit_tpu_torch.edit.h_edit_p2p import h_edit_p2p
    from hedit_tpu_torch.io_utils.images import load_image

    is_ddim = args.eta == 0
    eta = 1.0 if is_ddim else args.eta   # eta = 1 after a DDIM inversion (:164-165)
    N = args.num_diffusion_steps - args.skip
    images = np.concatenate([load_image(it["image_path"], size=img_size) for _, it in batch])
    x0s = pipe.vae_encode(torch.from_numpy(images))
    ids = np.concatenate([token_ids(tokenizer, pipe, ["", clean_prompt(it["original_prompt"]),
                                                      clean_prompt(it["editing_prompt"])],
                                    args.tiny) for _, it in batch])
    ctx3 = pipe.encode_token_ids(ids).reshape(len(batch), 3, 77, -1)  # [uncond, src, tar]

    # Inversion-free stepping: an h-Edit P2P loop rebuilds the residuals from
    # its own controller-source row, and in EF / PnP-Inv + P2P the
    # indexed-source row doubles as the inversion's evaluation; the inversion
    # then runs no residual pass.  A capture WITH zs replays those instead.
    traj = load_injected(args, pipe, x0s) if args.load_trajectory else None
    have_zs = traj is not None and traj.zs is not None
    derive_zs = (args.mode in ("h_edit_R_p2p", "h_edit_D_p2p") and args.implicit
                 and args.cfg_src == 1.0 and eta > 0 and not have_zs)
    derive_base = (args.mode in ("ef_p2p", "pnp_inv_p2p") and (args.cfg_src == 1.0 or is_ddim)
                   and (eta > 0 or is_ddim) and not have_zs)
    if traj is not None and not (have_zs or derive_zs or derive_base):
        raise ValueError("injected trajectory has no zs and this mode/config cannot "
                         "derive them in-loop; re-capture with zs")
    # NMG reads the trajectory and none of the residuals
    inv = traj if traj is not None else invert_batch(
        args, pipe, x0s, ctx3, derive_zs or derive_base or args.mode in ("nmg", "nmg_p2p"))
    if args.save_trajectory:
        from hedit_tpu_torch.io_utils.trajectory import save_trajectory

        save_trajectory(args.save_trajectory, inv)
    xT, zs, xts = inv.xts[:, N], inv.zs, inv.xts[:, : N + 1]

    res = img_size // 8 // 4
    controls = [build_sample_controls(args, pipe, key, it, N, tokenizer, res)
                for key, it in batch]
    control = stack_controls([c for c, _ in controls]).to(pipe.device)
    blend = stack_blends([b for _, b in controls]).to(pipe.device)
    cfg = HEditConfig(cfg_src=args.cfg_src, cfg_src_edit=args.cfg_src_edit,
                      cfg_tar=args.cfg_tar, eta=eta, is_ddim_inversion=is_ddim,
                      implicit=args.implicit, optimization_steps=args.optimization_steps,
                      weight_reconstruction=args.weight_reconstruction)
    common = dict(ctx3=ctx3, after_skip_steps=N)
    if args.mode == "h_edit_R":
        edited, _ = h_edit_r(pipe.unet, pipe.schedule, xT, zs, cfg=cfg, **common)
    elif args.mode in ("h_edit_R_p2p", "h_edit_D_p2p"):
        edited, _ = h_edit_p2p(pipe.unet, pipe.schedule, xT, zs, cfg=cfg, control=control,
                               local_blend=blend, xts=xts, derive_zs=derive_zs, **common)
    elif args.mode == "ef":
        edited = ef_sample(pipe.unet, pipe.schedule, xT, zs, cfg_tar=args.cfg_tar, eta=eta,
                           is_ddim_inversion=is_ddim, **common)
    elif args.mode in ("ef_p2p", "pnp_inv_p2p"):
        edited, _ = ef_or_pnp_inv_p2p(
            pipe.unet, pipe.schedule, xT, zs, cfg_src=args.cfg_src, cfg_tar=args.cfg_tar,
            eta=eta, is_ddim_inversion=is_ddim, control=control, local_blend=blend,
            xts=xts,                 # indexed source branch: 3 rows an image
            derive_zs=derive_base, **common)
    else:
        edited, _ = nmg_p2p(pipe.unet, pipe.schedule, xts=xts, cfg_tar=args.cfg_tar,
                            control=control, local_blend=blend, **common)
    return pipe.vae_decode(edited)


def main(argv=None):
    args = parse_args(argv)
    from hedit_tpu_torch.models.tokenizer import CLIPTokenizer

    # the DDIM modes build their schedule without the offset
    pipe = build_pipeline(args, steps_offset=0 if args.eta == 0 else 1)
    tokenizer = CLIPTokenizer()
    weight_str = (f"eta_{args.eta}_src_orig_{args.cfg_src}_src_edit_{args.cfg_src_edit}"
                  f"_tar_scale_{args.cfg_tar}_w_rec_{args.weight_reconstruction}"
                  f"_n_opts_{args.optimization_steps}")
    xa_sa = f"xa_{args.xa}_sa{args.sa}" if args.mode.endswith("p2p") else ""
    out_dir = os.path.join(args.output_path,
                           f"{args.mode}_total_steps_{args.num_diffusion_steps}_skip_"
                           f"{args.skip}_{weight_str}_{xa_sa}")
    img_size = pipe.vae.cfg.sample_size if args.tiny else 512
    run_batches(args, iter_samples(args), out_dir,
                lambda batch: edit_batch(args, pipe, batch, img_size, tokenizer))
    return 0


if __name__ == "__main__":
    sys.exit(main())
