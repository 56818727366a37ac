"""Text-guided editing CLI, P2P family (port of ``hedit_tpu/cli/main_p2p.py``).

    python -m hedit_tpu_torch.cli.main_p2p --mode h_edit_R_p2p --implicit \\
        --image img.jpg --source_prompt "a cat" --target_prompt "a dog" [--tiny]
    python -m hedit_tpu_torch.cli.main_p2p --mode nmg_p2p --eta 0 --image ...

The flags and their defaults are those of the JAX CLI.  This port runs two
modes on one device: the flagship ``h_edit_R_p2p --implicit`` configuration
(cfg_src == 1, one optimisation step, eta > 0), and ``nmg_p2p`` (alias
``nmg``, which runs without a P2P edit) with ``--eta 0``: DDIM inversion, then
Noise Map Guidance + P2P, whose every step differentiates through the UNet.
``--data_parallel B`` edits B images per batched UNet call.  Every other mode
raises NotImplementedError naming its ROADMAP item.  It runs on the card
(``--device cuda``, the default) and raises without one; ``--device cpu`` asks
for the CPU.  Reading prompts needs the ``regex`` package (the CLIP
tokenizer) and reading or writing images needs PIL; both are imported only
here, when the CLI runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

MODES = ["h_edit_R", "h_edit_D_p2p", "h_edit_R_p2p", "ef", "ef_p2p", "nmg", "nmg_p2p",
         "pnp_inv_p2p"]
PORTED_MODES = ("h_edit_R_p2p", "nmg", "nmg_p2p")
# PieBench keys for which the Replace controller may be used (main_p2p.py:179-188),
# and only by the h_edit modes
DDPM_REPLACE_KEYS = {"122000000005", "122000000006", "000000000099", "214000000009"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="h-edit text-guided editing (PyTorch port)")
    p.add_argument("--mode", type=str, default="h_edit_R_p2p", choices=MODES)
    p.add_argument("--device_num", type=int, default=0)
    p.add_argument("--data_path", type=str, default="data")
    p.add_argument("--output_path", type=str, default="results")
    p.add_argument("--mapping_file", type=str, default=None)
    p.add_argument("--image", type=str, default=None, help="single-image mode")
    p.add_argument("--source_prompt", type=str, default=None)
    p.add_argument("--target_prompt", type=str, default=None)
    p.add_argument("--blended_word", type=str, default="")
    p.add_argument("--edit_category_list", nargs="+", type=str,
                   default=["0", "1", "2", "3", "4", "5", "6", "7", "8", "9"])
    p.add_argument("--num_diffusion_steps", type=int, default=50)
    p.add_argument("--skip", type=int, default=0)
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
                   help="UNet rows a call when an inversion computes residuals; "
                        "neither ported mode does (the flagship derives them "
                        "in-loop, NMG reads none)")
    p.add_argument("--save_trajectory", type=str, default=None, metavar="NPZ")
    p.add_argument("--load_trajectory", type=str, default=None, metavar="NPZ")
    p.add_argument("--data_parallel", type=int, default=0, metavar="B",
                   help="edit B images per batched UNet call on one device")
    p.add_argument("--resume", action="store_true",
                   help="skip a sample whose output file already exists")
    p.add_argument("--weights", type=str, default=os.environ.get("HEDIT_SD_WEIGHTS"),
                   help="diffusers-layout checkpoint dir (unet/ vae/ text_encoder/)")
    p.add_argument("--tiny", action="store_true",
                   help="seeded tiny random-init model (no pretrained weights)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 model compute")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU only when asked for (--device cpu)")
    args = p.parse_args(argv)
    if args.mode in ("h_edit_R", "h_edit_R_p2p", "ef", "ef_p2p"):
        assert args.eta > 0, f"{args.mode} requires eta > 0 (DDPM inversion)"
    if args.mode in ("nmg", "nmg_p2p", "pnp_inv_p2p", "h_edit_D_p2p"):
        assert args.eta == 0, f"{args.mode} requires eta == 0 (DDIM inversion)"
    return args


def iter_samples(args):
    if args.image is not None:
        yield "single", {"image_path": args.image,
                         "original_prompt": args.source_prompt or "",
                         "editing_prompt": args.target_prompt or "",
                         "blended_word": args.blended_word, "editing_type_id": "0"}
        return
    from hedit_tpu_torch.io_utils.images import dataset_from_json

    mapping = args.mapping_file or os.path.join(args.data_path, "mapping_file.json")
    for key, item in dataset_from_json(mapping).items():
        if item.get("editing_type_id", "0") not in args.edit_category_list:
            continue
        item = dict(item)
        if not os.path.isabs(item["image_path"]):
            item["image_path"] = os.path.join(args.data_path, "annotation_images",
                                              item["image_path"])
        yield key, item


def _clean(prompt: str) -> str:
    return prompt.replace("[", "").replace("]", "")


def token_ids(tokenizer, pipe, prompts, tiny: bool) -> np.ndarray:
    """CLIP BPE ids [len(prompts), 77]; the tiny model folds them into its toy vocab."""
    ids = np.asarray(tokenizer(prompts))
    return ids % pipe.text_model.cfg.vocab_size if tiny else ids


def build_sample_controls(args, pipe, key, item, N, tokenizer, blend_res):
    """One image's (P2P control, LocalBlend) as ``build_sample_controls``
    builds them (``hedit_tpu/cli/main_p2p.py:128-188``), with cond_start=2."""
    from hedit_tpu_torch.control.p2p import (
        build_p2p_control, init_local_blend, neutral_blend, neutral_control,
    )

    nominal = pipe.unet.cfg.sample_size // 4
    heads = pipe.unet.cfg.num_heads
    if args.tiny or not args.mode.endswith("p2p"):
        return (neutral_control(N, nominal * nominal, cond_start=2),
                neutral_blend(N, heads, blend_res))
    src, tar = _clean(item["original_prompt"]), _clean(item["editing_prompt"])
    blended = item.get("blended_word", "")
    blended = blended.split(" ") if blended else []
    prompts = [src, tar]
    is_replace = (args.mode == "h_edit_R_p2p" and key in DDPM_REPLACE_KEYS
                  and len(src.split(" ")) == len(tar.split(" ")))
    # the JAX CLI reweights by 1.25 in the h_edit modes with several
    # optimisation steps, else by 2.0
    eq_params = {"words": (blended[1],), "values": (2.0,)} if len(blended) >= 2 else None
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


def _out_path(out_dir, item):
    return os.path.join(out_dir, os.path.basename(item["image_path"]).rsplit(".", 1)[0] + ".png")


def edit_batch(args, pipe, cfg, batch, img_size, tokenizer):
    """Edit a list of (key, item) samples in one batched run of the mode's
    loop; returns the decoded images [B, H, W, 3] in [-1, 1]."""
    from hedit_tpu_torch.control.p2p import stack_blends, stack_controls
    from hedit_tpu_torch.io_utils.images import load_image

    N = args.num_diffusion_steps - args.skip
    images = np.concatenate([load_image(it["image_path"], size=img_size) for _, it in batch])
    x0s = pipe.vae_encode(torch.from_numpy(images))
    ids = np.concatenate([token_ids(tokenizer, pipe, ["", _clean(it["original_prompt"]),
                                                      _clean(it["editing_prompt"])], args.tiny)
                          for _, it in batch])
    ctx3 = pipe.encode_token_ids(ids).reshape(len(batch), 3, 77, -1)  # [uncond, src, tar]
    res = img_size // 8 // 4
    controls = [build_sample_controls(args, pipe, key, it, N, tokenizer, res)
                for key, it in batch]
    control = stack_controls([c for c, _ in controls]).to(pipe.device)
    blend = stack_blends([b for _, b in controls]).to(pipe.device)
    if args.mode == "h_edit_R_p2p":
        from hedit_tpu_torch.edit.h_edit_p2p import h_edit_p2p_flagship
        from hedit_tpu_torch.invert.ddpm import sample_xts_from_x0

        xts = []
        for x0 in x0s:  # one fixed generator per sample: results do not depend on batching
            g = torch.Generator(device=pipe.device).manual_seed(args.device_num)
            xts.append(sample_xts_from_x0(pipe.schedule, x0[None], g)[: N + 1])
        edited = h_edit_p2p_flagship(pipe.unet, pipe.schedule, cfg, xts=torch.stack(xts),
                                     ctx4=ctx3[:, [0, 1, 1, 2]], control=control,
                                     local_blend=blend, after_skip_steps=N)
    else:
        from hedit_tpu_torch.edit.baselines import nmg_p2p
        from hedit_tpu_torch.invert.ddim import invert_ddim

        # NMG reads the inversion's trajectory and none of its residuals
        inv = invert_ddim(pipe.unet, pipe.schedule, x0s, uncond_ctx=ctx3[:, 0],
                          src_ctx=ctx3[:, 1], cfg_scale=args.cfg_src,
                          step_chunk=args.step_chunk, skip_zs=True)
        edited, _ = nmg_p2p(pipe.unet, pipe.schedule, xts=inv.xts[:, : N + 1], ctx3=ctx3,
                            cfg_tar=args.cfg_tar, control=control, local_blend=blend,
                            after_skip_steps=N)
    return pipe.vae_decode(edited)


def main(argv=None):
    args = parse_args(argv)
    if args.mode not in PORTED_MODES:
        raise NotImplementedError(
            f"--mode {args.mode} is not ported yet (ROADMAP.md queue 1 item 7); "
            "the port runs h_edit_R_p2p --implicit and nmg_p2p --eta 0")
    if args.save_trajectory or args.load_trajectory:
        raise NotImplementedError("trajectory capture / injection is not ported yet "
                                  "(ROADMAP.md queue 1 item 7)")
    if args.mode == "h_edit_R_p2p" and not (args.implicit and args.cfg_src == 1.0
                                            and args.optimization_steps == 1):
        raise NotImplementedError(
            "of h_edit_R_p2p the port runs the flagship configuration only (--implicit, "
            "--cfg_src 1, --optimization_steps 1); the general h-Edit loops are "
            "ROADMAP.md queue 1 item 7")
    from hedit_tpu_torch.core.schedule import Schedule
    from hedit_tpu_torch.edit.h_edit import HEditConfig
    from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

    cfg = HEditConfig(cfg_src_edit=args.cfg_src_edit, cfg_tar=args.cfg_tar, eta=args.eta)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; the port runs on the card unless "
                           "--device cpu is given")
    pipe = create_sd_pipeline(None if args.tiny else args.weights, tiny=args.tiny,
                              num_inference_steps=args.num_diffusion_steps,
                              dtype=torch.bfloat16 if args.bf16 else torch.float32,
                              device=args.device)
    if args.eta == 0:  # the DDIM modes build their schedule without the offset
        pipe = dataclasses.replace(pipe, schedule=Schedule.create(args.num_diffusion_steps,
                                                                   steps_offset=0))
    from hedit_tpu_torch.io_utils.images import to_pil
    from hedit_tpu_torch.models.tokenizer import CLIPTokenizer

    tokenizer = CLIPTokenizer()

    weight_str = (f"eta_{args.eta}_src_orig_{args.cfg_src}_src_edit_{args.cfg_src_edit}"
                  f"_tar_scale_{args.cfg_tar}_w_rec_{args.weight_reconstruction}"
                  f"_n_opts_{args.optimization_steps}")
    xa_sa = f"xa_{args.xa}_sa{args.sa}" if args.mode.endswith("p2p") else ""
    out_dir = os.path.join(args.output_path,
                           f"{args.mode}_total_steps_{args.num_diffusion_steps}_skip_"
                           f"{args.skip}_{weight_str}_{xa_sa}")
    os.makedirs(out_dir, exist_ok=True)
    img_size = pipe.vae.cfg.sample_size if args.tiny else 512
    B = max(args.data_parallel, 1)
    todo = []
    for key, item in iter_samples(args):
        if args.resume and os.path.exists(_out_path(out_dir, item)):
            print(f"[{key}] output exists, skipping (--resume)")
            continue
        todo.append((key, item))
    for start in range(0, len(todo), B):
        batch = todo[start:start + B]
        images = edit_batch(args, pipe, cfg, batch, img_size, tokenizer)
        for (key, item), img in zip(batch, images.cpu().numpy()):
            path = _out_path(out_dir, item)
            to_pil(img[None]).save(path)
            print(f"[{key}] saved {path}")
    print(f"done: {len(todo)} samples -> {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
