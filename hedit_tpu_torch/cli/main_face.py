"""Face-swapping CLI (port of ``hedit_tpu/cli/main_face.py``, itself
``face-swapping/main_edit.py``'s).

    python -m hedit_tpu_torch.cli.main_face --mode h_edit_R \\
        --ref ref.png --source source.png [--tiny] [--device cpu]

Modes ``h_edit_R`` (reward-guided implicit h-Edit) and ``ef``.  The flags
and quirks are the JAX CLI's: ``--eta`` must be 1.0; ``--weight_edit_face``
becomes 100 with ``--optimization_steps 1``; ``--post_processing`` is
``store_false``, so the mask blend is on by default and the flag turns it
off; the checkpoint flags fall back to the ``HEDIT_*_CKPT`` environment
variables; the inversion draws from a generator seeded with 42; the output
is ``item_{ref}_{source}.png``, a grid of [ref, source, edited]; a pair is
read from ``--ref`` / ``--source`` or from a ``--data_file`` JSON of
``{idx, ref, source}`` entries joined under ``--image_path``.

``--data_parallel B`` edits B pairs per batched run on one device.  Each
pair draws its inversion from its own seed-42 generator and descends its
own losses (summed over the batch, not averaged), and the mask blend runs
one image at a time, so each output is its one-pair result.  It runs on the
card (``--device cuda``, the default) and raises without one; ``--device
cpu`` asks for the CPU.  Reading images needs PIL.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="h-edit face swapping (PyTorch port)")
    p.add_argument("--mode", type=str, default="h_edit_R", choices=["h_edit_R", "ef"])
    p.add_argument("--data_file", type=str, default=None,
                   help="JSON [{idx, ref, source}] (assets/demo/demo.json layout)")
    p.add_argument("--image_path", type=str, default=None,
                   help="base dir joined onto the JSON's ref/source entries "
                        "(defaults to the --data_file directory)")
    p.add_argument("--ref", type=str, default=None)
    p.add_argument("--source", type=str, default=None)
    p.add_argument("--output_path", type=str, default="results")
    p.add_argument("--num_diffusion_steps", type=int, default=100)
    p.add_argument("--skip", type=int, default=0)
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--optimization_steps", type=int, default=3)
    p.add_argument("--weight_edit_face", type=float, default=50.0)
    p.add_argument("--post_processing", action="store_false",
                   help="ON by default; passing the flag DISABLES it (reference quirk)")
    p.add_argument("--celeba_ckpt", type=str, default=os.environ.get("HEDIT_CELEBA_CKPT"))
    p.add_argument("--arcface_ckpt", type=str, default=os.environ.get("HEDIT_ARCFACE_CKPT"))
    p.add_argument("--lpips_ckpt", type=str, default=os.environ.get("HEDIT_LPIPS_CKPT"))
    p.add_argument("--parser_ckpt", type=str, default=os.environ.get("HEDIT_PARSER_CKPT"))
    p.add_argument("--resume", action="store_true",
                   help="skip a pair when its output exists")
    p.add_argument("--data_parallel", type=int, default=0, metavar="B",
                   help="edit B pairs per batched run on one device; 0 = one pair a run")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--step_chunk", type=int, default=1,
                   help="inversion steps a UNet call (JAX's default is 10; at 2-10 float32 "
                        "rows cuDNN's heuristics pick a slow FFT convolution, see invert/sde.py)")
    p.add_argument("--save_trajectory", type=str, default=None, metavar="NPZ",
                   help="capture the SDE inversion trajectory for replay")
    p.add_argument("--load_trajectory", type=str, default=None, metavar="NPZ",
                   help="inject a captured trajectory (ours or torch NCHW)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU only when asked for (--device cpu)")
    args = p.parse_args(argv)
    # A trajectory encodes ONE source image; over --data_file it would be
    # injected into every pair (or overwritten once per pair on capture).
    if (args.save_trajectory or args.load_trajectory) and args.data_file:
        p.error("--save_trajectory/--load_trajectory encode a single source "
                "image; use --ref/--source instead of --data_file")
    if args.data_parallel > 0 and (args.save_trajectory or args.load_trajectory):
        p.error("trajectory capture/injection encodes a single pair; it is "
                "incompatible with --data_parallel")
    if args.eta != 1.0:
        raise ValueError("face swapping requires eta == 1.0 (main_edit.py:64)")
    if args.optimization_steps == 1 and args.weight_edit_face == 50.0:
        args.weight_edit_face = 100.0  # (:60)
    return args


def invert_pairs(args, pipe, srcs: torch.Tensor):
    """The SDE inversion of B sources, each from its own seed-42 generator."""
    from hedit_tpu_torch.invert.sde import invert_sde

    gens = [torch.Generator(device=pipe.device).manual_seed(42) for _ in range(len(srcs))]
    return invert_sde(pipe.unet, pipe.schedule, srcs.to(pipe.device), eta=args.eta,
                      generator=gens, step_chunk=args.step_chunk)


def edit_pairs(args, pipe, refs: torch.Tensor, srcs: torch.Tensor, inv=None) -> torch.Tensor:
    """Invert (unless ``inv`` is given) and edit B pairs: refs, srcs
    [B, H, W, 3] in [-1, 1] -> the edited images [B, H, W, 3], before the
    mask blend."""
    from hedit_tpu_torch.edit.face_swap import ef_face, h_edit_r_face

    refs, srcs = refs.to(pipe.device), srcs.to(pipe.device)
    if inv is None:
        inv = invert_pairs(args, pipe, srcs)
    N = args.num_diffusion_steps - args.skip
    common = dict(id_loss_fn=pipe.id_loss_fn(refs), lpips_loss_fn=pipe.lpips_loss_fn(srcs),
                  weight_edit_face=args.weight_edit_face, eta=args.eta, after_skip_steps=N,
                  soft_face_mask=None)
    if args.mode == "h_edit_R":
        return h_edit_r_face(pipe.unet, pipe.schedule, inv.xts[:, N], inv.zs,
                             optimization_steps=args.optimization_steps, **common)
    return ef_face(pipe.unet, pipe.schedule, inv.xts[:, N], inv.zs, **common)


def finish_pair(args, pipe, ref_img: torch.Tensor, src_img: torch.Tensor,
                edited: torch.Tensor):
    """One pair's tail of the reference loop (``main_edit.py:211-225``): the
    mask blend, the printed cosine similarity, the [ref, source, edited]
    grid.  Each image [1, H, W, 3]."""
    from hedit_tpu_torch.io_utils.images import image_grid, to_pil
    from hedit_tpu_torch.models.arcface import cosine_sim
    from hedit_tpu_torch.rewards.face_mask import build_face_mask

    if args.post_processing:
        mask = build_face_mask(pipe.parse(src_img))
        edited = edited * mask + src_img * (1 - mask)
    with torch.no_grad():
        sim = cosine_sim(pipe.arcface, edited, pipe.id_embed(ref_img))
    print(f"Cosine Similarity: {float(sim.mean())}")
    return image_grid([to_pil(x.cpu().numpy()) for x in (ref_img, src_img, edited)])


def main(argv=None):
    from hedit_tpu_torch.io_utils.images import dataset_from_json, load_image
    from hedit_tpu_torch.pipelines.face import create_face_pipeline

    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; the port runs on the card unless "
                           "--device cpu is given")
    pipe = create_face_pipeline(
        tiny=args.tiny, num_inference_steps=args.num_diffusion_steps,
        celeba_ckpt=args.celeba_ckpt, arcface_ckpt=args.arcface_ckpt,
        lpips_ckpt=args.lpips_ckpt, parser_ckpt=args.parser_ckpt, device=args.device)
    res = pipe.unet.cfg.resolution

    pairs = []
    if args.data_file:
        # the reference joins a base dir onto the JSON's bare filenames
        base = args.image_path or os.path.dirname(args.data_file)
        for item in dataset_from_json(args.data_file):
            pairs.append((os.path.join(base, item["ref"]), os.path.join(base, item["source"])))
    else:
        if not (args.ref and args.source):
            raise ValueError("need --ref and --source (or --data_file)")
        pairs.append((args.ref, args.source))

    os.makedirs(args.output_path, exist_ok=True)
    todo = []
    for ref_path, src_path in pairs:
        key = (f"{os.path.basename(ref_path).split('.')[0]}_"
               f"{os.path.basename(src_path).split('.')[0]}")
        out = os.path.join(args.output_path, f"item_{key}.png")
        if args.resume and os.path.exists(out):
            print(f"[{key}] output exists, skipping (--resume)")
            continue
        todo.append((ref_path, src_path, out))

    B = max(args.data_parallel, 1)
    for start in range(0, len(todo), B):
        batch = todo[start:start + B]

        def load(i):
            return torch.from_numpy(np.concatenate([load_image(p[i], size=res) for p in batch]))

        refs, srcs = load(0), load(1)
        inv = None
        if args.load_trajectory:
            from hedit_tpu_torch.io_utils.trajectory import load_trajectory

            inv = load_trajectory(args.load_trajectory, expect_steps=args.num_diffusion_steps,
                                  device=pipe.device)
            if inv.zs is None:
                raise ValueError("face trajectory must include zs")
        elif args.save_trajectory:
            from hedit_tpu_torch.io_utils.trajectory import save_trajectory

            inv = invert_pairs(args, pipe, srcs)
            save_trajectory(args.save_trajectory, inv)
        edited = edit_pairs(args, pipe, refs, srcs, inv)
        for b, (_, _, out) in enumerate(batch):
            one = slice(b, b + 1)
            finish_pair(args, pipe, refs[one].to(pipe.device), srcs[one].to(pipe.device),
                        edited[one]).save(out)
            print(f"saved {out}")
    print(f"done: {len(todo)} pairs -> {args.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
