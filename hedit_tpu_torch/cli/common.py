"""Shared plumbing of the port's editing CLIs (port of the parts of
``hedit_tpu/cli/common.py`` that ``main_p2p``, ``main_masactrl``,
``main_plugnplay`` and ``main_demo`` need; the JAX package's
``jit_with_params`` has no counterpart: PyTorch runs eagerly).

The CLIs read one image (``--image``), a PieBench-style mapping file or (the
demo) a demo YAML, edit ``--data_parallel B`` images per batched run on one device (one run an
image by default), skip written outputs under ``--resume``, and run on the
card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data_path", type=str, default="data")
    p.add_argument("--output_path", type=str, default="results")
    p.add_argument("--mapping_file", type=str, default=None)
    p.add_argument("--image", type=str, default=None, help="single-image mode")
    p.add_argument("--target_prompt", type=str, default=None)
    p.add_argument("--edit_category_list", nargs="+", type=str,
                   default=["0", "1", "2", "3", "4", "5", "6", "7", "8", "9"])
    p.add_argument("--num_diffusion_steps", type=int, default=50)
    p.add_argument("--skip", type=int, default=0)
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


def build_pipeline(args, steps_offset: int = 1):
    """The SD pipeline on ``args.device`` with a ``num_diffusion_steps`` grid
    of the given offset (0 for the DDIM modes).  Raises when the card is asked
    for and there is none."""
    from hedit_tpu_torch.core.schedule import Schedule
    from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; the port runs on the card unless "
                           "--device cpu is given")
    pipe = create_sd_pipeline(None if args.tiny else args.weights, tiny=args.tiny,
                              num_inference_steps=args.num_diffusion_steps,
                              dtype=torch.bfloat16 if args.bf16 else torch.float32,
                              device=args.device)
    if steps_offset != 1:
        pipe = dataclasses.replace(pipe, schedule=Schedule.create(args.num_diffusion_steps,
                                                                  steps_offset=steps_offset))
    return pipe


def dataset_samples(args):
    """(key, item) of the mapping file's samples in ``--edit_category_list``,
    image paths joined under ``<data_path>/annotation_images``."""
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


def clean_prompt(prompt: str) -> str:
    return prompt.replace("[", "").replace("]", "")


def token_ids(tokenizer, pipe, prompts, tiny: bool) -> np.ndarray:
    """CLIP BPE ids [len(prompts), 77]; the tiny model folds them into its toy vocab."""
    ids = np.asarray(tokenizer(prompts))
    return ids % pipe.text_model.cfg.vocab_size if tiny else ids


def out_path(out_dir: str, item) -> str:
    """``<out_dir>/<name>.png``: the sample's ``out_name`` where it has one, else
    its image's basename (``hedit_tpu/cli/main_p2p.py:_sample_out_path``)."""
    name = item.get("out_name") or os.path.basename(item["image_path"]).rsplit(".", 1)[0]
    return os.path.join(out_dir, name + ".png")


def result_dir_name(mode: str, args, extra: str = "") -> str:
    """``<mode>_total_steps_<N>_skip_<S>[_<extra>]``: the hyperparameters in
    the output directory's name (``hedit_tpu/cli/common.py:result_dir_name``)."""
    parts = [mode, f"total_steps_{args.num_diffusion_steps}", f"skip_{args.skip}"]
    if extra:
        parts.append(extra)
    return "_".join(parts)


def run_batches(args, samples, out_dir: str, edit_batch) -> int:
    """Edit the samples whose output is not written yet (under ``--resume``)
    in batches of ``--data_parallel`` (at least 1); ``edit_batch(batch)``
    returns the decoded images [B, H, W, 3] in [-1, 1], saved as PNGs.
    Returns the number of samples edited."""
    from hedit_tpu_torch.io_utils.images import to_pil

    os.makedirs(out_dir, exist_ok=True)
    todo = []
    for key, item in samples:
        if args.resume and os.path.exists(out_path(out_dir, item)):
            print(f"[{key}] output exists, skipping (--resume)")
            continue
        todo.append((key, item))
    B = max(args.data_parallel, 1)
    for start in range(0, len(todo), B):
        batch = todo[start:start + B]
        images = edit_batch(batch)
        for (key, item), img in zip(batch, images.cpu().numpy()):
            path = out_path(out_dir, item)
            to_pil(img[None]).save(path)
            print(f"[{key}] saved {path}")
    print(f"done: {len(todo)} samples -> {out_dir}")
    return len(todo)
