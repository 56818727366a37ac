"""Demo CLI (port of ``hedit_tpu/cli/main_demo.py``): ``main_p2p``'s edit over
a demo YAML of {image, source_prompt, target_prompt, blended_word,
editing_instruction} entries (the reference's ``assets/demo/demo.yaml``).

    python -m hedit_tpu_torch.cli.main_demo --data_path assets/demo \\
        [--mode h_edit_R_p2p --implicit] [--tiny] [--device cpu]

The flags are ``main_p2p``'s.  The YAML is ``--mapping_file``, else
``<data_path>/demo.yaml``, else ``demo.yaml`` beside ``--image``, whose
entries are then read against that directory.  An entry's image that does not
exist as written is the YAML directory's path with the entry CONCATENATED to
it, as the reference does (``main_demo.py:131``: the demo stores
``/lizard.jpg`` with a leading slash).  Each sample's blend words are the
entry's ``blended_word``, else the two sides of the word diff of its prompts
(``control/p2p_prep.py:preprocess_blend_and_eq``; its equalizer is computed
and unused, as in JAX).  Image i is written as ``demo_<i>.png`` under
``<mode>_demo_total_steps_<N>_skip_<S>``.  ``--data_parallel B`` edits B
images a batched run; without ``--device cpu`` it runs on the card and raises
where there is none.
"""

from __future__ import annotations

import os
import sys

from hedit_tpu_torch.cli import main_p2p
from hedit_tpu_torch.cli.common import build_pipeline, result_dir_name, run_batches


def demo_samples(args):
    """(key, item) of the demo YAML's entries, as the JAX CLI builds them."""
    from hedit_tpu_torch.control.p2p_prep import preprocess_blend_and_eq
    from hedit_tpu_torch.io_utils.images import dataset_from_yaml

    yaml_path = args.mapping_file or os.path.join(args.data_path, "demo.yaml")
    join_base = args.data_path
    if not os.path.exists(yaml_path) and args.image:
        yaml_path = os.path.join(os.path.dirname(args.image), "demo.yaml")
        join_base = os.path.dirname(args.image)
    samples = []
    for i, item in enumerate(dataset_from_yaml(yaml_path)):
        src, tar = item["source_prompt"], item["target_prompt"]
        blend, _eq = preprocess_blend_and_eq(src, tar)
        blended = item.get("blended_word", "")
        if not blended and blend is not None:
            blended = f"{blend[0][0]} {blend[1][0]}"
        image = item["image"]
        if not os.path.exists(image):
            image = join_base + image
        samples.append((f"demo_{i}", {"image_path": image, "original_prompt": src,
                                      "editing_prompt": tar, "blended_word": blended,
                                      "editing_type_id": "0", "out_name": f"demo_{i}"}))
    return samples


def main(argv=None):
    args = main_p2p.parse_args(argv)
    from hedit_tpu_torch.models.tokenizer import CLIPTokenizer

    pipe = build_pipeline(args, steps_offset=0 if args.eta == 0 else 1)
    tokenizer = CLIPTokenizer()
    img_size = pipe.vae.cfg.sample_size if args.tiny else 512
    out_dir = os.path.join(args.output_path, result_dir_name(args.mode + "_demo", args))
    run_batches(args, demo_samples(args), out_dir,
                lambda batch: main_p2p.edit_batch(args, pipe, batch, img_size, tokenizer))
    return 0


if __name__ == "__main__":
    sys.exit(main())
