"""``python -m hedit_tpu_torch.cli.main_demo`` on the CPU with the tiny models:
the demo YAML's entries (image paths with a leading slash, CONCATENATED to
the YAML's directory as the reference does), the blend-word heuristic where
an entry gives no blend word, the JAX CLI's output directory and names, and
each image bit for bit ``main_p2p``'s for the same sample.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from hedit_tpu.cli.common import result_dir_name as j_result_dir_name
from hedit_tpu_torch.cli import main_demo, main_p2p

STEPS = 4
ENTRIES = [("a photo of a green lizard on a rock", "a photo of a brown lizard on a rock", ""),
           ("a cat sitting on a bench", "a dog sitting on a bench", "cat dog")]


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def test_main_demo_runs_main_p2p_over_the_demo_yaml(tmp_path, monkeypatch):
    """Two 64x64 images and a ``demo.yaml`` whose entries read ``/im<i>.png``:

    * from ``--data_path`` and, with no YAML there, from beside ``--image``,
      one run an image and ``--data_parallel 2``: ``demo_0.png`` and
      ``demo_1.png`` in ``<mode>_demo_total_steps_4_skip_0``, JAX's
      ``result_dir_name``;
    * entry 0 gives no blend word and takes the heuristic's (``green brown``,
      the two sides of the prompts' word diff), entry 1 keeps its own;
    * each image equals, bit for bit, ``main_p2p``'s output for the same
      image, prompts and blend word (one run an image; the batched run
      within 2 of 255 levels, the CPU convolutions' batch rounding)."""
    data = tmp_path / "demo"
    data.mkdir()
    rs = np.random.RandomState(0)
    lines = []
    for i, (src, tar, word) in enumerate(ENTRIES):
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(data / f"im{i}.png")
        lines += [f"- image: /im{i}.png", f"  source_prompt: {src}", f"  target_prompt: {tar}",
                  f"  blended_word: '{word}'", "  editing_instruction: edit it"]
    (data / "demo.yaml").write_text("\n".join(lines) + "\n")

    seen = {}
    real = main_p2p.build_sample_controls

    def spy(args, pipe, key, item, *rest):
        seen[key] = item["blended_word"]
        return real(args, pipe, key, item, *rest)

    monkeypatch.setattr(main_p2p, "build_sample_controls", spy)
    tiny = ["--tiny", "--device", "cpu", "--num_diffusion_steps", str(STEPS)]
    runs = {"data_path": ["--data_path", str(data)],
            "beside_image": ["--data_path", str(tmp_path / "none"), "--image",
                             str(data / "im0.png")],
            "batched": ["--data_path", str(data), "--data_parallel", "2"]}
    outs = {}
    for name, flags in runs.items():
        out = tmp_path / name
        assert main_demo.main([*tiny, *flags, "--output_path", str(out)]) == 0
        (sub,) = os.listdir(out)
        assert sub == "h_edit_R_p2p_demo_total_steps_4_skip_0" == j_result_dir_name(
            "h_edit_R_p2p_demo", main_p2p.parse_args(tiny))
        assert sorted(os.listdir(out / sub)) == ["demo_0.png", "demo_1.png"]
        outs[name] = [np.asarray(Image.open(out / sub / f"demo_{i}.png")).astype(np.int32)
                      for i in range(2)]
    assert seen == {"demo_0": "green brown", "demo_1": "cat dog"}

    for i, (src, tar, _) in enumerate(ENTRIES):
        out = tmp_path / f"p2p{i}"
        assert main_p2p.main([*tiny, "--image", str(data / f"im{i}.png"), "--source_prompt", src,
                              "--target_prompt", tar, "--blended_word", seen[f"demo_{i}"],
                              "--output_path", str(out)]) == 0
        (png,) = [os.path.join(d, f) for d, _, fs in os.walk(out) for f in fs]
        want = np.asarray(Image.open(png)).astype(np.int32)
        assert want.shape == (64, 64, 3) and want.std() > 0
        np.testing.assert_array_equal(outs["data_path"][i], want)
        np.testing.assert_array_equal(outs["beside_image"][i], want)
        assert np.abs(outs["batched"][i] - want).max() <= 2
