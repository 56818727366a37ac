"""``python -m hedit_tpu_torch.cli.main_p2p`` on the CPU with the tiny models:
every mode and flag of the JAX CLI's ``run_sample``, trajectory files written
by one package and read by the other, and ``--data_parallel 2`` against two
single runs.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hedit_tpu.invert.ddpm import InversionResult as JInversionResult
from hedit_tpu.io_utils import trajectory as j_trajectory
from hedit_tpu_torch.cli import main_p2p
from hedit_tpu_torch.cli.main_p2p import main
from hedit_tpu_torch.invert.ddpm import InversionResult
from hedit_tpu_torch.io_utils import trajectory

STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two seeded 64x64 images and a mapping file over them."""
    root = tmp_path_factory.mktemp("p2p_modes")
    rs = np.random.RandomState(0)
    (root / "annotation_images").mkdir()
    for i in range(2):
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(
            root / "annotation_images" / f"im{i}.png")
    (root / "mapping.json").write_text(json.dumps({
        f"k{i}": {"image_path": f"im{i}.png", "original_prompt": "a green lizard",
                  "editing_prompt": "a brown lizard", "blended_word": "lizard lizard",
                  "editing_type_id": "0"} for i in range(2)}))
    return root


def _single(data_dir, out, *flags, image="im0.png"):
    return [*flags, "--tiny", "--device", "cpu", "--num_diffusion_steps", str(STEPS), "--image",
            str(data_dir / "annotation_images" / image), "--source_prompt", "a green lizard",
            "--target_prompt", "a brown lizard", "--output_path", str(out)]


def _png(out):
    pngs = sorted(out.rglob("*.png"))
    assert len(pngs) == 1, pngs
    return np.asarray(Image.open(pngs[0])).astype(np.int32)


MODE_FLAGS = [
    ("h_edit_R",), ("h_edit_R", "--implicit", "--optimization_steps", "3", "--skip", "2"),
    ("h_edit_R", "--cfg_src", "3"),
    ("h_edit_R_p2p",), ("h_edit_R_p2p", "--implicit"),
    ("h_edit_R_p2p", "--implicit", "--cfg_src", "3", "--optimization_steps", "3"),
    ("h_edit_R_p2p", "--implicit", "--skip", "2", "--eta", "0.7"),
    ("h_edit_D_p2p", "--eta", "0"), ("h_edit_D_p2p", "--eta", "0", "--implicit"),
    ("h_edit_D_p2p", "--eta", "0", "--implicit", "--cfg_src", "3", "--optimization_steps", "2"),
    ("ef",), ("ef", "--cfg_src", "3", "--step_chunk", "3"),
    ("ef_p2p",), ("ef_p2p", "--cfg_src", "3"),
    ("pnp_inv_p2p", "--eta", "0"), ("pnp_inv_p2p", "--eta", "0", "--cfg_src", "3"),
    ("nmg", "--eta", "0"), ("nmg_p2p", "--eta", "0", "--skip", "1"),
]


@pytest.mark.parametrize("flags", MODE_FLAGS, ids=lambda f: " ".join(f))
def test_cli_runs_every_mode(data_dir, tmp_path, flags):
    """Each mode of ``MODES`` with its flags writes one finite, non-constant
    image into the directory the JAX CLI would name."""
    assert main(_single(data_dir, tmp_path, "--mode", *flags)) == 0
    img = _png(tmp_path)
    assert img.shape == (64, 64, 3) and img.std() > 0
    assert next(tmp_path.iterdir()).name.startswith(f"{flags[0]}_total_steps_{STEPS}_skip_")


def test_every_mode_is_listed_and_dispatched():
    assert {f[0] for f in MODE_FLAGS} == set(main_p2p.MODES)
    src = open(main_p2p.__file__).read()
    assert "NotImplementedError" not in src and "PORTED_MODES" not in src


@pytest.mark.parametrize("mode,flags", [("h_edit_R_p2p", ("--implicit",)),
                                        ("ef_p2p", ("--cfg_src", "3")),
                                        ("h_edit_D_p2p", ("--eta", "0"))])
def test_cli_trajectory_round_trip(data_dir, tmp_path, mode, flags, capsys):
    """``--save_trajectory`` then ``--load_trajectory`` reproduces the run's
    image exactly (the same xts, and zs where the mode computed them); the file
    reads back through the JAX package's loader; injected onto another image
    it warns of the drift."""
    npz = str(tmp_path / "traj.npz")
    assert main(_single(data_dir, tmp_path / "a", "--mode", mode, *flags,
                        "--save_trajectory", npz)) == 0
    assert main(_single(data_dir, tmp_path / "b", "--mode", mode, *flags,
                        "--load_trajectory", npz)) == 0
    np.testing.assert_array_equal(_png(tmp_path / "a"), _png(tmp_path / "b"))
    back = j_trajectory.load_trajectory(npz, expect_steps=STEPS)
    assert back.xts.shape == (STEPS + 1, 8, 8, 4)
    assert (back.zs is None) == (mode == "h_edit_R_p2p")   # the flagship derives them
    capsys.readouterr()
    assert main(_single(data_dir, tmp_path / "c", "--mode", mode, *flags,
                        "--load_trajectory", npz, image="im1.png")) == 0
    assert "WARNING: injected trajectory" in capsys.readouterr().err


def test_trajectory_files_cross_the_packages(tmp_path):
    """A file saved by ``hedit_tpu`` loads in the port and the reverse: same
    keys, same arrays; an NCHW capture with a singleton batch axis is
    transposed; the length checks hold."""
    rs = np.random.RandomState(0)
    xts = rs.randn(STEPS + 1, 8, 8, 4).astype(np.float32)
    zs = rs.randn(STEPS, 8, 8, 4).astype(np.float32)
    noise = rs.randn(STEPS + 1, 8, 8, 4).astype(np.float32)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    j_trajectory.save_trajectory(jpath, JInversionResult(
        xT=jnp.asarray(xts[-1])[None], zs=jnp.asarray(zs), xts=jnp.asarray(xts),
        noise_added=jnp.asarray(noise)))
    got = trajectory.load_trajectory(jpath, expect_steps=STEPS)
    assert got.xts.shape == (1, STEPS + 1, 8, 8, 4) and got.zs.shape == (1, STEPS, 8, 8, 4)
    np.testing.assert_array_equal(got.xts[0].numpy(), xts)
    np.testing.assert_array_equal(got.zs[0].numpy(), zs)
    np.testing.assert_array_equal(got.noise_added[0].numpy(), noise)
    np.testing.assert_array_equal(got.xT.numpy(), xts[-1][None])

    trajectory.save_trajectory(tpath, InversionResult(
        xT=torch.from_numpy(xts[-1])[None], zs=None, xts=torch.from_numpy(xts)[None]))
    with np.load(tpath) as f:
        assert set(f.keys()) == {"xts", "num_steps"} and int(f["num_steps"]) == STEPS
    back = j_trajectory.load_trajectory(tpath, expect_steps=STEPS)
    np.testing.assert_array_equal(np.asarray(back.xts), xts)
    assert back.zs is None
    with np.load(jpath) as a:
        assert set(a.keys()) == {"xts", "zs", "noise_added", "num_steps"}

    np.savez(str(tmp_path / "nchw.npz"), xts=xts.transpose(0, 3, 1, 2)[:, None],
             zs=zs.transpose(0, 3, 1, 2))
    got = trajectory.load_trajectory(str(tmp_path / "nchw.npz"))
    np.testing.assert_array_equal(got.xts[0].numpy(), xts)
    np.testing.assert_array_equal(got.zs[0].numpy(), zs)
    with pytest.raises(ValueError, match="run expects"):
        trajectory.load_trajectory(jpath, expect_steps=STEPS + 1)
    np.savez(str(tmp_path / "short.npz"), xts=xts, zs=zs[:-1])
    with pytest.raises(ValueError, match="length mismatch"):
        trajectory.load_trajectory(str(tmp_path / "short.npz"))
    np.savez(str(tmp_path / "claims.npz"), xts=xts, num_steps=np.asarray(9))
    with pytest.raises(ValueError, match="claims 9 steps"):
        trajectory.load_trajectory(str(tmp_path / "claims.npz"))
    np.savez(str(tmp_path / "odd.npz"), xts=rs.randn(STEPS + 1, 8, 8, 5).astype(np.float32))
    with pytest.raises(ValueError, match="cannot infer layout"):
        trajectory.load_trajectory(str(tmp_path / "odd.npz"))
    with pytest.raises(ValueError, match="one image"):
        trajectory.save_trajectory(tpath, InversionResult(
            xT=torch.zeros(2, 8, 8, 4), zs=None, xts=torch.zeros(2, STEPS + 1, 8, 8, 4)))


def test_cli_trajectory_flags_are_single_image_and_need_residuals(data_dir, tmp_path):
    common = ["--tiny", "--device", "cpu", "--data_path", str(data_dir), "--mapping_file",
              str(data_dir / "mapping.json")]
    with pytest.raises(SystemExit):     # a sweep has no single trajectory
        main([*common, "--save_trajectory", str(tmp_path / "t.npz")])
    with pytest.raises(SystemExit):
        main(_single(data_dir, tmp_path, "--data_parallel", "2", "--load_trajectory", "t.npz"))
    npz = str(tmp_path / "nozs.npz")
    assert main(_single(data_dir, tmp_path / "a", "--mode", "h_edit_R_p2p", "--implicit",
                        "--save_trajectory", npz)) == 0
    with pytest.raises(ValueError, match="re-capture with zs"):   # ef cannot derive them
        main(_single(data_dir, tmp_path / "b", "--mode", "ef", "--load_trajectory", npz))
    with pytest.raises(ValueError, match="run expects"):
        main(_single(data_dir, tmp_path / "b", "--mode", "h_edit_R_p2p", "--implicit",
                     "--load_trajectory", npz) + ["--num_diffusion_steps", "3"])  # the last wins


@pytest.mark.parametrize("mode,flags", [("h_edit_R", ("--implicit", "--optimization_steps", "2")),
                                        ("ef_p2p", ("--cfg_src", "3")),
                                        ("h_edit_D_p2p", ("--eta", "0", "--implicit")),
                                        ("pnp_inv_p2p", ("--eta", "0"))])
def test_cli_data_parallel_two_equals_two_single_runs(data_dir, tmp_path, mode, flags):
    """Both images in one batched run against one run an image: every loop and
    inversion is batched, with one fixed generator an image.  At most 2 of 255
    levels apart (the batch size the CPU convolutions see, then the PNG's
    rounding)."""
    sweep = ["--mode", mode, *flags, "--tiny", "--device", "cpu", "--num_diffusion_steps",
             str(STEPS), "--data_path", str(data_dir), "--mapping_file",
             str(data_dir / "mapping.json")]
    assert main([*sweep, "--data_parallel", "2", "--output_path", str(tmp_path / "b2")]) == 0
    assert main([*sweep, "--output_path", str(tmp_path / "b1")]) == 0
    two, one = sorted((tmp_path / "b2").rglob("*.png")), sorted((tmp_path / "b1").rglob("*.png"))
    assert [p.name for p in two] == [p.name for p in one] == ["im0.png", "im1.png"]
    for a, b in zip(two, one):
        a, b = (np.asarray(Image.open(p)).astype(np.int32) for p in (a, b))
        assert np.abs(a - b).max() <= 2
    first, second = (np.asarray(Image.open(p)).astype(np.int32) for p in two)
    assert np.abs(first - second).max() > 2   # two different images
