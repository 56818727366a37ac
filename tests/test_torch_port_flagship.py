"""The PyTorch port's flagship edit (h-Edit-R + P2P, implicit) on the CPU:
parity with the JAX loop, batching, the golden identity, the CLI, and the
import guard of the machine that runs the port on the GPU.

The tiny UNet's weights are the port's seeded init, carried to the JAX model
by ``hedit_tpu.io_utils.weights.convert_unet``; trajectories and contexts are
numpy-seeded and fed to both packages.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.control.p2p import LocalBlendState as JLocalBlendState
from hedit_tpu.control.p2p import P2PControl as JP2PControl
from hedit_tpu.core.schedule import Schedule as JSchedule
from hedit_tpu.edit.h_edit import HEditConfig as JHEditConfig
from hedit_tpu.edit.h_edit_p2p import h_edit_p2p
from hedit_tpu.io_utils.weights import convert_unet
from hedit_tpu.models.unet_sd import UNet2DCondition as JUNet
from hedit_tpu.models.unet_sd import UNetConfig as JUNetConfig
from hedit_tpu_torch.control.p2p import (
    LocalBlendState, P2PControl, neutral_blend, neutral_control, stack_blends, stack_controls,
)
from hedit_tpu_torch.edit.h_edit import HEditConfig
from hedit_tpu_torch.edit.h_edit_p2p import h_edit_p2p_flagship
from hedit_tpu_torch.invert.ddpm import sample_xts_from_x0
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

S = 5          # editing steps
HEADS, RES = 2, 4  # tiny UNet heads; store grid of a 16x16 latent
CFG = dict(cfg_src_edit=2.0, cfg_tar=4.0)
JCFG = dict(CFG, cfg_src=1.0, implicit=True)  # the JAX config of the flagship


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its
    share.  Oversubscribed intra-op threads spin and stall each other (on an
    8-core host with 6 workers one flagship test took 250 s instead of 1.5 s)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pipe():
    return create_sd_pipeline(tiny=True, num_inference_steps=S, seed=0, device="cpu")


def _image(seed):
    """One image's inputs: trajectory [S+1, 1, 16, 16, 4], contexts
    [uncond, src, tar] [3, 1, 77, 32], control and LocalBlend arrays."""
    rng = np.random.RandomState(seed)
    xts = (rng.randn(S + 1, 1, 16, 16, 4) * 0.5).astype(np.float32)
    ctx = (rng.randn(3, 1, 77, 32) * 0.5).astype(np.float32)
    mapper = np.eye(77, dtype=np.float32)
    mapper[[3, 4]] = mapper[[4, 3]]
    alpha = np.zeros((S + 1, 77), np.float32)
    alpha[:3, 1:8] = rng.uniform(0.5, 1.0, (3, 7))
    arrays = dict(cross_alpha=alpha, refine_mapper=np.zeros(77, np.int64),
                  refine_alphas=np.ones(77, np.float32), replace_mapper=mapper,
                  equalizer=rng.uniform(1.0, 2.0, 77).astype(np.float32))
    words = np.zeros((2, 77), np.float32)
    words[:, 3:5] = 1.0
    return xts, ctx, arrays, words


STATIC = dict(mode="replace", use_reweight=True, self_replace_until=2, blend_px=RES * RES)


def _port_inputs(images):
    xts = torch.stack([torch.from_numpy(x[:, 0]) for x, _, _, _ in images])
    ctx4 = torch.stack([torch.from_numpy(np.stack([c[0, 0], c[1, 0], c[1, 0], c[2, 0]]))
                        for _, c, _, _ in images])
    control = stack_controls([
        P2PControl(**{k: torch.from_numpy(a)[None] for k, a in arr.items()}, **STATIC)
        for _, _, arr, _ in images])
    blend = stack_blends([
        LocalBlendState(alpha_layers=torch.from_numpy(w)[None],
                        store_sum=torch.zeros(1, 5, 2, HEADS, RES * RES, 77),
                        start_blend=torch.tensor([1]), res=RES)
        for _, _, _, w in images])
    return xts, ctx4, control, blend


def _port_run(pipe, images, **cfg):
    xts, ctx4, control, blend = _port_inputs(images)
    return h_edit_p2p_flagship(pipe.unet, pipe.schedule, HEditConfig(**(cfg or CFG)), xts=xts,
                               ctx4=ctx4, control=control, local_blend=blend,
                               after_skip_steps=S).numpy()


@pytest.fixture(scope="module")
def images():
    return [_image(1), _image(2)]


@pytest.fixture(scope="module")
def port_batched(pipe, images):
    return _port_run(pipe, images)


def test_flagship_matches_jax_h_edit_p2p(pipe, images, port_batched):
    """Image 0 of the port's batched run against the JAX loop with the same
    injected trajectory, a non-neutral replace + reweight control inside and
    outside its windows, and an active LocalBlend.  float32 on both sides;
    atol 1e-3: one UNet call of the two frameworks differs by ~2e-6, and five
    steps of the random tiny UNet at cfg 4 amplify that ~100x (measured
    2.3e-4; the JAX package's own tests bound the same chaotic amplification
    at 5e-3).  A row of another image leaking in would differ by O(1)."""
    xts, ctx, arrays, words = images[0]
    params = convert_unet({k: v.numpy() for k, v in pipe.unet.state_dict().items()})
    junet = JUNet(JUNetConfig.tiny())

    def eps_fn(x, t, c, ctrl):
        if getattr(ctrl, "stores_attn", False):
            out, aux = junet.apply(params, x, t, c, ctrl, True, mutable=["attn_store"])
            return out, aux["attn_store"]
        return junet.apply(params, x, t, c, ctrl)

    control = JP2PControl(step=jnp.zeros((), jnp.int32),
                          **{k: jnp.asarray(a) for k, a in arrays.items()}, **STATIC)
    blend = JLocalBlendState(alpha_layers=jnp.asarray(words),
                             store_sum=jnp.zeros((5, 2, HEADS, RES * RES, 77)),
                             start_blend=1, res=RES)
    run = jax.jit(lambda xts_, u, s, t, ctrl, lb: h_edit_p2p(
        eps_fn, JSchedule.create(S), xts_[S], None, uncond_ctx=u, src_ctx=s, tar_ctx=t,
        cfg=JHEditConfig(**JCFG), after_skip_steps=S, control=ctrl, local_blend=lb,
        xts=xts_, derive_zs=True)[0])
    want = np.asarray(run(jnp.asarray(xts), *(jnp.asarray(c) for c in ctx), control, blend))
    np.testing.assert_allclose(port_batched[0], want[0], rtol=0, atol=1e-3)
    assert np.abs(port_batched[0] - xts[0, 0]).max() > 1e-2  # the edit did something


def test_flagship_batched_matches_per_image(pipe, images, port_batched):
    """Two images in one batched run equal each image run alone: every
    control edit and the LocalBlend stay inside their image's rows.  The
    only difference is the batch size the CPU convolutions see (~2e-6 a
    UNet call, amplified as in the JAX comparison: measured 2.3e-4, atol
    1e-3).  One image twice in a batch gives bitwise equal rows."""
    for i, img in enumerate(images):
        alone = _port_run(pipe, [img])
        np.testing.assert_allclose(port_batched[i], alone[0], rtol=0, atol=1e-3)
    assert np.abs(port_batched[0] - port_batched[1]).max() > 1e-2
    twice = _port_run(pipe, [images[0], images[0]])
    np.testing.assert_array_equal(twice[0], twice[1])


def test_flagship_golden_identity(pipe):
    """README "golden numerics": target = source, cfg_tar == cfg_src_edit and
    a neutral control make the correction vanish, so the edit reproduces the
    source latent xts[0].  float32; 1e-5 is the f32 residue of five
    reverse steps."""
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn(2, 16, 16, 4, generator=g) * 0.5
    xts = torch.stack([sample_xts_from_x0(pipe.schedule, x[None], g) for x in x0])
    ctx = torch.randn(2, 2, 77, 32, generator=g)
    ctx4 = torch.stack([ctx[:, 0], ctx[:, 1], ctx[:, 1], ctx[:, 1]], dim=1)
    control = stack_controls([neutral_control(S, RES * RES, cond_start=2)] * 2)
    blend = stack_blends([neutral_blend(S, HEADS, RES)] * 2)
    out = h_edit_p2p_flagship(pipe.unet, pipe.schedule,
                              HEditConfig(cfg_src_edit=5.0, cfg_tar=5.0), xts=xts, ctx4=ctx4,
                              control=control, local_blend=blend, after_skip_steps=S)
    torch.testing.assert_close(out, xts[:, 0], rtol=0, atol=1e-5)


def test_cli_tiny_writes_finite_images(tmp_path):
    """``python -m hedit_tpu_torch.cli.main_p2p --tiny`` over a 3-image
    mapping at --data_parallel 2 (a full batch and a tail batch), then
    ``--resume`` skipping them all."""
    from PIL import Image

    from hedit_tpu_torch.cli.main_p2p import main

    rs = np.random.RandomState(0)
    (tmp_path / "annotation_images").mkdir()
    for i in range(3):
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(
            tmp_path / "annotation_images" / f"im{i}.png")
    mapping = tmp_path / "mapping.json"
    mapping.write_text(json.dumps({
        f"k{i}": {"image_path": f"im{i}.png", "original_prompt": "a green lizard",
                  "editing_prompt": "a brown lizard", "blended_word": "",
                  "editing_type_id": "0"} for i in range(3)}))
    out = tmp_path / "out"
    argv = ["--mode", "h_edit_R_p2p", "--implicit", "--num_diffusion_steps", "3",
            "--data_path", str(tmp_path), "--mapping_file", str(mapping),
            "--data_parallel", "2", "--output_path", str(out), "--tiny", "--device", "cpu"]
    assert main(argv) == 0
    pngs = sorted(p for p in out.rglob("*.png"))
    assert len(pngs) == 3
    for p in pngs:
        arr = np.asarray(Image.open(p))
        assert arr.shape == (64, 64, 3) and arr.std() > 0
    mtimes = [os.path.getmtime(p) for p in pngs]
    assert main(argv + ["--resume"]) == 0   # every output exists: all skipped
    assert [os.path.getmtime(p) for p in pngs] == mtimes
    # a mode beside the flagship, on one of the written images
    assert main(["--mode", "ef", "--tiny", "--device", "cpu", "--image", str(pngs[0]),
                 "--num_diffusion_steps", "3", "--output_path", str(out)]) == 0
    assert len(list(out.rglob("*.png"))) == 4


_GUARD = r"""
import sys
for name in ("jax", "flax", "regex", "PIL", "hedit_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np, torch
import chip_smoke  # the GPU entry script imports the same main path
from hedit_tpu_torch.control.p2p import neutral_blend, neutral_control
from hedit_tpu_torch.edit.h_edit import HEditConfig
from hedit_tpu_torch.edit.h_edit_p2p import h_edit_p2p_flagship
from hedit_tpu_torch.invert.ddpm import sample_xts_from_x0
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline
pipe = create_sd_pipeline(tiny=True, num_inference_steps=2, device="cpu")
ids = np.random.RandomState(0).randint(0, 1000, (4, 77))
ctx4 = pipe.encode_token_ids(ids).reshape(1, 4, 77, -1)
x0 = pipe.vae_encode(torch.rand(1, 64, 64, 3) * 2 - 1)
xts = sample_xts_from_x0(pipe.schedule, x0, torch.Generator().manual_seed(0))[None]
out = h_edit_p2p_flagship(pipe.unet, pipe.schedule, HEditConfig(), xts=xts, ctx4=ctx4,
                          control=neutral_control(2, 16, cond_start=2),
                          local_blend=neutral_blend(2, 2, 2), after_skip_steps=2)
img = pipe.vae_decode(out)
assert img.shape == (1, 64, 64, 3) and bool(torch.isfinite(img).all())

# the CLI, a DDPM and a DDIM mode, with the JAX package still blocked; it alone
# needs regex (the tokenizer) and PIL (image files)
del sys.modules["regex"], sys.modules["PIL"]
import os, tempfile
from PIL import Image
from hedit_tpu_torch.cli.main_p2p import main
with tempfile.TemporaryDirectory() as tmp:
    src = os.path.join(tmp, "im.png")
    Image.fromarray(np.random.RandomState(0).randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(src)
    common = ["--num_diffusion_steps", "2", "--image", src, "--source_prompt", "a green lizard",
              "--target_prompt", "a brown lizard", "--tiny", "--device", "cpu"]
    for flags in (["--mode", "h_edit_R_p2p", "--implicit"], ["--mode", "nmg_p2p", "--eta", "0"]):
        out = os.path.join(tmp, flags[1])
        assert main(flags + common + ["--output_path", out]) == 0
        assert any(f.endswith(".png") for _, _, fs in os.walk(out) for f in fs), flags
assert not any(m.split(".")[0] in ("jax", "jaxlib", "flax", "hedit_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("GUARD_OK")
"""


def test_main_path_imports_without_jax_flax_regex_pil():
    """The machine with the card has no jax, flax or regex and maybe no PIL:
    the port's main path and chip_smoke.py must import and run without them,
    and without the JAX package itself; the CLI runs both ported modes with
    the JAX package blocked (it alone needs regex and PIL)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS=str(torch.get_num_threads()))
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "GUARD_OK" in proc.stdout, proc.stderr[-3000:]


def test_flagship_rejects_other_configurations(pipe, images):
    """``h_edit_p2p_flagship`` takes the flagship configuration only (the other
    configurations of ``h_edit_R_p2p`` run through ``h_edit_p2p`` and the CLI:
    ``tests/test_torch_main_p2p_modes.py``) and refuses mismatched batches."""
    with pytest.raises(ValueError):
        _port_run(pipe, images[:1], **dict(CFG, cfg_src=2.0))   # derive_zs needs cfg_src 1
    with pytest.raises(ValueError):
        _port_run(pipe, images[:1], **dict(CFG, implicit=False))
    with pytest.raises(ValueError):
        _port_run(pipe, images[:1], **dict(CFG, eta=0.0))
    xts, ctx4, control, blend = _port_inputs(images)
    with pytest.raises(ValueError):
        h_edit_p2p_flagship(pipe.unet, pipe.schedule, HEditConfig(**CFG), xts=xts[:1],
                            ctx4=ctx4, control=control, local_blend=blend,
                            after_skip_steps=S)
