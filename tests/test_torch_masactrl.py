"""The port's MasaCtrl slice on the CPU against the JAX package with the tiny
models: the controls (``MasaCtrlControl.map_qkv``, the mask control's
``override_attention`` and the auto masks' store pass), the loops
``h_edit_masactrl`` (R and D) and ``ef_or_pnp_inv_p2p`` with MasaCtrl (EF and
PnP-Inv), and ``python -m hedit_tpu_torch.cli.main_masactrl`` in all four
modes, batched (``--data_parallel 2``) and one image a run.

The loops run the JAX CLI's configurations on numpy-seeded trajectories,
residuals and contexts at the tiny UNet's 16x16 latents (torch and JAX draw
different noise, so the inversion's outputs are injected); the tiny UNet's
seeded weights are carried to the JAX model by
``hedit_tpu.io_utils.weights.convert_unet``.  The port runs two images in one
batch, the JAX scan each image alone.  The CLI test checks that each mode runs
those loops with the JAX CLI's arguments.  float32 throughout.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hedit_tpu.control.masactrl import MasaCtrlControl as JMasaCtrlControl
from hedit_tpu.control.masactrl_auto import CrossMapStore as JCrossMapStore
from hedit_tpu.control.masactrl_auto import aggregate_token_mask as j_aggregate_token_mask
from hedit_tpu.control.masactrl_mask import MasaCtrlMaskControl as JMasaCtrlMaskControl
from hedit_tpu.core.schedule import Schedule as JSchedule
from hedit_tpu.edit.baselines import ef_or_pnp_inv_p2p as j_ef_or_pnp_inv_p2p
from hedit_tpu.edit.h_edit import HEditConfig as JHEditConfig
from hedit_tpu.edit.h_edit_ctrl import h_edit_masactrl as j_h_edit_masactrl
from hedit_tpu.edit.h_edit_p2p import flatten_attn_store
from hedit_tpu.io_utils.weights import convert_unet
from hedit_tpu.models.unet_sd import UNet2DCondition as JUNet
from hedit_tpu.models.unet_sd import UNetConfig as JUNetConfig
from hedit_tpu.models.unet_sd import _build_tags as j_build_tags
from hedit_tpu.ops.attention import controlled_attention as j_controlled_attention
from hedit_tpu_torch.cli.main_masactrl import MODES, main
from hedit_tpu_torch.control.base import LayerTag
from hedit_tpu_torch.control.masactrl import MasaCtrlControl
from hedit_tpu_torch.control.masactrl_auto import (
    CrossMapStore, aggregate_token_mask, auto_mask_control, masactrl_auto_masks,
)
from hedit_tpu_torch.control.masactrl_mask import MasaCtrlMaskControl, resize_nearest
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit import baselines, h_edit_ctrl
from hedit_tpu_torch.edit.h_edit import HEditConfig
from hedit_tpu_torch.models.unet_sd import UNetConfig, _build_tags
from hedit_tpu_torch.ops.attention import controlled_attention
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

STEPS = 4          # the CLI runs; MasaCtrl from step 1 (--step 1), pair 10 on (--layer 10)
START_STEP = 1
SELF_UP = LayerTag(place="up", is_cross=False, num_pixels=16, index=24)   # pair 12
CROSS_UP = LayerTag(place="up", is_cross=True, num_pixels=16, index=25)
SELF_DOWN = LayerTag(place="down", is_cross=False, num_pixels=16, index=2)  # pair 1


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pipe():
    return create_sd_pipeline(tiny=True, num_inference_steps=STEPS, seed=0, device="cpu")


@pytest.fixture(scope="module")
def jax_eps(pipe):
    """The JAX tiny UNet with the port's seeded weights, as ``eps_fn(x, t, c,
    ctrl)`` (a store control also returns its maps)."""
    params = convert_unet({k: v.numpy() for k, v in pipe.unet.state_dict().items()})
    junet = JUNet(JUNetConfig.tiny())

    def eps_fn(x, t, c, ctrl):
        if getattr(ctrl, "stores_attn", False):
            out, aux = junet.apply(params, x, t, c, ctrl, True, mutable=["attn_store"])
            return out, aux["attn_store"]
        return junet.apply(params, x, t, c, ctrl)

    return eps_fn


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _assert_close(got, want, mean_tol=1e-5, max_tol=2e-3):
    """The loop tolerance of ``test_torch_h_edit_p2p.py``, relative to the
    largest latent: a tight mean (a wrong coefficient, row or gate moves it by
    orders of magnitude) and a loose max (one call of the tiny UNet differs by
    ~2e-6 between the frameworks, and the random tiny UNet at cfg 7.5
    amplifies that over the steps in single elements)."""
    d = np.abs(got - want) / max(1.0, np.abs(want).max())
    assert d.mean() < mean_tol, f"mean |diff| {d.mean():.2e} >= {mean_tol:.0e}"
    assert d.max() < max_tol, f"max |diff| {d.max():.2e} >= {max_tol:.0e}"


# ------------------------------------------------------------- controls #

def _flat_tags(tags):
    """A model's LayerTags in visit order (the mid block is one block)."""
    return [t for place in ("down", "mid", "up")
            for blk in ([tags[place]] if place == "mid" else tags[place])
            for pair in blk for t in pair]


@pytest.mark.parametrize("config", ["tiny", "sd15"])
def test_masactrl_layers_match_jax(config):
    """The port's LayerTags are the JAX model's, in the same visit order, and
    MasaCtrl remaps exactly the layers JAX's ``_applies`` picks: for SD-1.5
    at its default start layer 10 the self-attentions of the up blocks at 32^2
    and 64^2 latent pixels, 1024 and 4096 tokens."""
    cfg, jcfg = getattr(UNetConfig, config)(), getattr(JUNetConfig, config)()
    mine, theirs = _flat_tags(_build_tags(cfg)), _flat_tags(j_build_tags(jcfg))
    assert [tuple(vars(t).values()) for t in mine] == [tuple(vars(t).values()) for t in theirs]
    assert [t.index for t in mine] == list(range(32))
    rng = np.random.RandomState(0)
    k = torch.from_numpy(_rand(rng, 4, 3, 8))
    ctrl, jctrl = MasaCtrlControl(step=5), JMasaCtrlControl(step=jnp.asarray(5))
    applied = [t.index for t in mine if ctrl.map_qkv(k, k, k, t)[1] is not k]
    assert applied == [t.index for t in theirs if jctrl._applies(t)]
    if config == "sd15":
        assert applied == [20, 22, 24, 26, 28, 30]
        assert {t.num_pixels for t in mine if t.index in applied} == {32 * 32, 64 * 64}
    with pytest.raises(ValueError, match="out of range"):
        MasaCtrlControl(start_layer=16)


@pytest.mark.parametrize("step", [3, 4, 7])
@pytest.mark.parametrize("layer", [SELF_UP, CROSS_UP, SELF_DOWN], ids=["self-up", "cross", "down"])
def test_map_qkv_matches_jax_per_image(step, layer):
    """Two images in one batch, 8 rows: each image's rows take the k / v of the
    first row of their own half, as JAX's control gives on each image's 4
    rows alone; a JAX-literal remap of all 8 rows would send image 2's rows to
    image 1's."""
    rng = np.random.RandomState(step)
    q, k, v = (_rand(rng, 8, 6, 16) for _ in range(3))
    got = MasaCtrlControl(step=step, num_images=2).map_qkv(
        *(torch.from_numpy(a) for a in (q, k, v)), layer)
    jctrl = JMasaCtrlControl(step=jnp.asarray(step))
    for img in range(2):
        rows = slice(4 * img, 4 * img + 4)
        want = jctrl.map_qkv(jnp.asarray(q[rows]), jnp.asarray(k[rows]), jnp.asarray(v[rows]),
                             layer)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[rows].numpy(), np.asarray(w))
    literal = jctrl.map_qkv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layer)[1]
    moved = step >= 4 and layer is not CROSS_UP and layer is not SELF_DOWN
    assert (not np.array_equal(np.asarray(literal), got[1].numpy())) == moved
    with pytest.raises(ValueError, match="images"):
        MasaCtrlControl(step=5, num_images=3).map_qkv(*(torch.zeros(8, 6, 16),) * 3, SELF_UP)


def _masks(rng, n, size):
    return (rng.rand(n, size, size) > 0.5).astype(np.float32)


@pytest.mark.parametrize("size,res", [(5, 4), (7, 3), (3, 8), (16, 16), (64, 16)])
def test_resize_nearest_is_jax_nearest(size, res):
    """JAX's nearest rule, not ``F.interpolate``'s (they differ at 5 -> 4)."""
    m = _masks(np.random.RandomState(size), 2, size)
    want = [np.asarray(jax.image.resize(jnp.asarray(x), (res, res), method="nearest"))
            for x in m]
    np.testing.assert_array_equal(resize_nearest(torch.from_numpy(m), res).numpy(), np.stack(want))


@pytest.mark.parametrize("step", [0, 5])
def test_mask_override_matches_jax(step):
    """The mask control's ``override_attention`` on two images' head-split
    views (masks 5x5, brought to the 4x4 grid of 16 tokens) and through
    ``controlled_attention`` on packed projections, against the JAX control on
    each image's 4 rows; before ``start_step`` plain attention."""
    rng = np.random.RandomState(11 + step)
    ms, mt = _masks(rng, 2, 5), _masks(rng, 2, 5)
    q, k, v = (_rand(rng, 8, 2, 16, 8) for _ in range(3))
    ctrl = MasaCtrlMaskControl(mask_s=torch.from_numpy(ms), mask_t=torch.from_numpy(mt),
                               step=step, start_layer=0)
    got = ctrl.override_attention(*(torch.from_numpy(a) for a in (q, k, v)), SELF_DOWN)
    packed = [a.transpose(0, 2, 1, 3).reshape(8, 16, 16) for a in (q, k, v)]
    got_packed, store = controlled_attention(*(torch.from_numpy(a) for a in packed), heads=2,
                                             layer=SELF_DOWN, control=ctrl)
    assert store == {} and ctrl.override_attention(q, k, v, CROSS_UP) is None
    for img in range(2):
        rows = slice(4 * img, 4 * img + 4)
        jmask = JMasaCtrlMaskControl(step=jnp.asarray(step), mask_s=jnp.asarray(ms[img]),
                                     mask_t=jnp.asarray(mt[img]), start_layer=0)
        want = jmask.override_attention(*(jnp.asarray(a[rows]) for a in (q, k, v)), SELF_DOWN)
        np.testing.assert_allclose(got[rows].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        want_packed, _ = j_controlled_attention(*(jnp.asarray(a[rows]) for a in packed), heads=2,
                                                layer=SELF_DOWN, control=jmask)
        np.testing.assert_allclose(got_packed[rows].numpy(), np.asarray(want_packed), rtol=1e-5,
                                   atol=1e-6)


def test_auto_masks_match_jax(pipe, jax_eps):
    """The store pass over the tiny UNet (16x16 latents: the 16^2 cross maps
    are its first down and last up block's), the aggregated token maps and
    the thresholded masks of two images, against JAX on each image; then one
    UNet call under the auto-mask control."""
    rng = np.random.RandomState(3)
    x4 = _rand(rng, 8, 16, 16, 4) * 0.2
    ctx4 = _rand(rng, 8, 77, 32) * 0.1
    t = 501
    store = {}
    pipe.unet(torch.from_numpy(x4), t, torch.from_numpy(ctx4), CrossMapStore(px=256), store)
    mask_s, mask_t = masactrl_auto_masks(pipe.unet, torch.from_numpy(x4), t,
                                         torch.from_numpy(ctx4), thres=0.3, px=256)
    assert mask_s.shape == mask_t.shape == (2, 16, 16)
    j_store = jax.jit(lambda x, c: flatten_attn_store(
        jax_eps(x, jnp.full((4,), t, jnp.int32), c, JCrossMapStore(px=256))[1]))
    for img in range(2):
        rows = slice(4 * img, 4 * img + 4)
        jmaps = j_store(jnp.asarray(x4[rows]), jnp.asarray(ctx4[rows]))
        assert sorted(jmaps) == sorted(store)
        for row, mask in ((2, mask_s[img]), (3, mask_t[img])):
            want = np.asarray(j_aggregate_token_mask(jmaps, (1,), row=row))
            agg = aggregate_token_mask(store, (1,), row=4 * img + row).numpy()
            np.testing.assert_allclose(agg, want, rtol=0, atol=1e-5)
            clear = np.abs(want - 0.3) > 1e-4        # no value sits on the threshold
            np.testing.assert_array_equal(mask.numpy()[clear], (want >= 0.3)[clear])
    ctrl = auto_mask_control(5, mask_s, mask_t, start_layer=0)
    got = pipe.unet(torch.from_numpy(x4), t, torch.from_numpy(ctx4), ctrl).numpy()
    j_masked = jax.jit(lambda x, c, ms, mt: jax_eps(
        x, jnp.full((4,), t, jnp.int32), c,
        JMasaCtrlMaskControl(step=jnp.asarray(5), mask_s=ms, mask_t=mt, start_layer=0)))
    for img in range(2):
        rows = slice(4 * img, 4 * img + 4)
        want = np.asarray(j_masked(jnp.asarray(x4[rows]), jnp.asarray(ctx4[rows]),
                                   jnp.asarray(mask_s[img].numpy()),
                                   jnp.asarray(mask_t[img].numpy())))
        np.testing.assert_allclose(got[rows], want, rtol=0, atol=1e-4 * np.abs(want).max())


# ----------------------------------------------------------------- loops #

def _image(seed):
    """One image's inputs at the tiny UNet's 16x16 latents: trajectory
    [S+1, 16, 16, 4], residuals [S, ...], contexts [uncond, src, tar]."""
    rng = np.random.RandomState(seed)
    return (_rand(rng, STEPS + 1, 16, 16, 4) * 0.5, _rand(rng, STEPS, 16, 16, 4) * 0.3,
            _rand(rng, 3, 77, 32) * 0.5)


# mode -> (loop, DDIM inversion, stored trajectory): the JAX CLI's
# configurations (eta 1, cfg_src 1, cfg_src_edit 5, cfg_tar 7.5, one
# optimisation step), MasaCtrl from step 1
VARIANTS = {
    "h_edit_R_masactrl": ("h_edit", False, True),
    "h_edit_D_masactrl": ("h_edit", True, True),
    "ef_masactrl": ("pair", False, False),
    "pnp_inv_masactrl": ("pair", True, False),
}


def _jax_loop(name, jax_eps):
    """The JAX loop of a variant, jitted: (xT, zs, xts, uncond, src, tar) of
    one image -> (edited, source branch)."""
    loop, ddim, _ = VARIANTS[name]
    sched = JSchedule.create(STEPS, steps_offset=0 if ddim else 1)
    if loop == "h_edit":
        cfg = JHEditConfig(**CLI_CFG, is_ddim_inversion=ddim)

        def run(xT, zs, xts, u, s, t):
            return j_h_edit_masactrl(jax_eps, sched, xT, zs, uncond_ctx=u, src_ctx=s, tar_ctx=t,
                                     cfg=cfg, after_skip_steps=STEPS, start_step=START_STEP,
                                     start_layer=10, xts=xts)
    else:
        def run(xT, zs, xts, u, s, t):
            mc = JMasaCtrlControl(step=jnp.array(0, jnp.int32), start_step=START_STEP,
                                  start_layer=10, num_halves=2)
            return j_ef_or_pnp_inv_p2p(jax_eps, sched, xT, zs, uncond_ctx=u, src_ctx=s,
                                       tar_ctx=t, cfg_src=1.0, cfg_tar=7.5, eta=1.0,
                                       is_ddim_inversion=ddim, after_skip_steps=STEPS,
                                       control=mc)
    return jax.jit(run)


CLI_CFG = dict(cfg_src=1.0, cfg_src_edit=5.0, cfg_tar=7.5, eta=1.0, optimization_steps=1)


def _port_loop(name, pipe, xT, zs, xts, ctx3, **kw):
    loop, ddim, _ = VARIANTS[name]
    sched = Schedule.create(STEPS, steps_offset=0 if ddim else 1)
    if loop == "h_edit":
        cfg = HEditConfig(**CLI_CFG, is_ddim_inversion=ddim)
        return h_edit_ctrl.h_edit_masactrl(pipe.unet, sched, xT, zs, ctx3=ctx3, cfg=cfg,
                                           after_skip_steps=STEPS,
                                           start_step=kw.get("start_step", START_STEP),
                                           start_layer=10, xts=xts)
    return baselines.ef_or_pnp_inv_p2p(
        pipe.unet, sched, xT, zs, ctx3=ctx3, cfg_src=1.0, cfg_tar=7.5, eta=1.0,
        is_ddim_inversion=ddim, after_skip_steps=STEPS,
        control=MasaCtrlControl(start_step=kw.get("start_step", START_STEP), num_images=2))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_masactrl_loops_match_jax(name, pipe, jax_eps):
    """``h_edit_masactrl`` (R and D with the stored trajectory, and the pair
    branch at cfg_src 2 with two optimisation steps) and ``ef_or_pnp_inv_p2p``
    with MasaCtrl (EF and PnP-Inv, the 4-row pair step) on two images in one
    batch, against the JAX scans on each image: edited and source branch.
    MasaCtrl is engaged: without it (its start step past the last step) the
    edit differs."""
    _, _, use_xts = VARIANTS[name]
    images = [_image(1), _image(2)]
    xts = torch.from_numpy(np.stack([im[0] for im in images]))
    zs = torch.from_numpy(np.stack([im[1] for im in images]))
    ctx3 = torch.from_numpy(np.stack([im[2] for im in images]))
    call = (pipe, xts[:, STEPS], zs, xts if use_xts else None, ctx3)
    edited, recon = _port_loop(name, *call)
    run = _jax_loop(name, jax_eps)
    for b, (xts_b, zs_b, ctx) in enumerate(images):
        want_edit, want_recon = run(jnp.asarray(xts_b[STEPS][None]), jnp.asarray(zs_b),
                                    jnp.asarray(xts_b) if use_xts else None,
                                    *(jnp.asarray(c[None]) for c in ctx))
        _assert_close(edited[b].numpy(), np.asarray(want_edit)[0])
        _assert_close(recon[b].numpy(), np.asarray(want_recon)[0])
    assert np.abs(edited.numpy() - recon.numpy()).max() > 1e-2   # the edit did something
    if use_xts:   # the source branch is the stored trajectory itself
        np.testing.assert_array_equal(recon.numpy(), xts[:, 0].numpy())
    off, _ = _port_loop(name, *call, start_step=STEPS)
    assert np.abs(off.numpy() - edited.numpy()).max() > 1e-3


@pytest.mark.parametrize("cfg_src", [1.0, 2.0])
def test_h_edit_masactrl_pair_branch_rewalks_the_trajectory(pipe, cfg_src):
    """Without ``xts`` the base pass steps [x_orig, x_edit] (2 rows an image,
    4 at cfg_src != 1) with the inversion's residuals: on a DDPM inversion
    made at the same cfg_src its source branch lands on the trajectory's
    source latent, and the edit is the one the indexed branch gives, up to
    float32 rounding (the base calls' batch differs from the inversion's)."""
    from hedit_tpu_torch.invert.ddpm import invert_ddpm

    rng = np.random.RandomState(9)
    x0 = torch.from_numpy(_rand(rng, 2, 16, 16, 4) * 0.5)
    ctx3 = torch.from_numpy(_rand(rng, 2, 3, 77, 32) * 0.5)
    inv = invert_ddpm(pipe.unet, pipe.schedule, x0, uncond_ctx=ctx3[:, 0], src_ctx=ctx3[:, 1],
                      cfg_scale_src=cfg_src, eta=1.0,
                      generator=[torch.Generator().manual_seed(i) for i in range(2)])
    cfg = HEditConfig(**{**CLI_CFG, "cfg_src": cfg_src})
    call = dict(ctx3=ctx3, cfg=cfg, after_skip_steps=STEPS, start_step=START_STEP)
    pair, recon = h_edit_ctrl.h_edit_masactrl(pipe.unet, pipe.schedule, inv.xT, inv.zs, **call)
    indexed, _ = h_edit_ctrl.h_edit_masactrl(pipe.unet, pipe.schedule, inv.xT, inv.zs,
                                             xts=inv.xts, **call)
    scale = inv.xts.abs().max().item()
    assert (recon - x0).abs().max().item() < 1e-5 * scale
    assert (pair - indexed).abs().max().item() < 5e-4 * scale
    assert (pair - recon).abs().max().item() > 1e-2


# ------------------------------------------------------------------- CLI #

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two seeded 64x64 images and a mapping file over them."""
    root = tmp_path_factory.mktemp("masactrl")
    rs = np.random.RandomState(0)
    (root / "annotation_images").mkdir()
    for i in range(2):
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(
            root / "annotation_images" / f"im{i}.png")
    (root / "mapping.json").write_text(json.dumps({
        f"k{i}": {"image_path": f"im{i}.png", "original_prompt": "a green lizard",
                  "editing_prompt": "a brown [lizard]", "editing_type_id": "0"}
        for i in range(2)}))
    return root


@pytest.mark.parametrize("mode", MODES)
def test_main_masactrl_runs_every_mode(mode, data_dir, tmp_path, monkeypatch):
    """The CLI with ``--tiny --device cpu --step 1`` over two images, in the
    directory the JAX CLI names:

    * ``--data_parallel 2`` against one run an image: the same PNGs within 2
      of 255 levels (the batch size the CPU convolutions see, then the PNG's
      rounding; one fixed generator an image);
    * the loop it runs is the JAX CLI's with the JAX CLI's arguments: the
      h-Edit modes ``h_edit_masactrl`` on the inversion's trajectory, EF /
      PnP-Inv ``ef_or_pnp_inv_p2p`` with a MasaCtrl control of both images
      and no trajectory; eta 1 on the DDIM grid (no step offset) after a DDIM
      inversion, the empty source prompt.  ``test_masactrl_loops_match_jax``
      holds those loops in these configurations to the JAX scans."""
    loop, ddim, use_xts = VARIANTS[mode]
    module, name = (h_edit_ctrl, "h_edit_masactrl") if loop == "h_edit" else (
        baselines, "ef_or_pnp_inv_p2p")
    real, calls = getattr(module, name), []

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    sweep = ["--mode", mode, "--step", str(START_STEP), "--tiny", "--device", "cpu",
             "--num_diffusion_steps", str(STEPS), "--data_path", str(data_dir),
             "--mapping_file", str(data_dir / "mapping.json")]
    assert main([*sweep, "--data_parallel", "2", "--output_path", str(tmp_path / "b2")]) == 0
    assert main([*sweep, "--output_path", str(tmp_path / "b1")]) == 0
    two, one = sorted((tmp_path / "b2").rglob("*.png")), sorted((tmp_path / "b1").rglob("*.png"))
    assert [p.name for p in two] == [p.name for p in one] == ["im0.png", "im1.png"]
    assert two[0].parent.name == f"{mode}_steps_{STEPS}_skip_0"
    for a, b in zip(two, one):
        pa, pb = (np.asarray(Image.open(p)).astype(np.int32) for p in (a, b))
        assert pa.shape == (64, 64, 3) and pa.std() > 0
        assert np.abs(pa - pb).max() <= 2

    assert [c[0][2].shape[0] for c in calls] == [2, 1, 1]   # batched, then one an image
    args, kw = calls[0]
    sched, ctx3 = args[1], kw["ctx3"]
    assert sched.timesteps.tolist() == JSchedule.create(
        STEPS, steps_offset=0 if ddim else 1).timesteps.tolist()
    np.testing.assert_array_equal(ctx3[:, 1].numpy(), ctx3[:, 0].numpy())   # src = ""
    assert kw["after_skip_steps"] == STEPS
    if loop == "h_edit":
        assert kw["cfg"] == HEditConfig(**CLI_CFG, is_ddim_inversion=ddim)
        assert (kw["start_step"], kw["start_layer"]) == (START_STEP, 10)
        assert kw["xts"].shape[1] == STEPS + 1
        np.testing.assert_array_equal(kw["xts"][:, STEPS].numpy(), args[2].numpy())
    else:
        assert kw.get("xts") is None and kw.get("local_blend") is None
        assert (kw["cfg_src"], kw["cfg_tar"], kw["eta"], kw["is_ddim_inversion"]) == (
            1.0, 7.5, 1.0, ddim)
        assert kw["control"] == MasaCtrlControl(start_step=START_STEP, num_images=2)


def test_masactrl_refuses_the_indexed_source_step(pipe):
    """MasaCtrl consumes the uncond source row: EF / PnP-Inv with it takes
    the 4-row pair step, and a stored trajectory is refused by name."""
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="MasaCtrl"):
        baselines.ef_or_pnp_inv_p2p(pipe.unet, pipe.schedule, x, torch.zeros(1, STEPS, 8, 8, 4),
                                    ctx3=torch.zeros(1, 3, 77, 32), cfg_src=1.0, cfg_tar=7.5,
                                    after_skip_steps=STEPS, control=MasaCtrlControl(),
                                    xts=torch.zeros(1, STEPS + 1, 8, 8, 4))
