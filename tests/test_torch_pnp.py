"""The port's Plug-and-Play slice on the CPU against the JAX package with the
tiny models: ``PnPControl`` (``map_qkv`` on every attention layer,
``map_features`` at every feature site, the step gates), the UNet's feature
hook, the loops ``h_edit_pnp`` (R and D), ``ef_or_pnp_inv_w_pnp`` (EF and
PnP-Inv, residuals derived in the loop), ``negative_prompt_pnp`` and
``nmg_pnp_loop``, and ``python -m hedit_tpu_torch.cli.main_plugnplay`` in
every mode, batched (``--data_parallel 2``) and one image a run
(``null_text_pnp`` itself is held to JAX's in ``test_torch_null_text_pnp.py``).

The loops run on numpy-seeded trajectories, residuals and contexts at the
tiny UNet's 16x16 latents, with gates that switch off mid-loop, so that
``h_edit_pnp``'s one-step shift of the gates shows; the tiny UNet's seeded
weights are carried to the JAX model by
``hedit_tpu.io_utils.weights.convert_unet``.  The port runs two images in one
batch, the JAX scan each image alone, each JAX loop compiled once.  float32
throughout; tolerance ``_assert_close`` (mean 1e-5, max 2e-3 of the largest
latent).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hedit_tpu.control.base import NO_CONTROL as J_NO_CONTROL
from hedit_tpu.control.pnp import PnPControl as JPnPControl
from hedit_tpu.control.pnp import pnp_step_gates as j_pnp_step_gates
from hedit_tpu.core.schedule import Schedule as JSchedule
from hedit_tpu.edit.h_edit import HEditConfig as JHEditConfig
from hedit_tpu.edit.h_edit_ctrl import h_edit_pnp as j_h_edit_pnp
from hedit_tpu.edit.pnp_baselines import ef_or_pnp_inv_w_pnp as j_ef_or_pnp_inv_w_pnp
from hedit_tpu.edit.pnp_baselines import negative_prompt_pnp as j_negative_prompt_pnp
from hedit_tpu.edit.pnp_baselines import nmg_pnp_loop as j_nmg_pnp_loop
from hedit_tpu.io_utils.weights import convert_unet
from hedit_tpu.models.unet_sd import UNet2DCondition as JUNet
from hedit_tpu.models.unet_sd import UNetConfig as JUNetConfig
from hedit_tpu.models.unet_sd import _build_tags as j_build_tags
from hedit_tpu_torch.cli import main_plugnplay
from hedit_tpu_torch.control.base import NO_CONTROL
from hedit_tpu_torch.control.masactrl import MasaCtrlControl
from hedit_tpu_torch.control.masactrl_auto import CrossMapStore
from hedit_tpu_torch.control.masactrl_mask import MasaCtrlMaskControl
from hedit_tpu_torch.control.p2p import neutral_control
from hedit_tpu_torch.control.pnp import PNP_CONV_SITE, PnPControl, pnp_step_gates
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit import h_edit_ctrl, pnp_baselines
from hedit_tpu_torch.edit.h_edit import HEditConfig
from hedit_tpu_torch.models.unet_sd import UNetConfig, _build_tags
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

STEPS = 4
# gates of pnp_step_gates(4, 0.5, 0.75): q / k on for steps 0-1, conv for 0-2
ATTN_T, F_T = 0.5, 0.75
GATES = [(True, True), (True, False), (False, True), (False, False)]


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
    ctrl)``."""
    params = convert_unet({k: v.numpy() for k, v in pipe.unet.state_dict().items()})
    junet = JUNet(JUNetConfig.tiny())
    return lambda x, t, c, ctrl: junet.apply(params, x, t, c, ctrl)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _assert_close(got, want, mean_tol=1e-5, max_tol=2e-3):
    """The loop tolerance of ``test_torch_masactrl.py``, relative to the
    largest latent: a tight mean (a wrong coefficient, row or gate moves it by
    orders of magnitude) and a loose max (the random tiny UNet at cfg 7.5
    amplifies the frameworks' float32 differences over the steps in single
    elements)."""
    d = np.abs(got - want) / max(1.0, np.abs(want).max())
    assert d.mean() < mean_tol, f"mean |diff| {d.mean():.2e} >= {mean_tol:.0e}"
    assert d.max() < max_tol, f"max |diff| {d.max():.2e} >= {max_tol:.0e}"


# ------------------------------------------------------------- controls #

def _flat_tags(tags):
    return [t for place in ("down", "mid", "up")
            for blk in ([tags[place]] if place == "mid" else tags[place])
            for pair in blk for t in pair]


SITES = [f"up_{b}_resnet_{i}" for b in range(4) for i in range(3)] + ["down_0_resnet_0", ""]


def test_pnp_control_matches_jax_per_image_pair():
    """``map_qkv`` on every attention layer of the tiny and SD-1.5 models and
    ``map_features`` at every feature site, on two images' [source, target]
    rows in one batch, in all four gate states: each image's pair equals JAX's
    control on that pair alone.  The injected copy keeps the input's strides
    (channels-last features stay channels-last, for the GroupNorm kernel that
    reads them next), the inputs are not written, and v and the untouched
    layers come back as the same tensors.  ``pnp_step_gates`` is JAX's."""
    rng = np.random.RandomState(0)
    q, k, v = (_rand(rng, 4, 6, 16) for _ in range(3))
    h = _rand(rng, 4, 8, 5, 5)                              # [rows, C, H, W]
    for qk_on, conv_on in GATES:
        ctrl = PnPControl(qk_on=qk_on, conv_on=conv_on, num_images=2)
        jctrl = JPnPControl(qk_on=jnp.asarray(qk_on), conv_on=jnp.asarray(conv_on))
        for config in ("tiny", "sd15"):
            mine = _flat_tags(_build_tags(getattr(UNetConfig, config)()))
            theirs = _flat_tags(j_build_tags(getattr(JUNetConfig, config)()))
            for tag, jtag in zip(mine, theirs):
                tq, tk, tv = (torch.from_numpy(a.copy()) for a in (q, k, v))
                got = ctrl.map_qkv(tq, tk, tv, tag)
                assert got[2] is tv
                for t, a in zip((tq, tk, tv), (q, k, v)):
                    np.testing.assert_array_equal(t.numpy(), a)
                for img in range(2):
                    rows = slice(2 * img, 2 * img + 2)
                    want = jctrl.map_qkv(*(jnp.asarray(a[rows]) for a in (q, k, v)), jtag)
                    for g, w in zip(got, want):
                        np.testing.assert_array_equal(g[rows].numpy(), np.asarray(w))
                injected = qk_on and not tag.is_cross and tag.up_block_index in (1, 2, 3) and (
                    (tag.up_block_index, tag.inner_index) != (1, 0))
                assert (got[0] is not tq) == injected and (got[1] is not tk) == injected
        th = torch.from_numpy(h.copy()).contiguous(memory_format=torch.channels_last)
        for site in SITES:
            got = ctrl.map_features(th, site)
            assert got.stride() == th.stride()
            np.testing.assert_array_equal(th.numpy(), h)
            assert (got is not th) == (conv_on and site == PNP_CONV_SITE)
            for img in range(2):
                rows = slice(2 * img, 2 * img + 2)
                want = jctrl.map_features(jnp.asarray(h[rows].transpose(0, 2, 3, 1)), site)
                np.testing.assert_array_equal(got[rows].numpy().transpose(0, 2, 3, 1),
                                              np.asarray(want))
    with pytest.raises(ValueError, match="pairs"):
        PnPControl(qk_on=True, num_images=3).map_qkv(*(torch.zeros(4, 6, 16),) * 3,
                                                     mine[-2])
    for case in ((STEPS, ATTN_T, F_T), (10, 0.35, 0.45), (50, 0.35, 0.45)):
        got = pnp_step_gates(*case)
        want = j_pnp_step_gates(*case)
        assert [list(g) for g in got] == [np.asarray(w).tolist() for w in want]
    assert pnp_step_gates(STEPS, ATTN_T, F_T) == ([True, True, False, False],
                                                  [True, True, True, False])


def test_feature_sites_and_the_other_controls_identity(pipe):
    """The port's UNet names its up blocks' resnets as the JAX model's
    feature sites (``up_{block}_resnet_{layer}``, set when it is built), no
    other resnet has one, and every other control's ``map_features`` returns
    its input, as each JAX control's does."""
    named = {name: m.feature_site for name, m in pipe.unet.named_modules()
             if hasattr(m, "feature_site")}
    assert {n: s for n, s in named.items() if s} == {
        f"up_blocks.{b}.resnets.{i}": f"up_{b}_resnet_{i}" for b in range(4) for i in range(3)}
    assert all(not m.feature_site for n, m in pipe.vae.named_modules()
               if hasattr(m, "feature_site"))
    assert sum(1 for s in named.values() if not s) == 10   # down and mid resnets
    h = torch.randn(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    controls = [NO_CONTROL, neutral_control(STEPS, 256), MasaCtrlControl(step=5),
                MasaCtrlMaskControl(mask_s=torch.ones(1, 4, 4), mask_t=torch.ones(1, 4, 4)),
                CrossMapStore()]
    for ctrl in controls:
        for site in SITES:
            assert ctrl.map_features(h, site) is h
    hj = jnp.asarray(h.numpy())
    assert all(J_NO_CONTROL.map_features(hj, s) is hj for s in SITES)


def test_unet_under_pnp_matches_jax(pipe, jax_eps):
    """One tiny-UNet call of two images x [source, target] under
    ``PnPControl`` in each gate state, against the JAX tiny UNet with JAX's
    control on each image's pair.  The source rows are the uncontrolled
    call's; each gate alone changes the target rows."""
    rng = np.random.RandomState(3)
    x = _rand(rng, 4, 16, 16, 4) * 0.5
    ctx = _rand(rng, 4, 77, 32) * 0.5
    t = 601
    j_call = jax.jit(lambda x_, c_, ctrl: jax_eps(x_, jnp.full((2,), t, jnp.int32), c_, ctrl))
    plain = pipe.unet(torch.from_numpy(x), t, torch.from_numpy(ctx)).numpy()
    for qk_on, conv_on in GATES:
        ctrl = PnPControl(qk_on=qk_on, conv_on=conv_on, num_images=2)
        got = pipe.unet(torch.from_numpy(x), t, torch.from_numpy(ctx), ctrl).numpy()
        jctrl = JPnPControl(qk_on=jnp.asarray(qk_on), conv_on=jnp.asarray(conv_on))
        for img in range(2):
            rows = slice(2 * img, 2 * img + 2)
            want = np.asarray(j_call(jnp.asarray(x[rows]), jnp.asarray(ctx[rows]), jctrl))
            np.testing.assert_allclose(got[rows], want, rtol=0, atol=1e-4 * np.abs(want).max())
        np.testing.assert_allclose(got[0::2], plain[0::2], rtol=0, atol=1e-6)
        moved = np.abs(got[1::2] - plain[1::2]).max()
        assert (moved > 1e-3) == (qk_on or conv_on), (qk_on, conv_on, moved)


# ----------------------------------------------------------------- loops #

def _image(seed):
    """One image's inputs at the tiny UNet's 16x16 latents: trajectory
    [S+1, 16, 16, 4], residuals [S, ...], contexts [uncond, src, tar]."""
    rng = np.random.RandomState(seed)
    return (_rand(rng, STEPS + 1, 16, 16, 4) * 0.5, _rand(rng, STEPS, 16, 16, 4) * 0.3,
            _rand(rng, 3, 77, 32) * 0.5)


# mode -> DDIM inversion: the JAX CLI's configurations (eta 1, cfg_src 1,
# cfg_src_edit 5, cfg_tar 7.5, one optimisation step); NMG at grad_scale 5,
# where the two frameworks' gradients agree to the stated tolerance
VARIANTS = {"h_edit_R_pnp": False, "h_edit_D_pnp": True, "ef_pnp": False,
            "pnp_inv_w_pnp": True, "np_pnp": True, "nmg_pnp": True}
CLI_CFG = dict(cfg_src=1.0, cfg_src_edit=5.0, cfg_tar=7.5, eta=1.0, optimization_steps=1)
NMG_GRAD_SCALE = 5.0


def _jax_loop(name, jax_eps, qk, conv):
    """The JAX loop of a variant, jitted: (xT, zs, xts, uncond, src, tar) of
    one image -> (edited, source branch)."""
    ddim = VARIANTS[name]
    sched = JSchedule.create(STEPS, steps_offset=0 if ddim else 1)
    gates = dict(after_skip_steps=STEPS, qk_mask=jnp.asarray(qk), conv_mask=jnp.asarray(conv))

    def run(xT, zs, xts, u, s, t):
        ctx = dict(uncond_ctx=u, src_ctx=s, tar_ctx=t)
        if name.startswith("h_edit"):
            return j_h_edit_pnp(jax_eps, sched, xT, zs, **ctx,
                                cfg=JHEditConfig(**CLI_CFG, is_ddim_inversion=ddim), xts=xts,
                                **gates)
        if name in ("ef_pnp", "pnp_inv_w_pnp"):
            return j_ef_or_pnp_inv_w_pnp(jax_eps, sched, xT, None, **ctx, cfg_src=1.0,
                                         cfg_tar=7.5, eta=1.0, is_ddim_inversion=ddim, xts=xts,
                                         derive_zs=True, **gates)
        if name == "np_pnp":
            return j_negative_prompt_pnp(jax_eps, sched, xT, zs, **ctx, cfg_tar=7.5, **gates)
        return j_nmg_pnp_loop(jax_eps, sched, xT, xts, zs, **ctx, cfg_tar=7.5,
                              grad_scale=NMG_GRAD_SCALE, **gates)
    return jax.jit(run)


def _port_loop(name, pipe, xts, zs, ctx3, qk, conv):
    ddim = VARIANTS[name]
    sched = Schedule.create(STEPS, steps_offset=0 if ddim else 1)
    gates = dict(after_skip_steps=STEPS, qk_mask=qk, conv_mask=conv)
    xT = xts[:, STEPS]
    if name.startswith("h_edit"):
        return h_edit_ctrl.h_edit_pnp(pipe.unet, sched, xT, zs, ctx3=ctx3,
                                      cfg=HEditConfig(**CLI_CFG, is_ddim_inversion=ddim),
                                      xts=xts, **gates)
    if name in ("ef_pnp", "pnp_inv_w_pnp"):
        return pnp_baselines.ef_or_pnp_inv_w_pnp(pipe.unet, sched, xT, None, ctx3=ctx3,
                                                 cfg_src=1.0, cfg_tar=7.5, eta=1.0,
                                                 is_ddim_inversion=ddim, xts=xts,
                                                 derive_zs=True, **gates)
    if name == "np_pnp":
        return pnp_baselines.negative_prompt_pnp(pipe.unet, sched, xT, ctx3=ctx3, cfg_tar=7.5,
                                                 **gates)
    return pnp_baselines.nmg_pnp_loop(pipe.unet, sched, xts=xts, ctx3=ctx3, cfg_tar=7.5,
                                      grad_scale=NMG_GRAD_SCALE, **gates)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_pnp_loops_match_jax(name, pipe, jax_eps):
    """Each PnP loop on two images in one batch against the JAX scan on each
    image, edited and source branch, with the gates of
    ``pnp_step_gates(4, 0.5, 0.75)``, which switch off mid-loop: ``h_edit_pnp``
    shifts them by one step (its pair call runs at the next timestep), the
    baselines do not.  The stored-trajectory loops return the trajectory's
    source latent as their source branch.  PnP is engaged: with every gate
    off the edit differs."""
    qk, conv = pnp_step_gates(STEPS, ATTN_T, F_T)
    images = [_image(1), _image(2)]
    xts = torch.from_numpy(np.stack([im[0] for im in images]))
    zs = torch.from_numpy(np.stack([im[1] for im in images]))
    ctx3 = torch.from_numpy(np.stack([im[2] for im in images]))
    edited, recon = _port_loop(name, pipe, xts, zs, ctx3, qk, conv)
    run = _jax_loop(name, jax_eps, qk, conv)
    for b, (xts_b, zs_b, ctx) in enumerate(images):
        want_edit, want_recon = run(jnp.asarray(xts_b[STEPS][None]), jnp.asarray(zs_b),
                                    jnp.asarray(xts_b), *(jnp.asarray(c[None]) for c in ctx))
        _assert_close(edited[b].numpy(), np.asarray(want_edit)[0])
        _assert_close(recon[b].numpy(), np.asarray(want_recon)[0])
    if name.startswith("h_edit") or name in ("ef_pnp", "pnp_inv_w_pnp"):
        np.testing.assert_array_equal(recon.numpy(), xts[:, 0].numpy())
    assert np.isfinite(edited.numpy()).all()
    off, _ = _port_loop(name, pipe, xts, zs, ctx3, [False] * STEPS, [False] * STEPS)
    scale = np.abs(edited.numpy()).max()
    assert np.abs(off.numpy() - edited.numpy()).max() > 1e-3 * scale


def test_pnp_loops_refuse_what_they_cannot_run(pipe):
    """The JAX loops' asserts as ``ValueError``s: residuals derived in the
    loop need the trajectory, and for DDPM eta > 0 and cfg_src 1; the gates
    must cover the loop."""
    x = torch.zeros(1, 8, 8, 4)
    ctx3 = torch.zeros(1, 3, 77, 32)
    xts = torch.zeros(1, STEPS + 1, 8, 8, 4)
    gates = dict(after_skip_steps=STEPS, qk_mask=[True] * STEPS, conv_mask=[True] * STEPS)
    call = dict(ctx3=ctx3, cfg_tar=7.5, **gates)
    ef = pnp_baselines.ef_or_pnp_inv_w_pnp
    for kw, match in ((dict(cfg_src=1.0, eta=1.0, is_ddim_inversion=False), "trajectory"),
                      (dict(cfg_src=1.0, eta=0.0, is_ddim_inversion=False, xts=xts), "eta > 0"),
                      (dict(cfg_src=2.0, eta=1.0, is_ddim_inversion=False, xts=xts), "cfg_src")):
        with pytest.raises(ValueError, match=match):
            ef(pipe.unet, pipe.schedule, x, None, derive_zs=True, **call, **kw)
    with pytest.raises(ValueError, match="residuals"):
        ef(pipe.unet, pipe.schedule, x, None, cfg_src=1.0, eta=1.0, is_ddim_inversion=False,
           **call)
    with pytest.raises(ValueError, match="gates"):
        pnp_baselines.negative_prompt_pnp(pipe.unet, pipe.schedule, x, ctx3=ctx3, cfg_tar=7.5,
                                          after_skip_steps=STEPS, qk_mask=[True],
                                          conv_mask=[True] * STEPS)
    with pytest.raises(ValueError, match="gates"):
        h_edit_ctrl.h_edit_pnp(pipe.unet, pipe.schedule, x, torch.zeros(1, STEPS, 8, 8, 4),
                               ctx3=ctx3, cfg=HEditConfig(), after_skip_steps=STEPS,
                               qk_mask=[True] * 3, conv_mask=[True] * STEPS)


# ------------------------------------------------------------------- CLI #

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two seeded 64x64 images and a mapping file over them."""
    root = tmp_path_factory.mktemp("pnp")
    rs = np.random.RandomState(0)
    (root / "annotation_images").mkdir()
    for i in range(2):
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(
            root / "annotation_images" / f"im{i}.png")
    (root / "mapping.json").write_text(json.dumps({
        f"k{i}": {"image_path": f"im{i}.png", "original_prompt": "a green [lizard]",
                  "editing_prompt": "a brown [lizard]", "editing_type_id": "0"}
        for i in range(2)}))
    return root


# mode -> (module, loop): where the CLI's spy sits
CLI_LOOPS = {"h_edit_R_pnp": (h_edit_ctrl, "h_edit_pnp"),
             "h_edit_D_pnp": (h_edit_ctrl, "h_edit_pnp"),
             "ef_pnp": (pnp_baselines, "ef_or_pnp_inv_w_pnp"),
             "pnp_inv_w_pnp": (pnp_baselines, "ef_or_pnp_inv_w_pnp"),
             "np_pnp": (pnp_baselines, "negative_prompt_pnp"),
             "nmg_pnp": (pnp_baselines, "nmg_pnp_loop"),
             "nt_pnp": (pnp_baselines, "null_text_pnp")}


# nt_pnp's batched and one-an-image PNGs differ by more than rounding: the CPU
# convolutions round differently at batch 2 and 1, and Adam's eps turns such a
# difference at a coordinate whose gradient is near 0 into a step of O(lr)
# there, every iteration.  Measured over 1, 2, 4 and 8 CPU threads: at most
# 9-32 levels, 0.5-4.5 on the mean (8 threads vary run to run).  In float64,
# where the convolutions round alike, the loop is batch-independent bit for
# bit (test_torch_null_text_pnp.py).  (max, mean) in levels of 255:
BATCH_LEVELS = {"nt_pnp": (64, 8)}


def test_main_plugnplay_runs_every_mode(data_dir, tmp_path, monkeypatch):
    """The CLI with ``--tiny --device cpu`` over two images, in every mode,
    in the directory the JAX CLI names:

    * ``--data_parallel 2`` against one run an image: the same PNGs within 2
      of 255 levels (the batch size the CPU convolutions see, then the PNG's
      rounding; one fixed generator an image), ``nt_pnp`` within
      ``BATCH_LEVELS``;
    * the loop it runs is the JAX CLI's with the JAX CLI's arguments: the
      gates of ``pnp_step_gates(N, 0.35, 0.45)``, unshifted; the DDIM grid
      (no step offset) and eta 1 with ``is_ddim_inversion`` in the D,
      PnP-Inv, NMG and negative-prompt modes; the residuals derived in the
      loop (``derive_zs``) in EF / PnP-Inv, whose inversion then makes no
      residual pass; null-text at its defaults (no ``optimization_steps``
      passed: 10 Adam iterations at most), from the trajectory's end; the
      source prompt read from ``original_prompt``; the edit finite.
      ``test_pnp_loops_match_jax`` and ``test_torch_null_text_pnp.py`` hold
      those loops to the JAX scans."""
    calls, current = {}, []
    for module, name in set(CLI_LOOPS.values()):
        def spy(*args, _real=getattr(module, name), **kw):
            out = _real(*args, **kw)
            calls.setdefault(current[-1], []).append((args, kw, out))
            return out

        monkeypatch.setattr(module, name, spy)
    for mode in CLI_LOOPS:
        current.append(mode)
        ddim = main_plugnplay.is_ddim_mode(main_plugnplay.parse_args(["--mode", mode]))
        sweep = ["--mode", mode, "--tiny", "--device", "cpu", "--num_diffusion_steps",
                 str(STEPS), "--data_path", str(data_dir), "--mapping_file",
                 str(data_dir / "mapping.json")]
        two, one = tmp_path / mode / "b2", tmp_path / mode / "b1"
        assert main_plugnplay.main([*sweep, "--data_parallel", "2", "--output_path", str(two)]) == 0
        assert main_plugnplay.main([*sweep, "--output_path", str(one)]) == 0
        two, one = sorted(two.rglob("*.png")), sorted(one.rglob("*.png"))
        assert [p.name for p in two] == [p.name for p in one] == ["im0.png", "im1.png"]
        assert two[0].parent.name == f"{mode}_steps_{STEPS}_skip_0_ft_0.45_attnt_0.35"
        for a, b in zip(two, one):
            pa, pb = (np.asarray(Image.open(p)).astype(np.int32) for p in (a, b))
            assert pa.shape == (64, 64, 3) and pa.std() > 0
            most, mean = BATCH_LEVELS.get(mode, (2, 2))
            assert np.abs(pa - pb).max() <= most and np.abs(pa - pb).mean() <= mean, mode

        args, kw, _ = calls[mode][0]
        assert len(calls[mode]) == 3
        assert all(bool(torch.isfinite(out[0]).all()) for *_, out in calls[mode])
        assert kw["ctx3"].shape[0] == 2
        sched = args[1]
        assert sched.timesteps.tolist() == JSchedule.create(
            STEPS, steps_offset=0 if ddim else 1).timesteps.tolist()
        assert (kw["after_skip_steps"], kw["qk_mask"], kw["conv_mask"]) == (
            STEPS, [True, False, False, False], [True, False, False, False])
        ctx3 = kw["ctx3"]
        assert not torch.equal(ctx3[:, 1], ctx3[:, 0]) and not torch.equal(ctx3[:, 1], ctx3[:, 2])
        if mode.startswith("h_edit"):
            assert kw["cfg"] == HEditConfig(**CLI_CFG, is_ddim_inversion=ddim)
            assert args[3].shape[1] == STEPS                 # the inversion's residuals
        elif mode in ("ef_pnp", "pnp_inv_w_pnp"):
            assert (kw["cfg_src"], kw["cfg_tar"], kw["eta"], kw["is_ddim_inversion"],
                    kw["derive_zs"]) == (1.0, 7.5, 1.0, ddim, True)
            assert args[3] is None                           # no residual pass
        elif mode == "nmg_pnp":
            assert kw["cfg_tar"] == 7.5 and kw["xts"].shape[1] == STEPS + 1
        elif mode == "nt_pnp":
            assert kw["cfg_tar"] == 7.5 and len(args) == 3 and "optimization_steps" not in kw
        else:
            assert kw["cfg_tar"] == 7.5 and len(args) == 3    # xT only
        if len(args) > 2 and "xts" in kw:                    # xT is the trajectory's end
            assert kw["xts"].shape[1] == STEPS + 1
            np.testing.assert_array_equal(kw["xts"][:, STEPS].numpy(), args[2].numpy())
    assert main_plugnplay.derives_zs(main_plugnplay.parse_args(
        ["--mode", "ef_pnp", "--cfg_src", "2"])) is False
