"""The PyTorch port's general h-Edit + P2P loop on the CPU against the JAX
package's ``h_edit_p2p`` with the tiny UNet: explicit and implicit, several
optimisation steps with cfg_src != 1, after a DDIM inversion, with and without
the stored trajectory and in-loop residuals, with and without a LocalBlend; and
the flagship configuration against the flagship loop written out step by step.

The tiny UNet's weights are the port's seeded init, carried to the JAX model
by ``hedit_tpu.io_utils.weights.convert_unet``; latents, residuals, contexts
and controls are numpy-seeded and fed to both packages.  The port runs two
images in one batch, the JAX scan each image alone.  float32 on both sides.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.control.p2p import LocalBlendState as JLocalBlendState
from hedit_tpu.control.p2p import P2PControl as JP2PControl
from hedit_tpu.core.schedule import Schedule as JSchedule
from hedit_tpu.edit.h_edit import HEditConfig as JHEditConfig
from hedit_tpu.edit.h_edit_p2p import h_edit_p2p as j_h_edit_p2p
from hedit_tpu.io_utils.weights import convert_unet
from hedit_tpu.models.unet_sd import UNet2DCondition as JUNet
from hedit_tpu.models.unet_sd import UNetConfig as JUNetConfig
from hedit_tpu_torch.control.p2p import (
    LocalBlendState, P2PControl, accumulate_store, apply_local_blend, stack_blends,
    stack_controls,
)
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit.h_edit import HEditConfig
from hedit_tpu_torch.edit.h_edit_p2p import h_edit_p2p, h_edit_p2p_flagship
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

S = 4              # inversion steps; the loops run N = S or S - 1 of them
HEADS, RES = 2, 4  # tiny UNet heads; store grid of a 16x16 latent
BASE = dict(cfg_src_edit=2.0, cfg_tar=4.0)
STATIC = dict(mode="replace", use_reweight=True, self_replace_until=2, blend_px=RES * RES)


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
    return create_sd_pipeline(tiny=True, num_inference_steps=S, seed=0, device="cpu")


@pytest.fixture(scope="module")
def jax_eps(pipe):
    params = convert_unet({k: v.numpy() for k, v in pipe.unet.state_dict().items()})
    junet = JUNet(JUNetConfig.tiny())

    def eps_fn(x, t, c, ctrl):
        if getattr(ctrl, "stores_attn", False):
            out, aux = junet.apply(params, x, t, c, ctrl, True, mutable=["attn_store"])
            return out, aux["attn_store"]
        return junet.apply(params, x, t, c, ctrl)

    return eps_fn


def _image(seed):
    """One image's inputs: trajectory [S+1, 16, 16, 4], residuals [S, ...],
    contexts [uncond, src, tar] [3, 77, 32], control arrays, LocalBlend words."""
    rng = np.random.RandomState(seed)
    xts = (rng.randn(S + 1, 16, 16, 4) * 0.5).astype(np.float32)
    zs = (rng.randn(S, 16, 16, 4) * 0.3).astype(np.float32)
    ctx = (rng.randn(3, 77, 32) * 0.5).astype(np.float32)
    mapper = np.eye(77, dtype=np.float32)
    mapper[[3, 4]] = mapper[[4, 3]]
    alpha = np.zeros((S + 1, 77), np.float32)
    alpha[:3, 1:8] = rng.uniform(0.5, 1.0, (3, 7))
    arrays = dict(cross_alpha=alpha, refine_mapper=np.zeros(77, np.int64),
                  refine_alphas=np.ones(77, np.float32), replace_mapper=mapper,
                  equalizer=rng.uniform(1.0, 2.0, 77).astype(np.float32))
    words = np.zeros((2, 77), np.float32)
    words[:, 3:5] = 1.0
    return xts, zs, ctx, arrays, words


@pytest.fixture(scope="module")
def images():
    return [_image(1), _image(2)]


def _port_state(images, blend: bool):
    control = stack_controls([
        P2PControl(**{k: torch.from_numpy(a)[None] for k, a in im[3].items()}, **STATIC)
        for im in images])
    if not blend:
        return control, None
    return control, stack_blends([
        LocalBlendState(alpha_layers=torch.from_numpy(im[4])[None],
                        store_sum=torch.zeros(1, 5, 2, HEADS, RES * RES, 77),
                        start_blend=torch.tensor([1]), res=RES) for im in images])


# name -> (config, steps run, stored trajectory, in-loop residuals, LocalBlend, grid offset)
VARIANTS = {
    "explicit": (dict(implicit=False), S, False, False, True, 1),
    "implicit-K2-cfg_src": (dict(implicit=True, optimization_steps=2, cfg_src=2.0,
                                 weight_reconstruction=0.3), S - 1, False, False, True, 1),
    "ddim-derive_zs-no_blend": (dict(implicit=True, is_ddim_inversion=True), S, True, True,
                                False, 0),
    "xts-with-zs-explicit": (dict(implicit=False, eta=0.8), S - 1, True, False, True, 1),
}


# With several optimisation steps the L1 pull moves each element by
# rho * sign(x_opt - x_prev_base).  Where that difference is float32 rounding
# noise the two sides may take opposite signs; the element then lands
# 2 * weight * rms(correction) away and the later UNet calls spread it
# (measured with one torch thread: 0.1% of the elements above 1e-4, mean
# 1.2e-5, max 7.5e-3; with eight threads no flip, max 1.2e-5).
L1_FLIPS = dict(mean_tol=1e-4, max_tol=2e-2)


def _assert_close(got, want, mean_tol=1e-5, max_tol=2e-3):
    """The JAX package's own cross-framework comparison, relative to the largest
    latent: a tight mean (a wrong coefficient, index or row moves it by orders
    of magnitude) and a loose max.  One call of the tiny UNet differs by ~2e-6
    between the frameworks; the random tiny UNet at cfg 4 amplifies that ~100x
    over the steps in single elements."""
    d = np.abs(got - want) / max(1.0, np.abs(want).max())
    assert d.mean() < mean_tol, f"mean |diff| {d.mean():.2e} >= {mean_tol:.0e}"
    assert d.max() < max_tol, f"max |diff| {d.max():.2e} >= {max_tol:.0e}"


@pytest.mark.parametrize("name", list(VARIANTS))
def test_h_edit_p2p_matches_jax(pipe, jax_eps, images, name):
    """Both outputs (edited, reconstructed) of both images against the JAX scan
    with the same non-neutral replace + reweight control, inside and outside
    its windows."""
    kw, n, use_xts, derive, blend, offset = VARIANTS[name]
    sched = Schedule.create(S, steps_offset=offset)
    jsched = JSchedule.create(S, steps_offset=offset)
    control, lb = _port_state(images, blend)
    xts = torch.from_numpy(np.stack([im[0] for im in images]))[:, : n + 1]
    zs = None if derive else torch.from_numpy(np.stack([im[1] for im in images]))
    got_edit, got_orig = h_edit_p2p(
        pipe.unet, sched, xts[:, n], zs, ctx3=torch.from_numpy(np.stack([im[2] for im in images])),
        cfg=HEditConfig(**BASE, **kw), after_skip_steps=n, control=control, local_blend=lb,
        xts=xts if use_xts else None, derive_zs=derive)

    def run(xts_, zs_, u, s, t, ctrl, jlb):
        return j_h_edit_p2p(jax_eps, jsched, xts_[n][None], zs_, uncond_ctx=u, src_ctx=s,
                            tar_ctx=t, cfg=JHEditConfig(**BASE, **kw), after_skip_steps=n,
                            control=ctrl, local_blend=jlb,
                            xts=xts_[:, None] if use_xts else None, derive_zs=derive)

    run = jax.jit(run)
    for b, (xts_b, zs_b, ctx, arrays, words) in enumerate(images):
        ctrl = JP2PControl(step=jnp.zeros((), jnp.int32),
                           **{k: jnp.asarray(a) for k, a in arrays.items()}, **STATIC)
        jlb = JLocalBlendState(alpha_layers=jnp.asarray(words),
                               store_sum=jnp.zeros((5, 2, HEADS, RES * RES, 77)),
                               start_blend=1, res=RES) if blend else None
        want_edit, want_orig = run(jnp.asarray(xts_b[: n + 1]),
                                   None if derive else jnp.asarray(zs_b),
                                   *(jnp.asarray(c[None]) for c in ctx), ctrl, jlb)
        tols = L1_FLIPS if kw.get("optimization_steps", 1) > 1 else {}
        _assert_close(got_edit[b].numpy(), np.asarray(want_edit)[0], **tols)
        _assert_close(got_orig[b].numpy(), np.asarray(want_orig)[0], **tols)
    assert np.abs(got_edit.numpy() - got_orig.numpy()).max() > 1e-2  # the edit did something
    if use_xts:  # the source branch is the stored trajectory itself
        np.testing.assert_array_equal(got_orig.numpy(), xts[:, 0].numpy())


def _flagship_step_loop(unet, schedule, cfg, xts, ctx4, control, local_blend, S_):
    """The flagship loop as it stood before the general loop took it over: the
    reference the general loop is held to under the flagship configuration."""
    B = xts.shape[0]
    src_ctx = ctx4[:, 1]
    ctx4c = ctx4.reshape(4 * B, *ctx4.shape[2:])
    ts = schedule.timesteps[-S_:].tolist()
    tts = ts[1:] + [0]
    lb, x_edit, eps_orig = local_blend, xts[:, S_], None
    with torch.no_grad():
        for i in range(S_):
            t, tt = ts[i], tts[i]
            x_orig_t, x_prev_orig = xts[:, S_ - i], xts[:, S_ - 1 - i]
            eps_src = unet(x_edit, t, src_ctx).float()
            if eps_orig is None:
                eps_orig = eps_src
            mu = schedule.reverse_step(eps_orig, t, x_orig_t, eta=cfg.eta)
            z = (x_prev_orig - mu) / (cfg.eta * torch.sqrt(schedule.variance(t)))
            x_opt = schedule.reverse_step(eps_src, t, x_edit, eta=cfg.eta, variance_noise=z)
            ctrl = dataclasses.replace(control, step=i, cond_start=2)
            xin4 = torch.stack([x_opt, x_opt, x_prev_orig, x_opt], dim=1)
            store = {}
            eps4 = unet(xin4.reshape(4 * B, *xin4.shape[2:]), tt, ctx4c, ctrl, store)
            eps4 = eps4.float().reshape(B, 4, *eps4.shape[1:])
            lb = accumulate_store(lb, store)
            u_tar, cond_src, c_tar = eps4[:, 0], eps4[:, 1], eps4[:, 3]
            eps_se = u_tar + cfg.cfg_src_edit * (cond_src - u_tar)
            eps_ta = u_tar + cfg.cfg_tar * (c_tar - u_tar)
            x_opt = x_opt + schedule.h_edit_coeff(t, tt, cfg.eta) * (eps_ta - eps_se)
            pair = apply_local_blend(lb, torch.stack([x_prev_orig, x_opt], dim=1), i)
            x_edit, eps_orig = pair[:, 1], eps4[:, 2]
    return x_edit


def test_general_loop_under_the_flagship_configuration_is_the_flagship_loop(pipe, images):
    """``h_edit_p2p`` with xts + derive_zs, implicit, cfg_src 1, one
    optimisation step, and ``h_edit_p2p_flagship`` around it, give bit for bit
    what the flagship's own step loop gave: same calls, same float32
    association."""
    sched = Schedule.create(S)
    control, lb = _port_state(images, True)
    xts = torch.from_numpy(np.stack([im[0] for im in images]))
    ctx3 = torch.from_numpy(np.stack([im[2] for im in images]))
    cfg = HEditConfig(**BASE)
    want = _flagship_step_loop(pipe.unet, sched, cfg, xts, ctx3[:, [0, 1, 1, 2]], control, lb, S)
    got, orig = h_edit_p2p(pipe.unet, sched, xts[:, S], None, ctx3=ctx3, cfg=cfg,
                           after_skip_steps=S, control=control, local_blend=lb, xts=xts,
                           derive_zs=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(orig.numpy(), xts[:, 0].numpy())
    wrapped = h_edit_p2p_flagship(pipe.unet, sched, cfg, xts=xts, ctx4=ctx3[:, [0, 1, 1, 2]],
                                  control=control, local_blend=lb, after_skip_steps=S)
    np.testing.assert_array_equal(wrapped.numpy(), want.numpy())


def test_h_edit_p2p_batching_and_refusals(pipe, images):
    """Two images in one batch equal each image alone (K = 2: the L1 pull's RMS
    and 1 / size are per image; a mean over the batch would move every element
    by O(0.1)), one image twice gives bitwise equal rows, and
    what the loop cannot run is refused."""
    sched = Schedule.create(S)
    cfg = HEditConfig(**BASE, optimization_steps=2, cfg_src=2.0)

    def run(imgs):
        control, lb = _port_state(imgs, True)
        xts = torch.from_numpy(np.stack([im[0] for im in imgs]))
        return h_edit_p2p(pipe.unet, sched, xts[:, S],
                          torch.from_numpy(np.stack([im[1] for im in imgs])),
                          ctx3=torch.from_numpy(np.stack([im[2] for im in imgs])), cfg=cfg,
                          after_skip_steps=S, control=control, local_blend=lb)[0].numpy()

    both = run(images)
    for b, im in enumerate(images):
        _assert_close(both[b], run([im])[0], **L1_FLIPS)
    twice = run([images[0], images[0]])
    np.testing.assert_array_equal(twice[0], twice[1])

    control, lb = _port_state(images, True)
    xts = torch.from_numpy(np.stack([im[0] for im in images]))
    zs = torch.from_numpy(np.stack([im[1] for im in images]))
    ctx3 = torch.from_numpy(np.stack([im[2] for im in images]))
    call = dict(ctx3=ctx3, after_skip_steps=S, control=control, local_blend=lb)
    with pytest.raises(ValueError, match="derive_zs"):    # derive_zs without xts
        h_edit_p2p(pipe.unet, sched, xts[:, S], None, cfg=HEditConfig(**BASE), derive_zs=True,
                   **call)
    with pytest.raises(ValueError, match="derive_zs"):    # derive_zs at cfg_src != 1
        h_edit_p2p(pipe.unet, sched, xts[:, S], None, cfg=cfg, xts=xts, derive_zs=True, **call)
    with pytest.raises(ValueError, match="residuals"):    # neither zs nor derive_zs
        h_edit_p2p(pipe.unet, sched, xts[:, S], None, cfg=cfg, **call)
    with pytest.raises(ValueError, match="trajectory points"):
        h_edit_p2p(pipe.unet, sched, xts[:, S], zs, cfg=cfg, xts=xts[:, :S], **call)
    with pytest.raises(ValueError, match="images"):
        h_edit_p2p(pipe.unet, sched, xts[:1, S], zs[:1], cfg=cfg,
                   **dict(call, ctx3=ctx3[:1]))
