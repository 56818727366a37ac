"""The PyTorch port's EF / PnP-Inv + P2P pair loop on the CPU against the JAX
package's ``ef_or_pnp_inv_p2p`` with the tiny UNet: the 4-row pair step, the
indexed 3-row step on a stored trajectory (cond_start = 1), in-loop residuals,
and the PnP-Inv edit branch at eta = 0.

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
from hedit_tpu.edit.baselines import ef_or_pnp_inv_p2p as j_ef_or_pnp_inv_p2p
from hedit_tpu.io_utils.weights import convert_unet
from hedit_tpu.models.unet_sd import UNet2DCondition as JUNet
from hedit_tpu.models.unet_sd import UNetConfig as JUNetConfig
from hedit_tpu_torch.control.base import NO_CONTROL
from hedit_tpu_torch.control.p2p import LocalBlendState, P2PControl, stack_blends, stack_controls
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit.baselines import _with_step, ef_or_pnp_inv_p2p
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

S = 4              # inversion steps; the loops run N = S or S - 1 of them
HEADS, RES = 2, 4  # tiny UNet heads; store grid of a 16x16 latent
CFG_TAR = 4.0
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


# name -> (keywords, steps run, stored trajectory, in-loop residuals, LocalBlend, grid offset)
VARIANTS = {
    "ef-pair-cfg_src": (dict(cfg_src=3.0, eta=0.9), S, False, False, True, 1),
    "ef-indexed-derive_zs": (dict(cfg_src=1.0, eta=1.0), S - 1, True, True, True, 1),
    "pnp_inv-indexed-zs": (dict(cfg_src=2.0, eta=1.0, is_ddim_inversion=True), S, True, False,
                           False, 0),
}


def _assert_close(got, want, mean_tol=1e-5, max_tol=2e-3):
    """The JAX package's own cross-framework comparison, relative to the largest
    latent: a tight mean (a wrong coefficient, index or row moves it by orders
    of magnitude) and a loose max (one call of the tiny UNet differs by ~2e-6
    between the frameworks; the random tiny UNet at cfg 4 amplifies that over
    the steps in single elements)."""
    d = np.abs(got - want) / max(1.0, np.abs(want).max())
    assert d.mean() < mean_tol, f"mean |diff| {d.mean():.2e} >= {mean_tol:.0e}"
    assert d.max() < max_tol, f"max |diff| {d.max():.2e} >= {max_tol:.0e}"


def _port_run(pipe, imgs, kw, n, use_xts, derive, blend, offset):
    control, lb = _port_state(imgs, blend)
    xts = torch.from_numpy(np.stack([im[0] for im in imgs]))[:, : n + 1]
    zs = None if derive else torch.from_numpy(np.stack([im[1] for im in imgs]))
    edit, orig = ef_or_pnp_inv_p2p(
        pipe.unet, Schedule.create(S, steps_offset=offset), xts[:, n], zs,
        ctx3=torch.from_numpy(np.stack([im[2] for im in imgs])), cfg_tar=CFG_TAR,
        after_skip_steps=n, control=control, local_blend=lb, xts=xts if use_xts else None,
        derive_zs=derive, **kw)
    return edit.numpy(), orig.numpy()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ef_or_pnp_inv_p2p_matches_jax(pipe, jax_eps, images, name):
    """Both outputs (edited, reconstructed) of both images against the JAX scan
    with the same non-neutral replace + reweight control."""
    kw, n, use_xts, derive, blend, offset = VARIANTS[name]
    got_edit, got_orig = _port_run(pipe, images, *VARIANTS[name])
    jsched = JSchedule.create(S, steps_offset=offset)

    def run(xts_, zs_, u, s, t, ctrl, jlb):
        return j_ef_or_pnp_inv_p2p(jax_eps, jsched, xts_[n][None], zs_, uncond_ctx=u, src_ctx=s,
                                   tar_ctx=t, cfg_tar=CFG_TAR, after_skip_steps=n, control=ctrl,
                                   local_blend=jlb, xts=xts_[:, None] if use_xts else None,
                                   derive_zs=derive, **kw)

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
        _assert_close(got_edit[b], np.asarray(want_edit)[0])
        _assert_close(got_orig[b], np.asarray(want_orig)[0])
    assert np.abs(got_edit - got_orig).max() > 1e-2  # the edit did something
    if use_xts:  # the source branch is the stored trajectory itself
        np.testing.assert_array_equal(got_orig, np.stack([im[0][0] for im in images]))


def test_pair_loop_batching_groups_of_three_and_refusals(pipe, images):
    """Two images in one batch of 3-row groups (cond_start = 1) equal each image
    alone, and one image twice gives equal rows (to rounding: in a 6-row call
    the CPU kernels block the two groups differently); a control without
    ``edit_pair`` may not take the indexed path; ``_with_step`` sets only the
    fields a control has."""
    variant = VARIANTS["ef-indexed-derive_zs"]
    both = _port_run(pipe, images, *variant)[0]
    for b, im in enumerate(images):
        _assert_close(both[b], _port_run(pipe, [im], *variant)[0][0])
    twice = _port_run(pipe, [images[0], images[0]], *variant)[0]
    _assert_close(twice[0], twice[1])
    assert np.abs(both[0] - both[1]).max() > 1e-2

    control, lb = _port_state(images, True)
    stepped = _with_step(control, 3, save_attn=False, cond_start=1, no_such_field=7)
    assert (stepped.step, stepped.save_attn, stepped.cond_start) == (3, False, 1)

    @dataclasses.dataclass(frozen=True)
    class Bare:       # a control with a step and nothing of P2P
        step: int = 0
        num_images: int = 2

    assert _with_step(Bare(), 2, save_attn=True, cond_start=1) == Bare(step=2)
    xts = torch.from_numpy(np.stack([im[0] for im in images]))
    zs = torch.from_numpy(np.stack([im[1] for im in images]))
    call = dict(ctx3=torch.from_numpy(np.stack([im[2] for im in images])), cfg_src=1.0,
                cfg_tar=CFG_TAR, after_skip_steps=S, local_blend=lb)
    sched = Schedule.create(S)
    with pytest.raises(ValueError, match="only exact for P2P"):
        ef_or_pnp_inv_p2p(pipe.unet, sched, xts[:, S], zs, control=Bare(), xts=xts, **call)
    assert not hasattr(NO_CONTROL, "edit_pair")
    with pytest.raises(ValueError, match="derive_zs"):      # DDPM at cfg_src != 1
        ef_or_pnp_inv_p2p(pipe.unet, sched, xts[:, S], None, control=control, xts=xts,
                          derive_zs=True, **dict(call, cfg_src=2.0))
    with pytest.raises(ValueError, match="derive_zs"):      # no stored trajectory
        ef_or_pnp_inv_p2p(pipe.unet, sched, xts[:, S], None, control=control, derive_zs=True,
                          **call)
    with pytest.raises(ValueError, match="residuals"):
        ef_or_pnp_inv_p2p(pipe.unet, sched, xts[:, S], None, control=control, **call)
