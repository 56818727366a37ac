"""The PyTorch port's NMG + P2P slice on the CPU: DDIM inversion and the NMG
loop against the JAX package, batching, and the CLI mode.

The tiny UNet's weights are the port's seeded init, carried to the JAX model
by ``hedit_tpu.io_utils.weights.convert_unet``; latents, contexts and controls
are numpy-seeded and fed to both packages.  float32 on both sides.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.control.p2p import LocalBlendState as JLocalBlendState
from hedit_tpu.control.p2p import P2PControl as JP2PControl
from hedit_tpu.core.schedule import Schedule as JSchedule
from hedit_tpu.edit.baselines import nmg_p2p as j_nmg_p2p
from hedit_tpu.invert.ddim import invert_ddim as j_invert_ddim
from hedit_tpu.io_utils.weights import convert_unet
from hedit_tpu.models.unet_sd import UNet2DCondition as JUNet
from hedit_tpu.models.unet_sd import UNetConfig as JUNetConfig
from hedit_tpu_torch.control.p2p import (
    LocalBlendState, P2PControl, neutral_blend, neutral_control, stack_blends, stack_controls,
)
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit.baselines import nmg_gradient, nmg_p2p
from hedit_tpu_torch.invert.ddim import invert_ddim
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

S = 5              # inversion and editing steps
HEADS, RES = 2, 4  # tiny UNet heads; store grid of a 16x16 latent
CFG_TAR = 4.0
STATIC = dict(mode="replace", use_reweight=True, self_replace_until=2, blend_px=RES * RES)


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its
    share (oversubscribed intra-op threads spin and stall each other)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pipe():
    return create_sd_pipeline(tiny=True, num_inference_steps=S, seed=0, device="cpu")


@pytest.fixture(scope="module")
def sched():
    """The DDIM modes' grid: no steps offset, in both packages."""
    return Schedule.create(S, steps_offset=0), JSchedule.create(S, steps_offset=0)


@pytest.fixture(scope="module")
def jax_eps(pipe):
    """The JAX tiny UNet with the port's weights: (plain eps_fn, controlled eps_fn)."""
    params = convert_unet({k: v.numpy() for k, v in pipe.unet.state_dict().items()})
    junet = JUNet(JUNetConfig.tiny())

    def eps_ctrl(x, t, c, ctrl):
        if getattr(ctrl, "stores_attn", False):
            out, aux = junet.apply(params, x, t, c, ctrl, True, mutable=["attn_store"])
            return out, aux["attn_store"]
        return junet.apply(params, x, t, c, ctrl)

    return (lambda x, t, c: junet.apply(params, x, t, c)), eps_ctrl


def _image(seed):
    """One image's inputs: x0 [1, 16, 16, 4], contexts [uncond, src, tar]
    [3, 77, 32], a non-neutral control's arrays and LocalBlend words."""
    rng = np.random.RandomState(seed)
    x0 = (rng.randn(1, 16, 16, 4) * 0.5).astype(np.float32)
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
    return x0, ctx, arrays, words


@pytest.fixture(scope="module")
def images():
    return [_image(1), _image(2)]


@pytest.fixture(scope="module")
def trajectories(images):
    """Seeded trajectories [2, S+1, 16, 16, 4], the NMG loop's input on both
    sides.  The loss is an L1 distance to these, and its gradient holds the
    sign of every element of (predicted - stored): stored points an O(0.5)
    distance away keep float32 drift of ~1e-6 from flipping a sign, which a
    true inversion trajectory (predicted ~ stored) would not."""
    return np.stack([(np.random.RandomState(10 + i).randn(S + 1, 16, 16, 4) * 0.5)
                     .astype(np.float32) for i in range(len(images))])


# ---------------------------------------------------------------- inversion #

@pytest.mark.parametrize("skip_zs,cfg_scale", [(True, 1.0), (False, 3.5)])
def test_invert_ddim_matches_jax(pipe, sched, jax_eps, images, skip_zs, cfg_scale):
    """Two images inverted in one batched call against the JAX function on
    each image alone: trajectory, xT and (phase 2, ``step_chunk`` 2 over 5
    steps: a ragged last chunk) the un-normalised residuals.  atol 1e-4: a
    UNet call of the two frameworks differs by ~2e-6, the CFG scale 3.5 and
    1 / sqrt(abar_t) (4.6 at t = 800) multiply it and five Euler steps carry
    it along (measured 5e-6 at scale 1, 5e-5 at 3.5)."""
    x0 = np.concatenate([im[0] for im in images])
    ctx = np.stack([im[1] for im in images])
    got = invert_ddim(pipe.unet, sched[0], torch.from_numpy(x0),
                      uncond_ctx=torch.from_numpy(ctx[:, 0]), src_ctx=torch.from_numpy(ctx[:, 1]),
                      cfg_scale=cfg_scale, step_chunk=2, skip_zs=skip_zs)
    assert got.xts.shape == (2, S + 1, 16, 16, 4) and (got.zs is None) == skip_zs
    np.testing.assert_array_equal(got.xts[:, 0].numpy(), x0)
    np.testing.assert_array_equal(got.xT.numpy(), got.xts[:, S].numpy())
    j_run = jax.jit(lambda x, u, c: j_invert_ddim(
        jax_eps[0], sched[1], x, uncond_ctx=u, src_ctx=c, cfg_scale=cfg_scale, step_chunk=2,
        skip_zs=skip_zs))
    for b in range(2):
        want = j_run(jnp.asarray(x0[b:b + 1]), jnp.asarray(ctx[b:b + 1, 0]),
                     jnp.asarray(ctx[b:b + 1, 1]))
        np.testing.assert_allclose(got.xts[b].numpy(), np.asarray(want.xts), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.xT[b].numpy(), np.asarray(want.xT)[0], rtol=0, atol=1e-4)
        if not skip_zs:
            assert got.zs.shape == (2, S, 16, 16, 4)
            # z = x_{t-1} - mu(x_t): the trajectory's drift enters mu times
            # sqrt(abar_{t-1} / abar_t) (2.6 at t = 800) and again through eps
            # (measured 2.3e-4 at scale 3.5)
            np.testing.assert_allclose(got.zs[b].numpy(), np.asarray(want.zs), rtol=0, atol=5e-4)
    assert np.abs(got.xT.numpy() - x0).max() > 1e-2


# ----------------------------------------------------------------- NMG loop #

def _port_controls(imgs, neutral):
    if neutral:
        return (stack_controls([neutral_control(S, RES * RES, cond_start=2)] * len(imgs)),
                stack_blends([neutral_blend(S, HEADS, RES)] * len(imgs)))
    control = stack_controls([
        P2PControl(**{k: torch.from_numpy(a)[None] for k, a in arr.items()}, **STATIC)
        for _, _, arr, _ in imgs])
    blend = stack_blends([
        LocalBlendState(alpha_layers=torch.from_numpy(w)[None],
                        store_sum=torch.zeros(1, 5, 2, HEADS, RES * RES, 77),
                        start_blend=torch.tensor([1]), res=RES)
        for _, _, _, w in imgs])
    return control, blend


def _port_run(pipe, sched, imgs, xts, *, neutral=False, grad_scale=5.0):
    control, blend = _port_controls(imgs, neutral)
    ctx3 = torch.from_numpy(np.stack([im[1] for im in imgs]))
    edit, orig = nmg_p2p(pipe.unet, sched[0], xts=torch.from_numpy(xts), ctx3=ctx3,
                         cfg_tar=CFG_TAR, control=control, local_blend=blend,
                         after_skip_steps=S, grad_scale=grad_scale)
    return edit.numpy(), orig.numpy()


_J_LOOPS = {}


def _jax_run(sched, jax_eps, image, xts, *, neutral, grad_scale):
    """The JAX loop on one image; compiled once a control variant, with
    ``grad_scale`` a traced argument."""
    _, ctx, arrays, words = image
    if neutral:
        control, blend = None, None
    else:
        control = JP2PControl(step=jnp.zeros((), jnp.int32),
                              **{k: jnp.asarray(a) for k, a in arrays.items()}, **STATIC)
        blend = JLocalBlendState(alpha_layers=jnp.asarray(words),
                                 store_sum=jnp.zeros((5, 2, HEADS, RES * RES, 77)),
                                 start_blend=1, res=RES)
    if neutral not in _J_LOOPS:
        _J_LOOPS[neutral] = jax.jit(lambda xts_, u, s, t, ctrl, lb, gs: j_nmg_p2p(
            jax_eps[1], sched[1], xts_[S][None], xts_, jnp.zeros_like(xts_[:S]), uncond_ctx=u,
            src_ctx=s, tar_ctx=t, cfg_tar=CFG_TAR, after_skip_steps=S, control=ctrl,
            local_blend=lb, grad_scale=gs))
    edit, orig = _J_LOOPS[neutral](jnp.asarray(xts), *(jnp.asarray(c[None]) for c in ctx),
                                   control, blend, jnp.float32(grad_scale))
    return np.asarray(edit)[0], np.asarray(orig)[0]


def _assert_close(got, want, mean_tol=1e-5, max_tol=2e-3):
    """The JAX package's own cross-framework comparison: a tight mean (a wrong
    coefficient, index or row moves it by orders of magnitude) and a loose max
    (single-element outliers of other summation orders through chained UNet
    steps); here relative to the largest value, because the NMG loop drives
    the random tiny UNet's latents to 20-100 (1e4 at ``grad_scale`` 5e3),
    where a float32 ulp alone is 1e-5 (1e-3)."""
    d = np.abs(got - want) / max(1.0, np.abs(want).max())
    assert d.mean() < mean_tol, f"mean |diff| {d.mean():.2e} >= {mean_tol:.0e}"
    assert d.max() < max_tol, f"max |diff| {d.max():.2e} >= {max_tol:.0e}"


@pytest.mark.parametrize("neutral", [False, True], ids=["control", "neutral"])
@pytest.mark.parametrize("grad_scale", [5.0, 5e3])
def test_nmg_p2p_matches_jax(pipe, sched, jax_eps, images, trajectories, grad_scale, neutral):
    """Image 0 of the port's batched loop against the JAX loop on the same
    seeded trajectory: the through-UNet L1 gradient (``torch.autograd``
    against ``jax.grad``), the noise-map step, the controlled call with the
    target scale on both rows, LocalBlend; with a non-neutral replace +
    reweight control and an active blend, and with none (the JAX side's
    ``control=None``; the port's neutral control).

    ``grad_scale`` 5.0 holds the loop at the JAX package's standard
    cross-framework tolerance (mean 1e-5, max 2e-3).  The default 5e3
    multiplies the L1 gradient, whose every element is a sign, by 5e3 and the
    guidance by 10: float32 drift of the two frameworks' VJPs lands in the
    reconstruction branch amplified ~5e4 times, so that branch, and the edit
    that shares its controlled call, are held at the loosened bound the JAX
    package's own test uses there (mean 8e-3, max 1e-1)."""
    got_edit, got_orig = _port_run(pipe, sched, images, trajectories, neutral=neutral,
                                   grad_scale=grad_scale)
    want_edit, want_orig = _jax_run(sched, jax_eps, images[0], trajectories[0], neutral=neutral,
                                    grad_scale=grad_scale)
    tols = {} if grad_scale <= 5.0 else dict(mean_tol=8e-3, max_tol=1e-1)
    _assert_close(got_edit[0], want_edit, **tols)
    _assert_close(got_orig[0], want_orig, **tols)
    assert np.abs(got_orig[0] - trajectories[0, 0]).max() > 1e-3  # the guidance moved it
    if neutral:
        # target ctx != source ctx, so the branches part even with no control
        assert np.abs(got_edit[0] - got_orig[0]).max() > 1e-3


def test_nmg_gradient_is_per_image_and_leaves_the_weights_alone(pipe, sched, images,
                                                                trajectories):
    """One step's (d loss / d x, eps_u) for two images at once: each image's
    row equals the call on that image alone (its loss sees its own row only;
    1e-3 of the largest element, the batch size the CPU convolutions see),
    nothing requires a gradient afterwards and no parameter got one.  The
    gradient's values are held to ``jax.grad`` by the loop comparisons above,
    which multiply it by up to 5e4."""
    t = int(sched[0].timesteps[0])
    x, stored = (torch.from_numpy(trajectories[:, i]) for i in (S, S - 1))
    unc = torch.from_numpy(np.stack([im[1][0] for im in images]))
    grad, eps_u = nmg_gradient(pipe.unet, sched[0], x, t, unc, stored)
    assert not grad.requires_grad and not eps_u.requires_grad
    assert all(p.grad is None for p in pipe.unet.parameters())
    assert grad.shape == x.shape and float(grad.abs().max()) > 0
    for b in range(2):
        g1, e1 = nmg_gradient(pipe.unet, sched[0], x[b:b + 1], t, unc[b:b + 1], stored[b:b + 1])
        torch.testing.assert_close(grad[b:b + 1], g1, rtol=0, atol=1e-3 * float(g1.abs().max()))
        torch.testing.assert_close(eps_u[b:b + 1], e1, rtol=0, atol=2e-5)


def test_nmg_batched_matches_per_image(pipe, sched, images, trajectories):
    """Two images in one batched loop equal each image run alone: each image's
    loss gradient, control edits and LocalBlend stay inside its rows.  The only
    difference is the batch size the CPU convolutions see; ``grad_scale`` 5.0
    keeps the L1 signs from amplifying it (tolerance as the JAX comparison).
    One image twice in a batch gives bitwise equal rows."""
    both = _port_run(pipe, sched, images, trajectories)
    for i, img in enumerate(images):
        alone = _port_run(pipe, sched, [img], trajectories[i:i + 1])
        _assert_close(both[0][i], alone[0][0])
        _assert_close(both[1][i], alone[1][0])
    assert np.abs(both[0][0] - both[0][1]).max() > 1e-2
    twice = _port_run(pipe, sched, [images[0]] * 2, trajectories[[0, 0]])
    np.testing.assert_array_equal(twice[0][0], twice[0][1])
    np.testing.assert_array_equal(twice[1][0], twice[1][1])


def test_nmg_edit_branch_is_plain_ddim_sampling(pipe, sched, images, trajectories):
    """Under a neutral control and no blend the edit branch never sees the
    reconstruction branch or its guidance: x_edit equals plain DDIM sampling
    from xts[S] at the target scale, computed here with batch-2 UNet calls of
    one image ([uncond, tar]).  (x_edit never equals x_orig, target = source
    or not: the reconstruction branch takes the noise-map step and then the
    pair step, two steps a loop iteration, as in the JAX package.)  Tolerance
    as the batching test's.  Mismatched shapes are refused."""
    edit, _ = _port_run(pipe, sched, images, trajectories, neutral=True, grad_scale=5e3)
    ts = sched[0].timesteps.tolist()
    for b, im in enumerate(images):
        x = torch.from_numpy(trajectories[b, S][None])
        ctx = torch.from_numpy(im[1][[0, 2]])
        with torch.no_grad():
            for t in ts:
                e_u, e_c = pipe.unet(torch.cat([x, x]), t, ctx).float().chunk(2)
                x = sched[0].reverse_step(e_u + CFG_TAR * (e_c - e_u), t, x, eta=0.0)
        _assert_close(edit[b], x[0].numpy())
    control, blend = _port_controls(images, True)
    ctx3 = torch.from_numpy(np.stack([im[1] for im in images]))
    with pytest.raises(ValueError):
        nmg_p2p(pipe.unet, sched[0], xts=torch.from_numpy(trajectories[:, :S]), ctx3=ctx3,
                cfg_tar=CFG_TAR, control=control, local_blend=blend, after_skip_steps=S)
    with pytest.raises(ValueError):
        nmg_p2p(pipe.unet, sched[0], xts=torch.from_numpy(trajectories[:1]), ctx3=ctx3[:1],
                cfg_tar=CFG_TAR, control=control, local_blend=blend, after_skip_steps=S)


# ---------------------------------------------------------------------- CLI #

@pytest.mark.parametrize("mode", ["nmg_p2p", "nmg"])
def test_cli_nmg_tiny_writes_finite_images(tmp_path, mode):
    """``python -m hedit_tpu_torch.cli.main_p2p --mode nmg_p2p --eta 0 --tiny``
    (and its alias ``nmg``) on the CPU: two images in one ``--data_parallel``
    batch, finite PNGs of the tiny VAE's size; a DDIM mode refuses eta > 0 and
    the default device refuses a machine without a card."""
    from PIL import Image

    from hedit_tpu_torch.cli.main_p2p import main

    rs = np.random.RandomState(0)
    (tmp_path / "annotation_images").mkdir()
    for i in range(2):
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(
            tmp_path / "annotation_images" / f"im{i}.png")
    mapping = tmp_path / "mapping.json"
    mapping.write_text(json.dumps({
        f"k{i}": {"image_path": f"im{i}.png", "original_prompt": "a green lizard",
                  "editing_prompt": "a brown lizard", "blended_word": "lizard lizard",
                  "editing_type_id": "0"} for i in range(2)}))
    out = tmp_path / "out"
    argv = ["--mode", mode, "--eta", "0", "--num_diffusion_steps", "3", "--data_path",
            str(tmp_path), "--mapping_file", str(mapping), "--data_parallel", "2",
            "--output_path", str(out), "--tiny"]
    assert main(argv + ["--device", "cpu"]) == 0
    pngs = sorted(out.rglob("*.png"))
    assert len(pngs) == 2 and mode + "_total_steps_3" in str(pngs[0])
    for p in pngs:
        img = np.asarray(Image.open(p))
        assert img.shape == (64, 64, 3) and img.std() > 0
    with pytest.raises(AssertionError, match="eta == 0"):
        main(["--mode", mode, "--tiny", "--device", "cpu", "--image", str(pngs[0])])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
