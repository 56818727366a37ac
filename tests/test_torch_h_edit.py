"""The PyTorch port's control-free loops on the CPU against the JAX package:
the h-Edit coefficient after a DDIM inversion, ``invert_ddpm``, ``h_edit_r``
(explicit, implicit with several optimisation steps, with skipped steps) and
``ef_sample``.

Both packages call one toy ``eps_fn`` (the same float32 arithmetic in numpy
terms, mixing neighbouring pixels, the context and the timestep), so the JAX
scans compile in seconds and the comparison holds the loops' own arithmetic:
index algebra, coefficients, CFG combinations, the per-image RMS and L1 pull.
The port runs B = 2 images in one batch; the JAX functions run each image
alone.  float32; loops within 1e-5 of the largest latent, the schedule within
1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.core.schedule import Schedule as JSchedule
from hedit_tpu.edit.h_edit import HEditConfig as JHEditConfig
from hedit_tpu.edit.h_edit import ef_sample as j_ef_sample
from hedit_tpu.edit.h_edit import h_edit_r as j_h_edit_r
from hedit_tpu.invert.ddpm import invert_ddpm as j_invert_ddpm
from hedit_tpu.invert.ddpm import sample_xts_from_x0 as j_sample_xts
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit.h_edit import HEditConfig, _l1_grad, _rms, ef_sample, h_edit_r
from hedit_tpu_torch.invert.ddpm import invert_ddpm

S = 6
B = 2
LOOP_TOL = 1e-5   # of the largest latent: float32 rounding of a few chained steps


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def j_eps(x, t, ctx):
    """Toy noise prediction: x [n, H, W, C], t [n], ctx [n, 77, D]."""
    c = jnp.mean(ctx, axis=(1, 2))[:, None, None, None]
    tt = jnp.sin(t.astype(jnp.float32) / 1000.0)[:, None, None, None]
    return jnp.tanh(0.7 * x + 0.3 * jnp.roll(x, 1, axis=1) + c + tt)


def t_eps(x, t, ctx):
    """The same arithmetic for the port; t a Python int or an int tensor [n]."""
    c = ctx.mean(dim=(1, 2))[:, None, None, None]
    t = torch.as_tensor(t).expand(x.shape[0]) if not torch.is_tensor(t) or t.dim() == 0 else t
    tt = torch.sin(t.float() / 1000.0)[:, None, None, None]
    return torch.tanh(0.7 * x + 0.3 * torch.roll(x, 1, dims=1) + c + tt)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    return dict(x0=(rng.randn(B, 8, 8, 4) * 0.5).astype(np.float32),
                xT=rng.randn(B, 8, 8, 4).astype(np.float32),
                zs=rng.randn(B, S, 8, 8, 4).astype(np.float32),
                ctx3=(rng.randn(B, 3, 77, 16) * 2.0).astype(np.float32))


def _close(got, want, tol=LOOP_TOL, flips=0.0):
    """Every element within ``tol`` of the largest latent, but for a share
    ``flips`` of them.  The L1 pull of optimisation steps after the first moves
    each element by rho * sign(x_opt - x_prev_base): where that difference is
    within float32 rounding of zero the two frameworks may take opposite signs,
    and that element lands 2 * rho / size away.  The mean stays tight."""
    d = np.abs(got - want) / max(1.0, np.abs(want).max())
    assert d.mean() <= tol, f"mean |diff| {d.mean():.2e}"
    assert (d > tol).mean() <= flips, f"{(d > tol).sum()} of {d.size} elements above {tol:g}"


@pytest.mark.parametrize("ddim", [False, True])
def test_h_edit_coeff_matches_jax(ddim):
    """Every (t, tt) of the 50-step grid, DDPM and after a DDIM inversion (omega
    zero), eta 1 and 0.6: 1e-6 absolute on coefficients of at most ~0.3."""
    sched, jsched = Schedule.create(50), JSchedule.create(50)
    ts = sched.timesteps.tolist()
    for eta in (1.0, 0.6):
        for t, tt in zip(ts, ts[1:] + [0]):
            got = float(sched.h_edit_coeff(t, tt, eta, is_ddim_inversion=ddim))
            want = float(jsched.h_edit_coeff(t, tt, eta, is_ddim_inversion=ddim))
            assert abs(got - want) <= 1e-6, (t, tt, eta, got, want)
    t, tt = ts[10], ts[11]
    assert float(sched.h_edit_coeff(t, tt, 1.0, is_ddim_inversion=True)) != \
        float(sched.h_edit_coeff(t, tt, 1.0))


@pytest.mark.parametrize("cfg_scale_src", [1.0, 3.5])
def test_invert_ddpm_matches_jax_on_its_draw(data, cfg_scale_src):
    """The residual pass on JAX's own q-samples, two images in one call against
    the JAX function on each: ``step_chunk`` 4 over 6 steps (a shorter last
    call here, a padded one there), with and without the uncond half."""
    sched, jsched = Schedule.create(S), JSchedule.create(S)
    keys = [jax.random.PRNGKey(b) for b in range(B)]
    xts = np.stack([np.asarray(j_sample_xts(jsched, jnp.asarray(data["x0"][b:b + 1]), keys[b])[0])
                    for b in range(B)])
    ctx3 = torch.from_numpy(data["ctx3"])
    got = invert_ddpm(t_eps, sched, xts=torch.from_numpy(xts), uncond_ctx=ctx3[:, 0],
                      src_ctx=ctx3[:, 1], cfg_scale_src=cfg_scale_src, eta=0.8, step_chunk=4)
    assert got.zs.shape == (B, S, 8, 8, 4) and got.noise_added is None
    np.testing.assert_array_equal(got.xts.numpy(), xts)
    np.testing.assert_array_equal(got.xT.numpy(), xts[:, S])
    for b in range(B):
        want = j_invert_ddpm(j_eps, jsched, jnp.asarray(data["x0"][b:b + 1]),
                             uncond_ctx=jnp.asarray(data["ctx3"][b:b + 1, 0]),
                             src_ctx=jnp.asarray(data["ctx3"][b:b + 1, 1]),
                             cfg_scale_src=cfg_scale_src, eta=0.8, rng=keys[b], step_chunk=4)
        np.testing.assert_array_equal(np.asarray(want.xts), xts[b])
        _close(got.zs[b].numpy(), np.asarray(want.zs))


def test_invert_ddpm_draws_and_refusals(data):
    """The port's own draw: xts[0] = x0, xts[idx] = sqrt(abar) x0 + sqrt(1 - abar)
    noise at t = timesteps[S - idx]; one generator an image gives each image
    the draw it gets alone; ``skip_zs`` calls no UNet."""
    sched = Schedule.create(S)
    x0 = torch.from_numpy(data["x0"])
    ctx3 = torch.from_numpy(data["ctx3"])
    kw = dict(uncond_ctx=ctx3[:, 0], src_ctx=ctx3[:, 1])

    def never(*a):
        raise AssertionError("skip_zs must not call the UNet")

    inv = invert_ddpm(never, sched, x0, generator=[torch.Generator().manual_seed(3)
                                                   for _ in range(B)], skip_zs=True, **kw)
    assert inv.zs is None and inv.xts.shape == (B, S + 1, 8, 8, 4)
    torch.testing.assert_close(inv.xts[:, 0], x0, rtol=0, atol=0)
    torch.testing.assert_close(inv.noise_added[0], inv.noise_added[1], rtol=0, atol=0)
    abar = sched.alphas_cumprod[sched.timesteps].flip(0).reshape(1, S, 1, 1, 1)
    torch.testing.assert_close(
        inv.xts[:, 1:], abar.sqrt() * x0[:, None] + (1 - abar).sqrt() * inv.noise_added[:, 1:],
        rtol=0, atol=1e-6)
    alone = invert_ddpm(never, sched, x0[1:], generator=torch.Generator().manual_seed(3),
                        skip_zs=True, uncond_ctx=ctx3[1:, 0], src_ctx=ctx3[1:, 1])
    torch.testing.assert_close(inv.xts[1], alone.xts[0], rtol=0, atol=0)
    full = invert_ddpm(t_eps, sched, xts=inv.xts, **kw)
    # the residuals reproduce the trajectory: reverse_step(eps, x_t, z) == x_{t-1}
    for i, t in enumerate(sched.timesteps.tolist()):
        x_t, x_prev = inv.xts[:, S - i], inv.xts[:, S - i - 1]
        back = sched.reverse_step(t_eps(x_t, t, ctx3[:, 1]), t, x_t, eta=1.0,
                                  variance_noise=full.zs[:, S - 1 - i])
        torch.testing.assert_close(back, x_prev, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        invert_ddpm(t_eps, sched, x0, eta=0.0, **kw)
    with pytest.raises(ValueError):
        invert_ddpm(t_eps, sched, x0, xts=inv.xts, **kw)
    with pytest.raises(ValueError):
        invert_ddpm(t_eps, sched, xts=inv.xts[:, :S], **kw)


H_EDIT_CASES = {
    "explicit": (dict(implicit=False), S),
    "implicit": (dict(implicit=True), S),
    "implicit-K2-cfg_src": (dict(implicit=True, optimization_steps=2, cfg_src=2.0,
                                 weight_reconstruction=0.3), S),
    "implicit-K3-skip": (dict(implicit=True, optimization_steps=3), S - 2),
    "explicit-skip-eta": (dict(implicit=False, eta=0.7), S - 1),
}


@pytest.mark.parametrize("case", list(H_EDIT_CASES))
def test_h_edit_r_matches_jax(data, case):
    """``h_edit_r`` on two images at once against the JAX scan on each image:
    both outputs (the edit and the along-for-the-ride branch).  With skipped
    steps the implicit loop takes the step-0 pre-optimisation; with K > 1 the
    L1 pull, whose RMS and 1 / size are per image."""
    kw, n = H_EDIT_CASES[case]
    base = dict(cfg_src_edit=2.0, cfg_tar=4.0)
    sched, jsched = Schedule.create(S), JSchedule.create(S)
    got_edit, got_orig = h_edit_r(t_eps, sched, torch.from_numpy(data["xT"]),
                                  torch.from_numpy(data["zs"]),
                                  ctx3=torch.from_numpy(data["ctx3"]),
                                  cfg=HEditConfig(**base, **kw), after_skip_steps=n)
    run = jax.jit(lambda xT, zs, c: j_h_edit_r(
        j_eps, jsched, xT, zs, uncond_ctx=c[0:1], src_ctx=c[1:2], tar_ctx=c[2:3],
        cfg=JHEditConfig(**base, **kw), after_skip_steps=n))
    for b in range(B):
        want_edit, want_orig = run(jnp.asarray(data["xT"][b:b + 1]), jnp.asarray(data["zs"][b]),
                                   jnp.asarray(data["ctx3"][b]))
        flips = 0.01 if kw.get("optimization_steps", 1) > 1 else 0.0
        _close(got_edit[b].numpy(), np.asarray(want_edit)[0], flips=flips)
        _close(got_orig[b].numpy(), np.asarray(want_orig)[0])
    assert np.abs(got_edit.numpy() - got_orig.numpy()).max() > 1e-2


@pytest.mark.parametrize("ddim,n", [(False, S), (True, S - 2)])
def test_ef_sample_matches_jax(data, ddim, n):
    """Plain CFG sampling on the target prompt with injected residuals, DDPM
    form and the un-normalised DDIM form, with and without skipped steps."""
    sched, jsched = Schedule.create(S), JSchedule.create(S)
    got = ef_sample(t_eps, sched, torch.from_numpy(data["xT"]), torch.from_numpy(data["zs"]),
                    ctx3=torch.from_numpy(data["ctx3"]), cfg_tar=4.0, eta=0.9,
                    after_skip_steps=n, is_ddim_inversion=ddim)
    run = jax.jit(lambda xT, zs, c: j_ef_sample(
        j_eps, jsched, xT, zs, uncond_ctx=c[0:1], tar_ctx=c[2:3], cfg_tar=4.0, eta=0.9,
        after_skip_steps=n, is_ddim_inversion=ddim))
    for b in range(B):
        want = run(jnp.asarray(data["xT"][b:b + 1]), jnp.asarray(data["zs"][b]),
                   jnp.asarray(data["ctx3"][b]))
        _close(got[b].numpy(), np.asarray(want)[0])


def test_rms_and_l1_gradient_are_per_image(data):
    """Two different images in a batch: each row's RMS and L1 gradient equal
    those of the image alone (a mean over the batch would mix them)."""
    x, ref = torch.from_numpy(data["xT"]) * torch.tensor([1.0, 3.0]).reshape(2, 1, 1, 1), \
        torch.from_numpy(data["x0"])
    for b in range(B):
        torch.testing.assert_close(_rms(x)[b], _rms(x[b:b + 1])[0], rtol=0, atol=0)
        torch.testing.assert_close(_l1_grad(x, ref)[b], _l1_grad(x[b:b + 1], ref[b:b + 1])[0],
                                   rtol=0, atol=0)
    assert float(_rms(x)[1]) > 2 * float(_rms(x)[0])
    assert float(_l1_grad(x, ref).abs().max()) == pytest.approx(1.0 / (8 * 8 * 4))
    with pytest.raises(ValueError):
        h_edit_r(t_eps, Schedule.create(S), x, torch.from_numpy(data["zs"]),
                 ctx3=torch.from_numpy(data["ctx3"]),
                 cfg=HEditConfig(is_ddim_inversion=True), after_skip_steps=S)
    with pytest.raises(ValueError):
        ef_sample(t_eps, Schedule.create(S), x, torch.from_numpy(data["zs"][:1]),
                  ctx3=torch.from_numpy(data["ctx3"]), cfg_tar=4.0, after_skip_steps=S)
