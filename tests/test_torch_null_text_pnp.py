"""The port's null-text + PnP loop on the CPU against the JAX package
(``hedit_tpu/edit/pnp_baselines.py:null_text_pnp``):

* (a) the Adam helper ``null_text_adam`` in float64 on the tiny UNet's real
  gradients (the port's seeded weights carried to the JAX model by
  ``hedit_tpu.io_utils.weights.convert_unet``, JAX under ``enable_x64``)
  against JAX's rule (:204-220) written out here, ten iterations of outer
  step 0;
* (b) ``null_text_pnp`` end to end in float64 on a stub UNet that is the same
  smooth function of (x, t, ctx) in both frameworks, two images in one batch
  that stop their Adam loops at different iterations, against JAX's scan on
  each image, and each image run alone against its row of the batch (also on
  the tiny UNet in float64);
* (c) ``null_text_pnp`` with ``optimization_steps=0`` on the tiny UNet in
  float32, gates that switch off mid-loop: the PnP pair with the uncond
  embedding, at ``test_torch_pnp.py``'s tolerances.

Two JAX loops are compiled, (b)'s and (c)'s.  The loop on the real UNet with
Adam iterations is not held end to end: Adam's ``eps`` turns any rounding
difference at a coordinate whose gradient is near zero into a step of O(lr)
there (``tests/test_e2e_pnp_parity.py``), a known divergence of ~1e-2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.config import enable_x64

from hedit_tpu.control.base import NO_CONTROL as J_NO_CONTROL
from hedit_tpu.control.pnp import pnp_step_gates as j_pnp_step_gates
from hedit_tpu.core.schedule import Schedule as JSchedule
from hedit_tpu.edit.pnp_baselines import null_text_pnp as j_null_text_pnp
from hedit_tpu.io_utils.weights import convert_unet
from hedit_tpu.models.blocks import timestep_embedding as j_timestep_embedding
from hedit_tpu.models.unet_sd import UNet2DCondition as JUNet
from hedit_tpu.models.unet_sd import UNetConfig as JUNetConfig
from hedit_tpu_torch.control.pnp import pnp_step_gates
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.edit import pnp_baselines
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

STEPS = 4
CFG_TAR = 7.5
# gates of pnp_step_gates(4, 0.5, 0.75): q / k on for steps 0-1, conv for 0-2
ATTN_T, F_T = 0.5, 0.75


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _rand(rng, *shape, dtype=np.float32):
    return rng.randn(*shape).astype(dtype)


def _jax_unet(unet, dtype):
    """The JAX tiny UNet in ``dtype`` with the port's weights, as ``eps_fn(x,
    t, c, ctrl)``."""
    params = convert_unet({k: v.numpy() for k, v in unet.state_dict().items()})
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
    import dataclasses

    junet = JUNet(dataclasses.replace(JUNetConfig.tiny(), dtype=dtype))
    return lambda x, t, c, ctrl: junet.apply(params, x, t, c, ctrl)


# ------------------------------------------------------ (a) the Adam chain #

def _jax_adam_rule(value_and_grad, u, steps=10):
    """JAX's rule (hedit_tpu/edit/pnp_baselines.py:204-220) at outer step 0,
    written out as the JAX loop runs it: (u after ``steps`` updates, losses,
    |first gradient|)."""
    lr = 1e-2 * (1.0 - jnp.asarray(0, jnp.int32).astype(jnp.float32) / 100.0)
    m, v = jnp.zeros_like(u), jnp.zeros_like(u)
    g0, losses = None, []
    for j in range(steps):
        loss, g = value_and_grad(u)
        if g0 is None:
            g0 = np.abs(np.asarray(g))[0]
        m = 0.9 * m + (1 - 0.9) * g
        v = 0.999 * v + (1 - 0.999) * g * g
        jf = jnp.asarray(j + 1, jnp.int32)
        mhat = m / (1 - 0.9 ** jf)
        vhat = v / (1 - 0.999 ** jf)
        u = u - lr * mhat / (jnp.sqrt(vhat) + 1e-8)
        losses.append(float(loss))
    return np.asarray(u), np.asarray(losses), g0


def _u_diffs(got, want, g0):
    """(max |du| outside Adam's saturation set |g0| <= 1e-8, mean |du|)."""
    du = np.abs(got - want)
    live = g0 > 1e-8
    assert live.mean() > 0.99, live.mean()
    return du[live].max(), du.mean()


def test_adam_chain_matches_jax_rule_on_real_gradients_f64():
    """Ten iterations of outer step 0 in float64 on the tiny UNet's loss, the
    port's ``null_text_adam`` against JAX's rule on JAX's ``eps_fn``:

    * the helper fed JAX's loss and gradient: the rule itself, within
      ``tests/test_e2e_pnp_parity.py``'s bounds, losses 1e-5 relative, u_opt
      3e-6 outside the set |g| <= 1e-8 of the first gradient (where Adam's eps
      saturates any difference to a step of O(lr)) and 1e-6 on the mean;
    * the port's loss and gradient (``null_text_loss`` on the port's UNet)
      at the first iterate: the loss within 1e-6 relative, the gradient
      within 3e-6 of its largest element;
    * the helper on the port's UNet, the whole port: losses 1e-5 relative,
      u_opt 1e-6 on the mean and 1e-5 outside the saturation set.  Both
      "float64" models round their GroupNorm statistics and attention scores
      to float32 (``hedit_tpu/ops/groupnorm.py:51``,
      ``hedit_tpu/ops/flash_attention.py:443``), so their gradients agree to
      ~1e-6 of their largest element, not the ~1e-11 of a model that is
      float64 throughout; Adam turns that into up to ~4e-6 at a few
      coordinates whose gradient changes sign along the chain.

    The loss stays above outer step 0's threshold, so all ten iterations run,
    and the float64 UNet's timestep sinusoid is float64, as JAX's is."""
    pipe = create_sd_pipeline(tiny=True, num_inference_steps=STEPS, seed=0,
                              dtype=torch.float64, device="cpu")
    sched = Schedule.create(STEPS, steps_offset=0)
    rng = np.random.RandomState(5)
    x = _rand(rng, 1, 16, 16, 4, dtype=np.float64) * 0.5
    target = _rand(rng, 1, 16, 16, 4, dtype=np.float64) * 0.5
    uncond, src = (_rand(rng, 1, 77, 32, dtype=np.float64) * 0.5 for _ in range(2))
    t = int(sched.timesteps[-STEPS])
    adam = dict(optimization_steps=10, lr=torch.tensor(1e-2, dtype=torch.float32),
                thresh=torch.tensor(1e-5, dtype=torch.float32))

    tx = torch.from_numpy(x)
    sinusoid = []
    hook = pipe.unet.time_embedding.register_forward_pre_hook(
        lambda module, args: sinusoid.append(args[0]))
    with torch.no_grad():
        cond = pipe.unet(tx, t, torch.from_numpy(src))
    hook.remove()
    port_loss_grad = pnp_baselines.null_text_loss(pipe.unet, sched, tx, t, cond,
                                                  torch.from_numpy(target), CFG_TAR)
    u_port, losses_port = pnp_baselines.null_text_adam(port_loss_grad,
                                                       torch.from_numpy(uncond), **adam)
    loss0, grad0 = port_loss_grad(torch.from_numpy(uncond), torch.arange(1))

    with enable_x64(True):
        eps_fn = _jax_unet(pipe.unet, jnp.float64)
        jsched = JSchedule.create(STEPS, steps_offset=0)
        jt, xj = jnp.asarray([t]), jnp.asarray(x)
        cond_j = eps_fn(xj, jt, jnp.asarray(src), J_NO_CONTROL)

        @jax.jit
        def value_and_grad(uu):
            def loss_fn(u_):
                eps_u = eps_fn(xj, jt, u_, J_NO_CONTROL)
                eps_cfg = eps_u + CFG_TAR * (cond_j - eps_u)
                x_pred = jsched.reverse_step(eps_cfg, jnp.asarray(t), xj, eta=0.0)
                return jnp.mean((x_pred - jnp.asarray(target)) ** 2)
            return jax.value_and_grad(loss_fn)(uu)

        u_jax, losses_jax, g0 = _jax_adam_rule(value_and_grad, jnp.asarray(uncond))

        def jax_loss_grad(u, rows):
            loss, g = value_and_grad(jnp.asarray(u.numpy()))
            return torch.tensor([float(loss)], dtype=torch.float64), torch.tensor(np.asarray(g))

        u_rule, losses_rule = pnp_baselines.null_text_adam(
            jax_loss_grad, torch.from_numpy(uncond), **adam)
        loss0_j, grad0_j = (np.asarray(a) for a in value_and_grad(jnp.asarray(uncond)))
        sinusoid_j = np.asarray(j_timestep_embedding(jnp.asarray([t]), 32, dtype=jnp.float64))
    jax.clear_caches()  # drop the float64-traced executables

    # a float64 model's sinusoid is float64, as JAX's UNet computes it
    np.testing.assert_allclose(sinusoid[0].numpy(), sinusoid_j, rtol=0, atol=1e-12)
    for losses in (losses_rule, losses_port):
        losses = losses[:, 0].numpy()
        assert np.isfinite(losses).all() and (losses > 1e-5).all()
        assert losses[-1] < losses[0]
    # the helper against the rule on the same gradient function
    rel = np.abs(losses_rule[:, 0].numpy() - losses_jax) / losses_jax
    assert rel.max() < 1e-5, rel
    top, mean = _u_diffs(u_rule.numpy()[0], u_jax[0], g0)
    print(f"helper vs rule: loss rel {rel.max():.2e}, u max {top:.2e} mean {mean:.2e}")
    assert top < 3e-6 and mean < 1e-6, (top, mean)
    # the port's loss and gradient at u0
    lerr = abs(float(loss0[0]) - float(loss0_j)) / float(loss0_j)
    assert lerr < 1e-6, lerr
    gerr = np.abs(grad0.numpy() - grad0_j).max() / np.abs(grad0_j).max()
    assert gerr < 3e-6, gerr
    # the whole port
    rel = np.abs(losses_port[:, 0].numpy() - losses_jax) / losses_jax
    assert rel.max() < 1e-5, rel
    top, mean = _u_diffs(u_port.numpy()[0], u_jax[0], g0)
    assert top < 1e-5 and mean < 1e-6, (top, mean)
    print(f"port: loss rel {rel.max():.2e}, u max {top:.2e} mean {mean:.2e}; at u0 loss "
          f"{lerr:.2e}, gradient {gerr:.2e}")


# ----------------------------------------- (b) the loop on a stub, float64 #

# the stub: eps = 0.3 tanh(x) + 1e-4 t + STUB_A s, s = tanh(8 mean(ctx * W))
# one number a row, so d loss / d ctx is W times one factor that keeps its
# sign: no gradient coordinate near 0.  The targets lie STUB_OFFSETS away
# from the branch, so each image's loss falls step after step without
# reaching its minimum, and EPSILON splits the stop decisions (a first pass of
# the losses, checked below): image 0 runs 10, 5, 2 and 1 iterations, image 1
# one every step; the nearest decision lies 2.7e-3 of its threshold away.
STUB_A, STUB_OFFSETS, EPSILON = 0.05, (2.0, -2.0), 3.85
STUB_ITERATIONS = [[10, 1], [5, 1], [2, 1], [1, 1]]
_W = np.random.RandomState(11).uniform(0.5, 1.5, (77, 32)) * \
    np.random.RandomState(13).choice([-1.0, 1.0], (77, 32))


def _stub_port(x, t, ctx, control=None, store=None):
    s = torch.tanh((ctx * torch.from_numpy(_W)).sum(dim=(1, 2)) / _W.size * 8)
    return 0.3 * torch.tanh(x) + 1e-4 * t + STUB_A * s[:, None, None, None]


def _stub_jax(x, t, ctx, ctrl):
    s = jnp.tanh(jnp.sum(ctx * jnp.asarray(_W), axis=(1, 2)) / _W.size * 8)
    return 0.3 * jnp.tanh(x) + 1e-4 * t[:, None, None, None] + STUB_A * s[:, None, None, None]


def _stub_inputs():
    rng = np.random.RandomState(12)
    xts = rng.randn(2, STEPS + 1, 16, 16, 4) * 0.3
    for b, off in enumerate(STUB_OFFSETS):
        xts[b, :STEPS] += off
    return xts, rng.randn(2, 3, 77, 32) * 0.5


def _port_stub_run(xts, ctx3, qk, conv, monkeypatch):
    """The port's loop on the stub; returns (edited, source branch, [(thresh,
    losses [10, B])] of each step's Adam loop)."""
    record, real = [], pnp_baselines.null_text_adam

    def spy(loss_grad, u0, **kw):
        u, losses = real(loss_grad, u0, **kw)
        record.append((float(kw["thresh"]), losses.numpy()))
        return u, losses

    monkeypatch.setattr(pnp_baselines, "null_text_adam", spy)
    xts = torch.from_numpy(xts)
    edited, recon = pnp_baselines.null_text_pnp(
        _stub_port, Schedule.create(STEPS, steps_offset=0), xts[:, STEPS], xts=xts,
        ctx3=torch.from_numpy(ctx3), cfg_tar=CFG_TAR, after_skip_steps=STEPS, qk_mask=qk,
        conv_mask=conv, epsilon=EPSILON)
    monkeypatch.setattr(pnp_baselines, "null_text_adam", real)
    return edited.numpy(), recon.numpy(), record


def test_null_text_pnp_matches_jax_on_a_stub_f64(monkeypatch):
    """``null_text_pnp`` on two images in one batch, float64, against JAX's
    scan on each image within 1e-10 of the largest latent, edited and source
    branch.  The images stop their Adam loops at different iterations (the
    first, none, and between), and no stop decision lies within 1e-4 of its
    threshold.  Each image run alone equals its row of the batch bit for
    bit, here and on the tiny UNet in float64 (whose CPU convolutions round
    alike at batch 1 and 2; in float32 they do not, and Adam amplifies it:
    ``test_torch_pnp.py``'s ``BATCH_LEVELS``)."""
    qk, conv = pnp_step_gates(STEPS, ATTN_T, F_T)
    xts, ctx3 = _stub_inputs()
    edited, recon, record = _port_stub_run(xts, ctx3, qk, conv, monkeypatch)
    assert [list(np.isfinite(losses).sum(0)) for _, losses in record] == STUB_ITERATIONS
    for thresh, losses in record:
        taken = losses[np.isfinite(losses)]
        assert (np.abs(taken - thresh) > 1e-4 * thresh).all(), (thresh, losses)

    for b in range(2):
        alone = _port_stub_run(xts[b:b + 1], ctx3[b:b + 1], qk, conv, monkeypatch)
        np.testing.assert_array_equal(alone[0][0], edited[b])
        np.testing.assert_array_equal(alone[1][0], recon[b])
    pipe = create_sd_pipeline(tiny=True, num_inference_steps=STEPS, seed=0,
                              dtype=torch.float64, device="cpu")
    rng = np.random.RandomState(3)
    xts64 = torch.from_numpy(rng.randn(2, STEPS + 1, 16, 16, 4) * 0.5)
    ctx64 = torch.from_numpy(rng.randn(2, 3, 77, 32) * 0.5)
    kw = dict(cfg_tar=CFG_TAR, after_skip_steps=STEPS, qk_mask=qk, conv_mask=conv)
    sched = Schedule.create(STEPS, steps_offset=0)
    both = pnp_baselines.null_text_pnp(pipe.unet, sched, xts64[:, STEPS], xts=xts64, ctx3=ctx64,
                                       **kw)
    for b in range(2):
        alone = pnp_baselines.null_text_pnp(pipe.unet, sched, xts64[b:b + 1, STEPS],
                                            xts=xts64[b:b + 1], ctx3=ctx64[b:b + 1], **kw)
        for a, w in zip(alone, both):
            np.testing.assert_array_equal(a[0].numpy(), w[b].numpy())

    with enable_x64(True):
        sched = JSchedule.create(STEPS, steps_offset=0)

        @jax.jit
        def run(xts_b, u, s, t):
            return j_null_text_pnp(_stub_jax, sched, xts_b[STEPS][None], xts_b,
                                   jnp.zeros_like(xts_b[:STEPS]), uncond_ctx=u, src_ctx=s,
                                   tar_ctx=t, cfg_tar=CFG_TAR, after_skip_steps=STEPS,
                                   qk_mask=jnp.asarray(qk), conv_mask=jnp.asarray(conv),
                                   epsilon=EPSILON)

        for b in range(2):
            want_edit, want_recon = (np.asarray(a)[0] for a in run(
                jnp.asarray(xts[b]), *(jnp.asarray(c[None]) for c in ctx3[b])))
            for got, want in ((edited[b], want_edit), (recon[b], want_recon)):
                assert want.dtype == np.float64
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err < 1e-10, (b, err)
    jax.clear_caches()


# ------------------------------------ (c) no Adam iteration, tiny UNet f32 #

def test_null_text_pnp_without_adam_matches_jax():
    """``optimization_steps=0`` on the tiny UNet in float32: each step is the
    PnP pair with the uncond embedding, eta = 0, the target cfg scale on both
    rows.  Two images in one batch against JAX's ``null_text_pnp`` on each
    image, with gates that switch off mid-loop, at ``test_torch_pnp.py``'s
    tolerance; with every gate off the edit differs (PnP is engaged)."""
    from test_torch_pnp import _assert_close

    pipe = create_sd_pipeline(tiny=True, num_inference_steps=STEPS, seed=0, device="cpu")
    qk, conv = pnp_step_gates(STEPS, ATTN_T, F_T)
    sched = Schedule.create(STEPS, steps_offset=0)
    rngs = [np.random.RandomState(seed) for seed in (1, 2)]
    xts = np.stack([_rand(r, STEPS + 1, 16, 16, 4) * 0.5 for r in rngs])
    ctx3 = np.stack([_rand(r, 3, 77, 32) * 0.5 for r in rngs])
    kw = dict(xts=torch.from_numpy(xts), ctx3=torch.from_numpy(ctx3), cfg_tar=CFG_TAR,
              after_skip_steps=STEPS, optimization_steps=0)
    xT = torch.from_numpy(xts[:, STEPS])
    edited, recon = pnp_baselines.null_text_pnp(pipe.unet, sched, xT, qk_mask=qk,
                                                conv_mask=conv, **kw)
    off, _ = pnp_baselines.null_text_pnp(pipe.unet, sched, xT, qk_mask=[False] * STEPS,
                                         conv_mask=[False] * STEPS, **kw)

    eps_fn = _jax_unet(pipe.unet, jnp.float32)
    jsched = JSchedule.create(STEPS, steps_offset=0)
    jqk, jconv = j_pnp_step_gates(STEPS, ATTN_T, F_T)

    @jax.jit
    def run(xts_b, u, s, t):
        return j_null_text_pnp(eps_fn, jsched, xts_b[STEPS][None], xts_b,
                               jnp.zeros_like(xts_b[:STEPS]), uncond_ctx=u, src_ctx=s,
                               tar_ctx=t, cfg_tar=CFG_TAR, after_skip_steps=STEPS,
                               qk_mask=jqk, conv_mask=jconv, optimization_steps=0)

    for b in range(2):
        want_edit, want_recon = (np.asarray(a)[0] for a in run(
            jnp.asarray(xts[b]), *(jnp.asarray(c[None]) for c in ctx3[b])))
        _assert_close(edited[b].numpy(), want_edit)
        _assert_close(recon[b].numpy(), want_recon)
    assert np.isfinite(edited.numpy()).all()
    scale = np.abs(edited.numpy()).max()
    assert np.abs(off.numpy() - edited.numpy()).max() > 1e-3 * scale
