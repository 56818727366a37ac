"""Plain versions of the differentiable flash attention, the GroupNorm
gradient and the DDIM step math of the PyTorch port against the JAX package,
on the CPU in float32 (the flash backward in bf16 too).

The same numpy-seeded inputs go through both.  The JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them; tolerances are
stated at each comparison.  The CUDA kernels themselves are held to these
plain versions on the card (``test_torch_port_kernels.py``, ``chip_smoke.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.core.schedule import Schedule as JSchedule
from hedit_tpu.ops.flash_attention import _flash_bounded_fwd_lse, _flash_bwd_pallas
from hedit_tpu.ops.flash_attention import reference_attention as j_reference_attention
from hedit_tpu.ops.groupnorm import group_norm_reference as j_group_norm_reference
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.ops import flash_attention as flash_mod
from hedit_tpu_torch.ops import groupnorm as gn_mod


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its
    share (oversubscribed intra-op threads spin and stall each other)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


# the shapes of the JAX package's own gradient tests: one aligned, three
# that pad (unaligned both axes; cross-attention, Sq != Sk; Sq < Sk)
SHAPES = [(256, 256, 40), (300, 300, 40), (256, 77, 64), (140, 260, 40)]


def _qkvo(sq, sk, d):
    rng = np.random.RandomState(sq + sk + d)
    return (rng.randn(1, 2, sq, d).astype(np.float32), rng.randn(1, 2, sk, d).astype(np.float32),
            rng.randn(1, 2, sk, d).astype(np.float32), rng.randn(1, 2, sq, d).astype(np.float32))


@pytest.mark.parametrize("sq,sk,d", SHAPES)
def test_flash_lse_plain_matches_jax_kernel(sq, sk, d):
    """(out, lse2) of ``flash_attention_lse_reference`` against the JAX LSE
    forward kernel in interpret mode and the JAX oracle.  2e-5: the kernel's
    exp2 and summation order; lse2 is ~10, so 2e-5 relative there."""
    q, k, v, _ = _qkvo(sq, sk, d)
    out, lse2 = flash_mod.flash_attention_lse_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    jout, jlse = _flash_bounded_fwd_lse(*(jnp.asarray(a) for a in (q, k, v)), interpret=True)
    assert tuple(lse2.shape) == jlse.shape == (2, 1, sq) and lse2.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse2.numpy(), np.asarray(jlse), rtol=2e-5, atol=2e-5)
    oracle = j_reference_attention(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("sq,sk,d", SHAPES)
def test_flash_backward_plain_matches_jax_kernels_and_vjp(sq, sk, d):
    """(dq, dk, dv) of ``flash_attention_backward_reference`` (the explicit
    formulas, fed its own forward's out and lse2) against the JAX dq and
    dk / dv kernels in interpret mode and against ``jax.vjp`` of the JAX
    oracle; and ``flash_attention_diff``'s autograd on the CPU gives the same.
    rtol 2e-4 / atol 3e-5 as the JAX package holds its kernels to its oracle."""
    q, k, v, do = _qkvo(sq, sk, d)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse2 = flash_mod.flash_attention_lse_reference(tq, tk, tv)
    got = flash_mod.flash_attention_backward_reference(tq, tk, tv, out, lse2, tdo)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = _flash_bounded_fwd_lse(jq, jk, jv, interpret=True)
    kernels = _flash_bwd_pallas(jq, jk, jv, jout, jlse, jdo, interpret=True)
    vjp = jax.vjp(j_reference_attention, jq, jk, jv)[1](jdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(flash_mod.flash_attention_diff(*leaves), leaves, tdo)
    for a, b, c, e in zip(got, kernels, vjp, auto):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=3e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=2e-4, atol=3e-5)
        np.testing.assert_array_equal(a.numpy(), e.numpy())


def test_flash_backward_plain_matches_jax_kernels_in_bf16():
    """bf16 inputs at (Sq, Sk, D) = (256, 256, 40), (140, 260, 40), (256,
    256, 80) and the VAE's width (256, 300, 512: JAX pads the keys to its
    256-key block above d = 128), one item (pytest-xdist's loadfile
    scheduler queues files by their number of items): the port's plain LSE
    forward and plain backward against
    ``_flash_bounded_fwd_lse`` and the JAX dq and dk / dv kernels in
    interpret mode, which round qs = q * c and ks = k * c, ds on each side
    and p for ``p^T dO`` to bf16.  Both sides round each output to bf16 from
    float32 values that differ only by summation order and by the ulps in
    which the two LSE forwards' outputs differ (delta), so they agree except
    where those values straddle a rounding boundary: at most 2^-8 of each
    output's largest value apart, and at most 2% of the elements differing
    at all.  That is tighter than the gap a plain backward that computes in
    float32 from the bf16 inputs and rounds once leaves: such a version
    fails every case here."""
    for sq, sk, d in ((256, 256, 40), (140, 260, 40), (256, 256, 80), (256, 300, 512)):
        rng = np.random.RandomState(sq + sk + d)
        arrays = [rng.randn(1, 2, s, d).astype(np.float32) for s in (sq, sk, sk, sq)]
        tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
        out, lse2 = flash_mod.flash_attention_lse_reference(tq, tk, tv)
        got = flash_mod.flash_attention_backward_reference(tq, tk, tv, out, lse2, tdo)
        jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
        jout, jlse = _flash_bounded_fwd_lse(jq, jk, jv, interpret=True)
        kernels = _flash_bwd_pallas(jq, jk, jv, jout, jlse, jdo, interpret=True)
        for a, b in zip(got, kernels):
            assert a.dtype == torch.bfloat16
            a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
            np.testing.assert_allclose(a, b, rtol=0, atol=2.0 ** -8 * np.abs(b).max(),
                                       err_msg=f"{(sq, sk, d)}")
            assert np.mean(a != b) <= 0.02, (sq, sk, d)


@pytest.mark.parametrize("act", ["silu", None])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 64), 32), ((1, 4, 4, 96), 8)])
def test_groupnorm_gradient_matches_jax(shape, groups, act):
    """The autograd wrapper's CPU path (forward the plain version, backward
    ``group_norm_backward_reference``) against ``jax.grad`` of the JAX
    ``group_norm_reference``: dx, dweight, dbias.  float32, 1e-5 of each
    gradient's largest value plus 1e-6 (two-pass statistics on both sides)."""
    rng = np.random.RandomState(shape[-1])
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)            # NHWC
    w, b = (rng.randn(shape[-1]).astype(np.float32) for _ in range(2))
    dy = rng.randn(*shape).astype(np.float32)
    want = jax.grad(lambda x_, w_, b_: jnp.sum(j_group_norm_reference(
        x_, w_, b_, groups=groups, eps=1e-5, act=act) * dy), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()  # NCHW
    tw, tb = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = gn_mod.group_norm(tx, tw, tb, groups=groups, eps=1e-5, act=act)
    assert isinstance(y.grad_fn, gn_mod._GroupNormFn._backward_cls)
    got = torch.autograd.grad(y, (tx, tw, tb), torch.from_numpy(dy).permute(0, 3, 1, 2))
    got = (got[0].permute(0, 2, 3, 1).numpy(), got[1].numpy(), got[2].numpy())
    for a, c in zip(got, want):
        c = np.asarray(c)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-5 * np.abs(c).max() + 1e-6)
    # only x needs a gradient on the NMG path (the weights are frozen)
    dx_only, = torch.autograd.grad(
        gn_mod.group_norm(tx, tw.detach(), tb.detach(), groups=groups, eps=1e-5, act=act), tx,
        torch.from_numpy(dy).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(dx_only.permute(0, 2, 3, 1).numpy(), got[0])


@pytest.mark.parametrize("steps,offset", [(50, 0), (7, 0), (10, 1)])
def test_ddim_step_math_matches_jax(steps, offset):
    """``next_step``, ``reverse_step(is_ddim_inversion=True)`` with and
    without noise, and the eta = 0 step, on a ``steps_offset`` 0 grid (the
    DDIM modes') and an offset 1 grid.  Tables equal exactly; the steps agree
    to 1e-6 (float32 on both sides, the same association)."""
    js = JSchedule.create(steps, steps_offset=offset)
    ts = Schedule.create(steps, steps_offset=offset)
    np.testing.assert_array_equal(ts.timesteps.numpy(), np.asarray(js.timesteps))
    assert int(ts.timesteps[-1]) == offset
    rng = np.random.RandomState(steps)
    eps, x, z = (rng.randn(2, 4, 4, 3).astype(np.float32) for _ in range(3))
    je, jx, jz = (jnp.asarray(a) for a in (eps, x, z))
    te, tx, tz = (torch.from_numpy(a) for a in (eps, x, z))
    for t in np.asarray(js.timesteps).tolist():
        pairs = [
            (ts.next_step(te, t, tx), js.next_step(je, t, jx)),
            (ts.reverse_step(te, t, tx, eta=0.0), js.reverse_step(je, t, jx, eta=0.0)),
            (ts.reverse_step(te, t, tx, eta=1.0, is_ddim_inversion=True),
             js.reverse_step(je, t, jx, eta=1.0, is_ddim_inversion=True)),
            (ts.reverse_step(te, t, tx, eta=1.0, variance_noise=tz, is_ddim_inversion=True),
             js.reverse_step(je, t, jx, eta=1.0, variance_noise=jz, is_ddim_inversion=True)),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # a tensor of timesteps (the batched phase 2 of the inversion) gives the rows of the ints
    tt = ts.timesteps[:3]
    got = ts.abar_prev(tt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.abar_prev(js.timesteps[:3])))
