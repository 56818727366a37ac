"""The two softmax modes of the port's flash forward on the CPU, against the
JAX package's Pallas kernels in interpret mode (as ``tests/test_models.py``
runs them, 128-query and 128-key blocks, so a 128-key anchor window).

* bounded (max-free): ``flash_attention_bounded_reference`` and its LSE twin
  ``flash_attention_lse_reference`` against ``flash_attention_bounded`` and
  ``_flash_bounded_fwd_lse`` (TPU kernels 1 and 3);
* exact (running max): ``reference_attention`` against ``flash_attention``
  (TPU kernel 6);
* a saturating input, where keys beyond the anchor window score more than
  116 log2 units above its row max: the two bounded versions agree and both
  differ from exact attention.

The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_port_kernels.py``, ``chip_smoke.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.ops.flash_attention import (
    _flash_bounded_fwd_lse, flash_attention, flash_attention_bounded,
)
from hedit_tpu_torch.ops import flash_attention as flash_mod

ANCHOR = 128   # the JAX kernels' blk_k in these runs
SHAPES = [(128, 128, 40), (300, 300, 40), (256, 77, 64)]   # aligned, ragged, masked tail
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _inputs(sq, sk, d, dtype):
    """numpy-seeded q, k, v [1, 2, S, D] as (torch, jax) pairs of one dtype."""
    rng = np.random.RandomState(sq + sk + d)
    arrays = [rng.randn(1, 2, s, d).astype(np.float32) for s in (sq, sk, sk)]
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a).astype(jdt) for a in arrays])


def _saturating(dtype):
    """q [1, 2, 128, 40], k / v [1, 2, 320, 40]: every query has a large
    first component, so its score with a key is set by that key's first
    component.  Keys of the anchor window score a few log2 units; key 140
    scores ~146 (more than 116 above the window's max: clamped to 2^100 by
    the bounded form), keys 150-213 score ~109 (below the clamp).  Exact
    attention puts the whole weight on key 140; the bounded form gives the
    64 keys about a tenth of it."""
    rng = np.random.RandomState(5)
    q = rng.randn(1, 2, 128, 40).astype(np.float32) * 0.1
    q[..., 0] = 8.0
    k = rng.randn(1, 2, 320, 40).astype(np.float32) * 0.5
    v = rng.randn(1, 2, 320, 40).astype(np.float32)
    k[:, :, 140, 0] = 80.0
    k[:, :, 150:214, 0] = 60.0
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in (q, k, v)],
            [jnp.asarray(a).astype(jdt) for a in (q, k, v)])


def _tol(dtype, want):
    """float32: 2e-5 (exp2 and summation order).  bfloat16: both sides round
    q * scale, p and the output to bf16 at the same steps; their float32
    scores differ in the last bits, so a rounding may fall the other way:
    one bf16 ulp at the largest output, 2^-8 * max."""
    return 2e-5 if dtype == "float32" else 2.0 ** -8 * np.abs(want).max()


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sq,sk,d", SHAPES)
def test_bounded_plain_versions_match_jax_kernels(sq, sk, d, dtype):
    """Kernel 1's and kernel 3's plain versions with a 128-key anchor against
    the JAX bounded kernels: out, and lse2 (float32 for either dtype: 2e-5;
    in bf16 a rounding of one p that falls the other way moves the sum by at
    most one ulp of its largest term, so lse2 by at most log2(1 + 2^-8))."""
    (q, k, v), (jq, jk, jv) = _inputs(sq, sk, d, dtype)
    got = flash_mod.flash_attention_bounded_reference(q, k, v, ANCHOR)
    out, lse2 = flash_mod.flash_attention_lse_reference(q, k, v, ANCHOR)
    want = np.asarray(flash_attention_bounded(jq, jk, jv, blk_q=128, blk_k=128,
                                              interpret=True).astype(jnp.float32))
    jout, jlse = _flash_bounded_fwd_lse(jq, jk, jv, blk_q=128, blk_k=128, interpret=True)
    assert got.dtype == q.dtype and tuple(lse2.shape) == jlse.shape == (2, 1, sq)
    np.testing.assert_array_equal(_f32(got), _f32(out))
    tol = _tol(dtype, want)
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=tol)
    np.testing.assert_allclose(_f32(out), _f32(jout), rtol=0, atol=tol)
    np.testing.assert_allclose(lse2.numpy(), np.asarray(jlse), rtol=0,
                               atol=2e-5 if dtype == "float32" else np.log2(1 + 2.0 ** -8))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sq,sk,d", SHAPES)
def test_exact_plain_version_matches_jax_exact_kernel(sq, sk, d, dtype):
    """Kernel 6's plain version, ``reference_attention``, against JAX's exact
    ``flash_attention``.  float32: the JAX package's own oracle tolerance
    (rtol 2e-4, atol 2e-5).  bfloat16: the JAX kernel rounds q * scale and p
    to bf16 where the plain version keeps float32 scores, so they are held to
    the JAX package's bf16 bound, 3e-2 of the largest output."""
    (q, k, v), (jq, jk, jv) = _inputs(sq, sk, d, dtype)
    got = _f32(flash_mod.reference_attention(q, k, v))
    want = np.asarray(flash_attention(jq, jk, jv, blk_q=128, blk_k=128,
                                      interpret=True).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        assert np.abs(got - want).max() < 3e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_saturating_input_separates_bounded_from_exact(dtype):
    """Where the bounded form saturates, the port's bounded plain versions
    follow the JAX bounded kernels, the exact ones follow JAX's exact kernel,
    and the two forms differ by far more than either tolerance."""
    (q, k, v), (jq, jk, jv) = _saturating(dtype)
    bounded = _f32(flash_mod.flash_attention_bounded_reference(q, k, v, ANCHOR))
    _, lse2 = flash_mod.flash_attention_lse_reference(q, k, v, ANCHOR)
    exact = _f32(flash_mod.reference_attention(q, k, v))
    j_bounded = np.asarray(flash_attention_bounded(jq, jk, jv, blk_q=128, blk_k=128,
                                                   interpret=True).astype(jnp.float32))
    _, j_lse = _flash_bounded_fwd_lse(jq, jk, jv, blk_q=128, blk_k=128, interpret=True)
    j_exact = np.asarray(flash_attention(jq, jk, jv, blk_q=128, blk_k=128,
                                         interpret=True).astype(jnp.float32))
    tol = _tol(dtype, j_bounded)
    np.testing.assert_allclose(bounded, j_bounded, rtol=0, atol=tol)
    # lse2 ~ 100 + 16 + a few: the float32 rounding of the shift's ulp
    np.testing.assert_allclose(lse2.numpy(), np.asarray(j_lse), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(exact, j_exact, rtol=0, atol=max(tol, 2e-5))
    gap = np.abs(bounded - exact).max()
    assert gap > 20 * tol, f"bounded and exact differ by only {gap:.3e}"
    # exact attention is the saturating key's value row; bounded is not
    np.testing.assert_allclose(exact, _f32(v[:, :, 140:141]).repeat(128, axis=2),
                               rtol=0, atol=max(tol, 1e-5))
    # the bounded sum is finite and saturated: lse2 >= the shift + 100
    assert np.isfinite(lse2.numpy()).all() and lse2.min().item() > 100.0


def test_bounded_anchor_is_the_jax_key_block():
    """The anchor the CUDA wrappers pass: the JAX wrappers' ``blk_k`` at the
    shape with their default blocks."""
    from hedit_tpu.ops.flash_attention import _shrink_blocks

    for sk, d, itemsize in ((4096, 40, 2), (1024, 80, 2), (4096, 512, 2), (4096, 40, 4),
                            (4096, 512, 4), (300, 40, 4), (77, 64, 2), (1000, 80, 2)):
        blk_k = min(_shrink_blocks(d, itemsize, 2048, 512)[1], max(128, sk))
        assert flash_mod.bounded_anchor(sk, d) == blk_k


def test_wrappers_take_the_plain_versions_on_cpu():
    """CPU tensors: the bounded wrappers give the bounded plain versions with
    the JAX anchor, the exact one ``flash_attention_exact_reference`` at the
    kernel's key tile; nothing launches."""
    (q, k, v), _ = _saturating("float32")
    counts = (flash_mod.launches, flash_mod.launches_lse, flash_mod.launches_lse_tc,
              flash_mod.launches_exact)
    np.testing.assert_array_equal(
        flash_mod.flash_attention_cuda(q, k, v).numpy(),
        flash_mod.flash_attention_bounded_reference(q, k, v, flash_mod.bounded_anchor(320, 40)))
    out, lse2 = flash_mod.flash_attention_lse_cuda(q, k, v)
    want_out, want_lse = flash_mod.flash_attention_lse_reference(q, k, v)
    np.testing.assert_array_equal(out.numpy(), want_out.numpy())
    np.testing.assert_array_equal(lse2.numpy(), want_lse.numpy())
    np.testing.assert_array_equal(flash_mod.flash_attention_exact_cuda(q, k, v).numpy(),
                                  flash_mod.flash_attention_exact_reference(q, k, v).numpy())
    assert counts == (flash_mod.launches, flash_mod.launches_lse, flash_mod.launches_lse_tc,
                      flash_mod.launches_exact)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_packed_bounded_plain_version_matches_jax_on_saturating_input(dtype):
    """The bounded forward on packed heads, the route of every UNet
    self-attention on the card: its plain version on the saturating input
    laid out packed ([1, S, 2 * 40]) equals JAX's ``flash_attention_bounded``
    with its heads merged (tolerances of ``_tol``), and differs from exact
    attention by far more.  On the CPU the packed wrapper gives this plain
    version and the routing, like the JAX package's off the TPU, the exact
    one."""
    from hedit_tpu_torch.ops.attention import fused_attention_packed, merge_heads

    (q, k, v), (jq, jk, jv) = _saturating(dtype)
    qp, kp, vp = (merge_heads(t).contiguous() for t in (q, k, v))
    got = _f32(flash_mod.flash_attention_packed_bounded_reference(qp, kp, vp, 2, ANCHOR))
    want = np.asarray(flash_attention_bounded(jq, jk, jv, blk_q=128, blk_k=128,
                                              interpret=True).astype(jnp.float32))
    want = want.transpose(0, 2, 1, 3).reshape(got.shape)
    tol = _tol(dtype, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    exact = _f32(fused_attention_packed(qp, kp, vp, 2))
    np.testing.assert_array_equal(exact, _f32(merge_heads(flash_mod.reference_attention(q, k, v))))
    assert np.abs(got - exact).max() > 20 * tol
    count = flash_mod.launches_packed_bounded
    np.testing.assert_array_equal(
        _f32(flash_mod.flash_attention_packed_bounded_cuda(qp, kp, vp, 2, ANCHOR)), got)
    assert flash_mod.launches_packed_bounded == count
