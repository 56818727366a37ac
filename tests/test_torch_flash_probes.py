"""The plain versions of TPU kernels 10 and 11 (the flash probes) on the CPU,
against the probes' own Pallas kernel bodies run in interpret mode.

The kernels live in ``scripts/flash_nhd_variants.py`` (``_packed_t_kernel``,
``_packed_t_kernel_sminor``, ``_packed_t_kernel_all_sminor``: bounded,
packed transposed output ``[B, H*D, Sq]``) and ``scripts/flash_v4_variants.py``
(``kern_exp2``: exact with exp2, ``[B*H, D, Sq]`` output, with and without the
pipelined loop).  Their wrappers are jitted without an ``interpret`` flag, so
each test builds ``pl.pallas_call(..., interpret=True)`` around the imported
kernel body with the script's own block specs, at 128-query and 128-key
blocks (so a 128-key anchor window; kernel 10 also at the CUDA kernel's
64-key blocks) and S = 256.  Importing a script sets
JAX's compilation-cache directory and ``sys.path``; both are restored at
once, before anything compiles.

The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_port_kernels.py``, ``chip_smoke.py``).
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hedit_tpu_torch.ops import flash_probes as fp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLK = 128          # blk_q and blk_k of the interpret runs: the anchor window
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
LAYOUTS = ["packed_t", "packed_t_sminor", "packed_t_all_sminor"]
# per layout: the script's kernel and whether q / k and v are S-minor
KERNELS = {"packed_t": ("_packed_t_kernel", False, False),
           "packed_t_sminor": ("_packed_t_kernel_sminor", True, False),
           "packed_t_all_sminor": ("_packed_t_kernel_all_sminor", True, True)}


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _import_script(name):
    """Import ``scripts/<name>.py`` by path; undo its settings of JAX's
    compilation-cache directory and of ``sys.path``."""
    cache_dir, path = jax.config.jax_compilation_cache_dir, list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                      os.path.join(ROOT, "scripts", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        sys.path[:] = path
    return module


@pytest.fixture(scope="module")
def scripts():
    had_cache = os.path.exists(os.path.join(ROOT, ".jax_cache"))
    mods = {n: _import_script(n) for n in ("flash_nhd_variants", "flash_v4_variants")}
    yield mods
    assert had_cache or not os.path.exists(os.path.join(ROOT, ".jax_cache"))


def _inputs(dtype, saturating=False, seed=0):
    """q, k, v [1, 2, 256, 40] from numpy as (torch, jax) pairs.  Saturating:
    every query's score with a key is set by the key's first component; the
    anchor window (the first 128 keys) scores a few log2 units, key 140 ~146
    (clamped to 2^100 by the bounded form), keys 150-213 ~109."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(1, 2, 256, 40).astype(np.float32) for _ in range(3))
    if saturating:
        q, k = q * 0.1, k * 0.5
        q[..., 0] = 8.0
        k[:, :, 140, 0] = 80.0
        k[:, :, 150:214, 0] = 60.0
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in (q, k, v)],
            [jnp.asarray(a).astype(jdt) for a in (q, k, v)])


def _jax_packed_t(mod, layout, q, k, v):
    """The script's wrapper of ``layout`` with interpret=True and BLK blocks:
    q, k, v [B, H, S, D] (transposed here to the kernel's S-minor inputs) ->
    [B, H*D, Sq]."""
    kernel, qk_minor, v_minor = KERNELS[layout]
    b, h, sq, d = q.shape
    sk = k.shape[2]

    def flat(t, minor):
        return t.swapaxes(-1, -2).reshape(b * h, d, -1) if minor else t.reshape(b * h, -1, d)

    def spec(minor, s, whole):
        rows = s if whole else BLK
        index = (lambda bh, i: (bh, 0, 0)) if whole else (
            (lambda bh, i: (bh, 0, i)) if minor else (lambda bh, i: (bh, i, 0)))
        return pl.BlockSpec((None, d, rows) if minor else (None, rows, d), index)

    return pl.pallas_call(
        functools.partial(getattr(mod, kernel), sm_scale=1.0 / d ** 0.5, blk_k=BLK),
        grid=(b * h, sq // BLK),
        in_specs=[spec(qk_minor, sq, False), spec(qk_minor, sk, True), spec(v_minor, sk, True)],
        out_specs=pl.BlockSpec((None, d, BLK), lambda bh, i: (bh // h, bh % h, i)),
        out_shape=jax.ShapeDtypeStruct((b, h * d, sq), q.dtype),
        interpret=True,
    )(flat(q, qk_minor), flat(k, qk_minor), flat(v, v_minor))


def _jax_exp2_t(mod, q, k, v, pipe, blk_k):
    """``run_variant``'s pallas_call with interpret=True, BLK query blocks and
    ``blk_k`` key blocks."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    return pl.pallas_call(
        functools.partial(mod.kern_exp2, sm_scale=1.0 / d ** 0.5, blk_k=blk_k, pipe=pipe),
        grid=(b * h, sq // BLK),
        in_specs=[pl.BlockSpec((None, BLK, d), lambda bh, i: (bh, i, 0)),
                  pl.BlockSpec((None, sk, d), lambda bh, i: (bh, 0, 0)),
                  pl.BlockSpec((None, sk, d), lambda bh, i: (bh, 0, 0))],
        out_specs=pl.BlockSpec((None, d, BLK), lambda bh, i: (bh, 0, i)),
        out_shape=jax.ShapeDtypeStruct((b * h, d, sq), q.dtype),
        interpret=True,
    )(*(t.reshape(b * h, -1, d) for t in (q, k, v)))


def _args(layout, q, k, v):
    """The port's operands of ``layout`` from [B, H, S, D] tensors."""
    _, qk_minor, v_minor = KERNELS[layout]
    tr = lambda t, m: t.transpose(-1, -2).contiguous() if m else t  # noqa: E731
    return tr(q, qk_minor), tr(k, qk_minor), tr(v, v_minor)


def _tol(dtype, want):
    """float32: 2e-5 (exp2 and summation order).  bfloat16: both sides round
    q * scale, p and the output to bf16 at the same steps; their float32
    scores differ in the last bits, so a rounding may fall the other way:
    one bf16 ulp at the largest output, 2^-8 * max."""
    return 2e-5 if dtype == "float32" else 2.0 ** -8 * np.abs(want).max()


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("saturating", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_packed_t_plain_versions_match_jax_kernels(scripts, layout, dtype, saturating):
    """Kernel 11's three plain versions, anchored on the first 128 keys,
    against the script's kernels (tolerances of ``_tol``).  On the saturating
    input they also differ from exact attention by far more than that."""
    (q, k, v), (jq, jk, jv) = _inputs(dtype, saturating)
    got = getattr(fp, f"flash_{layout}_reference")(*_args(layout, q, k, v), BLK)
    want = _f32(_jax_packed_t(scripts["flash_nhd_variants"], layout, jq, jk, jv))
    assert tuple(got.shape) == (1, 80, 256) and got.dtype == q.dtype
    tol = _tol(dtype, want)
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=tol)
    if saturating:
        exact = fp._packed_t(torch.nn.functional.scaled_dot_product_attention(
            q.float(), k.float(), v.float()))
        assert np.abs(_f32(got) - exact.numpy()).max() > 20 * tol


@pytest.mark.parametrize("blk_k", [fp.TILE, BLK])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pipe", [False, True])
def test_exp2_t_plain_version_matches_jax_kernel(scripts, pipe, dtype, blk_k):
    """Kernel 10's plain version against ``kern_exp2`` with and without the
    pipelined loop, at the same key block: the CUDA kernel's 64 keys (the
    plain version's default) and 128 (tolerances of ``_tol``); the plain
    version depends on no such loop."""
    (q, k, v), (jq, jk, jv) = _inputs(dtype, seed=1)
    got = (fp.flash_exp2_t_reference(q, k, v) if blk_k == fp.TILE
           else fp.flash_exp2_t_reference(q, k, v, blk_k=blk_k))
    want = _f32(_jax_exp2_t(scripts["flash_v4_variants"], jq, jk, jv, pipe, blk_k))
    assert tuple(got.shape) == (2, 40, 256) and got.dtype == q.dtype
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=_tol(dtype, want))


def test_cuda_wrappers_take_the_plain_versions_on_cpu():
    """CPU tensors: every probe wrapper returns its plain version bit for bit
    and launches nothing; shapes the kernels cannot cover raise on the CPU as
    on the card."""
    (q, k, v), _ = _inputs("float32", seed=2)
    counts = (fp.launches_packed_t, fp.launches_packed_t_sminor,
              fp.launches_packed_t_all_sminor, fp.launches_exp2_t)
    for layout in LAYOUTS:
        args = _args(layout, q, k, v)
        np.testing.assert_array_equal(getattr(fp, f"flash_{layout}_cuda")(*args, BLK).numpy(),
                                      getattr(fp, f"flash_{layout}_reference")(*args, BLK).numpy())
    for pipe in (False, True):
        np.testing.assert_array_equal(fp.flash_exp2_t_cuda(q, k, v, pipe).numpy(),
                                      fp.flash_exp2_t_reference(q, k, v).numpy())
    assert counts == (fp.launches_packed_t, fp.launches_packed_t_sminor,
                      fp.launches_packed_t_all_sminor, fp.launches_exp2_t)
    with pytest.raises(ValueError, match="multiples"):
        fp.flash_exp2_t_cuda(q[:, :, :200], k, v)
    with pytest.raises(ValueError, match="anchor"):
        fp.flash_packed_t_cuda(q, k, v, 96)
