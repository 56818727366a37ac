"""The plain versions of TPU kernels 8, 9 and 12 (the cost probes) on the CPU,
against the probes' own Pallas kernel bodies run in interpret mode.

The kernels live in ``scripts/flash_ablate.py`` (``make_kernel(mode)``: the
bounded loop cut down, q unscaled, transposed output), ``scripts/
flash_variants.py`` (``kern_a`` with and without ``pv_bf16``, ``kern_b``,
``kern_c``: exact attention in float32 in three layouts) and ``scripts/
mm_probe.py`` (``_loop_kernel``: nudged matmuls accumulated in float32,
four dimension numbers).  Their wrappers are jitted without an
``interpret`` flag, so each test builds ``pl.pallas_call(...,
interpret=True)`` around the imported kernel body with the script's own
block specs, at small shapes.

Importing a script sets JAX's compilation-cache directory and ``sys.path``;
both are restored at once.  ``flash_variants.py`` has no ``__main__`` guard
and runs its four probes when imported (on the CPU each prints "FAILED:
Only interpret mode is supported"): the import runs with the compilation
cache off and its output silenced.  Its kernels read the key block
``BLK_K`` from the module: the tests set it on the imported module and
restore it.

The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_port_kernels.py``, ``chip_smoke.py``).
"""

import contextlib
import functools
import importlib.util
import io
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hedit_tpu_torch.ops import flash_probes as fp
from hedit_tpu_torch.ops import mm_probe as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
BLK = 256          # query blocks of the interpret runs (and row 8's key blocks)
# mm_probe.py's dimension numbers by the port's layout names
DNUMS = {"nn": (((1,), (0,)), ((), ())), "tl": (((0,), (0,)), ((), ())),
         "tr": (((1,), (1,)), ((), ())), "tm": (((0,), (1,)), ((), ()))}
# reduced operand shapes of each layout: qk-like (K = 48, 40) and pv-like (K = 256)
MM_SHAPES = {"nn": ((64, 48), (48, 96)), "tl": ((40, 64), (40, 96)),
             "tr": ((64, 40), (96, 40)), "tm": ((256, 40), (64, 256))}
MM_REPS = 8


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _import_script(name):
    """Import ``scripts/<name>.py`` by path, with JAX's compilation cache off
    and its output silenced; undo its settings of the cache directory and of
    ``sys.path``."""
    cache_dir, path = jax.config.jax_compilation_cache_dir, list(sys.path)
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        spec = importlib.util.spec_from_file_location(f"_cost_probe_{name}",
                                                      os.path.join(ROOT, "scripts", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        with contextlib.redirect_stdout(io.StringIO()):
            spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_enable_compilation_cache", enabled)
        sys.path[:] = path
    return module


@pytest.fixture(scope="module")
def scripts():
    had_cache = os.path.exists(os.path.join(ROOT, ".jax_cache"))
    mods = {n: _import_script(n) for n in ("flash_ablate", "flash_variants", "mm_probe")}
    yield mods
    assert had_cache or not os.path.exists(os.path.join(ROOT, ".jax_cache"))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _pair(arrays, dtype):
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrays],
            [jnp.asarray(a.astype(np.float32)).astype(jdt) for a in arrays])


def _bf16_ulp_tol(dtype, want, f32_tol=2e-5):
    """float32: 2e-5 (summation order); bfloat16: one output ulp at the
    largest output, 2^-8 * max: both sides round p and the output at the
    same steps, and a rounding may fall the other way."""
    return f32_tol if dtype == "float32" else 2.0 ** -8 * np.abs(want).max()


# -- row 8: flash_ablate.py ------------------------------------------------


def _ablate_inputs(dtype):
    """q, k, v [1, 2, 1024, 40] drawn as the probe draws them: numpy
    RandomState(0), q and k * 0.05, v unit normal."""
    rng = np.random.RandomState(0)
    shape = (1, 2, 1024, 40)
    return _pair([rng.randn(*shape) * 0.05, rng.randn(*shape) * 0.05, rng.randn(*shape)], dtype)


def _jax_ablate(mod, mode, q, k, v):
    """The script's ``run`` with interpret=True and 256-row blocks."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    return pl.pallas_call(
        functools.partial(mod.make_kernel(mode), blk_k=BLK),
        grid=(b * h, sq // BLK),
        in_specs=[pl.BlockSpec((None, BLK, d), lambda bh, i: (bh, i, 0)),
                  pl.BlockSpec((None, sk, d), lambda bh, i: (bh, 0, 0)),
                  pl.BlockSpec((None, sk, d), lambda bh, i: (bh, 0, 0))],
        out_specs=pl.BlockSpec((None, d, BLK), lambda bh, i: (bh, 0, i)),
        out_shape=jax.ShapeDtypeStruct((b * h, d, sq), q.dtype),
        interpret=True,
    )(*(t.reshape(b * h, -1, d) for t in (q, k, v)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", fp.ABLATE_MODES)
def test_ablate_plain_version_matches_jax_kernel(scripts, mode, dtype):
    """Kernel 8's plain version against ``make_kernel(mode)``.  ``exp`` and
    ``noprolog`` (sums of p >= 0.19 here): one output ulp in bf16, 2e-5 in
    float32.  ``dots``: the sum of p is as often negative as positive, so each
    element is held within ``ablate_dots_tolerance`` (float32 reordering of
    the sums and of the scores, whose order differs between the two), the
    rows within that reach of zero excused: at most 0.1% of them."""
    (q, k, v), (jq, jk, jv) = _ablate_inputs(dtype)
    got = fp.flash_ablate_t_reference(q, k, v, mode)
    want = _f32(_jax_ablate(scripts["flash_ablate"], mode, jq, jk, jv))
    assert tuple(got.shape) == (2, 40, 1024) and got.dtype == q.dtype
    err = np.abs(_f32(got) - want)
    if mode != "dots":
        assert err.max() <= _bf16_ulp_tol(dtype, want)
        return
    tol, excused = fp.ablate_dots_tolerance(q, k, v, got)
    held = ~excused.numpy()[:, None, :]
    assert excused.float().mean().item() <= 1e-3, excused.sum().item()
    assert np.all((err <= tol.numpy()) | ~held), np.max(np.where(held, err / tol.numpy(), 0))
    # the floor is in use: rows with a negative sum come out near 1e30
    assert np.isfinite(want).all() and np.abs(want).max() > 1e25


# -- row 9: flash_variants.py ----------------------------------------------


def _variant_inputs(dtype, seed=1):
    """q, k, v [2, 1024, 40] (the script's [B*H, S, D]) from numpy."""
    rng = np.random.RandomState(seed)
    return _pair([rng.randn(2, 1024, 40) for _ in range(3)], dtype)


@contextlib.contextmanager
def _blk_k(mod, blk_k):
    """The script's kernels read BLK_K from their module: set it there only."""
    before = mod.BLK_K
    mod.BLK_K = blk_k
    try:
        yield
    finally:
        mod.BLK_K = before


def _jax_variant(mod, variant, q, k, v):
    """``run``'s pallas_call with interpret=True and 256-query blocks; variant
    d is ``kern_a`` with ``pv_bf16=True``."""
    bh, s, d = q.shape
    kernel, transposed, extra = {"a": (mod.kern_a, False, {}), "b": (mod.kern_b, True, {}),
                                 "c": (mod.kern_c, True, {}),
                                 "d": (mod.kern_a, False, {"pv_bf16": True})}[variant]
    out_spec = (pl.BlockSpec((None, d, BLK), lambda b, i: (b, 0, i)) if transposed
                else pl.BlockSpec((None, BLK, d), lambda b, i: (b, i, 0)))
    return pl.pallas_call(
        functools.partial(kernel, sm_scale=1.0 / d ** 0.5, **extra),
        grid=(bh, s // BLK),
        in_specs=[pl.BlockSpec((None, BLK, d), lambda b, i: (b, i, 0)),
                  pl.BlockSpec((None, s, d), lambda b, i: (b, 0, 0)),
                  pl.BlockSpec((None, s, d), lambda b, i: (b, 0, 0))],
        out_specs=out_spec,
        out_shape=jax.ShapeDtypeStruct((bh, d, s) if transposed else (bh, s, d), q.dtype),
        interpret=True,
    )(q, k, v)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["a", "b", "c", "d"])
def test_variant_plain_versions_match_jax_kernels(scripts, variant, dtype):
    """Kernel 9's plain versions against ``kern_a`` / ``kern_b`` / ``kern_c``
    and ``kern_a(pv_bf16=True)`` (d), with the script's ``BLK_K`` set to the
    plain version's key block, the CUDA kernel's 64-key tile (with pv_bf16 it
    decides the point p is rounded against); tolerances of
    ``_bf16_ulp_tol``."""
    (q, k, v), (jq, jk, jv) = _variant_inputs(dtype)
    mod = scripts["flash_variants"]
    with _blk_k(mod, fp.TILE):
        want = _f32(_jax_variant(mod, variant, jq, jk, jv))
    if variant in ("a", "d"):
        got = fp.flash_variant_a_reference(q, k, v, pv_bf16=variant == "d")
        assert tuple(got.shape) == (2, 1024, 40)
    else:
        got = getattr(fp, f"flash_variant_{variant}_reference")(q, k, v)
        assert tuple(got.shape) == (2, 40, 1024)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=_bf16_ulp_tol(dtype, want))


def test_variant_pv_bf16_at_the_tpu_key_block(scripts):
    """``kern_a(pv_bf16=True)`` at the TPU's 512-key block against the plain
    version with ``blk_k=512``, bf16 (one output ulp); the 64-key plain
    version rounds p against other points and differs from it."""
    (q, k, v), (jq, jk, jv) = _variant_inputs("bfloat16", seed=2)
    mod = scripts["flash_variants"]
    with _blk_k(mod, 512):
        want = _f32(_jax_variant(mod, "d", jq, jk, jv))
    got = _f32(fp.flash_variant_a_reference(q, k, v, pv_bf16=True, blk_k=512))
    np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_ulp_tol("bfloat16", want))
    assert np.any(_f32(fp.flash_variant_a_reference(q, k, v, pv_bf16=True)) != got)
    assert mod.BLK_K == 512  # the script's own, restored


# -- row 12: mm_probe.py ---------------------------------------------------


def _jax_mm(mod, layout, a, b, out_shape):
    """``run_case``'s pallas_call with interpret=True and MM_REPS reps."""
    return pl.pallas_call(
        functools.partial(mod._loop_kernel, dnums=DNUMS[layout], reps=MM_REPS),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32), interpret=True)(a, b)


def _mm_out_shape(layout):
    (a0, a1), (b0, b1) = MM_SHAPES[layout]
    _, a_t, b_t = mp.LAYOUTS[layout]
    return (a1 if a_t else a0, b0 if b_t else b1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", list(mp.LAYOUTS))
def test_mm_loop_plain_version_matches_jax_kernel(scripts, layout, dtype):
    """Kernel 12's plain version against ``_loop_kernel`` under each of the
    script's dimension numbers.  All-ones inputs (the probe's): every output
    is exactly K * (1 + 2 + ... + reps) on both sides.  Seeded inputs: within
    4 sqrt(reps K) 2^-24 times the sum of the magnitudes of each output's
    terms (float32 reordering; the products of bf16 values are exact).  In
    bf16 with the lhs contracted on its first dim (``tl``, ``tm``) XLA:CPU
    keeps the nudge a + i in float32 (excess precision) where the script
    rounds it to bf16, so there a is drawn on a 1/16 grid on which a + i is
    exact in bf16; ``nn`` and ``tr`` hold the rounding itself."""
    a_shape, b_shape = MM_SHAPES[layout]
    out_shape = _mm_out_shape(layout)
    k = a_shape[0] if mp.LAYOUTS[layout][1] else a_shape[1]
    (a1, b1), (ja1, jb1) = _pair([np.ones(a_shape), np.ones(b_shape)], dtype)
    got = mp.mm_loop_reference(a1, b1, layout, MM_REPS)
    want = np.asarray(_jax_mm(scripts["mm_probe"], layout, ja1, jb1, out_shape))
    exact = k * MM_REPS * (MM_REPS + 1) // 2
    assert tuple(got.shape) == out_shape and got.dtype == torch.float32
    assert np.all(got.numpy() == exact) and np.all(want == exact)

    rng = np.random.RandomState(3)
    a_np = rng.randn(*a_shape)
    if dtype == "bfloat16" and mp.LAYOUTS[layout][1]:
        a_np = np.round(a_np * 16) / 16
    (a, b), (ja, jb) = _pair([a_np, rng.randn(*b_shape)], dtype)
    got = mp.mm_loop_reference(a, b, layout, MM_REPS).numpy()
    want = np.asarray(_jax_mm(scripts["mm_probe"], layout, ja, jb, out_shape))
    tol = 4 * math.sqrt(MM_REPS * k) * 2.0 ** -24 * mp.mm_loop_magnitude(a, b, layout,
                                                                          MM_REPS).numpy()
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want) / tol)


# -- the wrappers on the CPU ------------------------------------------------


def test_cost_probe_wrappers_take_the_plain_versions_on_cpu():
    """CPU tensors: every new wrapper returns its plain version bit for bit
    and launches nothing; inputs the kernels cannot take raise on the CPU as
    on the card."""
    counters = ([f"launches_ablate_{m}{tc}" for m in fp.ABLATE_MODES for tc in ("", "_tc")]
                + [f"launches_variant_{v}_{t}" for v in "abc" for t in ("tc", "f32")]
                + ["launches_variant_d", "launches_variant_d_tc"])
    before = ([getattr(fp, c) for c in counters],
              [getattr(mp, f"launches_{lay}") for lay in mp.LAYOUTS])
    (q, k, v), _ = _ablate_inputs("float32")
    for mode in fp.ABLATE_MODES:
        torch.testing.assert_close(fp.flash_ablate_t_cuda(q, k, v, mode),
                                   fp.flash_ablate_t_reference(q, k, v, mode), rtol=0, atol=0)
    (q3, k3, v3), _ = _variant_inputs("bfloat16")
    torch.testing.assert_close(fp.flash_variant_a_cuda(q3, k3, v3),
                               fp.flash_variant_a_reference(q3, k3, v3), rtol=0, atol=0)
    torch.testing.assert_close(fp.flash_variant_a_cuda(q3, k3, v3, pv_bf16=True),
                               fp.flash_variant_a_reference(q3, k3, v3, pv_bf16=True),
                               rtol=0, atol=0)
    for name in "bc":
        torch.testing.assert_close(getattr(fp, f"flash_variant_{name}_cuda")(q3, k3, v3),
                                   fp.flash_variant_b_reference(q3, k3, v3), rtol=0, atol=0)
    for layout, (a_shape, b_shape) in MM_SHAPES.items():
        a, b = torch.randn(a_shape), torch.randn(b_shape)
        torch.testing.assert_close(mp.mm_loop_cuda(a, b, layout, 3),
                                   mp.mm_loop_reference(a, b, layout, 3), rtol=0, atol=0)
    assert before == ([getattr(fp, c) for c in counters],
                      [getattr(mp, f"launches_{lay}") for lay in mp.LAYOUTS])
    with pytest.raises(ValueError, match="mode"):
        fp.flash_ablate_t_cuda(q, k, v, "softmax")
    with pytest.raises(ValueError, match="multiples"):
        fp.flash_ablate_t_cuda(q[:, :, :200], k, v, "exp")
    with pytest.raises(ValueError, match="B\\*H, S, D"):
        fp.flash_variant_b_cuda(q, k, v)
    with pytest.raises(ValueError, match="multiples"):
        fp.flash_variant_c_cuda(q3[:, :100], k3, v3)
    with pytest.raises(ValueError, match="contraction"):
        mp.mm_loop_cuda(torch.ones(8, 40), torch.ones(48, 16), "nn")
    with pytest.raises(ValueError, match="layout"):
        mp.mm_loop_cuda(torch.ones(8, 40), torch.ones(40, 16), "nt")
