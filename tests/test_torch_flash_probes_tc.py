"""The bf16 tensor-core route of the S-minor bounded probes (TPU kernels 11b
and 11c), on the CPU.

The kernel (``hedit_tpu_torch/csrc/flash_probes_tc.cu``) runs only on the
card (``tests/test_torch_port_kernels.py``, ``chip_smoke.py``).  Here:

* the dispatch by dtype and layout (``probe_entry``), as values: bf16
  S-minor to the tensor-core entry point, float32 and ``packed_t`` to the
  CUDA-core template, anything else refused; CPU tensors take the plain
  versions and launch nothing;
* the C entry point's parameter list, read from the source, against the
  ``ctypes`` argument types the loader gives it (the sources cannot be
  compiled here);
* the kernel's order of work rendered in plain torch: the S-minor operands
  as they lie, the d = 40 contraction padded to 48, 64-key tiles, the
  anchor prologue over tiles, p rounded to bf16 and the row sum tile by
  tile, 64- or 128-row query blocks whose last one may reach past Sq.  It
  is held against the plain versions and against the scripts' Pallas
  kernels ``_packed_t_kernel_sminor`` and ``_packed_t_kernel_all_sminor``
  in interpret mode (128-query and 128-key blocks, so a 128-key anchor
  window, S = 256), the saturating input included.

The cases run as loops inside few items: pytest-xdist's loadfile scheduler
queues test files by their number of items.
"""

import ctypes
import functools
import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_probes as fp
from hedit_tpu_torch.ops.flash_attention import DENOM_FLOOR, reference_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLK = 128          # blk_q and blk_k of the interpret runs: the anchor window
BK = 64            # the kernel's key tile
SMINOR = ("packed_t_sminor", "packed_t_all_sminor")
# per S-minor layout: the script's kernel and whether v is S-minor
KERNELS = {"packed_t_sminor": ("_packed_t_kernel_sminor", False),
           "packed_t_all_sminor": ("_packed_t_kernel_all_sminor", True)}


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def test_probe_entry_dispatch_and_cpu_tensors():
    """bf16 S-minor inputs take the tensor-core entry point; float32 inputs,
    and ``packed_t`` in either dtype, the template's; other dtypes and
    layouts are refused.  CPU tensors of either dtype take the plain
    versions bit for bit and move no counter."""
    for layout in SMINOR:
        assert fp.probe_entry(torch.bfloat16, layout) == "hedit_flash_packed_t_tc"
        assert fp.probe_entry(torch.float32, layout) == "hedit_flash_packed_t"
    for dtype in (torch.bfloat16, torch.float32):
        assert fp.probe_entry(dtype, "packed_t") == "hedit_flash_packed_t"
    for dtype in (torch.float16, torch.float64, torch.int8):
        for layout in ("packed_t", *SMINOR):
            with pytest.raises(ValueError, match="float32 or bfloat16"):
                fp.probe_entry(dtype, layout)
    with pytest.raises(ValueError, match="layout"):
        fp.probe_entry(torch.bfloat16, "sminor")
    names = [n for n in dir(fp) if n.startswith("launches_packed_t")]
    assert {f"launches_{layout}_tc" for layout in SMINOR} <= set(names)
    counts = {n: getattr(fp, n) for n in names}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.from_numpy(np.random.RandomState(i).randn(1, 2, 128, 40)
                                    .astype(np.float32)).to(dtype) for i in range(3))
        for layout, (_, v_minor) in KERNELS.items():
            args = (q.mT.contiguous(), k.mT.contiguous(), v.mT.contiguous() if v_minor else v)
            got = getattr(fp, f"flash_{layout}_cuda")(*args, BK)
            want = getattr(fp, f"flash_{layout}_reference")(*args, BK)
            assert torch.equal(got, want) and got.dtype == dtype
            unrounded = getattr(fp, f"flash_{layout}_reference")(*args, BK,
                                                                 out_dtype=torch.float32)
            assert unrounded.dtype == torch.float32 and torch.equal(unrounded.to(dtype), want)
    assert counts == {n: getattr(fp, n) for n in names}


def _c_params(path, name):
    """[ctypes type of each parameter] of ``extern "C" int name(...)`` in
    ``path``, read from the source text (pointers and the stream as
    ``c_void_p``)."""
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', path.read_text()).group(1)
    return [ctypes.c_void_p if "*" in p else kinds[re.sub(r"\s+", " ", p).strip().rsplit(" ", 1)[0]]
            for p in (re.sub(r"\bconst\b", "", p) for p in params.split(","))]


def test_tc_entry_point_matches_its_argument_types():
    """``hedit_flash_packed_t_tc`` in ``csrc/flash_probes_tc.cu`` takes the
    parameters its ``ctypes`` argument types describe, which are those of
    the template's ``hedit_flash_packed_t``."""
    tc = _c_params(_build.CSRC / "flash_probes_tc.cu", "hedit_flash_packed_t_tc")
    template = _c_params(_build.CSRC / "flash_probes.cu", "hedit_flash_packed_t")
    assert tc == template == _build.ARGTYPES["hedit_flash_packed_t_tc"]
    assert _build.ARGTYPES["hedit_flash_packed_t_tc"] == _build.ARGTYPES["hedit_flash_packed_t"]


def _tiled_probe(qt, kt, vx, v_minor, anchor, bq):
    """The tensor-core kernel's order of work in plain torch, float32
    arithmetic on its bf16 roundings, from the S-minor operands as they lie
    (qt, kt [B, H, D, S]; vx [B, H, S, D], or [B, H, D, S] when ``v_minor``):
    (q * scale)^T rounded to the input dtype in slabs of ``bq`` queries, the
    last one padded with zero queries past Sq, and the contraction
    zero-padded to a multiple of 16; for each tile of 64 keys the scores of
    the slab; the shift from the prologue's tiles over the first ``anchor``
    keys; p rounded to the input dtype, the row sum and the PV product
    accumulated tile by tile; the floored denominator.  Returns [B, H*D, Sq],
    the float32 output before the kernel's final rounding."""
    b, h, d, sq = qt.shape
    sk = kt.shape[-1]
    dk, sq_blocks = -(-d // 16) * 16, -(-sq // bq) * bq
    scale = torch.tensor(1.0 / d ** 0.5 * np.log2(np.e), dtype=qt.dtype)
    qs = F.pad((qt * scale).float(), (0, sq_blocks - sq, 0, dk - d))   # [B, H, DK, Sq']
    ks = F.pad(kt.float(), (0, 0, 0, dk - d))                          # [B, H, DK, Sk]
    vs = (vx.mT if v_minor else vx).float()                            # [B, H, Sk, D]

    def scores(k0):
        return qs.mT @ ks[..., k0:k0 + BK]

    m = torch.full((b, h, sq_blocks, 1), -float("inf"))
    for k0 in range(0, anchor, BK):
        m = torch.maximum(m, scores(k0).amax(dim=-1, keepdim=True))
    shift = m + 16.0
    den = torch.zeros((b, h, sq_blocks, 1))
    acc = torch.zeros((b, h, sq_blocks, d))
    for k0 in range(0, sk, BK):
        p = torch.exp2(torch.clamp(scores(k0) - shift, max=100.0)).to(qt.dtype).float()
        den = den + p.sum(dim=-1, keepdim=True)
        acc = acc + p @ vs[..., k0:k0 + BK, :]
    out = acc / torch.clamp(den, min=DENOM_FLOOR)
    assert torch.isfinite(out).all()   # the zero queries past Sq too
    return out[:, :, :sq].mT.reshape(b, h * d, sq)


def _import_script(name):
    """Import ``scripts/<name>.py`` by path; undo its settings of JAX's
    compilation-cache directory and of ``sys.path``."""
    cache_dir, path = jax.config.jax_compilation_cache_dir, list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"_probe_tc_{name}",
                                                      os.path.join(ROOT, "scripts", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        sys.path[:] = path
    return module


def _jax_sminor(mod, layout, qt, kt, vx):
    """The script's S-minor kernel of ``layout`` with interpret=True and BLK
    blocks, on its own operands (qt, kt [B, H, D, S]; vx as the layout lays
    v) -> [B, H*D, Sq]."""
    kernel, v_minor = KERNELS[layout]
    b, h, d, sq = qt.shape
    sk = kt.shape[-1]
    whole = (lambda bh, i: (bh, 0, 0))
    return pl.pallas_call(
        functools.partial(getattr(mod, kernel), sm_scale=1.0 / d ** 0.5, blk_k=BLK),
        grid=(b * h, sq // BLK),
        in_specs=[pl.BlockSpec((None, d, BLK), lambda bh, i: (bh, 0, i)),
                  pl.BlockSpec((None, d, sk), whole),
                  pl.BlockSpec((None, d, sk) if v_minor else (None, sk, d), whole)],
        out_specs=pl.BlockSpec((None, d, BLK), lambda bh, i: (bh // h, bh % h, i)),
        out_shape=jax.ShapeDtypeStruct((b, h * d, sq), qt.dtype),
        interpret=True,
    )(*(t.reshape(b * h, *t.shape[2:]) for t in (qt, kt, vx)))


def _inputs(sq, sk, d, layout, saturate):
    """numpy-seeded bf16 operands of ``layout`` (qt, kt [1, 2, D, S]; v
    [1, 2, S, D] or S-minor) as (torch, jax) triples, and q, k, v [1, 2, S,
    D] in float32 for exact attention.  ``saturate``: every query's score
    with a key is set by the key's first component; key 140 scores ~146 log2
    units, more than 116 above the 128-key anchor window's max (clamped to
    2^100), keys 150-213 ~109."""
    rng = np.random.RandomState(sq + sk + d)
    q, k, v = (rng.randn(1, 2, s, d).astype(np.float32) for s in (sq, sk, sk))
    if saturate:
        q, k = q * 0.1, k * 0.5
        q[..., 0] = 8.0 * (d / 40) ** 0.5   # the same scores at every d
        k[:, :, 140, 0] = 80.0
        k[:, :, 150:214, 0] = 60.0
    ops = [q.swapaxes(-1, -2), k.swapaxes(-1, -2), v.swapaxes(-1, -2) if KERNELS[layout][1] else v]
    ops = [np.ascontiguousarray(a) for a in ops]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in ops],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in ops],
            [torch.from_numpy(a).to(torch.bfloat16).float() for a in (q, k, v)])


def _tol(want, rounded=False):
    """The rendering's output before its final rounding against another
    computation's.  Both round q * scale and p at the same steps, where
    float32 scores that differ in the last bits (other summation orders) may
    round the other way: 2^-8 of the largest output, as the kernel is held
    to the plain version on the card.  ``rounded``: the other output is
    rounded to bf16 (JAX's kernels), which adds half a bf16 ulp of the
    largest output."""
    top = float(np.abs(want).max())
    return 2.0 ** -8 * top + (2.0 ** (np.floor(np.log2(top)) - 8) if rounded else 0.0)


def test_tiled_order_matches_the_plain_versions_and_jax():
    """Both layouts at d = 40 (64-query blocks, the contraction padded to
    48) and d = 80 (128-query blocks), plain and saturating, anchored on the
    first 128 keys, against the plain versions before their final rounding
    and the scripts' kernels in interpret mode (tolerances of ``_tol``: the
    largest error read 5e-5 and 0.8-1.03 of 2^-8 * max); on
    the saturating input the probe differs from exact attention by more
    than 20 tolerances.  Then at d = 80 an Sq of 64 more than a multiple of
    128 (Sq = 320 != Sk = 256), whose last block reaches past Sq, against
    the plain versions alone (the interpret runs cover whole 128-row
    blocks)."""
    scripts = _import_script("flash_nhd_variants")
    for layout in SMINOR:
        for d, bq in ((40, 64), (80, 128)):
            for saturate in (False, True):
                where = f"{layout} d={d} saturate={saturate}"
                ops, jops, exact_in = _inputs(256, 256, d, layout, saturate)
                got = _tiled_probe(*ops, KERNELS[layout][1], BLK, bq).numpy()
                plain = getattr(fp, f"flash_{layout}_reference")(
                    *ops, BLK, out_dtype=torch.float32).numpy()
                want = np.asarray(_jax_sminor(scripts, layout, *jops).astype(jnp.float32))
                assert got.shape == (1, 2 * d, 256), where
                tol = _tol(plain)
                np.testing.assert_allclose(got, plain, rtol=0, atol=tol, err_msg=where)
                np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want, rounded=True),
                                           err_msg=where)
                if saturate:
                    exact = fp._packed_t(reference_attention(*exact_in)).numpy()
                    assert np.abs(got - exact).max() > 20 * tol, where
        ops, _, _ = _inputs(320, 256, 80, layout, False)
        got = _tiled_probe(*ops, KERNELS[layout][1], BLK, 128).numpy()
        plain = getattr(fp, f"flash_{layout}_reference")(*ops, BLK,
                                                         out_dtype=torch.float32).numpy()
        assert got.shape == (1, 160, 320)
        np.testing.assert_allclose(got, plain, rtol=0, atol=_tol(plain), err_msg=layout)
