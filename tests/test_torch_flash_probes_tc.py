"""The bf16 tensor-core route of the bounded probes (TPU kernels 11a, 11b
and 11c), of the exact exp2 probe (TPU kernel 10, both key loops), of the
ablations ``dots``, ``exp`` and ``noprolog`` (TPU kernel 8) and of
``kern_a`` with ``pv_bf16`` (TPU kernel 9 d), and the kernels of
``csrc/flash_variants.cu`` in both dtypes (rows 9 a, b and float32 d, and
rows 11a-c, 8 and 10 in float32, on the query-major kernel, row 9 c on its
own), on the CPU.

The kernels (``hedit_tpu_torch/csrc/flash_probes_tc.cu``) run only on the
card (``tests/test_torch_port_kernels.py``, ``chip_smoke.py``).  Here:

* the dispatch by dtype (``probe_entry``, ``exp2_entry``, ``ablate_entry``,
  ``variant_entry``), as values: bf16 to the tensor-core entry points (but
  variants a-c), float32 to the CUDA-core kernels (``hedit_flash_packed_t``,
  ``hedit_flash_exp2_t``, ``hedit_flash_ablate_t`` and, for variants a, b
  and d, ``hedit_flash_variant`` the query-major kernel's;
  ``hedit_flash_variant_c`` for c, in both dtypes), anything else
  refused; CPU tensors take the plain versions and launch nothing;
* the C entry points' parameter lists, read from the source, against the
  ``ctypes`` argument types the loader gives them (the sources cannot be
  compiled here);
* the kernel's order of work rendered in plain torch: q * scale rounded in
  blocks of ``bq`` queries, the last one padded with zero queries past Sq,
  the d = 40 contraction padded to 48, 64-key tiles, the bounded probes'
  anchor prologue over tiles, the exact probe's running max over each
  64-key tile (plain and pipelined loops), p rounded to bf16 and the row
  sum tile by tile.  It is held against the plain versions and against the
  scripts' Pallas kernels ``_packed_t_kernel``, ``_packed_t_kernel_sminor``,
  ``_packed_t_kernel_all_sminor`` (128-query and 128-key blocks, so a
  128-key anchor window, S = 256) and ``kern_exp2`` (128-query blocks,
  ``blk_k = 64``) in interpret mode, the saturating input included;
* the same for rows 8 and 9 d: q as it is, p rounded and summed tile by
  tile with row 8's floor, or row 9 d's scores times sm_scale * log2(e)
  after the product, its running max a 64-key tile, its unrounded sum and
  bf16 p in PV; held against the plain versions and ``make_kernel(mode)``
  and ``kern_a(pv_bf16=True)`` (``BLK_K`` = 64) in interpret mode.  ``dots``
  is held on the rendering's own scores and lane-ordered row sums with the
  smoke's check functions (``fp.ablate_dots_check``), which must also
  refuse a row sum, an output or a score moved past them;
* row 9 c's order of work: exact bf16 products, the scale (times log2(e))
  after the product, key-major scores, the column max and sum down the key
  axis, the running max over 64-key tiles, exp2, float32 PV; held against
  ``flash_variant_c_reference`` and ``kern_c`` in interpret mode;
* rows 9 a, b and float32 d in the query-major kernel's order: 128-query
  blocks, the row max and sum, the scale after the product with exp2 (a,
  b) or the template's order (d, p rounded to bf16 for PV); held against
  the plain versions and ``kern_a`` / ``kern_b`` / ``kern_a(pv_bf16=True)``
  in interpret mode;
* rows 11a-c and 8 in float32 in the same kernel's order: 128-query blocks
  and 64-key tiles at d = 40, 64 and 32 at d = 80, row 11's online shift
  over its anchor window's tiles, the row sums in the kernel's lanes, the
  S-minor operands transposed on their way as the kernel copies them; held
  against the plain versions and the scripts' kernels in interpret mode;
* row 10 in float32 in the same kernel's order, both key loops: q times c
  as it is loaded, the key tile of each head dim, the running max; held
  against ``flash_exp2_t_reference`` at that tile and ``kern_exp2`` in
  interpret mode, the two loops bit for bit.

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
from test_torch_cost_probes import _blk_k, _jax_ablate, _jax_variant
from test_torch_cost_probes import _import_script as _import_quietly
from test_torch_flash_probes import _jax_exp2_t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLK = 128          # blk_q and blk_k of the bounded interpret runs: the anchor window
BK = 64            # the kernel's key tile, and kern_exp2's blk_k in the interpret runs
LAYOUTS = ("packed_t", "packed_t_sminor", "packed_t_all_sminor")
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


def _layout_args(layout, q, k, v):
    """The operands of ``layout`` from [B, H, S, D] tensors."""
    _, qk_minor, v_minor = KERNELS[layout]
    tr = lambda t, m: t.mT.contiguous() if m else t  # noqa: E731
    return tr(q, qk_minor), tr(k, qk_minor), tr(v, v_minor)


def test_probe_entry_dispatch_and_cpu_tensors():
    """bf16 inputs of every bounded layout and of the exp2 probe take the
    tensor-core entry points, float32 inputs the query-major kernel's of the
    CUDA cores (the same entry names); other dtypes and layouts are refused.
    The exp2 probe's key tile is 64 keys but in float32 at d = 80 (32).  CPU
    tensors of either dtype take the plain versions bit for bit (the exp2
    probe in both loops, at its key tile) and move no counter."""
    for layout in LAYOUTS:
        assert fp.probe_entry(torch.bfloat16, layout) == "hedit_flash_packed_t_tc"
        assert fp.probe_entry(torch.float32, layout) == "hedit_flash_packed_t"
    assert fp.exp2_entry(torch.bfloat16) == "hedit_flash_exp2_t_tc"
    assert fp.exp2_entry(torch.float32) == "hedit_flash_exp2_t"
    assert [fp.exp2_key_tile(dtype, d) for dtype in (torch.bfloat16, torch.float32)
            for d in (40, 80)] == [64, 64, 64, 32]
    for dtype in (torch.float16, torch.float64, torch.int8):
        for layout in LAYOUTS:
            with pytest.raises(ValueError, match="float32 or bfloat16"):
                fp.probe_entry(dtype, layout)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fp.exp2_entry(dtype)
    with pytest.raises(ValueError, match="layout"):
        fp.probe_entry(torch.bfloat16, "sminor")
    # rows 8 and 9: bf16 dots, exp, noprolog and d on the tensor cores; c on
    # its own kernel in both dtypes; a, b and float32 d on the query-major one
    for mode in fp.ABLATE_MODES:
        assert fp.ablate_entry(torch.bfloat16, mode) == "hedit_flash_ablate_t_tc"
        assert fp.ablate_entry(torch.float32, mode) == "hedit_flash_ablate_t"
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fp.ablate_entry(torch.float16, mode)
    for name in "abcd":
        assert fp.variant_entry(torch.bfloat16, name) == {
            "c": "hedit_flash_variant_c", "d": "hedit_flash_variant_tc"}.get(
                name, "hedit_flash_variant")
        assert fp.variant_entry(torch.float32, name) == (
            "hedit_flash_variant_c" if name == "c" else "hedit_flash_variant")
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fp.variant_entry(torch.float64, name)
    with pytest.raises(ValueError, match="mode"):
        fp.ablate_entry(torch.bfloat16, "softmax")
    with pytest.raises(ValueError, match="variant"):
        fp.variant_entry(torch.bfloat16, "e")
    names = [n for n in dir(fp) if n.startswith("launches_")]
    assert ({f"launches_{layout}_tc" for layout in LAYOUTS}
            | {"launches_exp2_t_tc", "launches_ablate_dots_tc", "launches_ablate_exp_tc",
               "launches_ablate_noprolog_tc", "launches_ablate_dots_check_tc",
               "launches_variant_d_tc", "launches_variant_d"}
            | {f"launches_variant_{v}_{t}" for v in "abc" for t in ("tc", "f32")}
            <= set(names))
    counts = {n: getattr(fp, n) for n in names}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.from_numpy(np.random.RandomState(i).randn(1, 2, 128, 40)
                                    .astype(np.float32)).to(dtype) for i in range(3))
        for layout in LAYOUTS:
            args = _layout_args(layout, q, k, v)
            got = getattr(fp, f"flash_{layout}_cuda")(*args, BK)
            want = getattr(fp, f"flash_{layout}_reference")(*args, BK)
            assert torch.equal(got, want) and got.dtype == dtype
            unrounded = getattr(fp, f"flash_{layout}_reference")(*args, BK,
                                                                 out_dtype=torch.float32)
            assert unrounded.dtype == torch.float32 and torch.equal(unrounded.to(dtype), want)
        want = fp.flash_exp2_t_reference(q, k, v, blk_k=fp.exp2_key_tile(dtype, 40))
        for pipe in (False, True):
            got = fp.flash_exp2_t_cuda(q, k, v, pipe)
            assert torch.equal(got, want) and got.dtype == dtype
        unrounded = fp.flash_exp2_t_reference(q, k, v, out_dtype=torch.float32)
        assert unrounded.dtype == torch.float32 and torch.equal(unrounded.to(dtype), want)
        for mode in fp.ABLATE_MODES:
            want = fp.flash_ablate_t_reference(q, k, v, mode)
            got = fp.flash_ablate_t_cuda(q, k, v, mode)
            assert torch.equal(got, want) and got.dtype == dtype
            unrounded = fp.flash_ablate_t_reference(q, k, v, mode, out_dtype=torch.float32)
            assert unrounded.dtype == torch.float32 and torch.equal(unrounded.to(dtype), want)
        q3, k3, v3 = (t[0] for t in (q, k, v))
        want = fp.flash_variant_a_reference(q3, k3, v3, pv_bf16=True)
        got = fp.flash_variant_a_cuda(q3, k3, v3, pv_bf16=True)
        assert torch.equal(got, want) and got.dtype == dtype
        unrounded = fp.flash_variant_a_reference(q3, k3, v3, pv_bf16=True,
                                                 out_dtype=torch.float32)
        assert unrounded.dtype == torch.float32 and torch.equal(unrounded.to(dtype), want)
        got = fp.flash_variant_c_cuda(q3, k3, v3)
        assert torch.equal(got, fp.flash_variant_c_reference(q3, k3, v3)) and got.dtype == dtype
        # dots' check instance: its plain version, the row sums in the kernel's order
        out, scores, sums = fp.flash_ablate_dots_check_cuda(q, k, v)
        assert out.dtype == dtype and scores.shape == (2, 128, 128) and sums.shape == (2, 128)
        assert torch.equal(sums, fp.ablate_dots_row_sums(scores))
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
    """``hedit_flash_packed_t_tc``, ``hedit_flash_exp2_t_tc``,
    ``hedit_flash_ablate_t_tc`` and ``hedit_flash_variant_tc`` in
    ``csrc/flash_probes_tc.cu`` take the parameters their ``ctypes``
    argument types describe, which are those of the float32 entries
    ``hedit_flash_packed_t``, ``hedit_flash_exp2_t``, ``hedit_flash_ablate_t``
    and ``hedit_flash_variant`` (the query-major kernel,
    ``csrc/flash_variants.cu``, the only source that defines
    ``hedit_flash_exp2_t``)."""
    for name in ("hedit_flash_packed_t", "hedit_flash_exp2_t", "hedit_flash_ablate_t",
                 "hedit_flash_variant"):
        tc = _c_params(_build.CSRC / "flash_probes_tc.cu", f"{name}_tc")
        core = _c_params(_build.CSRC / "flash_variants.cu", name)
        assert tc == core == _build.ARGTYPES[f"{name}_tc"], name
        assert _build.ARGTYPES[f"{name}_tc"] == _build.ARGTYPES[name], name
    # dots' check instance (two more pointers, no mode) and row 9 c (no variant code)
    for name, source in (("hedit_flash_ablate_dots_check_tc", "flash_probes_tc.cu"),
                         ("hedit_flash_variant_c", "flash_variants.cu")):
        assert _c_params(_build.CSRC / source, name) == _build.ARGTYPES[name], name
    defining = [p.name for p in sorted(_build.CSRC.glob("*.cu"))
                if re.search(r'extern "C" int hedit_flash_exp2_t\(', p.read_text())]
    assert defining == ["flash_variants.cu"], defining


def _tiled_probe(ops, layout, anchor, bq, exact=False, pipe=False):
    """The tensor-core kernel's order of work in plain torch, float32
    arithmetic on its bf16 roundings, from the operands of ``layout`` (the
    exact probe: ``packed_t``'s): q * scale rounded to the input dtype in
    blocks of ``bq`` queries, the last one padded with zero queries past
    Sq, and the contraction zero-padded to a multiple of 16; for each tile
    of 64 keys the scores of the block.  Bounded (``exact`` false): the
    shift from the prologue's tiles over the first ``anchor`` keys, p
    rounded to the input dtype, the row sum and the PV product accumulated
    tile by tile, the floored denominator; returns [B, H*D, Sq].  Exact: the
    running max from -1e30 moved over each tile, alpha rescaling the sum and
    the accumulator, p = exp2(s - m) rounded, no floor; ``pipe`` takes tile
    t's scores before tile t - 1's softmax and PV, with a prologue and an
    epilogue; returns [B*H, D, Sq].  The output before the kernel's final
    rounding."""
    _, qk_minor, v_minor = KERNELS[layout]
    q, k, v = (t.mT if m else t for t, m in zip(ops, (qk_minor, qk_minor, v_minor)))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = torch.tensor(1.0 / d ** 0.5 * np.log2(np.e), dtype=q.dtype)
    qs, ks, vs, sq_blocks = _padded(q * scale, k, v, bq)

    def scores(k0):
        return qs @ ks[..., k0:k0 + BK, :].mT

    den = torch.zeros((b, h, sq_blocks, 1))
    acc = torch.zeros((b, h, sq_blocks, d))
    if not exact:
        m = torch.full((b, h, sq_blocks, 1), -float("inf"))
        for k0 in range(0, anchor, BK):
            m = torch.maximum(m, scores(k0).amax(dim=-1, keepdim=True))
        shift = m + 16.0
        for k0 in range(0, sk, BK):
            p = torch.exp2(torch.clamp(scores(k0) - shift, max=100.0)).to(q.dtype).float()
            den = den + p.sum(dim=-1, keepdim=True)
            acc = acc + p @ vs[..., k0:k0 + BK, :]
        out = acc / torch.clamp(den, min=DENOM_FLOOR)
    else:
        m = torch.full((b, h, sq_blocks, 1), -1e30)

        def softmax_pv(s, k0):
            nonlocal m, den, acc
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new).to(q.dtype).float()
            den = den * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vs[..., k0:k0 + BK, :]
            m = m_new

        if pipe:
            s_prev = scores(0)
            for k0 in range(BK, sk, BK):
                s_next = scores(k0)
                softmax_pv(s_prev, k0 - BK)
                s_prev = s_next
            softmax_pv(s_prev, sk - BK)
        else:
            for k0 in range(0, sk, BK):
                softmax_pv(scores(k0), k0)
        out = acc / den
    assert torch.isfinite(out).all()   # the zero queries past Sq too
    out = out[:, :, :sq].mT
    return out.reshape(b * h, d, sq) if exact else out.reshape(b, h * d, sq)


def _padded(q, k, v, bq):
    """q [B, H, Sq, D] in float32, padded with zero queries to a multiple of
    ``bq`` and with zero columns to the contraction's multiple of 16; k
    padded with the same columns; v in float32; the padded Sq."""
    d, sq = q.shape[-1], q.shape[-2]
    dk, sq_blocks = -(-d // 16) * 16, -(-sq // bq) * bq
    return (F.pad(q.float(), (0, dk - d, 0, sq_blocks - sq)), F.pad(k.float(), (0, dk - d)),
            v.float(), sq_blocks)


def _tiled_ablate_or_pv_bf16(q, k, v, what, bq):
    """Rows 8 (``what`` ``dots``, ``exp`` or ``noprolog``) and 9 d
    (``pv_bf16``) in the tensor-core kernel's order of work, float32
    arithmetic on its bf16 roundings, from q, k, v [B, H, S, D]: q as it is,
    in blocks of ``bq`` queries padded as ``_tiled_probe`` pads them; for
    each tile of 64 keys the block's float32 scores.  Row 8: s - shift (0,
    or 12.34 clamped at 100), exp2 (``dots``: neither, p = s), p rounded to
    the input dtype into the row sum and the PV product tile by tile, the
    sum floored at 1e-30; returns [B*H, D, Sq].  ``dots`` sums each row in
    the kernel's lanes: lane t adds the pair p[8j + 2t] + p[8j + 2t + 1] of
    each 8-key n-tile in order, then lanes (0 + 1) + (2 + 3); and returns
    (out, its float32 scores [B*H, Sq, Sk], those sums [B*H, Sq]).  Row 9
    d: the scores times c = sm_scale * log2(e) in float32, the running max
    from -1e30 moved over each tile, alpha rescaling the sum and the
    accumulator, p = exp2(s c - m) unrounded into the sum and rounded to
    bf16 into PV, no floor; returns [B*H, Sq, D].  The output before the
    kernel's final rounding."""
    b, h, sq, d = q.shape
    qs, ks, vs, sq_blocks = _padded(q, k, v, bq)
    c = torch.tensor(1.0 / d ** 0.5 * np.log2(np.e), dtype=torch.float32)
    m = torch.full((b, h, sq_blocks, 1), -1e30)
    den = torch.zeros((b, h, sq_blocks, 1))
    acc = torch.zeros((b, h, sq_blocks, d))
    lanes = torch.zeros((b, h, sq_blocks, 4))
    tiles = []
    for k0 in range(0, k.shape[2], BK):
        s = qs @ ks[..., k0:k0 + BK, :].mT
        if what == "dots":
            p = s.to(q.dtype).float()
            for j in range(BK // 8):
                lanes = lanes + (p[..., 8 * j:8 * j + 8:2] + p[..., 8 * j + 1:8 * j + 8:2])
            acc = acc + p @ vs[..., k0:k0 + BK, :]
            tiles.append(s[:, :, :sq])
        elif what == "pv_bf16":
            s = s * c
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            den = den * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(torch.bfloat16).float() @ vs[..., k0:k0 + BK, :]
            m = m_new
        else:
            s = torch.clamp(s - 12.34, max=100.0) if what == "noprolog" else s
            p = torch.exp2(s).to(q.dtype).float()
            den = den + p.sum(dim=-1, keepdim=True)
            acc = acc + p @ vs[..., k0:k0 + BK, :]
    if what == "dots":
        den = ((lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3]))[..., None]
    out = (acc / (den if what == "pv_bf16" else torch.clamp(den, min=fp.ABLATE_FLOOR)))
    assert torch.isfinite(out).all()   # the zero queries past Sq too
    out = out[:, :, :sq]
    if what == "pv_bf16":
        return out.reshape(b * h, sq, d)
    out = out.mT.reshape(b * h, d, sq)
    if what != "dots":
        return out
    return (out, torch.cat(tiles, dim=-1).reshape(b * h, sq, -1),
            den[:, :, :sq, 0].reshape(b * h, sq))


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


def _jax_packed_t(mod, layout, q, k, v):
    """The script's kernel of ``layout`` with interpret=True and BLK blocks,
    on its own operands (q, k [B, H, S, D] or S-minor [B, H, D, S]; v as
    the layout lays it) -> [B, H*D, Sq]."""
    kernel, qk_minor, v_minor = KERNELS[layout]
    b, h = q.shape[:2]
    d, sq = (q.shape[2], q.shape[3]) if qk_minor else (q.shape[3], q.shape[2])
    sk = k.shape[3] if qk_minor else k.shape[2]
    whole = (lambda bh, i: (bh, 0, 0))
    return pl.pallas_call(
        functools.partial(getattr(mod, kernel), sm_scale=1.0 / d ** 0.5, blk_k=BLK),
        grid=(b * h, sq // BLK),
        in_specs=[pl.BlockSpec((None, d, BLK), lambda bh, i: (bh, 0, i)) if qk_minor
                  else pl.BlockSpec((None, BLK, d), lambda bh, i: (bh, i, 0)),
                  pl.BlockSpec((None, d, sk) if qk_minor else (None, sk, d), whole),
                  pl.BlockSpec((None, d, sk) if v_minor else (None, sk, d), whole)],
        out_specs=pl.BlockSpec((None, d, BLK), lambda bh, i: (bh // h, bh % h, i)),
        out_shape=jax.ShapeDtypeStruct((b, h * d, sq), q.dtype),
        interpret=True,
    )(*(t.reshape(b * h, *t.shape[2:]) for t in (q, k, v)))


def _inputs(sq, sk, d, layout, saturate, dtype=torch.bfloat16):
    """numpy-seeded operands of ``layout`` in ``dtype`` (q, k [1, 2, S, D]
    or S-minor [1, 2, D, S]; v [1, 2, S, D] or S-minor) as (torch, jax)
    triples, and q, k, v [1, 2, S, D] in float32 (rounded to ``dtype``)
    for exact attention.
    ``saturate``: every query's score with a key is set by the key's first
    component; key 140 scores ~146 log2 units, more than 116 above the
    128-key anchor window's max (clamped to 2^100), keys 150-213 ~109."""
    rng = np.random.RandomState(sq + sk + d)
    q, k, v = (rng.randn(1, 2, s, d).astype(np.float32) for s in (sq, sk, sk))
    if saturate:
        q, k = q * 0.1, k * 0.5
        q[..., 0] = 8.0 * (d / 40) ** 0.5   # the same scores at every d
        k[:, :, 140, 0] = 80.0
        k[:, :, 150:214, 0] = 60.0
    _, qk_minor, v_minor = KERNELS[layout]
    ops = [a.swapaxes(-1, -2) if m else a for a, m in zip((q, k, v), (qk_minor, qk_minor, v_minor))]
    ops = [np.ascontiguousarray(a) for a in ops]
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([torch.from_numpy(a).to(dtype) for a in ops],
            [jnp.asarray(a).astype(jdtype) for a in ops],
            [torch.from_numpy(a).to(dtype).float() for a in (q, k, v)])


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
    """The bounded probes in the three layouts at d = 40 (64-query blocks,
    the contraction padded to 48) and d = 80 (128-query blocks), plain and
    saturating, anchored on the first 128 keys; the exact exp2 probe in both
    loops at both head dims.  Each against its plain version before the
    final rounding and the scripts' kernels in interpret mode (tolerances
    of ``_tol``: the largest error read up to 1.03 of 2^-8 * max against
    JAX's rounded outputs); the two exact loops give the same float32
    values; on the saturating input the bounded probe differs from exact
    attention by more than 20 tolerances.  Then at d = 80 an Sq of 64 more
    than a multiple of 128 (Sq = 320 != Sk = 256), whose last block reaches
    past Sq, against the plain versions alone (the interpret runs cover
    whole 128-row blocks)."""
    nhd = _import_script("flash_nhd_variants")
    v4 = _import_script("flash_v4_variants")
    for layout in LAYOUTS:
        for d, bq in ((40, 64), (80, 128)):
            for saturate in (False, True):
                where = f"{layout} d={d} saturate={saturate}"
                ops, jops, exact_in = _inputs(256, 256, d, layout, saturate)
                got = _tiled_probe(ops, layout, BLK, bq).numpy()
                plain = getattr(fp, f"flash_{layout}_reference")(
                    *ops, BLK, out_dtype=torch.float32).numpy()
                want = np.asarray(_jax_packed_t(nhd, layout, *jops).astype(jnp.float32))
                assert got.shape == (1, 2 * d, 256), where
                tol = _tol(plain)
                np.testing.assert_allclose(got, plain, rtol=0, atol=tol, err_msg=where)
                np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want, rounded=True),
                                           err_msg=where)
                if saturate:
                    exact = fp._packed_t(reference_attention(*exact_in)).numpy()
                    assert np.abs(got - exact).max() > 20 * tol, where
        ops, _, _ = _inputs(320, 256, 80, layout, False)
        got = _tiled_probe(ops, layout, BLK, 128).numpy()
        plain = getattr(fp, f"flash_{layout}_reference")(*ops, BLK,
                                                         out_dtype=torch.float32).numpy()
        assert got.shape == (1, 160, 320)
        np.testing.assert_allclose(got, plain, rtol=0, atol=_tol(plain), err_msg=layout)
    for sq, d, bq in ((256, 40, 64), (256, 80, 128), (320, 80, 128)):
        ops, jops, _ = _inputs(sq, 256, d, "packed_t", False)
        loops = [_tiled_probe(ops, "packed_t", None, bq, exact=True, pipe=pipe)
                 for pipe in (False, True)]
        assert torch.equal(loops[0], loops[1]), f"exp2 d={d} Sq={sq}: the loops differ"
        got = loops[0].numpy()
        plain = fp.flash_exp2_t_reference(*ops, out_dtype=torch.float32).numpy()
        assert got.shape == (2, d, sq)
        np.testing.assert_allclose(got, plain, rtol=0, atol=_tol(plain), err_msg=f"exp2 d={d}")
        if sq % BLK:
            continue
        for pipe in (False, True):
            want = np.asarray(_jax_exp2_t(v4, *jops, pipe, BK).astype(jnp.float32))
            np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want, rounded=True),
                                       err_msg=f"exp2 d={d} pipe={pipe}")


def test_tiled_ablations_and_pv_bf16_match_the_plain_versions_and_jax():
    """Rows 8 (``exp``, ``noprolog``) at d = 40 (64-query blocks, the
    contraction padded to 48) and d = 80 (128-query blocks), S = 256, q and
    k times 0.5; ``noprolog`` also on an input whose scores pass 112.34, so
    that p saturates at 2^100 (the clamp then moves the output by more than
    20 tolerances); row 9 d at d = 40 on unit-normal inputs.  Each rendering
    against its plain version before the final rounding (``_tol``) and the
    script's kernel in interpret mode (``make_kernel(mode)`` with 256-row
    blocks; ``kern_a(pv_bf16=True)`` with ``BLK_K`` = 64, the kernel's key
    tile; ``_tol(..., rounded=True)``)."""
    ablate = _import_quietly("flash_ablate")
    for d, bq in ((40, 64), (80, 128)):
        for mode, saturate in (("exp", False), ("noprolog", False), ("noprolog", True)):
            where = f"{mode} d={d} saturate={saturate}"
            rng = np.random.RandomState(d + saturate)
            q, k, v = (rng.randn(1, 2, 256, d).astype(np.float32) * c for c in (0.5, 0.5, 1.0))
            if saturate:   # key 140 scores ~128, keys 150-159 ~116, every other key < 10
                q, k = q * 0.1, k * 0.1
                q[..., 0] = 8.0
                k[:, :, 140, 0] = 16.0
                k[:, :, 150:160, 0] = 14.5
            ops = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
            got = _tiled_ablate_or_pv_bf16(*ops, mode, bq).numpy()
            plain = fp.flash_ablate_t_reference(*ops, mode, out_dtype=torch.float32).numpy()
            want = np.asarray(_jax_ablate(ablate, mode, *(jnp.asarray(a).astype(jnp.bfloat16)
                                                           for a in (q, k, v))
                                          ).astype(jnp.float32))
            assert got.shape == (2, d, 256), where
            tol = _tol(plain)
            np.testing.assert_allclose(got, plain, rtol=0, atol=tol, err_msg=where)
            np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want, rounded=True),
                                       err_msg=where)
            if saturate:
                qf, kf, vf = (t.float()[0] for t in ops)
                w = torch.exp2(qf @ kf.mT - 12.34)          # no clamp
                unclamped = (w @ vf / w.sum(dim=-1, keepdim=True)).mT.numpy()
                assert np.abs(got - unclamped).max() > 20 * tol, where
    variants = _import_quietly("flash_variants")
    rng = np.random.RandomState(9)
    q, k, v = (rng.randn(2, 256, 40).astype(np.float32) for _ in range(3))
    ops = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = _tiled_ablate_or_pv_bf16(*(t[None] for t in ops), "pv_bf16", 64).numpy()
    plain = fp.flash_variant_a_reference(*ops, pv_bf16=True, out_dtype=torch.float32).numpy()
    with _blk_k(variants, BK):
        want = np.asarray(_jax_variant(variants, "d", *(jnp.asarray(a).astype(jnp.bfloat16)
                                                         for a in (q, k, v))
                                       ).astype(jnp.float32))
    assert got.shape == (2, 256, 40)
    np.testing.assert_allclose(got, plain, rtol=0, atol=_tol(plain), err_msg="pv_bf16")
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want, rounded=True),
                               err_msg="pv_bf16")


def _dots_inputs(d, scale, seed):
    """q, k, v [1, 2, 256, d] from numpy: q and k times ``scale`` (0.05 as
    the probe draws them), v unit normal, as (torch bf16, jax bf16)."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(1, 2, 256, d).astype(np.float32) * c for c in (scale, scale, 1.0)]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrays],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays])


def test_tiled_dots_holds_on_its_own_numbers_and_matches_jax():
    """Row 8 ``dots`` at d = 40 (64-query blocks, the contraction padded to
    48) and d = 80 (128-query blocks), S = 256, q and k times 0.5 and times
    0.05 (the probe's draw): row sums of both signs, so rows straddle the
    floor.  The rendering is held on its own scores and lane-ordered sums
    (``fp.ablate_dots_check``, the smoke's check: scores within the tensor
    cores' bound of the exact q . k, sums bit for bit ``ablate_dots_row_sums``
    of its scores, outputs within one ulp and the summation bound over the
    sum of the exact numerator over that sum); against the plain version and
    ``make_kernel("dots")`` in interpret mode (other scores and sums, so p
    may round the other way) each element within ``ablate_dots_tolerance``,
    rows within its reach of zero excused: under 1% (the card test's
    share)."""
    ablate = _import_quietly("flash_ablate")
    for d, bq in ((40, 64), (80, 128)):
        for scale in (0.5, 0.05):
            where = f"dots d={d} scale={scale}"
            (q, k, v), jops = _dots_inputs(d, scale, d)
            got, scores, sums = _tiled_ablate_or_pv_bf16(q, k, v, "dots", bq)
            assert bool((sums < 0).any() and (sums > 0).any()), where
            out = got.to(torch.bfloat16)
            q3, k3, v3 = (t[0] for t in (q, k, v))
            worst = fp.ablate_dots_check(q3, k3, v3, out, scores, sums)
            assert worst["sums_differing_rows"] == 0, where
            assert worst["score_err_over_tol"] <= 1.0 and worst["out_err_over_tol"] <= 1.0, where
            tol, excused = fp.ablate_dots_tolerance(q, k, v, out)
            held = ~excused[:, None, :]
            assert excused.float().mean().item() < 1e-2, (where, int(excused.sum()))
            for want in (fp.flash_ablate_t_reference(q, k, v, "dots").float(),
                         _f32_jax(_jax_ablate(ablate, "dots", *jops))):
                err = (out.float() - want).abs()
                assert bool(((err <= tol) | ~held).all()), (where, (err / tol * held).max())


def _f32_jax(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def test_dots_check_functions_refuse_moved_numbers():
    """The plain-side checks of the bf16 ``dots`` kernel, on the rendering's
    numbers at [1, 2, 256, 40] (the probe's draw): they hold as they are;
    a row sum moved by two float32 ulps is off the kernel's order (iii); an
    output moved by three bf16 ulps of itself is past its tolerance (iv),
    in a row whose sum is positive and in one the floor replaced; a score
    moved by twice its bound is past it (ii).  ``check_ablate_dots_kernel``
    on CPU tensors runs its passes through the plain version of the check
    instance and excuses no row."""
    (q, k, v), _ = _dots_inputs(40, 0.05, 7)
    got, scores, sums = _tiled_ablate_or_pv_bf16(q, k, v, "dots", 64)
    out = got.to(torch.bfloat16)
    q3, k3, v3 = (t[0] for t in (q, k, v))
    ok = fp.ablate_dots_check(q3, k3, v3, out, scores, sums)
    assert ok["sums_differing_rows"] == 0 and ok["out_err_over_tol"] <= 1.0
    assert ok["score_err_over_tol"] <= 1.0 and 0 < ok["floored_rows"] < 512
    moved = sums.clone()
    moved[1, 9] = torch.nextafter(torch.nextafter(moved[1, 9], torch.tensor(np.inf)),
                                  torch.tensor(np.inf))
    assert fp.ablate_dots_check(q3, k3, v3, out, scores, moved)["sums_differing_rows"] == 1
    for row in (int(sums[0].argmax()), int(sums[0].argmin())):
        bad = out.clone()
        bad[0, 5, row] = (bad[0, 5, row].float() * (1 + 3 * 2.0 ** -7)).to(torch.bfloat16)
        assert fp.ablate_dots_check(q3, k3, v3, bad, scores, sums)["out_err_over_tol"] > 1.0
    bound = fp.ablate_dots_score_tolerance(q3, k3)
    bad = scores.clone()
    bad[0, 3, 17] += float(2 * bound[0, 3, 17])
    assert fp.ablate_dots_check(q3, k3, v3, out, bad, sums)["score_err_over_tol"] > 1.0
    worst = fp.check_ablate_dots_kernel(q, k, v, fp.flash_ablate_dots_check_cuda(q, k, v)[0],
                                        images=1)
    assert worst["bit_identical"] and worst["sums_differing_rows"] == 0
    assert worst["out_err_over_tol"] <= 1.0 and worst["excused_rows"] == 0
    assert worst["row_count"] == 512


def _tiled_variant_c(q, k, v):
    """Row 9 c's kernel in plain torch, float32 arithmetic, from q, k, v
    [BH, S, D] (bf16 or float32): blocks of 128 queries (the last padded
    with zero queries), for each tile of 64 keys the key-major scores
    S^T = K Q^T of the unscaled inputs (exact products), times c = sm_scale
    log2(e) rounded to float32; each query column's max down the key axis,
    the running max m from -1e30, alpha = exp2(m - m_new), p = exp2(s - m)
    in float32, l = l alpha + the column sum, acc^T = acc^T alpha + V^T p;
    out^T = acc^T / l, [BH, D, Sq] in float32 (before the final rounding)."""
    bh, sq, d = q.shape
    blocks = -(-sq // 128) * 128
    qs = F.pad(q.float(), (0, 0, 0, blocks - sq))
    c = torch.tensor(1.0 / d ** 0.5 * np.log2(np.e), dtype=torch.float32)
    m = torch.full((bh, 1, blocks), -1e30)
    den = torch.zeros((bh, 1, blocks))
    acc = torch.zeros((bh, d, blocks))
    for k0 in range(0, k.shape[1], BK):
        kt, vt = k[:, k0:k0 + BK].float(), v[:, k0:k0 + BK].float()
        s = (kt @ qs.mT) * c                                  # [BH, keys, queries]
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        den = den * alpha + p.sum(dim=1, keepdim=True)
        acc = acc * alpha + vt.mT @ p
        m = m_new
    out = acc / den
    assert torch.isfinite(out).all()   # the zero queries past Sq too
    return out[..., :sq]


def test_tiled_variant_c_matches_the_plain_version_and_jax():
    """Row 9 c's order of work (``_tiled_variant_c``) at [2, 256, 40] and a
    ragged Sq of 320 (its last 128-query block half past Sq) in bf16 and
    float32, against ``flash_variant_c_reference`` (bf16: one output ulp of
    the largest output; float32: 2e-5, summation order and the base-2 exp)
    and, at S = 256, ``kern_c`` in interpret mode (the script's ``BLK_K``
    set to the kernel's 64-key tile; bf16 adds half an ulp for JAX's
    rounded output)."""
    variants = _import_quietly("flash_variants")
    for sq in (256, 320):
        rng = np.random.RandomState(sq)
        arrays = [rng.randn(2, s, 40).astype(np.float32) for s in (sq, 256, 256)]
        for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            where = f"kern_c Sq={sq} {dtype}"
            ops = [torch.from_numpy(a).to(dtype) for a in arrays]
            got = _tiled_variant_c(*ops)
            plain = fp.flash_variant_c_reference(*ops).float()
            assert got.shape == (2, 40, sq), where
            tol = 2e-5 if dtype == torch.float32 else _tol(plain.numpy())
            torch.testing.assert_close(got, plain, rtol=0, atol=tol, msg=where)
            if sq != 256:
                continue
            with _blk_k(variants, BK):
                want = _f32_jax(_jax_variant(variants, "c", *(jnp.asarray(a).astype(jdtype)
                                                              for a in arrays)))
            tol = 2e-5 if dtype == torch.float32 else _tol(want.numpy(), rounded=True)
            torch.testing.assert_close(got, want, rtol=0, atol=tol, msg=where)


def _tiled_variant_ab(q, k, v, name):
    """Rows 9 a, b and float32 d in the query-major kernel's order of work,
    plain torch, float32 arithmetic, from q, k, v [BH, S, D] (bf16 or
    float32): blocks of 128 queries (the last padded with zero queries), for
    each tile of 64 keys the query-major scores of the block.  a and b: the
    products of the unscaled inputs (exact for bf16), times c = sm_scale
    log2(e) rounded to float32 after the product, the running max of each
    row from -1e30, alpha = exp2(m - m_new), p = exp2(s c - m_new).  d
    (``pv_bf16``, float32 only): the template's order, q times sm_scale
    before the product, alpha and p by exp.  Then l = l alpha + the row sum
    of the unrounded p, acc = acc alpha + p v in float32 with p rounded to
    bf16 for d; out = acc / l before the final rounding, [BH, Sq, D] (a, d)
    or [BH, D, Sq] (b)."""
    bh, sq, d = q.shape
    blocks = -(-sq // 128) * 128
    natural = name == "d"
    sm_scale = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32)
    c = torch.tensor(1.0 / d ** 0.5 * np.log2(np.e), dtype=torch.float32)
    qs = F.pad(q.float() * sm_scale if natural else q.float(), (0, 0, 0, blocks - sq))
    exp = torch.exp if natural else torch.exp2
    m = torch.full((bh, blocks, 1), -1e30)
    den = torch.zeros((bh, blocks, 1))
    acc = torch.zeros((bh, blocks, d))
    for k0 in range(0, k.shape[1], BK):
        s = qs @ k[:, k0:k0 + BK].float().mT                  # [BH, queries, keys]
        s = s if natural else s * c
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = exp(m - m_new)
        p = exp(s - m_new)
        den = den * alpha + p.sum(dim=-1, keepdim=True)
        pv = p.to(torch.bfloat16).float() if natural else p
        acc = acc * alpha + pv @ v[:, k0:k0 + BK].float()
        m = m_new
    out = acc / den
    assert torch.isfinite(out).all()   # the zero queries past Sq too
    out = out[:, :sq]
    return out.mT if name == "b" else out


def test_tiled_variant_ab_matches_the_plain_versions_and_jax():
    """Rows 9 a and b in bf16 and float32 and row 9 d in float32 in the
    query-major kernel's order of work (``_tiled_variant_ab``) at [2, 256,
    40] and a ragged Sq of 320 (its last 128-query block half past Sq),
    against ``flash_variant_a_reference`` / ``flash_variant_b_reference``
    (bf16: one output ulp of the largest output; float32: 2e-5, summation
    order and, for a and b, the base-2 exp after the scale; d takes the
    plain version's own order, so its p rounds to bf16 at the same points)
    and, at S = 256, ``kern_a``, ``kern_b`` and ``kern_a(pv_bf16=True)`` in
    interpret mode (the script's ``BLK_K`` set to the kernel's 64-key tile;
    bf16 adds half an ulp for JAX's rounded output).  a's rendering is b's
    transposed, bit for bit, as the kernel's outputs are."""
    variants = _import_quietly("flash_variants")
    for sq in (256, 320):
        rng = np.random.RandomState(sq + 1)
        arrays = [rng.randn(2, s, 40).astype(np.float32) for s in (sq, 256, 256)]
        for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            ops = [torch.from_numpy(a).to(dtype) for a in arrays]
            got = {}
            for name in "abd" if dtype == torch.float32 else "ab":
                where = f"kern_{name} Sq={sq} {dtype}"
                got[name] = _tiled_variant_ab(*ops, name)
                plain = (fp.flash_variant_b_reference(*ops) if name == "b" else
                         fp.flash_variant_a_reference(*ops, pv_bf16=name == "d")).float()
                assert got[name].shape == plain.shape == ((2, 40, sq) if name == "b"
                                                          else (2, sq, 40)), where
                tol = 2e-5 if dtype == torch.float32 else _tol(plain.numpy())
                torch.testing.assert_close(got[name], plain, rtol=0, atol=tol, msg=where)
                if sq != 256:
                    continue
                with _blk_k(variants, BK):
                    want = _f32_jax(_jax_variant(variants, name, *(jnp.asarray(a).astype(jdtype)
                                                                   for a in arrays)))
                tol = 2e-5 if dtype == torch.float32 else _tol(want.numpy(), rounded=True)
                torch.testing.assert_close(got[name], want, rtol=0, atol=tol, msg=where)
            assert torch.equal(got["a"], got["b"].mT), f"Sq={sq} {dtype}"


def _tiled_qm_f32(ops, what, anchor=None, layout="packed_t", pipe=False):
    """Rows 11 (``what`` ``bounded``, the operands of ``layout``), 8
    (``dots``, ``exp``, ``noprolog``; [B, H, S, D]) and 10 (``exp2``; [B, H,
    S, D]) in float32 in the query-major kernel's order of work, plain
    torch: the S-minor operands read as the kernel reads them (q and each K
    and V tile transposed to [S, D] on their way, the same values); blocks
    of 128 queries at d = 40 (the last padded with zero queries past Sq) or
    64 at d = 80, key tiles of 64 or 32; q times c = sm_scale log2(e) in
    float32 first (rows 11 and 10) or as it is (row 8); each tile's float32
    scores.  Row 11's window: over the tiles of the first ``anchor`` keys a
    running max m from -1e30, p = exp2(min(s - (m + 16), 100)), alpha =
    exp2(m_old - m_new) rescaling the sum and the accumulator; then the
    shift m + 16 frozen.  Row 8: p = s, exp2(s) or exp2(min(s - 12.34,
    100)).  Row 10: over every tile the running max m from -1e30, p =
    exp2(s - m_new), alpha = exp2(m_old - m_new); ``pipe`` takes tile t's
    scores before tile t - 1's softmax and PV (a prologue takes tile 0's, an
    epilogue drains the last tile).  Each row's sum in the kernel's lanes:
    lane t of a quad adds, key by key, its keys j*8 + 2t + e of the tile
    (j-major), the four lanes then (0 + 1) + (2 + 3), and l = l alpha + that
    sum; acc = acc alpha + p v in float32; out = acc / max(l, floor)
    (1.2e-38, 1e-30; row 10 none) before any rounding, [B, H*D, Sq] (row 11)
    or [B*H, D, Sq] (rows 8 and 10)."""
    _, qk_minor, v_minor = KERNELS[layout]
    q, k, v = (t.mT if m else t for t, m in zip(ops, (qk_minor, qk_minor, v_minor)))
    b, h, sq, d = q.shape
    bq, tk = (128, 64) if d == 40 else (64, 32)
    bounded, exp2 = what == "bounded", what == "exp2"
    c = torch.tensor(1.0 / d ** 0.5 * np.log2(np.e), dtype=torch.float32)
    blocks = -(-sq // bq) * bq
    qs = F.pad(q.float() * c if bounded or exp2 else q.float(), (0, 0, 0, blocks - sq))
    slots = torch.tensor([[j * 8 + 2 * t + e for j in range(tk // 8) for e in range(2)]
                          for t in range(4)])                          # [lane, slot] -> key
    m = torch.full((b, h, blocks, 1), -1e30)
    den = torch.zeros((b, h, blocks, 1))
    acc = torch.zeros((b, h, blocks, d))

    def scores(k0):
        return qs @ k[:, :, k0:k0 + tk].float().mT

    def softmax_pv(s, k0):
        nonlocal m, den, acc
        alpha = None
        if exp2 or (bounded and k0 < anchor):
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            m = m_new
        if exp2:
            p = torch.exp2(s - m)
        elif bounded:
            p = torch.exp2(torch.clamp(s - (m + 16.0), max=100.0))
        elif what == "dots":
            p = s
        elif what == "exp":
            p = torch.exp2(s)
        else:
            p = torch.exp2(torch.clamp(s - 12.34, max=100.0))
        lanes = torch.zeros((b, h, blocks, 4))
        for slot in range(slots.shape[1]):
            lanes = lanes + p[..., slots[:, slot]]
        tile_sum = ((lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3]))[..., None]
        pv = p @ v[:, :, k0:k0 + tk].float()
        den = den + tile_sum if alpha is None else den * alpha + tile_sum
        acc = acc + pv if alpha is None else acc * alpha + pv

    sk = k.shape[2]
    if pipe:
        s_prev = scores(0)
        for k0 in range(tk, sk, tk):
            s_next = scores(k0)
            softmax_pv(s_prev, k0 - tk)
            s_prev = s_next
        softmax_pv(s_prev, sk - tk)
    else:
        for k0 in range(0, sk, tk):
            softmax_pv(scores(k0), k0)
    out = acc / (den if exp2 else torch.clamp(den, min=DENOM_FLOOR if bounded
                                              else fp.ABLATE_FLOOR))
    assert torch.isfinite(out).all()   # the zero queries past Sq too
    out = out[:, :, :sq].mT
    return out.reshape(b, h * d, sq) if bounded else out.reshape(b * h, d, sq)


def test_tiled_qm_bounded_and_ablations_match_the_plain_versions_and_jax():
    """Rows 11a-c and 8 in float32 in the query-major kernel's order of work
    (``_tiled_qm_f32``) at d = 40 and 80: row 11 in its three layouts at S =
    256 (128-key anchor), plain and saturating (key 140 beyond the window
    clamped: the rendering then differs from exact attention by more than
    20 tolerances), and a ragged Sq of 320 against Sk = 256 with a 64-key
    anchor; row 8's three modes at S = 256 (q, k times 0.5; ``dots`` times
    0.05, row sums of both signs) and ``noprolog`` saturating.  Each against
    its plain version (2e-5: summation order, the online shift's rescale)
    and, at S = 256, ``_packed_t_kernel`` / ``_packed_t_kernel_sminor`` /
    ``_packed_t_kernel_all_sminor`` (128-query and 128-key blocks) and
    ``make_kernel(mode)`` in interpret mode (2e-5); ``dots`` within
    ``ablate_dots_tolerance`` of both, rows within its reach of zero
    excused: under 1%."""
    nhd = _import_script("flash_nhd_variants")
    ablate = _import_quietly("flash_ablate")
    for d in (40, 80):
        for layout in LAYOUTS:
            jitted = jax.jit(functools.partial(_jax_packed_t, nhd, layout))
            for saturate in (False, True):
                where = f"{layout} d={d} saturate={saturate}"
                ops, jops, exact_in = _inputs(256, 256, d, layout, saturate, torch.float32)
                got = _tiled_qm_f32(ops, "bounded", BLK, layout)
                plain = getattr(fp, f"flash_{layout}_reference")(*ops, BLK)
                want = _f32_jax(jitted(*jops))
                assert got.shape == (1, 2 * d, 256), where
                torch.testing.assert_close(got, plain, rtol=0, atol=2e-5, msg=where)
                torch.testing.assert_close(got, want, rtol=0, atol=2e-5, msg=where)
                if saturate:
                    exact = fp._packed_t(reference_attention(*exact_in))
                    assert (got - exact).abs().max().item() > 20 * 2e-5, where
            ops, _, _ = _inputs(320, 256, d, layout, False, torch.float32)
            got = _tiled_qm_f32(ops, "bounded", 64, layout)
            plain = getattr(fp, f"flash_{layout}_reference")(*ops, 64)
            assert got.shape == (1, 2 * d, 320)
            torch.testing.assert_close(got, plain, rtol=0, atol=2e-5, msg=f"{layout} d={d} Sq=320")
        jitted = {mode: jax.jit(functools.partial(_jax_ablate, ablate, mode))
                  for mode in fp.ABLATE_MODES}
        for mode, scale, saturate in (("exp", 0.5, False), ("noprolog", 0.5, False),
                                      ("noprolog", 0.5, True), ("dots", 0.05, False)):
            where = f"{mode} d={d} saturate={saturate}"
            rng = np.random.RandomState(d + saturate)
            q, k, v = (rng.randn(1, 2, 256, d).astype(np.float32) * c for c in (scale, scale, 1.0))
            if saturate:   # key 140 scores ~128, keys 150-159 ~116, every other key < 10
                q, k = q * 0.1, k * 0.1
                q[..., 0] = 8.0
                k[:, :, 140, 0] = 16.0
                k[:, :, 150:160, 0] = 14.5
            ops = [torch.from_numpy(a) for a in (q, k, v)]
            got = _tiled_qm_f32(ops, mode)
            plain = fp.flash_ablate_t_reference(*ops, mode)
            want = _f32_jax(jitted[mode](*(jnp.asarray(a) for a in (q, k, v))))
            assert got.shape == (2, d, 256), where
            if mode != "dots":
                torch.testing.assert_close(got, plain, rtol=0, atol=2e-5, msg=where)
                torch.testing.assert_close(got, want, rtol=0, atol=2e-5, msg=where)
                continue
            for other in (plain, want):
                tol, excused = fp.ablate_dots_tolerance(*ops, other)
                assert excused.float().mean().item() < 1e-2, (where, int(excused.sum()))
                err = (got - other).abs()
                assert bool(((err <= tol) | excused[:, None, :]).all()), (where, (err / tol).max())


def test_tiled_qm_exp2_matches_the_plain_version_and_jax():
    """Row 10 in float32 in the query-major kernel's order of work
    (``_tiled_qm_f32(..., "exp2")``), both key loops, at d = 40 (128-query
    blocks, 64-key tiles) and d = 80 (64-query blocks, 32-key tiles), S =
    256 and a ragged Sq of 320 against Sk = 256 (d = 40: its last block
    half past Sq).  The two loops give the same bits; each is held to
    ``flash_exp2_t_reference`` at the kernel's key tile (``exp2_key_tile``)
    and to ``kern_exp2`` in interpret mode with that ``blk_k`` (2e-5:
    summation order and the base-2 exp; q padded with zero queries to the
    interpret run's 128-query blocks, each query's output its own)."""
    v4 = _import_script("flash_v4_variants")
    for sq, d in ((256, 40), (256, 80), (320, 40), (320, 80)):
        where = f"exp2 float32 d={d} Sq={sq}"
        rng = np.random.RandomState(sq + d)
        q, k, v = (rng.randn(1, 2, s, d).astype(np.float32) for s in (sq, 256, 256))
        ops = [torch.from_numpy(a) for a in (q, k, v)]
        loops = [_tiled_qm_f32(ops, "exp2", pipe=pipe) for pipe in (False, True)]
        assert torch.equal(loops[0], loops[1]), f"{where}: the loops differ"
        got = loops[0]
        blk_k = fp.exp2_key_tile(torch.float32, d)
        assert blk_k == (64 if d == 40 else 32)
        plain = fp.flash_exp2_t_reference(*ops, blk_k=blk_k)
        assert got.shape == plain.shape == (2, d, sq), where
        torch.testing.assert_close(got, plain, rtol=0, atol=2e-5, msg=where)
        padded = np.pad(q, ((0, 0), (0, 0), (0, -sq % BLK), (0, 0)))
        for pipe in (False, True):
            want = _f32_jax(_jax_exp2_t(v4, *(jnp.asarray(a) for a in (padded, k, v)), pipe,
                                        blk_k))[..., :sq]
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5, msg=f"{where} pipe={pipe}")
