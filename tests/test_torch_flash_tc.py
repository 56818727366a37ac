"""The bf16 tensor-core route of the port's flash forwards (bounded and
exact), on the CPU.

The kernel (``hedit_tpu_torch/csrc/flash_attention_tc.cu``) runs only on the
card (``tests/test_torch_port_kernels.py``, ``chip_smoke.py``).  Here:

* the dispatch by dtype (``bounded_entry``, ``exact_entry``): bf16 to the
  tensor-core entry points, float32 at the VAE's d = 512 to its float32
  kernel (``tests/test_torch_flash_f32_512.py``; at d = 40 / 80 the bounded
  mode takes the float32 kernel, ``tests/test_torch_flash_f32.py``, the
  exact one the CUDA-core template), anything else refused;
* the operand check (``check_tc_operands``): head dims, 16-byte alignment
  and strides that are multiples of 8, as values;
* the C entry points' parameter lists against the ``ctypes`` argument types
  the loader gives them (the sources cannot be compiled here);
* the kernel's order of work rendered in plain torch (key tiles, the d = 40
  contraction padded to 48, the VAE width's four partial score products
  added in order, the anchor prologue over tiles, p and the row sum tile by
  tile) against ``flash_attention_bounded_reference`` and JAX's
  ``flash_attention_bounded`` in Pallas interpret mode (128-key blocks, so a
  128-key anchor window), the saturating input included; with the LSE
  entry's second output, lse2 = shift + log2(floored sum), against
  ``flash_attention_lse_reference`` and JAX's ``_flash_bounded_fwd_lse``;
* the exact mode's order of work (the same partial scores, then a running
  max, rescale and rounded p per key tile) against
  ``flash_attention_exact_reference`` at the kernel's key tiles, and at
  128-key tiles against JAX's ``flash_attention`` and
  ``flash_attention_packed`` in Pallas interpret mode.  Its cases run as
  loops inside two items: pytest-xdist's loadfile scheduler queues test
  files by their number of items.
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hedit_tpu.ops.flash_attention import (
    _flash_bounded_fwd_lse, flash_attention, flash_attention_bounded, flash_attention_packed,
)
from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_attention as flash_mod

ANCHOR = 128   # the JAX kernel's blk_k in these runs
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TC_ENTRIES = ("hedit_flash_attention_fwd_tc", "hedit_flash_attention_fwd_packed_bounded_tc",
              "hedit_flash_attention_fwd_lse_tc", "hedit_flash_attention_fwd_exact_tc",
              "hedit_flash_attention_fwd_packed_exact_tc")
# the exact forward's entry points by dtype at d = 512: (head-split, packed)
EXACT_ENTRIES = {torch.bfloat16: ("hedit_flash_attention_fwd_exact_tc",
                                  "hedit_flash_attention_fwd_packed_exact_tc"),
                 torch.float32: ("hedit_flash_attention_fwd_exact_f32_512",
                                 "hedit_flash_attention_fwd_packed_exact_f32_512")}


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, ("hedit_flash_attention_fwd_tc",
                      "hedit_flash_attention_fwd_packed_bounded_tc")),
    (torch.float32, ("hedit_flash_attention_fwd_f32_512",
                     "hedit_flash_attention_fwd_packed_bounded_f32_512")),
])
def test_bounded_entry_sends_bf16_to_the_tensor_cores(dtype, entry, packed):
    """bf16 CUDA inputs take the tensor-core entry points, float32 ones the
    float32 d = 512 kernel's (``csrc/flash_attention_f32_512.cu``), head-split
    and packed alike, in the bounded mode at the VAE's d = 512 and in the
    exact one (``exact_entry``)."""
    assert flash_mod.bounded_entry(dtype, packed, 512) == entry[packed]
    assert flash_mod.exact_entry(dtype, packed, 512) == EXACT_ENTRIES[dtype][packed]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_bounded_entry_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_mod.bounded_entry(dtype, False, 40)
    for packed in (False, True):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            flash_mod.exact_entry(dtype, packed, 40)


@pytest.mark.parametrize("d", [40, 80, 512])
def test_check_tc_operands_takes_the_paths_operands(d):
    """The paths' operands pass: 16-byte aligned tensors, head-split row
    strides d and image strides S * d, packed rows 8 * d and batch strides of
    whole images, a row slice of a larger batch included."""
    addresses = [0x7F0000000000 + 16 * i for i in range(4)]
    flash_mod.check_tc_operands(d, addresses, [4096 * d, 1000 * d, d, 8 * d, 3 * 4096 * 8 * d])


@pytest.mark.parametrize("d,addresses,strides,match", [
    (64, [0, 16, 32, 48], [64], "head dims"),          # a head dim with no tile
    (32, [0, 16, 32, 48], [32], "head dims"),
    (40, [0, 16, 34, 48], [40], "aligned"),            # a view one element in
    (80, [8, 16, 32, 48], [80], "aligned"),            # 8 bytes off
    (40, [0, 16, 32, 48], [40, 4093 * 40 + 4], "multiples of 8"),   # an odd batch stride
    (512, [0, 16, 32, 48], [513], "multiples of 8"),
])
def test_check_tc_operands_refuses(d, addresses, strides, match):
    with pytest.raises(ValueError, match=match):
        flash_mod.check_tc_operands(d, addresses, strides)


def _c_entry_points():
    """{name: [ctypes type of each parameter]} of every ``extern "C"``
    function in ``csrc/*.cu``, read from the source text."""
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    found = {}
    for path in _build.CSRC.glob("*.cu"):
        text = path.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for p in params.split(","):
                p = re.sub(r"\bconst\b", "", p).strip()
                ctype = p.rsplit(None, 1)[0] if "*" not in p else "void*"
                types.append(kinds[re.sub(r"\s+", " ", ctype).strip()])
            found[name] = types
    return found


def test_c_entry_points_match_their_argument_types():
    """Every entry point the loader binds exists in the sources with the
    parameter list its ``ctypes`` argument types describe (pointers and the
    stream as ``c_void_p``); the tensor-core ones among them, the LSE and
    exact entries' with the template's parameter lists.  ``lse_entry`` sends
    bf16 to the tensor cores, float32 at d = 512 to the float32 d = 512
    kernel, and refuses other dtypes; ``exact_entry`` names bound entry
    points."""
    found = _c_entry_points()
    assert set(TC_ENTRIES) <= set(_build.ARGTYPES)
    for name, argtypes in _build.ARGTYPES.items():
        assert found.get(name) == argtypes, name
    for dtype in (torch.bfloat16, torch.float32):
        for d in flash_mod.HEAD_DIMS:
            assert flash_mod.lse_entry(dtype, d) in _build.ARGTYPES
            for packed in (False, True):
                assert flash_mod.bounded_entry(dtype, packed, d) in _build.ARGTYPES
    assert flash_mod.lse_entry(torch.bfloat16, 512) == "hedit_flash_attention_fwd_lse_tc"
    assert flash_mod.lse_entry(torch.float32, 512) == "hedit_flash_attention_fwd_lse_f32_512"
    assert (_build.ARGTYPES["hedit_flash_attention_fwd_lse_tc"]
            == _build.ARGTYPES["hedit_flash_attention_fwd_lse"])
    for packed in (False, True):
        for d in flash_mod.HEAD_DIMS:
            tc, f32 = (flash_mod.exact_entry(dt, packed, d)
                       for dt in (torch.bfloat16, torch.float32))
            assert _build.ARGTYPES[tc] == _build.ARGTYPES[f32], tc
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_mod.lse_entry(torch.float16, 40)


def test_wrappers_on_cpu_launch_nothing():
    """CPU tensors of either dtype take the plain versions; no counter of
    either route moves, the exact forwards' included (the packed exact
    wrapper has no plain route and refuses CPU tensors)."""
    names = ("launches", "launches_tc", "launches_packed_bounded", "launches_packed_bounded_tc",
             "launches_exact", "launches_exact_tc", "launches_packed", "launches_packed_tc",
             "launches_f32_512", "launches_packed_bounded_f32_512", "launches_exact_f32_512",
             "launches_packed_f32_512", "launches_exact_f32", "launches_packed_f32")
    counts = [getattr(flash_mod, n) for n in names]
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(1, 1100, 2 * 40).to(dtype)
        got = flash_mod.flash_attention_packed_bounded_cuda(q, q, q, 2)
        torch.testing.assert_close(
            got, flash_mod.flash_attention_packed_bounded_reference(q, q, q, 2), rtol=0, atol=0)
        qh = q.reshape(1, 1100, 2, 40).transpose(1, 2).contiguous()
        torch.testing.assert_close(flash_mod.flash_attention_cuda(qh, qh, qh),
                                   flash_mod.flash_attention_bounded_reference(qh, qh, qh),
                                   rtol=0, atol=0)
        torch.testing.assert_close(flash_mod.flash_attention_exact_cuda(qh, qh, qh),
                                   flash_mod.flash_attention_exact_reference(qh, qh, qh),
                                   rtol=0, atol=0)
        with pytest.raises(ValueError, match="CUDA"):
            flash_mod.flash_attention_packed_cuda(q, q, q, 2)
    assert counts == [getattr(flash_mod, n) for n in names]


def _tiled_forward(q, k, v, anchor, bk, wc):
    """The tensor-core kernel's order of work in plain torch, float32
    arithmetic on the kernel's bf16 roundings: q * scale rounded to the
    input dtype, the contraction zero-padded to a multiple of 16; for each
    tile of ``bk`` keys the scores as ``wc`` partial products over equal
    parts of the contraction added in order; the shift from the prologue's
    tiles over the first min(anchor, Sk) keys; p rounded to the input dtype,
    the row sum and the PV product accumulated tile by tile; the floored
    denominator.  Returns (the float32 output before the kernel's final
    rounding, lse2 = shift + log2(floored denominator))."""
    d, sk = q.shape[-1], k.shape[-2]
    dk = -(-d // 16) * 16
    qs = F.pad((q * torch.tensor(1.0 / d ** 0.5 * np.log2(np.e), dtype=q.dtype)).float(),
               (0, dk - d))
    kf, vf = F.pad(k.float(), (0, dk - d)), v.float()
    part = dk // wc

    def scores(k0):
        kt = kf[..., k0:k0 + bk, :]
        s = torch.zeros(q.shape[:-1] + (kt.shape[-2],))
        for c in range(wc):
            s = s + qs[..., c * part:(c + 1) * part] @ kt[..., c * part:(c + 1) * part].mT
        return s

    a_end = min(anchor, sk)
    m = torch.full(q.shape[:-1], -float("inf"))
    for k0 in range(0, a_end, bk):
        m = torch.maximum(m, scores(k0)[..., :a_end - k0].amax(dim=-1))
    shift = (m + 16.0)[..., None]
    den = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros(q.shape[:-1] + (d,))
    for k0 in range(0, sk, bk):
        p = torch.exp2(torch.clamp(scores(k0) - shift, max=100.0)).to(v.dtype).float()
        den = den + p.sum(dim=-1, keepdim=True)
        acc = acc + p @ vf[..., k0:k0 + bk, :]
    den = torch.clamp(den, min=flash_mod.DENOM_FLOOR)
    return acc / den, (shift + torch.log2(den))[..., 0]


def _inputs(sq, sk, d, dtype, saturate=False):
    """numpy-seeded q, k, v [1, 2, S, D] as (torch, jax) pairs of one dtype.
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
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in (q, k, v)],
            [jnp.asarray(a).astype(jdt) for a in (q, k, v)])


def _tol(dtype, want):
    """float32: 2e-5 (exp2 and summation order).  bfloat16: the rendering's
    output before its final rounding against outputs rounded to bf16 (half
    an ulp), both sides rounding q * scale and p at the same steps, where
    float32 scores that differ in the last bits may round the other way:
    one bf16 ulp at the largest output, 2^-8 * max."""
    return 2e-5 if dtype == "float32" else 2.0 ** -8 * float(np.abs(want).max())


# (Sq, Sk, D, key tile, warps along D, saturating): the kernel's three tile
# shapes, ragged Sq and Sk, a key tile that ends inside the anchor window
@pytest.mark.parametrize("sq,sk,d,bk,wc,saturate", [
    (300, 300, 40, 64, 1, False),
    (100, 330, 80, 64, 1, False),
    (96, 270, 512, 32, 4, False),
    (128, 320, 40, 64, 1, True),
    (64, 320, 512, 32, 4, True),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tiled_order_matches_the_plain_version_and_jax(dtype, sq, sk, d, bk, wc, saturate):
    """out (tolerances of ``_tol``) and lse2 (float32 for either dtype: 2e-5
    in float32; in bf16 a rounding of one p that falls the other way moves a
    row's sum by at most one ulp of its largest term, log2(1 + 2^-8); 1e-5
    relative on the saturating rows' ~120) of the rendering against the
    plain versions and the JAX kernels."""
    (q, k, v), (jq, jk, jv) = _inputs(sq, sk, d, dtype, saturate)
    got, got_lse = (t.numpy() for t in _tiled_forward(q, k, v, ANCHOR, bk, wc))
    plain = flash_mod.flash_attention_bounded_reference(q, k, v, ANCHOR).float().numpy()
    _, plain_lse = flash_mod.flash_attention_lse_reference(q, k, v, ANCHOR)
    want = np.asarray(flash_attention_bounded(jq, jk, jv, blk_q=128, blk_k=128,
                                              interpret=True).astype(jnp.float32))
    _, want_lse = _flash_bounded_fwd_lse(jq, jk, jv, blk_q=128, blk_k=128, interpret=True)
    tol = _tol(dtype, want)
    np.testing.assert_allclose(got, plain, rtol=0, atol=tol)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    tol_lse = 2e-5 if dtype == "float32" else np.log2(1 + 2.0 ** -8)
    got_lse = got_lse.reshape(2, 1, sq)
    np.testing.assert_allclose(got_lse, plain_lse.numpy(), rtol=1e-5, atol=tol_lse)
    np.testing.assert_allclose(got_lse, np.asarray(want_lse), rtol=1e-5, atol=tol_lse)
    if saturate:
        exact = flash_mod.reference_attention(q.float(), k.float(), v.float()).numpy()
        assert np.abs(got - exact).max() > 20 * tol


def _tiled_exact_forward(q, k, v, bk, wc):
    """The tensor-core kernel's order of work in its exact mode, in plain
    torch: the scores of ``_tiled_forward`` (q * scale rounded to the input
    dtype, the contraction zero-padded to a multiple of 16, ``wc`` partial
    products over equal parts of it added in order); for each tile of ``bk``
    keys the running max m_new = max(m, tile max) from m = -1e30, alpha =
    exp2(m - m_new) rescaling the accumulator and the row sum, p = exp2(s -
    m_new) rounded to the input dtype into both; out = acc / sum, no floor.
    Returns the float32 output before the kernel's final rounding."""
    d, sk = q.shape[-1], k.shape[-2]
    dk = -(-d // 16) * 16
    qs = F.pad((q * torch.tensor(1.0 / d ** 0.5 * np.log2(np.e), dtype=q.dtype)).float(),
               (0, dk - d))
    kf, vf = F.pad(k.float(), (0, dk - d)), v.float()
    part = dk // wc
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    den = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros(q.shape[:-1] + (d,))
    for k0 in range(0, sk, bk):
        kt = kf[..., k0:k0 + bk, :]
        s = torch.zeros(q.shape[:-1] + (kt.shape[-2],))
        for c in range(wc):
            s = s + qs[..., c * part:(c + 1) * part] @ kt[..., c * part:(c + 1) * part].mT
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new).to(v.dtype).float()
        den = den * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vf[..., k0:k0 + bk, :]
        m = m_new
    return acc / den


def test_tiled_exact_order_matches_the_plain_version():
    """The exact mode's order of work at the kernel's tiles ((key tile,
    warps along D) = (64, 1) at d = 40 and 80, (32, 4) at d = 512), ragged
    Sq and Sk, a saturating input, both dtypes, against
    ``flash_attention_exact_reference`` at the same key tile
    (``exact_key_tile``), both before their final rounding: tolerances of
    ``_tol``.  On the saturating input the exact result differs from the
    bounded one by more than 20 tolerances."""
    for sq, sk, d, bk, wc, saturate in ((300, 300, 40, 64, 1, False),
                                        (100, 330, 80, 64, 1, False),
                                        (96, 270, 512, 32, 4, False),
                                        (128, 320, 40, 64, 1, True),
                                        (64, 320, 512, 32, 4, True)):
        assert flash_mod.exact_key_tile(d) == bk
        for dtype in DTYPES:
            (q, k, v), _ = _inputs(sq, sk, d, dtype, saturate)
            where = f"{dtype} {(sq, sk, d, bk, wc, saturate)}"
            got = _tiled_exact_forward(q, k, v, bk, wc).numpy()
            want = flash_mod.flash_attention_exact_reference(q, k, v, bk,
                                                             out_dtype=torch.float32).numpy()
            tol = _tol(dtype, want)
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=where)
            assert np.isfinite(got).all(), where
            if saturate:
                bounded = flash_mod.flash_attention_bounded_reference(
                    q, k, v, ANCHOR, out_dtype=torch.float32).numpy()
                assert np.abs(got - bounded).max() > 20 * tol, where


def test_tiled_exact_order_matches_jax_exact_kernels():
    """At 128-key tiles the exact mode's order of work, rounded once to the
    input dtype, against JAX's ``flash_attention`` (head-split) and
    ``flash_attention_packed`` (packed heads, split here into heads) with
    ``blk_q = blk_k = 128`` in interpret mode, aligned, ragged and Sq != Sk,
    the VAE's width with four partial score products: the tolerances of
    ``test_exact_plain_versions_match_jax_exact_kernels``, float32 2e-5;
    bfloat16 2^-8 of the largest output and at most 2% of the elements
    differing."""
    for dtype in DTYPES:
        tdt, jdt = DTYPES[dtype]
        for b, heads, sq, sk, d, wc, packed in ((1, 2, 300, 300, 40, 1, False),
                                                (1, 2, 256, 77, 80, 1, False),
                                                (1, 1, 128, 200, 512, 4, False),
                                                (2, 3, 128, 400, 80, 1, True)):
            rng = np.random.RandomState(b + heads + sq + sk + d)
            shapes = [(b, s, heads * d) if packed else (b, heads, s, d) for s in (sq, sk, sk)]
            arrays = [rng.randn(*shape).astype(np.float32) for shape in shapes]
            q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
            jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
            if packed:
                split = lambda t: t.reshape(b, -1, heads, d).transpose(1, 2)  # noqa: E731
                got = _tiled_exact_forward(split(q), split(k), split(v), 128, wc)
                got = got.transpose(1, 2).reshape(b, sq, heads * d)
                want = flash_attention_packed(jq, jk, jv, heads=heads, blk_q=128, blk_k=128,
                                              interpret=True)
            else:
                got = _tiled_exact_forward(q, k, v, 128, wc)
                want = flash_attention(jq, jk, jv, blk_q=128, blk_k=128, interpret=True)
            got = got.to(tdt).float().numpy()
            want = np.asarray(want.astype(jnp.float32))
            where = f"{dtype} {(b, heads, sq, sk, d, wc, packed)}"
            tol = 2e-5 if dtype == "float32" else 2.0 ** -8 * np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=where)
            if dtype == "bfloat16":
                assert np.mean(got != want) <= 0.02, where
