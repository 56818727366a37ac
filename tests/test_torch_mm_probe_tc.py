"""TPU kernel 12 (``scripts/mm_probe.py:_loop_kernel``) on the tensor cores:
what the CPU can check of ``csrc/mm_probe_tc.cu`` and its wrapper.

* The nudge: the kernel adds i to a bf16 pair with one ``add.rn.bf16x2``,
  which rounds a + i once, correctly.  The plain version (``nudged``) adds
  in float32 and then rounds to bf16.  For every bf16 value a and every i
  the kernel takes this way (0 <= i <= 256, where i is a bf16 integer) the
  two agree: the correctly rounded sum is computed here from the exact sum
  (an error-free float64 sum) with integer bit operations.
* The split-K plan (``split_k_plan``) at the probe's nine cases and ragged
  shapes: chunks a multiple of mma's K step, splits covering K exactly,
  enough blocks for the card where K is split.
* The library yardstick's operands (``mm_library_operands``): one product of
  the nudged A's side by side and B stacked reps times is the function,
  within the plain version's tolerance.
* The wrapper on CPU tensors: the plain version in both dtypes, and no
  launch counted on either route.

No JAX here: the plain version is held to JAX's kernel in
``test_torch_cost_probes.py``.
"""

from __future__ import annotations

import math
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hedit_tpu_torch.ops import mm_probe as mp
from hedit_tpu_torch.probes.mm_probe import CASES, contraction

# the largest i the kernel nudges with add.rn.bf16x2 (bf16 holds every
# integer up to 256; past it the kernel rounds the float32 sum as ``nudged``)
EXACT_I = 256


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _bf16_round(s: np.ndarray, err: np.ndarray) -> np.ndarray:
    """The bf16 value nearest to s + err (ties to even), where s is a finite
    float64 at least bf16's least normal in magnitude and err the exact
    remainder of the sum (|err| below half an ulp of s in float64): the
    float64 bits cut to bf16's 8 significant bits, rounded up where the rest
    is above half an ulp, or exactly half with an odd last bit and no
    remainder, or exactly half with a remainder of s's sign."""
    bits = s.view(np.uint64)
    sign = bits & np.uint64(1 << 63)
    mag = bits & ~np.uint64(1 << 63)
    shift = np.uint64(52 - 7)
    kept = mag >> shift
    rest = mag & np.uint64((1 << 45) - 1)
    half = np.uint64(1 << 44)
    same_sign = (err != 0) & (np.signbit(err) == np.signbit(s))
    up = (rest > half) | ((rest == half) & (((kept & np.uint64(1)) == 1) & (err == 0)
                                             | same_sign))
    rounded = (kept + up.astype(np.uint64)) << shift
    return (rounded | sign).view(np.float64)


def test_nudge_add_is_the_plain_rounding_for_every_bf16_value():
    """``nudged`` (float32 add, then bf16) equals the correctly rounded
    bf16 sum a + i, for all 65,536 bf16 bit patterns but the NaNs and every
    i in [0, 256], signed zeros included."""
    a16 = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    a = a16.view(torch.bfloat16)
    finite = torch.isfinite(a.float())
    assert int((~finite).sum()) == 2 * 128  # the NaNs and the two infinities
    inf = a[torch.isinf(a.float())]
    a = a[finite]
    a64 = a.double().numpy()
    for i in range(EXACT_I + 1):
        got = mp.nudged(a, i).double().numpy()
        s = a64 + float(i)
        bb = s - a64
        err = (a64 - (s - bb)) + (float(i) - bb)  # s + err == a + i exactly
        small = np.abs(s) < 2.0 ** -126
        # a sum below bf16's normals is exact (a = -i + tiny: Sterbenz), and s is it
        assert np.all(err[small] == 0) and np.all(s[small] == a64[small] + i)
        want = np.where(small, s, _bf16_round(np.where(small, 1.0, s), err))
        assert np.array_equal(got.view(np.uint64), want.view(np.uint64)), i
        assert torch.equal(mp.nudged(inf, i), inf.float())


def test_nudge_rounding_helper_rounds_ties_to_even():
    """The helper above on hand-made cases: bf16 has 8 significant bits, so
    at 1 its ulp is 2^-7 and 1 + 2^-8 is a tie."""
    s = np.array([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 1 + 2.0 ** -8, 1 + 2.0 ** -8,
                  -(1 + 2.0 ** -8), 1 + 2.0 ** -9, 1 + 3 * 2.0 ** -9, 255.5, 256.5])
    err = np.array([0.0, 0.0, 2.0 ** -60, -2.0 ** -60, -2.0 ** -60, 0.0, 0.0, 0.0, 0.0])
    want = np.array([1.0, 1 + 2 * 2.0 ** -7, 1 + 2.0 ** -7, 1.0, -(1 + 2.0 ** -7), 1.0,
                     1 + 2.0 ** -7, 256.0, 256.0])
    assert np.array_equal(_bf16_round(s, err), want)


def _covers(chunk: int, splits: int, k: int) -> bool:
    starts = [s * chunk for s in range(splits)]
    ends = [min(k, s + chunk) for s in starts]
    return (starts[0] == 0 and ends[-1] == k and all(e > s for s, e in zip(starts, ends))
            and all(e == s2 for e, s2 in zip(ends, starts[1:])))


def test_split_k_plan_covers_k_in_steps_of_16():
    """Each of the probe's nine cases and ragged shapes: chunk a multiple of
    16, the splits [s chunk, min((s + 1) chunk, K)) covering K exactly, each
    non-empty; one split where the tiles fill the card (the qk cases), else
    tiles x splits >= the card's SMs (the pv cases: 16 splits of 128 at
    N = 128, 32 of 64 at N = 40 or M = 40); the kernel takes its tile from
    the caller (``tc_tile``)."""
    shapes = {}
    for name, (a_shape, b_shape, layout) in CASES.items():
        _, a_t, b_t = mp.LAYOUTS[layout]
        shapes[name] = (a_shape[1] if a_t else a_shape[0], b_shape[0] if b_t else b_shape[1],
                        contraction(name))
    plans = {name: mp.split_k_plan(*mnk) for name, mnk in shapes.items()}
    assert plans == {"qk_pad": (128, 1), "qk_raw": (48, 1), "qk_tlhs": (48, 1),
                     "qk_tlhs48": (48, 1), "qk_trhs": (48, 1), "pv_pad": (128, 16),
                     "pv_raw": (64, 32), "pv_trhs": (64, 32), "pv_mixed": (64, 32)}
    rng = np.random.RandomState(0)
    ragged = [(100, 70, 37), (3, 130, 128), (64, 64, 300), (40, 48, 96), (48, 40, 1000),
              (1, 1, 1), (16, 8, 15), (4096, 4096, 17), (7, 5, 1 << 20)]
    ragged += [tuple(int(x) for x in rng.randint(1, 3000, 3)) for _ in range(200)]
    for m, n, k in list(shapes.values()) + ragged:
        chunk, splits = mp.split_k_plan(m, n, k)
        bm, bn = mp.tc_tile(m, n)
        tiles = -(-m // bm) * -(-n // bn)
        assert chunk % mp.MMA_K == 0 and chunk >= mp.MMA_K and _covers(chunk, splits, k)
        assert bm == 16 * min(4, -(-m // 16)) and bn == (40 if n <= 40 else 64)
        if tiles >= mp.SMS:
            assert splits == 1
        elif k > mp.MMA_K * mp.SMS:
            assert tiles * splits >= mp.SMS, (m, n, k, chunk, splits)
        assert splits <= 2 * mp.SMS
    # the tile is chosen here only: the kernel's entry point takes it
    source = (Path(mp.__file__).parents[1] / "csrc" / "mm_probe_tc.cu").read_text()
    params, = re.findall(r'extern "C" int hedit_mm_loop_tc\(([^)]*)\)', source)
    assert "int bm, int bn, int chunk" in " ".join(params.split())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_library_operands_compute_the_function(dtype):
    """``mm_library_operands``' one product a_cat @ b_rep, in float32 on the
    CPU, against the plain version in each layout, within the plain
    version's tolerance 4 sqrt(reps K) 2^-24 sum |terms|; all ones give
    exactly K * (1 + ... + reps)."""
    rng = np.random.RandomState(11)
    reps = 64
    for layout, (_, a_t, b_t) in mp.LAYOUTS.items():
        for m, n, k in ((24, 40, 48), (40, 16, 100)):
            a_shape, b_shape = ((k, m) if a_t else (m, k)), ((n, k) if b_t else (k, n))
            a = torch.from_numpy(rng.randn(*a_shape)).to(dtype)
            b = torch.from_numpy(rng.randn(*b_shape)).to(dtype)
            a_cat, b_rep = mp.mm_library_operands(a, b, layout, reps)
            assert a_cat.shape == (m, reps * k) and b_rep.shape == (reps * k, n)
            assert a_cat.dtype == b_rep.dtype == dtype
            got = a_cat.float() @ b_rep.float()
            want = mp.mm_loop_reference(a, b, layout, reps)
            tol = 4 * math.sqrt(reps * k) * 2.0 ** -24 * mp.mm_loop_magnitude(a, b, layout, reps)
            assert bool(((got - want).abs() <= tol).all()), ((got - want).abs() / tol).max()
            ones = mp.mm_library_operands(torch.ones(a_shape, dtype=dtype),
                                          torch.ones(b_shape, dtype=dtype), layout, reps)
            assert bool(((ones[0].float() @ ones[1].float()) == k * reps * (reps + 1) // 2).all())


def test_wrapper_on_cpu_counts_no_launch_on_either_route():
    """CPU tensors in bf16 and float32 take ``mm_loop_reference`` bit for
    bit and move neither the tensor-core counters nor the ``_core`` ones."""
    counters = [f"launches_{lay}{suffix}" for lay in mp.LAYOUTS
                for suffix in ("", "_core")]
    before = [getattr(mp, c) for c in counters]
    rng = np.random.RandomState(2)
    for dtype in (torch.bfloat16, torch.float32):
        for layout, (_, a_t, b_t) in mp.LAYOUTS.items():
            m, n, k = 20, 12, 37
            a = torch.from_numpy(rng.randn(*((k, m) if a_t else (m, k)))).to(dtype)
            b = torch.from_numpy(rng.randn(*((n, k) if b_t else (k, n)))).to(dtype)
            assert torch.equal(mp.mm_loop_cuda(a, b, layout, 5),
                               mp.mm_loop_reference(a, b, layout, 5))
    assert [getattr(mp, c) for c in counters] == before
    assert {d: e for d, (e, _) in mp.ENTRIES.items()} == {
        torch.bfloat16: "hedit_mm_loop_tc", torch.float32: "hedit_mm_loop"}
