"""TPU kernel 12 (``scripts/mm_probe.py:_loop_kernel``) in float32 on the
CUDA cores: what the CPU can check of ``csrc/mm_probe.cu`` and its plan.

* The plan (``core_plan``) at the probe's nine cases and ragged shapes: its
  slices, K chunks times rep ranges, cover every (rep, k) pair of the
  contraction exactly once; the shared tiles fit a block's 227 KB; the
  blocks fill a wave of the card's SMs wherever the contraction has enough
  terms to, and never take more than two blocks an SM.
* The partials (``core_partials``), the kernel's workspace in plain tensor
  code, summed in slice order as ``csrc/mm_split_sum.cuh`` sums them: the
  plain version within its tolerance on seeded input, exactly on all ones.
* The entry point takes the plan in ``CorePlan``'s order, the loader's
  argument types are the ones the source declares, the kernel instantiates
  the thread tiles ``core_tile`` picks, and the sum of the partials is one
  kernel in one header, included by both routes.

No JAX here: the plain version is held to JAX's kernel in
``test_torch_cost_probes.py``.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import mm_probe as mp
from hedit_tpu_torch.probes.mm_probe import CASES, _c_argtypes, case_shape

CSRC = Path(mp.__file__).parents[1] / "csrc"
SHARED_MAX = 227 * 1024  # a block's shared memory on an H100


def _shapes():
    """The nine cases' (M, N, K) and ragged ones, seeded."""
    rng = np.random.RandomState(0)
    shapes = [case_shape(name) for name in CASES]
    shapes += [(100, 70, 37), (3, 130, 128), (2100, 2050, 24), (256, 256, 16), (40, 40, 40),
               (1, 1, 1), (41, 41, 1000), (4096, 4096, 17), (7, 5, 1 << 20)]
    return shapes + [tuple(int(x) for x in rng.randint(1, 3000, 3)) for _ in range(300)]


def _tiles(plan: mp.CorePlan, m: int, n: int) -> int:
    bm, bn = plan.tile
    return -(-m // bm) * -(-n // bn)


def test_core_plan_covers_the_contraction_once_and_fills_the_card():
    """Every shape at 64, 3 and 0 reps: K chunks [s chunk, min((s + 1) chunk,
    K)) and rep ranges [r rchunk, min((r + 1) rchunk, reps)) each non-empty
    and covering K and the reps exactly, so the slices, their product, take
    every (rep, k) pair once; the shared tiles within 227 KB; at most
    max(tiles, 2 x 132) blocks; a full wave (or 90% of the SMs busy over
    the waves) wherever tiles x K / 16 x reps allows one.  The nine cases'
    plans as measured: 128 x 128 tiles of 2 x 32 but for N = 40 (256 x 40,
    2 x 20) and M = 40 (40 x 256, 5 x 8), K split into 2-128 chunks."""
    for m, n, k in _shapes():
        for reps in (mp.REPS, 3, 0):
            plan = mp.core_plan(m, n, k, reps)
            assert plan[:4] == mp.core_tile(m, n)
            starts = [s * plan.chunk for s in range(plan.ksplits)]
            assert starts[-1] < k <= starts[-1] + plan.chunk, (m, n, k, plan)
            if reps:
                firsts = [r * plan.rchunk for r in range(plan.rsplits)]
                assert firsts[-1] < reps <= firsts[-1] + plan.rchunk, (m, n, k, reps, plan)
            else:
                assert plan.rsplits == 1
            assert 1 <= plan.kt <= min(plan.chunk, mp.CORE_KT)
            assert plan.tx * plan.ty <= 256 and plan.shared_bytes <= SHARED_MAX
            tiles = _tiles(plan, m, n)
            blocks = tiles * plan.slices
            assert blocks <= max(tiles, 2 * mp.SMS), (m, n, k, reps, plan)
            if tiles * -(-k // mp.CORE_MIN_CHUNK) * reps >= mp.SMS:
                assert blocks >= mp.SMS or mp._fill(blocks) >= 0.9, (m, n, k, reps, plan)
    plans = {name: mp.core_plan(*case_shape(name)) for name in CASES}
    assert {name: (p.rm, p.rn, p.tile, p.ksplits, p.rsplits) for name, p in plans.items()} == {
        "qk_pad": (2, 32, (128, 128), 4, 1), "qk_raw": (2, 32, (128, 128), 2, 1),
        "qk_tlhs": (2, 32, (128, 128), 2, 1), "qk_tlhs48": (2, 32, (128, 128), 2, 1),
        "qk_trhs": (2, 32, (128, 128), 2, 1), "pv_pad": (2, 32, (128, 128), 64, 1),
        "pv_raw": (2, 20, (256, 40), 128, 1), "pv_trhs": (5, 8, (40, 256), 128, 1),
        "pv_mixed": (5, 8, (40, 256), 128, 1)}
    for name, plan in plans.items():
        assert mp._fill(_tiles(plan, *case_shape(name)[:2]) * plan.slices) >= 0.95, name


@pytest.mark.parametrize("layout", ["nn", "tl", "tr", "tm"])
def test_partials_summed_in_slice_order_are_the_function(layout):
    """``core_partials`` at plans that split K and the reps, summed one
    slice after another as the kernel's second pass sums them: within
    4 sqrt(64 K) 2^-24 sum |terms| of ``mm_loop_reference`` on seeded
    float32 input, exactly K * 2080 on all ones."""
    rng = np.random.RandomState(3)
    _, a_t, b_t = mp.LAYOUTS[layout]
    for m, n, k in ((100, 70, 37), (40, 48, 96), (130, 20, 300)):
        plan = mp.core_plan(m, n, k)
        assert plan.ksplits > 1 and plan.rsplits > 1, plan
        a_shape, b_shape = ((k, m) if a_t else (m, k)), ((n, k) if b_t else (k, n))

        def summed(a, b):
            parts = mp.core_partials(a, b, layout, plan)
            assert parts.shape == (plan.slices, m, n)
            out = parts[0].clone()
            for s in range(1, plan.slices):
                out += parts[s]
            return out
        a = torch.from_numpy(rng.randn(*a_shape).astype(np.float32))
        b = torch.from_numpy(rng.randn(*b_shape).astype(np.float32))
        got, want = summed(a, b), mp.mm_loop_reference(a, b, layout)
        tol = 4 * math.sqrt(mp.REPS * k) * 2.0 ** -24 * mp.mm_loop_magnitude(a, b, layout)
        assert bool(((got - want).abs() <= tol).all()), ((got - want).abs() / tol).max()
        ones = summed(torch.ones(a_shape), torch.ones(b_shape))
        assert bool((ones == k * mp.REPS * (mp.REPS + 1) // 2).all())


def test_entry_point_takes_the_plan_and_the_sum_is_shared():
    """``hedit_mm_loop`` declares the plan's fields in ``CorePlan``'s order
    after the layout, and the loader's argument types are the declared ones;
    the kernel takes exactly the thread tiles ``core_tile`` picks; one
    ``mm_split_sum_kernel``, in ``mm_split_sum.cuh``, which both routes
    include and neither defines again."""
    source = (CSRC / "mm_probe.cu").read_text()
    params, = re.findall(r'extern "C" int hedit_mm_loop\(([^)]*)\)', source)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[names.index("layout") + 1:-2] == list(mp.CorePlan._fields)
    assert _c_argtypes(CSRC / "mm_probe.cu", "hedit_mm_loop") == _build.ARGTYPES["hedit_mm_loop"]
    supported = {(int(a), int(b)) for a, b in
                 re.findall(r"rm == (\d+) && rn == (\d+)", source.split("bool tile_supported")[1]
                            .split("}")[0])}
    picked = {mp.core_tile(m, n)[:2] for m in (1, 40, 41, 512) for n in (1, 40, 41, 2048)}
    assert supported == picked
    defined = {p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")
               and re.search(r"mm_split_sum_kernel\(const float", p.read_text())}
    assert defined == {"mm_split_sum.cuh"}
    for route in ("mm_probe.cu", "mm_probe_tc.cu"):
        text = (CSRC / route).read_text()
        assert '#include "mm_split_sum.cuh"' in text and "launch_split_sum(" in text
