"""What small contractions and small output widths cost: 64 nudged matmuls
accumulated in float32, in the nine cases of the script, timed on the card.

Port of ``scripts/mm_probe.py`` (its TPU kernel is ``_loop_kernel``,
``ops/mm_probe.py:mm_loop_cuda``).  M = 512, N = 2048 (the flash blocks at
res 64), bfloat16 operands of all ones, as the script's:

* qk-like, contraction = d: ``qk_pad`` (K = 128), ``qk_raw`` (K = 40),
  ``qk_tlhs`` (K = 40, lhs transposed), ``qk_tlhs48`` (K = 48),
  ``qk_trhs`` (K = 40, rhs transposed);
* pv-like, contraction = seq_k = 2048, output width d: ``pv_pad`` (128),
  ``pv_raw`` (40), ``pv_trhs`` (out [40, 512], rhs transposed),
  ``pv_mixed`` (lhs and rhs transposed).

Each output must come out exactly K * (1 + 2 + ... + 64) = K * 2080 (the
inputs carry no seed, so ``run`` takes none).  Prints each case's time per matmul and its speed
against the padded case of its kind, as the script does.  These kernels
run on the CUDA cores: they say what the contraction and output widths
cost there, not what tensor-core K padding costs.

    python -m hedit_tpu_torch.probes.mm_probe
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

from hedit_tpu_torch.ops.mm_probe import REPS, mm_loop_cuda
from hedit_tpu_torch.probes.timing import cuda_ms, require_cuda

M, N = 512, 2048
# name: (a shape, b shape, layout), in the script's order
CASES = {"qk_pad": ((M, 128), (128, N), "nn"), "qk_raw": ((M, 40), (40, N), "nn"),
         "qk_tlhs": ((40, M), (40, N), "tl"), "qk_tlhs48": ((48, M), (48, N), "tl"),
         "qk_trhs": ((M, 40), (N, 40), "tr"), "pv_pad": ((M, N), (N, 128), "nn"),
         "pv_raw": ((M, N), (N, 40), "nn"), "pv_trhs": ((40, N), (M, N), "tr"),
         "pv_mixed": ((N, 40), (M, N), "tm")}


def contraction(name: str) -> int:
    """K of a case: a's second dim, or its first where a is stored [K, M]."""
    a_shape, _, layout = CASES[name]
    return a_shape[0] if layout in ("tl", "tm") else a_shape[1]


def run(reps: int = 10) -> Dict[str, Dict[str, float]]:
    """Returns {case: {us_per_matmul, ms, exact, x_vs_padded}}."""
    require_cuda("mm_probe")
    results = {}
    for name, (a_shape, b_shape, layout) in CASES.items():
        a = torch.ones(a_shape, dtype=torch.bfloat16, device="cuda")
        b = torch.ones(b_shape, dtype=torch.bfloat16, device="cuda")
        out = mm_loop_cuda(a, b, layout)
        ms = cuda_ms(lambda: mm_loop_cuda(a, b, layout), reps=reps)
        results[name] = {"us_per_matmul": ms * 1e3 / REPS, "ms": ms,
                         "exact": bool((out == contraction(name) * REPS * (REPS + 1) // 2).all())}
    for name, r in results.items():
        base = results["qk_pad" if name.startswith("qk") else "pv_pad"]
        r["x_vs_padded"] = base["us_per_matmul"] / r["us_per_matmul"]
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    results = run(args.reps)
    print(f"mm_probe: reps={REPS} M={M} N={N} bfloat16, {torch.cuda.get_device_name(0)}")
    for name, r in results.items():
        print(f"{name:<10} K={contraction(name):<5} {r['us_per_matmul']:9.2f} us/matmul  "
              f"({r['x_vs_padded']:4.2f}x vs padded)  exact {r['exact']}")
    print(json.dumps({"mm_probe": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
