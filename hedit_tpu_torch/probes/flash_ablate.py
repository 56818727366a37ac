"""The bounded flash loop cut down to its floor, at the controlled call's hot
shape [4, 32, 4096, 40] bfloat16, timed on the card.

Port of ``scripts/flash_ablate.py`` (its TPU kernel is ``make_kernel(mode)``,
``ops/flash_probes.py:flash_ablate_t_cuda``).  Each ablation writes the
transposed ``[B*H, D, S]`` output from q, k, v with q unscaled:

* dots: p = s (the QK product, the cast and the PV product alone);
* exp: p = exp2(s);
* noprolog: p = exp2(min(s - 12.34, 100)), the bounded loop without the
  prologue that finds each row's shift.

In bf16 all three run on the tensor cores (``csrc/flash_probes_tc.cu``);
``run(dtype=torch.float32)`` runs them in float32 on the query-major kernel
of the CUDA cores (``csrc/flash_variants.cu``).

Inputs are drawn as the script draws them (numpy ``RandomState(seed)``: q
and k times 0.05, so that exp2(s) stays finite, v unit normal).  The
script's fourth run repeats ``dots`` with 1024 x 1024 blocks, a VMEM tiling
parameter of the TPU kernel; the CUDA kernel has its own 64 x 64 tiles, so
that run has no counterpart and is reported as such.  Prints each
ablation's time beside the port's bounded forward at the same shape
(``flash_attention_cuda``, TPU kernel 1, the loop the ablations cut down).

    python -m hedit_tpu_torch.probes.flash_ablate
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from hedit_tpu_torch.ops.flash_attention import flash_attention_cuda
from hedit_tpu_torch.ops.flash_probes import ABLATE_MODES, flash_ablate_t_cuda
from hedit_tpu_torch.probes.timing import cuda_ms, require_cuda

B, H, S, D = 4, 32, 4096, 40
NO_COUNTERPART = ("dots with 1024 x 1024 blocks sets the TPU kernel's VMEM tiling; "
                  "the CUDA kernel's tiles are its own (64 x 64): no counterpart")


def make_inputs(seed: int = 0, device="cuda", dtype=torch.bfloat16):
    """q, k, v [B, H, S, D] in ``dtype`` from numpy ``RandomState(seed)``: q
    and k scaled by 0.05, v unit normal."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, H, S, D) * 0.05, rng.randn(B, H, S, D) * 0.05, rng.randn(B, H, S, D)]
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype) for a in arrays]


def run(seed: int = 0, reps: int = 10, dtype=torch.bfloat16) -> Dict[str, object]:
    """Returns {mode: {ms, finite}, "bounded": {ms}, "dots_1024x1024": reason}."""
    require_cuda("flash_ablate")
    q, k, v = make_inputs(seed, dtype=dtype)
    results: Dict[str, object] = {}
    with torch.no_grad():
        for mode in ABLATE_MODES:
            out = flash_ablate_t_cuda(q, k, v, mode)
            results[mode] = {"ms": cuda_ms(lambda: flash_ablate_t_cuda(q, k, v, mode), reps=reps),
                             "finite": bool(torch.isfinite(out).all())}
        results["bounded"] = {"ms": cuda_ms(lambda: flash_attention_cuda(q, k, v), reps=reps)}
    results["dots_1024x1024"] = NO_COUNTERPART
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    results = run(args.seed, args.reps)
    print(f"flash_ablate: [{B}, {H}, {S}, {D}] bfloat16, {torch.cuda.get_device_name(0)}")
    for mode in ABLATE_MODES + ("bounded",):
        print(f"{mode:9s}: {results[mode]['ms']:.3f} ms/call")
    print(f"dots 1024x1024: {NO_COUNTERPART}")
    print(json.dumps({"flash_ablate": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
