"""The exact forward in float32 in three layouts at [4*8, 4096, 40]
bfloat16, timed on the card.

Port of ``scripts/flash_variants.py`` (its TPU kernels are ``kern_a``,
``kern_b`` and ``kern_c``, ``ops/flash_probes.py:flash_variant_{a,b,c}_cuda``).
Each variant computes exact attention in float32 (q upcast and scaled by
1/sqrt(D), a running max, the natural exp):

* a_nopad: a [S, D] accumulator and output;
* b_mixed: a transposed [D, S] accumulator and output;
* c_trans: key-major scores, softmax down the key axis, transposed output
  (a kernel of its own in both dtypes, ``hedit_flash_variant_c`` in
  ``csrc/flash_variants.cu``: in bf16 its scores' product on the tensor
  cores);
* d_bf16pv: a, with p rounded to bf16 for the PV product (in bf16 on the
  tensor cores, ``csrc/flash_probes_tc.cu``).

a, b and float32 d run on one query-major kernel (``hedit_flash_variant`` in
``csrc/flash_variants.cu``: in bf16 its scores' product on the tensor
cores, PV on the CUDA cores); ``run(dtype=torch.float32)`` runs all four
in float32.

The script draws q, k and v from one ``PRNGKey(0)``, so q = k = v; here one
tensor from numpy ``RandomState(seed)``, unit normal, serves as all three.
Prints each variant's time and its largest error on head 0 against exact
attention in float32.

    python -m hedit_tpu_torch.probes.flash_variants
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from hedit_tpu_torch.ops.flash_attention import reference_attention
from hedit_tpu_torch.ops.flash_probes import (
    flash_variant_a_cuda, flash_variant_b_cuda, flash_variant_c_cuda,
)
from hedit_tpu_torch.probes.timing import cuda_ms, require_cuda

B, H, S, D = 4, 8, 4096, 40
# name: (call, output transposed)
VARIANTS = {"a_nopad": (flash_variant_a_cuda, False), "b_mixed": (flash_variant_b_cuda, True),
            "c_trans": (flash_variant_c_cuda, True),
            "d_bf16pv": (lambda q, k, v: flash_variant_a_cuda(q, k, v, pv_bf16=True), False)}


def make_input(seed: int = 0, device="cuda", dtype=torch.bfloat16):
    """x [B*H, S, D] in ``dtype`` from numpy ``RandomState(seed)``: q = k = v = x."""
    x = np.random.RandomState(seed).randn(B * H, S, D).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype)


def run(seed: int = 0, reps: int = 10, dtype=torch.bfloat16) -> Dict[str, Dict[str, float]]:
    """Returns {variant: {ms, err_exact_head0}}."""
    require_cuda("flash_variants")
    x = make_input(seed, dtype=dtype)
    x0 = x[:1].float()[None]                                  # head 0 as [1, 1, S, D]
    exact0 = reference_attention(x0, x0, x0)[0, 0]
    results = {}
    with torch.no_grad():
        for name, (fn, transposed) in VARIANTS.items():
            out0 = fn(x, x, x)[0].float()
            out0 = out0.T if transposed else out0
            results[name] = {"ms": cuda_ms(lambda: fn(x, x, x), reps=reps),
                             "err_exact_head0": (out0 - exact0).abs().max().item()}
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    results = run(args.seed, args.reps)
    print(f"flash_variants: [{B * H}, {S}, {D}] bfloat16, {torch.cuda.get_device_name(0)}")
    for name, r in results.items():
        print(f"{name:<10} {r['ms']:8.3f} ms   (err vs exact attention, head 0, "
              f"{r['err_exact_head0']:.2e})")
    print(json.dumps({"flash_variants": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
