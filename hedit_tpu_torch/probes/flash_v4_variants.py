"""The exact forward's loop variants at the controlled call's hot shape
[4, 32, 4096, 40] bfloat16, timed on the card.

Port of ``scripts/flash_v4_variants.py`` (its TPU kernel is ``kern_exp2``,
``ops/flash_probes.py:flash_exp2_t_cuda``):

* base: the port's exact forward, TPU kernel 6 (``flash_attention_exact_cuda``,
  the script's shipped ``flash_attention``; in bf16 on the tensor cores);
* exp2: sm_scale * log2(e) folded into q, exp2, p rounded to bf16, the
  transposed ``[B*H, D, S]`` output (in bf16 on the tensor cores);
* exp2+pipe: the same with the software-pipelined key loop (the scores of
  tile t before the softmax and PV of tile t - 1).

Inputs are seeded as the script seeds them (numpy ``RandomState(0)``, unit
normal).  Prints each one's time and its largest error on head 0 against
exact attention in float32 (as the script does) and, for the exp2 kernels,
against their plain version.

    python -m hedit_tpu_torch.probes.flash_v4_variants
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from hedit_tpu_torch.ops.flash_attention import flash_attention_exact_cuda, reference_attention
from hedit_tpu_torch.ops.flash_probes import flash_exp2_t_cuda, flash_exp2_t_reference
from hedit_tpu_torch.probes.timing import cuda_ms, require_cuda

B, H, S, D = 4, 32, 4096, 40


def make_inputs(seed: int = 0, device="cuda", dtype=torch.bfloat16):
    """q, k, v [B, H, S, D] in ``dtype`` from numpy ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, H, S, D).astype(np.float32)).to(device, dtype)
            for _ in range(3)]


def run(seed: int = 0, reps: int = 10, dtype=torch.bfloat16) -> Dict[str, Dict[str, float]]:
    """Returns {variant: {ms, err_exact_head0[, err_plain_head0]}}."""
    require_cuda("flash_v4_variants")
    q, k, v = make_inputs(seed, dtype=dtype)
    head0 = [t[:1, :1] for t in (q, k, v)]
    exact0 = reference_attention(*(t.float() for t in head0))[0, 0]      # [S, D]
    plain0 = flash_exp2_t_reference(*head0)[0].T.float()
    results = {}
    with torch.no_grad():
        base = flash_attention_exact_cuda(q, k, v)
        results["base"] = {"ms": cuda_ms(lambda: flash_attention_exact_cuda(q, k, v), reps=reps),
                           "err_exact_head0": (base[0, 0].float() - exact0).abs().max().item()}
        for name, pipe in (("exp2", False), ("exp2+pipe", True)):
            got0 = flash_exp2_t_cuda(q, k, v, pipe)[0].T.float()         # head 0: [D, S] -> [S, D]
            results[name] = {
                "ms": cuda_ms(lambda: flash_exp2_t_cuda(q, k, v, pipe), reps=reps),
                "err_exact_head0": (got0 - exact0).abs().max().item(),
                "err_plain_head0": (got0 - plain0).abs().max().item()}
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    results = run(args.seed, args.reps)
    print(f"flash_v4_variants: [{B}, {H}, {S}, {D}] bfloat16, {torch.cuda.get_device_name(0)}")
    for name, r in results.items():
        plain = (f", vs plain version {r['err_plain_head0']:.2e}"
                 if "err_plain_head0" in r else "")
        print(f"{name:10s}: {r['ms']:.3f} ms/call  (err vs exact attention, head 0, "
              f"{r['err_exact_head0']:.2e}{plain})")
    print(json.dumps({"flash_v4_variants": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
