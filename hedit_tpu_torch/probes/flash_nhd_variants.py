"""Where the head-split / merge copies around the flash kernel go: the full
chain ``x [B, S, C] -> q / k / v projections -> attention -> out projection``
at the controlled call's hot shape, each layout variant timed on the card.

Port of ``scripts/flash_nhd_variants.py`` (its TPU kernels are the three
bounded forwards of ``ops/flash_probes.py``).  B = 16 rows (4 images x 4
rows), S = 4096 tokens, H = 8 heads of D = 40, C = 320 channels, bfloat16
(``run(dtype=torch.float32)``: every chain in float32, on the CUDA-core
kernels); x and the four [C, C] weights seeded as the script seeds them.
Every chain computes the bounded (max-free) attention anchored on the first
512 keys:

* A: the projections, a head split of each (a copy), the head-split bounded
  forward (TPU kernel 1, ``flash_attention_cuda``), the merge (a copy), the
  out projection;
* C: the same inputs, but the kernel writes the packed transposed output
  ``[B, H*D, S]`` (``flash_packed_t_cuda``; bf16 on the tensor cores) and
  the out projection reads it as a transposed operand, with no copy;
* D: C with the projections written as ``einsum('bsc,chd->bhsd')``; torch's
  einsum returns a permuted view, so a copy still makes the kernel's
  ``[B, H, S, D]``;
* E: C with q and k projected straight into the S-minor ``[B, H, D, S]``
  (one matmul of the transposed weight with the transposed x: no copy), v
  as in D (``flash_packed_t_sminor_cuda``; bf16 on the tensor cores);
* F: all three S-minor (``flash_packed_t_all_sminor_cuda``; bf16 on the
  tensor cores);
* P: the port's own route: the packed bounded forward reads the
  ``[B, S, H*D]`` projections as they are and writes ``[B, S, H*D]``
  (``flash_attention_packed_bounded_cuda``), no copy on either side.

Prints each chain's largest difference from chain A and its CUDA-event time.

    python -m hedit_tpu_torch.probes.flash_nhd_variants
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from hedit_tpu_torch.ops.flash_attention import (
    flash_attention_cuda, flash_attention_packed_bounded_cuda,
)
from hedit_tpu_torch.ops.flash_probes import (
    flash_packed_t_all_sminor_cuda, flash_packed_t_cuda, flash_packed_t_sminor_cuda,
)
from hedit_tpu_torch.probes.timing import cuda_ms, require_cuda

B, S, H, D, C = 16, 4096, 8, 40, 320


def make_inputs(seed: int = 0, device="cuda", dtype=torch.bfloat16):
    """x [B, S, C] and wq, wk, wv, wo [C, C] in ``dtype``, drawn as the script
    draws them (numpy ``RandomState(seed)``: x * 0.2, the weights * 0.05)."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, S, C) * 0.2] + [rng.randn(C, C) * 0.05 for _ in range(4)]
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype) for a in arrays]


def _split(t):
    """[B, S, H*D] -> contiguous [B, H, S, D] (a copy)"""
    return t.reshape(B, S, H, D).transpose(1, 2).contiguous()


def _heads_sd(x, w):
    """einsum('bsc,chd->bhsd') made contiguous for the kernel"""
    return torch.einsum("bsc,chd->bhsd", x, w.reshape(C, H, D)).contiguous()


def _heads_ds(x, w):
    """The S-minor projection [B, H, D, S], written as such by one matmul
    (w^T [H*D, C] times x^T [B, C, S], both transposed operands)."""
    return torch.matmul(w.t(), x.transpose(1, 2)).view(B, H, D, S)


def _outproj_t(ot, wo):
    """[B, C, S] x [C, E] -> [B, S, E], reading ot as a transposed operand"""
    return torch.matmul(ot.transpose(1, 2), wo)


def chain_a(x, wq, wk, wv, wo):
    q, k, v = x @ wq, x @ wk, x @ wv
    o = flash_attention_cuda(_split(q), _split(k), _split(v))
    return o.transpose(1, 2).reshape(B, S, H * D) @ wo


def chain_c(x, wq, wk, wv, wo):
    q, k, v = x @ wq, x @ wk, x @ wv
    return _outproj_t(flash_packed_t_cuda(_split(q), _split(k), _split(v)), wo)


def chain_d(x, wq, wk, wv, wo):
    return _outproj_t(flash_packed_t_cuda(_heads_sd(x, wq), _heads_sd(x, wk), _heads_sd(x, wv)),
                      wo)


def chain_e(x, wq, wk, wv, wo):
    return _outproj_t(flash_packed_t_sminor_cuda(_heads_ds(x, wq), _heads_ds(x, wk),
                                                 _heads_sd(x, wv)), wo)


def chain_f(x, wq, wk, wv, wo):
    return _outproj_t(flash_packed_t_all_sminor_cuda(_heads_ds(x, wq), _heads_ds(x, wk),
                                                     _heads_ds(x, wv)), wo)


def chain_p(x, wq, wk, wv, wo):
    return flash_attention_packed_bounded_cuda(x @ wq, x @ wk, x @ wv, H) @ wo


CHAINS = {"A": chain_a, "C": chain_c, "D": chain_d, "E": chain_e, "F": chain_f, "P": chain_p}


def run(seed: int = 0, reps: int = 10, dtype=torch.bfloat16) -> Dict[str, Dict[str, float]]:
    """Every chain once against chain A, then timed; returns {chain: {ms,
    max_abs_diff}}."""
    require_cuda("flash_nhd_variants")
    args = make_inputs(seed, dtype=dtype)
    with torch.no_grad():
        ref = chain_a(*args).float()
        results = {}
        for name, fn in CHAINS.items():
            diff = (fn(*args).float() - ref).abs().max().item()
            results[name] = {"max_abs_diff": diff, "ms": cuda_ms(lambda: fn(*args), reps=reps)}
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    results = run(args.seed, args.reps)
    print(f"flash_nhd_variants: B={B} S={S} H={H} D={D} C={C} bfloat16, "
          f"{torch.cuda.get_device_name(0)}")
    for name, r in results.items():
        print(f"chain{name}: {r['ms']:.3f} ms/call  max|diff| vs chainA {r['max_abs_diff']:.4f}")
    print(json.dumps({"flash_nhd_variants": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
