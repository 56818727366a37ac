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
inputs carry no seed, so ``run`` takes none).  Prints each case's time per
matmul and its speed against the padded case of its kind, as the script
does.  In bf16 the cases run on the tensor cores (``csrc/mm_probe_tc.cu``,
``mma.sync`` m16n8k16), which take K in steps of 16: K = 40 costs what
K = 48 costs (three steps against 128's eight), and M = 40 (``pv_trhs``,
``pv_mixed``) what 48 rows cost; ``qk_tlhs`` against ``qk_tlhs48`` (one
layout, K = 40 and 48) reads what the padding charges.  ``run(dtype=
torch.float32)`` takes the CUDA-core kernel (``csrc/mm_probe.cu``).

    python -m hedit_tpu_torch.probes.mm_probe [--parent DIR]

The script's main also times, beside each case, the library call that
computes the same function in one product (``torch.mm`` of the nudged A's
side by side along K by B stacked 64 times, into float32:
``ops/mm_probe.py:mm_library_operands``); it times the kernel and the
library call by CUDA-graph replays, as their 10-60 us calls launched one at
a time would take the host's pace.  ``run``, which ``chip_smoke.py`` drives
with the launch counts at 0, calls the kernel eagerly, so that each counted
launch is one call of the entry point.  ``--parent DIR``: a checkout of
an earlier commit (``git archive <commit> hedit_tpu_torch | tar -x -C DIR``);
its ``csrc/mm_probe.cu`` is built alone and its ``hedit_mm_loop`` timed in
bf16 in turns with this tree's kernel, both through their entry points
(parent, this, this, parent; best of 3 means of 20), and the two
``hedit_mm_loop`` float32 outputs held bit for bit to each other in each
layout (the probe exits 1 if they differ).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict

import torch

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import mm_probe as mp
from hedit_tpu_torch.ops.mm_probe import REPS, mm_loop_cuda
from hedit_tpu_torch.probes.timing import (
    best_ms, build_alone, cuda_graph_ms, cuda_ms, require_cuda,
)

M, N = 512, 2048
# name: (a shape, b shape, layout), in the script's order
CASES = {"qk_pad": ((M, 128), (128, N), "nn"), "qk_raw": ((M, 40), (40, N), "nn"),
         "qk_tlhs": ((40, M), (40, N), "tl"), "qk_tlhs48": ((48, M), (48, N), "tl"),
         "qk_trhs": ((M, 40), (N, 40), "tr"), "pv_pad": ((M, N), (N, 128), "nn"),
         "pv_raw": ((M, N), (N, 40), "nn"), "pv_trhs": ((40, N), (M, N), "tr"),
         "pv_mixed": ((N, 40), (M, N), "tm")}
BF16_RATE = 989e12


def contraction(name: str) -> int:
    """K of a case: a's second dim, or its first where a is stored [K, M]."""
    a_shape, _, layout = CASES[name]
    return a_shape[0] if layout in ("tl", "tm") else a_shape[1]


def library_mm(a_cat: torch.Tensor, b_rep: torch.Tensor) -> torch.Tensor:
    """The yardstick: one ``torch.mm`` into float32 (``aten::mm.dtype``)."""
    return torch.mm(a_cat, b_rep, out_dtype=torch.float32)


def run(reps: int = 10, dtype: torch.dtype = torch.bfloat16, library: bool = False,
        timer=cuda_ms) -> Dict[str, Dict[str, float]]:
    """Returns {case: {us_per_matmul, ms, exact, x_vs_padded[, library_ms]}},
    each case through ``mm_loop_cuda`` in ``dtype``, timed by ``timer``
    (``cuda_ms``: eager calls; ``cuda_graph_ms``: replays of captured calls,
    each capture counted as one launch); ``library`` adds the library
    call's ms (bf16, CUDA-graph replays)."""
    require_cuda("mm_probe")
    results = {}
    for name, (a_shape, b_shape, layout) in CASES.items():
        a = torch.ones(a_shape, dtype=dtype, device="cuda")
        b = torch.ones(b_shape, dtype=dtype, device="cuda")
        out = mm_loop_cuda(a, b, layout)
        ms = timer(lambda: mm_loop_cuda(a, b, layout), reps=reps)
        results[name] = {"us_per_matmul": ms * 1e3 / REPS, "ms": ms,
                         "exact": bool((out == contraction(name) * REPS * (REPS + 1) // 2).all())}
        if library:
            a_cat, b_rep = mp.mm_library_operands(a, b, layout)
            results[name]["library_ms"] = cuda_graph_ms(lambda: library_mm(a_cat, b_rep),
                                                        reps=reps)
            del a_cat, b_rep
    for name, r in results.items():
        base = results["qk_pad" if name.startswith("qk") else "pv_pad"]
        r["x_vs_padded"] = base["us_per_matmul"] / r["us_per_matmul"]
    return results


def _entry_call(lib, entry, a, b, layout):
    """(a call of ``entry`` of ``lib`` on a, b through ctypes, its output)."""
    am, bk = mp._canonical(a, b, layout)
    m, k = am.shape
    n = bk.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device="cuda")
    code, dtype = mp.LAYOUTS[layout][0], int(a.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, entry)
    ws = out
    if entry.endswith("_tc"):
        chunk, splits = mp.split_k_plan(m, n, k)
        ws = torch.empty((splits, m, n), dtype=torch.float32, device="cuda")
        ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr())
        ints = (m, n, k, REPS, code, *mp.tc_tile(m, n), chunk, splits, dtype)
    else:
        ptrs, ints = (a.data_ptr(), b.data_ptr(), out.data_ptr()), (m, n, k, REPS, code, dtype)

    def call(ws=ws):  # holds the workspace as long as the call
        err = fn(*ptrs, *ints, stream)
        if err:
            raise RuntimeError(f"{entry} failed (code {err})")
    return call, out


def parent_turns(mine, parent) -> list:
    """Each bf16 case: the parent's ``hedit_mm_loop`` and this tree's
    ``hedit_mm_loop_tc``, both through their entry points, in turns."""
    records = []
    for name, (a_shape, b_shape, layout) in CASES.items():
        a = torch.ones(a_shape, dtype=torch.bfloat16, device="cuda")
        b = torch.ones(b_shape, dtype=torch.bfloat16, device="cuda")
        this, out = _entry_call(mine, "hedit_mm_loop_tc", a, b, layout)
        old, old_out = _entry_call(parent, "hedit_mm_loop", a, b, layout)
        this()
        old()
        torch.cuda.synchronize()
        exact = contraction(name) * REPS * (REPS + 1) // 2
        ok = bool((out == exact).all()) and bool((old_out == exact).all())
        turns = [("parent", old), ("this", this), ("this", this), ("parent", old)]
        ms = [best_ms(fn) for _, fn in turns]
        k = contraction(name)
        m, n = out.shape
        bound_ms = 2 * REPS * m * n * k / BF16_RATE * 1e3
        print(f"{name:<10} turns " + ", ".join(f"{w} {t:.4f}" for (w, _), t in zip(turns, ms))
              + f" ms; bound {bound_ms:.5f} ms ({bound_ms / min(ms[1:3]):.1%}); both exact {ok}")
        records.append({"case": name, "turns": [[w, t] for (w, _), t in zip(turns, ms)],
                        "bound_ms": bound_ms, "exact": ok})
    return records


def f32_identity(mine, parent) -> bool:
    """This tree's float32 ``hedit_mm_loop`` against the parent's, bit for
    bit, in each layout on seeded inputs (ragged M, N and K)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    same = True
    for layout, (_, a_t, b_t) in mp.LAYOUTS.items():
        for m, n, k in ((100, 70, 37), (64, 128, 300)):
            a = torch.randn((k, m) if a_t else (m, k), generator=g, device="cuda")
            b = torch.randn((n, k) if b_t else (k, n), generator=g, device="cuda")
            outs = []
            for lib in (mine, parent):
                call, out = _entry_call(lib, "hedit_mm_loop", a, b, layout)
                call()
                outs.append(out)
            torch.cuda.synchronize()
            equal = torch.equal(*outs)
            same &= equal
            print(f"float32 hedit_mm_loop {layout} [{m}, {n}, {k}]: "
                  f"{'bit-identical to the parent' if equal else 'DIFFERS from the parent'}")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit, timed in turns with this tree")
    args = ap.parse_args(argv)
    results = run(args.reps, library=True, timer=cuda_graph_ms)
    print(f"mm_probe: reps={REPS} M={M} N={N} bfloat16, {torch.cuda.get_device_name(0)}")
    for name, r in results.items():
        print(f"{name:<10} K={contraction(name):<5} {r['us_per_matmul']:9.3f} us/matmul  "
              f"({r['x_vs_padded']:4.2f}x vs padded)  library {r['library_ms'] * 1e3 / REPS:9.3f}"
              f" us/matmul  exact {r['exact']}")
    pad = results["qk_tlhs"]["ms"] / results["qk_tlhs48"]["ms"]
    print(f"K padding on the tensor cores: qk_tlhs (K = 40) takes {pad:.3f}x qk_tlhs48 (K = 48)")
    report = {"mm_probe": results}
    ok = all(r["exact"] for r in results.values())
    if args.parent is not None:
        csrc = args.parent / "hedit_tpu_torch" / "csrc"
        parent, info = build_alone(csrc / "mm_probe.cu", _build.BUILD_DIR / "mm_probe_parent.so",
                                   csrc)
        print(f"ptxas, the parent's mm_probe.cu: {info}")
        mine = _build.cuda_library()
        report["parent_turns"] = parent_turns(mine, parent)
        ok &= all(r["exact"] for r in report["parent_turns"])
        ok &= f32_identity(mine, parent)
    print(json.dumps(report))
    if not ok:
        print("FAILED: an all-ones output is not K * 2080, or a float32 output differs "
              "from the parent's")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
