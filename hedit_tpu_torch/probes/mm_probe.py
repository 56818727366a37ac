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
torch.float32)`` takes the CUDA-core kernel (``csrc/mm_probe.cu``, the
contraction split over blocks by ``ops/mm_probe.py:core_plan``); the
script's main runs the nine cases in both dtypes.

    python -m hedit_tpu_torch.probes.mm_probe [--parent DIR]

The script's main also times, beside each case, the library call that
computes the same function in one product (``torch.mm`` of the nudged A's
side by side along K by B stacked 64 times, into float32:
``ops/mm_probe.py:mm_library_operands``); it times the kernel and the
library call by CUDA-graph replays, as their 10-100 us calls launched one
at a time would take the host's pace.  ``run``, which ``chip_smoke.py``
drives with the launch counts at 0, calls the kernel eagerly, so that each
counted launch is one call of the entry point.  ``--parent DIR``: a
checkout of an earlier commit (``git archive <commit> hedit_tpu_torch |
tar -x -C DIR``); its ``csrc/mm_probe.cu`` and ``csrc/mm_probe_tc.cu`` are
built alone, each entry point called with the arguments its source
declares.  The parent's float32 ``hedit_mm_loop`` is timed in turns with
this tree's in the nine cases (parent, this, this, parent; entry points;
best of 3 means of 20), each with its bound at the float32 rate and its
share; on seeded input (the nine cases and a ragged one a layout) the two
float32 outputs are held to each other within 4 sqrt(64 K) 2^-24 times the
sum of each output's term magnitudes (the smoke's tolerance: the two sum
in other orders), both all-ones outputs exactly to K * 2080, and this
tree's bf16 ``hedit_mm_loop_tc`` bit for bit to the parent's.  The probe
exits 1 if any of these fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
from pathlib import Path
from typing import Dict, Tuple

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
RATES = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the ragged case (M, N, K) of ``seeded_cases``, in each layout
RAGGED = (100, 70, 37)


def contraction(name: str) -> int:
    """K of a case: a's second dim, or its first where a is stored [K, M]."""
    a_shape, _, layout = CASES[name]
    return a_shape[0] if layout in ("tl", "tm") else a_shape[1]


def library_mm(a_cat: torch.Tensor, b_rep: torch.Tensor) -> torch.Tensor:
    """The yardstick: one ``torch.mm`` into float32 (``aten::mm.dtype`` for
    bf16 operands, the plain product for float32 ones)."""
    if a_cat.dtype == torch.float32:
        return torch.mm(a_cat, b_rep)
    return torch.mm(a_cat, b_rep, out_dtype=torch.float32)


def case_shape(name: str) -> Tuple[int, int, int]:
    """(M, N, K) of a case."""
    a_shape, b_shape, layout = CASES[name]
    _, a_t, b_t = mp.LAYOUTS[layout]
    return (a_shape[1] if a_t else a_shape[0], b_shape[0] if b_t else b_shape[1],
            contraction(name))


def run(reps: int = 10, dtype: torch.dtype = torch.bfloat16, library: bool = False,
        timer=cuda_ms) -> Dict[str, Dict[str, float]]:
    """Returns {case: {us_per_matmul, ms, exact, x_vs_padded[, library_ms]}},
    each case through ``mm_loop_cuda`` in ``dtype``, timed by ``timer``
    (``cuda_ms``: eager calls; ``cuda_graph_ms``: replays of captured calls,
    each capture counted as one launch); ``library`` adds the library
    call's ms (``library_mm``, CUDA-graph replays)."""
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


def _c_argtypes(source: Path, entry: str):
    """ctypes argument types of ``entry`` as ``source`` declares it: a
    pointer for each ``void*``, an int for each ``int``."""
    params, = re.findall(rf'extern "C" int {entry}\(([^)]*)\)', source.read_text())
    return [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params.split(",")]


def _entry_call(lib, entry, a, b, layout):
    """(a call of ``entry`` of ``lib`` on a, b through ctypes, its output).
    The float32 entry point takes a workspace and ``core_plan`` where it is
    declared with one (``ws``: this tree's), else a, b, o alone."""
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
    elif len(fn.argtypes) == len(_build.ARGTYPES[entry]):
        plan = mp.core_plan(m, n, k)
        ws = torch.empty((plan.slices, m, n), dtype=torch.float32, device="cuda")
        ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr())
        ints = (m, n, k, REPS, code, *plan, dtype)
    else:
        ptrs, ints = (a.data_ptr(), b.data_ptr(), out.data_ptr()), (m, n, k, REPS, code, dtype)

    def call(ws=ws):  # holds the workspace as long as the call
        err = fn(*ptrs, *ints, stream)
        if err:
            raise RuntimeError(f"{entry} failed (code {err})")
    return call, out


def _operands(shape_a, shape_b, dtype, g=None):
    """All-ones operands, or seeded ones where ``g`` is given, on the card."""
    if g is None:
        return (torch.ones(shape_a, dtype=dtype, device="cuda"),
                torch.ones(shape_b, dtype=dtype, device="cuda"))
    return tuple(torch.randn(sh, generator=g, device="cuda").to(dtype) for sh in (shape_a, shape_b))


def seeded_cases(ragged=RAGGED):
    """(label, a shape, b shape, layout, K): the nine cases, then the
    ``ragged`` (M, N, K) in each layout."""
    m, n, k = ragged
    cases = [(name, a_shape, b_shape, layout, contraction(name))
             for name, (a_shape, b_shape, layout) in CASES.items()]
    return cases + [(f"ragged_{lay}", (k, m) if a_t else (m, k), (n, k) if b_t else (k, n), lay, k)
                     for lay, (_, a_t, b_t) in mp.LAYOUTS.items()]


def parent_turns(mine, parent) -> list:
    """Each float32 case: the parent's ``hedit_mm_loop`` and this tree's,
    both through their entry points on the all-ones operands, in turns, both
    outputs held exactly to K * 2080."""
    records = []
    for name, (a_shape, b_shape, layout) in CASES.items():
        a, b = _operands(a_shape, b_shape, torch.float32)
        this, out = _entry_call(mine, "hedit_mm_loop", a, b, layout)
        old, old_out = _entry_call(parent, "hedit_mm_loop", a, b, layout)
        this()
        old()
        torch.cuda.synchronize()
        exact = contraction(name) * REPS * (REPS + 1) // 2
        ok = bool((out == exact).all()) and bool((old_out == exact).all())
        turns = [("parent", old), ("this", this), ("this", this), ("parent", old)]
        ms = [best_ms(fn) for _, fn in turns]
        m, n, k = case_shape(name)
        plan = mp.core_plan(m, n, k)
        bound_ms = 2 * REPS * m * n * k / RATES[torch.float32] * 1e3
        print(f"{name:<10} float32 turns " + ", ".join(f"{w} {t:.4f}" for (w, _), t in
                                                       zip(turns, ms))
              + f" ms; bound {bound_ms:.5f} ms ({bound_ms / min(ms[1:3]):.1%}); tile "
              f"{plan.tile[0]}x{plan.tile[1]}, {plan.slices} slices ({plan.ksplits} K chunks "
              f"of {plan.chunk} x {plan.rsplits} rep ranges); both exact {ok}")
        records.append({"case": name, "turns": [[w, t] for (w, _), t in zip(turns, ms)],
                        "bound_ms": bound_ms, "share": bound_ms / min(ms[1:3]),
                        "slices": plan.slices, "tile": list(plan.tile), "exact": ok})
    return records


def f32_agreement(mine, parent) -> bool:
    """This tree's float32 ``hedit_mm_loop`` against the parent's on seeded
    operands, each case and a ragged one a layout: within 4 sqrt(64 K)
    2^-24 times the sum of each output's term magnitudes."""
    g = torch.Generator(device="cuda").manual_seed(5)
    agree = True
    for label, a_shape, b_shape, layout, k in seeded_cases():
        a, b = _operands(a_shape, b_shape, torch.float32, g)
        outs = []
        for lib in (mine, parent):
            call, out = _entry_call(lib, "hedit_mm_loop", a, b, layout)
            call()
            outs.append(out)
        tol = 4 * math.sqrt(REPS * k) * 2.0 ** -24 * mp.mm_loop_magnitude(a, b, layout)
        ratio = ((outs[0] - outs[1]).abs() / tol).max().item()
        agree &= ratio <= 1.0
        print(f"float32 hedit_mm_loop {label} ({layout}): |this - parent| / tol at most "
              f"{ratio:.3e} {'OK' if ratio <= 1.0 else 'FAIL'}")
    return agree


def bf16_identity(mine, parent) -> bool:
    """This tree's bf16 ``hedit_mm_loop_tc`` against the parent's, bit for
    bit, on seeded operands: each case and a ragged one a layout."""
    g = torch.Generator(device="cuda").manual_seed(6)
    same = True
    for label, a_shape, b_shape, layout, _ in seeded_cases():
        a, b = _operands(a_shape, b_shape, torch.bfloat16, g)
        outs = []
        for lib in (mine, parent):
            call, out = _entry_call(lib, "hedit_mm_loop_tc", a, b, layout)
            call()
            outs.append(out)
        torch.cuda.synchronize()
        equal = torch.equal(*outs)
        same &= equal
        print(f"bf16 hedit_mm_loop_tc {label} ({layout}): "
              f"{'bit-identical to the parent' if equal else 'DIFFERS from the parent'}")
    return same


def _build_parent(csrc: Path):
    """The parent's two row-12 sources, each built alone into one library
    whose entry points take the arguments the parent's sources declare."""
    libs = {}
    for src, entry in (("mm_probe.cu", "hedit_mm_loop"), ("mm_probe_tc.cu", "hedit_mm_loop_tc")):
        lib, info = build_alone(csrc / src, _build.BUILD_DIR / f"{Path(src).stem}_parent.so",
                                csrc)
        getattr(lib, entry).argtypes = _c_argtypes(csrc / src, entry)
        print(f"ptxas, the parent's {src}: {info}")
        libs[entry] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit, timed in turns with this tree")
    args = ap.parse_args(argv)
    report, ok = {}, True
    for dtype, key in ((torch.bfloat16, "mm_probe"), (torch.float32, "mm_probe_f32")):
        results = report[key] = run(args.reps, dtype=dtype, library=True, timer=cuda_graph_ms)
        print(f"mm_probe: reps={REPS} M={M} N={N} {str(dtype)[6:]}, "
              f"{torch.cuda.get_device_name(0)}")
        for name, r in results.items():
            m, n, k = case_shape(name)
            bound_ms = 2 * REPS * m * n * k / RATES[dtype] * 1e3
            r["bound_ms"] = bound_ms
            print(f"{name:<10} K={k:<5} {r['us_per_matmul']:9.3f} us/matmul  "
                  f"({r['x_vs_padded']:4.2f}x vs padded)  library "
                  f"{r['library_ms'] * 1e3 / REPS:9.3f} us/matmul  bound {bound_ms:.5f} ms "
                  f"({bound_ms / r['ms']:.1%})  exact {r['exact']}")
        ok &= all(r["exact"] for r in results.values())
    pad = report["mm_probe"]["qk_tlhs"]["ms"] / report["mm_probe"]["qk_tlhs48"]["ms"]
    print(f"K padding on the tensor cores: qk_tlhs (K = 40) takes {pad:.3f}x qk_tlhs48 (K = 48)")
    if args.parent is not None:
        parent = _build_parent(args.parent / "hedit_tpu_torch" / "csrc")
        _, info = build_alone(_build.CSRC / "mm_probe.cu", _build.BUILD_DIR / "mm_probe_this.so",
                              _build.CSRC)
        print(f"ptxas, this tree's mm_probe.cu: {info}")
        mine = _build.cuda_library()
        report["parent_turns"] = parent_turns(mine, parent["hedit_mm_loop"])
        ok &= all(r["exact"] for r in report["parent_turns"])
        ok &= f32_agreement(mine, parent["hedit_mm_loop"])
        ok &= bf16_identity(mine, parent["hedit_mm_loop_tc"])
    print(json.dumps(report))
    if not ok:
        print("FAILED: an all-ones output is not K * 2080, the float32 outputs differ beyond "
              "the tolerance, or a bf16 output differs from the parent's")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
