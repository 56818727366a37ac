"""Rows 8-11 (ablations, the variants, exact exp2, bounded probes) on the card, beside the parent's.

    python -m hedit_tpu_torch.probes.flash_probe_tiles [--parent DIR]

Times ``csrc/flash_probes_tc.cu`` on the card:

* row 11 (entry point ``hedit_flash_packed_t_tc``) in its three layouts, 0
  (q, k, v ``[BH, S, D]``: row 11a, ``_packed_t_kernel``), 1 (q, k
  ``[BH, D, S]``, v ``[BH, S, D]``: row 11b, ``_packed_t_kernel_sminor``)
  and 2 (q, k, v ``[BH, D, S]``: row 11c, ``_packed_t_kernel_all_sminor``),
  at ``CASES``: the probe's [16, 8, 4096, 40] and [16, 8, 1024, 80],
  anchored on the first 512 keys; beside it the packed bounded tensor-core
  kernel on ``[B, S, H*D]`` (the port's own route: the ratio is what the
  probe's layout costs);
* row 10 (entry point ``hedit_flash_exp2_t_tc``) in its two key loops at
  ``EXP2_CASES``: the probe's [4, 32, 4096, 40] and [4, 32, 1024, 80]; the
  two loops' outputs must be bit-identical; and at d = 40 once for each
  of ``VARIANTS`` (the exact loops' blocks an SM, the source built with
  ``-DEXP2_MINB_40=n``, one ``nvcc`` each, all started together; variant 0
  is the source's default, whose ``-Xptxas -v`` lines are the shipped
  instances'), in turns with variant 0;
* row 8 (entry point ``hedit_flash_ablate_t_tc``), ``dots``, ``exp`` and
  ``noprolog``, at ``ABLATE_CASES``: the probe's [4, 32, 4096, 40] and
  [4, 32, 1024, 80], q and k times 0.05 as the probe draws them; at d = 40
  also at 4 blocks an SM (``-DABLATE_MINB_40=4``) in turns with the source's
  5; SDPA with scale ln 2 beside it.  ``dots`` is held on its own scores and
  sums (``fp.check_ablate_dots_kernel``), the others to their plain
  versions;
* row 9 d (entry point ``hedit_flash_variant_tc``, ``kern_a`` with
  ``pv_bf16``) at the probe's [32, 4096, 40], and at each of ``VARIANTS``
  (its budget is the exact loops' ``EXP2_MINB_40``); SDPA in bf16 beside
  it;
* rows 9 a, b (entry point ``hedit_flash_variant``, codes 0 and 2, the
  query-major kernel of ``csrc/flash_variants.cu``), float32 9 d (code 1,
  the same kernel) and 9 c (``hedit_flash_variant_c``) at
  ``VARIANT_CORE_CASES``: the probe's [32, 4096, 40] in bf16 and the
  smoke's [8, 4096, 40] in float32, beside SDPA on the float32 inputs and
  the bound (QK at the inputs' rate, PV at 67 TFLOP/s; float32 d's PV at
  67 too: JAX promotes its bf16 p to the float32 v);
* rows 11a-c and 8 in float32 (entry points ``hedit_flash_packed_t`` and
  ``hedit_flash_ablate_t``, the same query-major kernel) at ``F32_CASES``:
  the smoke's [2, 8, 4096, 40] (row 11, anchored on 512 keys) and
  [1, 8, 4096, 40] (row 8, q and k times 0.05), and their d = 80
  counterparts at 1024 tokens, beside SDPA in float32 (row 8: scale ln 2)
  and the bound (4 B H S^2 D operations at 67 TFLOP/s).  Outputs held to
  the plain versions within 1e-4 (``dots``: within
  ``ablate_dots_tolerance``, at most 0.1% of rows excused);
* row 10 in float32 (entry point ``hedit_flash_exp2_t``, the same
  query-major kernel) in its two key loops at ``EXP2_F32_CASES``: the
  smoke's [1, 8, 4096, 40] and [1, 8, 1024, 80], beside SDPA in float32 and
  the same bound; held to the plain version at the kernel's key tile
  (``fp.exp2_key_tile``) within 1e-4, the two loops bit for bit.

Each kernel is launched through its entry point without the wrappers' host
checks (CUDA-event means of 20 launches, best of 3), beside SDPA on the same
``[B, H, S, D]`` values and the bound (4 B H S^2 D operations at 989
TFLOP/s), and its output is held to its plain version before the final
rounding (largest error over 2^-8 of the largest value, as
``chip_smoke.py`` holds it).  Each build prints ``-Xptxas -v``'s registers
and spills of each instance.

``--parent DIR``: a checkout of an earlier commit of this repository (for
example ``git archive <commit> | tar -x -C DIR``).  Its entries of the
rows this tree's kernels compute are timed in turns with this tree's
(parent, this, this, parent) where the parent takes the call: the bf16
rows 8, 9 d, 10 and 11 in its ``csrc/flash_probes_tc.cu``, rows 9 a, b, c,
float32 d, and float32 8, 10 and 11 in its ``csrc/flash_variants.cu``
(float32 row 10 in whichever of its sources defines
``hedit_flash_exp2_t``: an earlier parent's CUDA-core template).  Its
``csrc/flash_attention_tc.cu``, ``csrc/flash_probes_tc.cu``,
``csrc/flash_variants.cu`` and that source are built beside this tree's,
and these outputs of the two must agree bit for bit: the bounded, LSE and exact tensor-core forwards on the
smoke's inputs (``flash_exact_tiles.identity``), rows 8 ``exp`` /
``noprolog``, 9 d, 10 and 11a-c on the tensor cores, rows 9 a, b and
float32 d on the query-major kernel, row 9 c in both dtypes, and float32
rows 8, 10 and 11 where the parent's ``csrc/flash_variants.cu`` holds them
(``kept_identity``; a parent whose template still computes one is not
held to it, which is then held to its plain version only).  The probe exits
non-zero if any differs.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_probes as fp
from hedit_tpu_torch.probes.flash_exact_tiles import _call, identity
from hedit_tpu_torch.probes.timing import best_ms, build_alone, require_cuda

OUT_DIR = _build.BUILD_DIR / "probe_tiles"
TC_SOURCE = _build.CSRC / "flash_probes_tc.cu"
# (batch, heads, S, D): the bounded probe's shape and the UNet's d = 80 level
CASES = ((16, 8, 4096, 40), (16, 8, 1024, 80))
# the exp2 probe's shape and its d = 80 counterpart
EXP2_CASES = ((4, 32, 4096, 40), (4, 32, 1024, 80))
# the entry point's layout codes and the probes' layout names
LAYOUTS = {0: "packed_t", 1: "packed_t_sminor", 2: "packed_t_all_sminor"}
# the blocks an SM of the exact probe's two loops and row 9 d at d = 40 (the
# source's EXP2_MINB_40; the bounded probes keep 5); variant 0 is the
# source's default
VARIANTS = (4, 5, 3)
# the ablations' shapes, and their other budget at d = 40 (ABLATE_MINB_40;
# the source's is 5)
ABLATE_CASES = ((4, 32, 4096, 40), (4, 32, 1024, 80))
ABLATE_MINB = 4
# row 9 d's [B*H, S, D]
VARIANT_SHAPE = (32, 4096, 40)
# rows 9 a, b, c and float32 d: the probe's in bf16, the smoke's float32 case
VARIANT_CORE_CASES = (((32, 4096, 40), torch.bfloat16), ((8, 4096, 40), torch.float32))
# rows 11 and 8 in float32: the smoke's shapes and their d = 80 counterparts
F32_CASES = {"packed_t": ((2, 8, 4096, 40), (2, 8, 1024, 80)),
             "ablate": ((1, 8, 4096, 40), (1, 8, 1024, 80))}
# row 10 in float32: the smoke's shapes
EXP2_F32_CASES = ((1, 8, 4096, 40), (1, 8, 1024, 80))
# the parent's sources this probe builds, beside the one that defines float32 row 10
PARENT_SOURCES = ("flash_variants.cu", "flash_attention_tc.cu", "flash_probes_tc.cu")
F32_PEAK_FLOPS = 67e12
F32_TOL = 1e-4
PEAK_FLOPS = 989e12
# the rate of each type's products (rows 9 a-c: QK in the inputs' type, PV in float32)
RATES = {torch.bfloat16: PEAK_FLOPS, torch.float32: 67e12}


def _sminor(t):
    return t.transpose(-1, -2).contiguous()


def _entry_call(lib, entry, args, out, ints):
    """A launch of ``entry`` on ``args`` writing ``out``; ``ints`` are the
    entry point's integers before the dtype (``args[0]``'s: 1 bf16, 0
    float32)."""
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, entry)
    dtype = int(args[0].dtype == torch.bfloat16)

    def call():
        err = fn(*(t.data_ptr() for t in (*args, out)), *ints, dtype, stream)
        if err:
            raise RuntimeError(f"{entry} failed (code {err})")
    return call


def _err(out, plain):
    """The largest error over 2^-8 of the plain output's largest value."""
    return (out.float() - plain).abs().max().item() / (2.0 ** -8 * plain.abs().max().item())


def _turns(mine, parent, entry, args, out, ints):
    """(who, call) pairs in turns: parent, this, this, parent; this alone
    where there is no parent, it has no ``entry`` or its ``entry`` refuses
    the call."""
    turns = [("this tree", mine)]
    if parent is None or not hasattr(parent, entry):
        return turns
    theirs = _entry_call(parent, entry, args, torch.empty_like(out), ints)
    try:
        theirs()
    except RuntimeError as e:
        print(f"  the parent's {entry} takes no such call ({e}): no parent turns")
        return turns
    return [("parent", theirs), *turns, *turns, ("parent", theirs)]


def _timed(label, turns, sdpa, bound_ms, err, extra=""):
    ms = [best_ms(fn) for _, fn in turns]
    tc_ms = min(t for (who, _), t in zip(turns, ms) if who == "this tree")
    print(f"{label}: " + ", ".join(f"{who} {t:.4f}" for (who, _), t in zip(turns, ms))
          + f" ms;{extra} SDPA {sdpa:.4f} ms, kernel / SDPA {tc_ms / sdpa:.3f}; "
          f"bound {bound_ms:.4f} ms ({bound_ms / tc_ms:.1%}); out err / tol {err:.3f}")
    return [[who, t] for (who, _), t in zip(turns, ms)]


def _qkv(b, h, s, d, scales=(1.0, 1.0, 1.0), dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(s + d)
    return [(torch.randn(b, h, s, d, generator=g, device="cuda") * c).to(dtype) for c in scales]


def bounded_timings(mine, parent):
    """Row 11's three layouts at ``CASES``; one record a case and layout."""
    records = []
    for b, h, s, d in CASES:
        q, k, v = _qkv(b, h, s, d)
        packed = [t.transpose(1, 2).reshape(b, s, h * d).contiguous() for t in (q, k, v)]
        route, _ = _call(mine, "hedit_flash_attention_fwd_packed_bounded_tc", *packed, heads=h)
        p_ms = best_ms(route)
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms = 4 * b * h * s * s * d / PEAK_FLOPS * 1e3
        del packed
        for layout, name in LAYOUTS.items():
            args = {0: (q, k, v), 1: (_sminor(q), _sminor(k), v),
                    2: (_sminor(q), _sminor(k), _sminor(v))}[layout]
            out = torch.empty(b, h * d, s, dtype=torch.bfloat16, device="cuda")
            ints = (b * h, s, s, d, fp.BLK_K, layout)
            tc = _entry_call(mine, "hedit_flash_packed_t_tc", args, out, ints)
            tc()
            plain = getattr(fp, f"flash_{name}_reference")(*args, fp.BLK_K,
                                                           out_dtype=torch.float32)
            torch.cuda.synchronize()
            err = _err(out, plain)
            del plain
            torch.cuda.empty_cache()
            turns = _turns(tc, parent, "hedit_flash_packed_t_tc", args, out, ints)
            label = f"{name} (layout {layout}) q[{b}, {h}, {s}, {d}] bf16"
            ms = _timed(label, turns, sdpa, bound_ms, err,
                        f" packed bounded (tensor cores) {p_ms:.4f} ms;")
            records.append({"probe": name, "shape": [b, h, s, d], "turns": ms,
                            "packed_bounded_ms": p_ms, "sdpa_ms": sdpa, "bound_ms": bound_ms,
                            "err_over_tol": err})
            del args, out
        del q, k, v
        torch.cuda.empty_cache()
    return records


def exp2_timings(mine, parent, variants):
    """Row 10's two loops at ``EXP2_CASES``, then the d = 40 variants; one
    record a case and loop."""
    records = []
    for b, h, s, d in EXP2_CASES:
        q, k, v = _qkv(b, h, s, d)
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms = 4 * b * h * s * s * d / PEAK_FLOPS * 1e3
        plain = fp.flash_exp2_t_reference(q, k, v, out_dtype=torch.float32)
        outs = []
        for pipe in (0, 1):
            out = torch.empty(b * h, d, s, dtype=torch.bfloat16, device="cuda")
            ints = (b * h, s, s, d, pipe)
            tc = _entry_call(mine, "hedit_flash_exp2_t_tc", (q, k, v), out, ints)
            tc()
            torch.cuda.synchronize()
            err = _err(out, plain)
            outs.append(out)
            label = f"exp2_t pipe={pipe} q[{b}, {h}, {s}, {d}] bf16"
            ms = _timed(label, _turns(tc, parent, "hedit_flash_exp2_t_tc", (q, k, v), out, ints),
                        sdpa, bound_ms, err)
            records.append({"probe": f"exp2_t pipe={pipe}", "shape": [b, h, s, d], "turns": ms,
                            "sdpa_ms": sdpa, "bound_ms": bound_ms, "err_over_tol": err})
        same = torch.equal(outs[0].view(torch.int16), outs[1].view(torch.int16))
        records[-1]["pipe_bit_identical"] = records[-2]["pipe_bit_identical"] = same
        print(f"exp2_t q[{b}, {h}, {s}, {d}]: pipe=1 "
              f"{'bit-identical to' if same else 'DIFFERS from'} pipe=0")
        if d == 40:
            for pipe in (0, 1):
                calls = [_entry_call(lib, "hedit_flash_exp2_t_tc", (q, k, v), outs[pipe],
                                     (b * h, s, s, d, pipe)) for lib in variants]
                ms = [best_ms(calls[i]) for i in [*range(len(variants)), 0]]
                print(f"exp2_t pipe={pipe} q[{b}, {h}, {s}, {d}] variants (blocks an SM): "
                      + ", ".join(
                          f"{VARIANTS[i]} {t:.4f}" for i, t in
                          zip([*range(len(variants)), 0], ms)) + " ms")
        del q, k, v, plain, outs
        torch.cuda.empty_cache()
    return records


def ablate_timings(mine, parent, minb):
    """Row 8's three modes at ``ABLATE_CASES``, at d = 40 in turns with the
    source built at ``ABLATE_MINB`` blocks an SM; one record a case and
    mode.  ``dots`` is held on its own numbers: the record's err_over_tol is
    its output's largest error over tolerance, and its other checks must
    hold too."""
    records = []
    for b, h, s, d in ABLATE_CASES:
        q, k, v = _qkv(b, h, s, d, scales=(0.05, 0.05, 1.0))
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=math.log(2.0)))
        bound_ms = 4 * b * h * s * s * d / PEAK_FLOPS * 1e3
        for mode in fp.ABLATE_MODES:
            out = torch.empty(b * h, d, s, dtype=torch.bfloat16, device="cuda")
            ints = (b * h, s, s, d, fp.ABLATE_MODES.index(mode))
            tc = _entry_call(mine, "hedit_flash_ablate_t_tc", (q, k, v), out, ints)
            tc()
            extra = {}
            if mode == "dots":
                worst = fp.check_ablate_dots_kernel(q, k, v, out)
                held = (worst["bit_identical"] and worst["sums_differing_rows"] == 0
                        and worst["score_err_over_tol"] <= 1.0)
                err = worst["out_err_over_tol"] if held else math.inf
                extra = {"dots_check": worst}
                print(f"ablate dots q[{b}, {h}, {s}, {d}] on its own numbers: {worst}")
            else:
                plain = fp.flash_ablate_t_reference(q, k, v, mode, out_dtype=torch.float32)
                torch.cuda.synchronize()
                err = _err(out, plain)
                del plain
            torch.cuda.empty_cache()
            label = f"ablate {mode} q[{b}, {h}, {s}, {d}] bf16"
            ms = _timed(label, _turns(tc, parent, "hedit_flash_ablate_t_tc", (q, k, v), out, ints),
                        sdpa, bound_ms, err)
            records.append({"probe": f"ablate {mode}", "shape": [b, h, s, d], "turns": ms,
                            "sdpa_ms": sdpa, "bound_ms": bound_ms, "err_over_tol": err, **extra})
            if d == 40:
                other = _entry_call(minb, "hedit_flash_ablate_t_tc", (q, k, v), out, ints)
                t = [best_ms(fn) for fn in (tc, other, other, tc)]
                print(f"ablate {mode} q[{b}, {h}, {s}, {d}] blocks an SM: 5 {t[0]:.4f}, "
                      f"{ABLATE_MINB} {t[1]:.4f}, {ABLATE_MINB} {t[2]:.4f}, 5 {t[3]:.4f} ms")
                records[-1]["minb_turns"] = [[5, t[0]], [ABLATE_MINB, t[1]],
                                             [ABLATE_MINB, t[2]], [5, t[3]]]
            del out
        del q, k, v
        torch.cuda.empty_cache()
    return records


def variant_timings(mine, parent, variants):
    """Row 9 d at ``VARIANT_SHAPE``, then at each of ``VARIANTS``; one record."""
    bh, s, d = VARIANT_SHAPE
    q, k, v = (t[0] for t in _qkv(1, bh, s, d))
    sdpa = best_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]))
    bound_ms = 4 * bh * s * s * d / PEAK_FLOPS * 1e3
    out = torch.empty(bh, s, d, dtype=torch.bfloat16, device="cuda")
    ints = (bh, s, s, d, 1)
    tc = _entry_call(mine, "hedit_flash_variant_tc", (q, k, v), out, ints)
    tc()
    plain = fp.flash_variant_a_reference(q, k, v, pv_bf16=True, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = _err(out, plain)
    del plain
    label = f"variant d q[{bh}, {s}, {d}] bf16"
    ms = _timed(label, _turns(tc, parent, "hedit_flash_variant_tc", (q, k, v), out, ints), sdpa,
                bound_ms, err)
    calls = [_entry_call(lib, "hedit_flash_variant_tc", (q, k, v), out, ints)
             for lib in variants]
    order = [*range(len(variants)), 0]
    t = [best_ms(calls[i]) for i in order]
    print(f"{label} variants (blocks an SM): "
          + ", ".join(f"{VARIANTS[i]} {x:.4f}" for i, x in zip(order, t)) + " ms")
    return [{"probe": "variant d", "shape": [bh, s, d], "turns": ms, "sdpa_ms": sdpa,
             "bound_ms": bound_ms, "err_over_tol": err,
             "minb_ms": [[VARIANTS[i], x] for i, x in zip(order, t)]}]


def variant_core_timings(mine, parent):
    """Rows 9 a, b, float32 d (``hedit_flash_variant``, codes 0, 2, 1) and c
    (``hedit_flash_variant_c``) at ``VARIANT_CORE_CASES``, each in turns
    with the parent's entry where it takes the call; one record a case and
    variant.  err_over_tol: bf16 over 2^-8 of the largest value, float32
    over 1e-4, against the plain versions (d with its 64-key blocks)."""
    records = []
    for (bh, s, d), dtype in VARIANT_CORE_CASES:
        q, k, v = (t[0] for t in _qkv(1, bh, s, d, dtype=dtype))
        q32, k32, v32 = (t.float()[None] for t in (q, k, v))
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(q32, k32, v32))
        del q32, k32, v32
        bound_ms = 2 * bh * s * s * d * (1 / RATES[dtype] + 1 / RATES[torch.float32]) * 1e3
        names = "abc" + ("d" if dtype == torch.float32 else "")
        for name in names:
            code = {"a": 0, "d": 1, "b": 2}.get(name)
            entry = "hedit_flash_variant" + ("_c" if name == "c" else "")
            ints = (bh, s, s, d) if name == "c" else (bh, s, s, d, code)
            out = torch.empty((bh, d, s) if name in "bc" else (bh, s, d), dtype=dtype,
                              device="cuda")
            kernel = _entry_call(mine, entry, (q, k, v), out, ints)
            kernel()
            plain = (fp.flash_variant_b_reference(q, k, v) if name in "bc" else
                     fp.flash_variant_a_reference(q, k, v, pv_bf16=name == "d")).float()
            torch.cuda.synchronize()
            err = ((out.float() - plain).abs().max().item() / 1e-4 if dtype == torch.float32
                   else _err(out, plain))
            del plain
            label = f"variant {name} q[{bh}, {s}, {d}] {str(dtype)[6:]}"
            ms = _timed(label, _turns(kernel, parent, entry, (q, k, v), out, ints), sdpa,
                        bound_ms, err)
            records.append({"probe": f"variant {name} {str(dtype)[6:]}", "shape": [bh, s, d],
                            "turns": ms, "sdpa_ms": sdpa, "bound_ms": bound_ms,
                            "err_over_tol": err})
            del out
        del q, k, v
        torch.cuda.empty_cache()
    return records


def qm_f32_timings(mine, parent):
    """Rows 11a-c and 8 in float32 at ``F32_CASES``, each in turns with the
    parent's same entry point (its ``csrc/flash_variants.cu``) where it takes
    the call; one record a case and layout or mode.  err_over_tol: over 1e-4
    against the plain version; ``dots`` over ``ablate_dots_tolerance``, the
    excused rows beside it (inf where more than 0.1% of them)."""
    records = []
    for b, h, s, d in F32_CASES["packed_t"]:
        q, k, v = _qkv(b, h, s, d, dtype=torch.float32)
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms = 4 * b * h * s * s * d / F32_PEAK_FLOPS * 1e3
        for layout, name in LAYOUTS.items():
            args = {0: (q, k, v), 1: (_sminor(q), _sminor(k), v),
                    2: (_sminor(q), _sminor(k), _sminor(v))}[layout]
            out = torch.empty(b, h * d, s, device="cuda")
            ints = (b * h, s, s, d, fp.BLK_K, layout)
            kernel = _entry_call(mine, "hedit_flash_packed_t", args, out, ints)
            kernel()
            plain = getattr(fp, f"flash_{name}_reference")(*args, fp.BLK_K)
            torch.cuda.synchronize()
            err = (out - plain).abs().max().item() / F32_TOL
            del plain
            torch.cuda.empty_cache()
            label = f"{name} (layout {layout}) q[{b}, {h}, {s}, {d}] float32"
            ms = _timed(label, _turns(kernel, parent, "hedit_flash_packed_t", args, out, ints),
                        sdpa, bound_ms, err)
            records.append({"probe": f"{name} float32", "shape": [b, h, s, d], "turns": ms,
                            "sdpa_ms": sdpa, "bound_ms": bound_ms, "err_over_tol": err})
            del args, out
        del q, k, v
        torch.cuda.empty_cache()
    for b, h, s, d in F32_CASES["ablate"]:
        q, k, v = _qkv(b, h, s, d, scales=(0.05, 0.05, 1.0), dtype=torch.float32)
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=math.log(2.0)))
        bound_ms = 4 * b * h * s * s * d / F32_PEAK_FLOPS * 1e3
        for code, mode in enumerate(fp.ABLATE_MODES):
            out = torch.empty(b * h, d, s, device="cuda")
            ints = (b * h, s, s, d, code)
            kernel = _entry_call(mine, "hedit_flash_ablate_t", (q, k, v), out, ints)
            kernel()
            plain = fp.flash_ablate_t_reference(q, k, v, mode)
            torch.cuda.synchronize()
            extra = {}
            if mode == "dots":
                tol, excused = fp.ablate_dots_tolerance(q, k, v, plain)
                ratio = ((out - plain).abs() / tol).masked_fill(excused[:, None, :], 0.0)
                share = excused.float().mean().item()
                err = ratio.max().item() if share <= 1e-3 else math.inf
                extra = {"excused_rows": int(excused.sum()), "row_count": excused.numel()}
                del tol, excused, ratio
            else:
                err = (out - plain).abs().max().item() / F32_TOL
            del plain
            torch.cuda.empty_cache()
            label = f"ablate {mode} q[{b}, {h}, {s}, {d}] float32"
            ms = _timed(label, _turns(kernel, parent, "hedit_flash_ablate_t", (q, k, v), out, ints),
                        sdpa, bound_ms, err, f" {extra}" if extra else "")
            records.append({"probe": f"ablate {mode} float32", "shape": [b, h, s, d], "turns": ms,
                            "sdpa_ms": None if mode == "dots" else sdpa, "bound_ms": bound_ms,
                            "err_over_tol": err, **extra})
            del out
        del q, k, v
        torch.cuda.empty_cache()
    return records


def exp2_f32_timings(mine, parent):
    """Row 10 in float32, both loops, at ``EXP2_F32_CASES``, each in turns
    with ``parent``'s ``hedit_flash_exp2_t`` where it takes the call; one
    record a case and loop.  err_over_tol: over 1e-4 against the plain
    version with the kernel's key tile; the loops' outputs bit for bit."""
    records = []
    for b, h, s, d in EXP2_F32_CASES:
        q, k, v = _qkv(b, h, s, d, dtype=torch.float32)
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms = 4 * b * h * s * s * d / F32_PEAK_FLOPS * 1e3
        plain = fp.flash_exp2_t_reference(q, k, v, blk_k=fp.exp2_key_tile(torch.float32, d))
        outs = []
        for pipe in (0, 1):
            out = torch.empty(b * h, d, s, device="cuda")
            ints = (b * h, s, s, d, pipe)
            kernel = _entry_call(mine, "hedit_flash_exp2_t", (q, k, v), out, ints)
            kernel()
            torch.cuda.synchronize()
            err = (out - plain).abs().max().item() / F32_TOL
            outs.append(out)
            label = f"exp2_t pipe={pipe} q[{b}, {h}, {s}, {d}] float32"
            ms = _timed(label, _turns(kernel, parent, "hedit_flash_exp2_t", (q, k, v), out, ints),
                        sdpa, bound_ms, err)
            records.append({"probe": f"exp2_t pipe={pipe} float32", "shape": [b, h, s, d],
                            "turns": ms, "sdpa_ms": sdpa, "bound_ms": bound_ms,
                            "err_over_tol": err})
        same = torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
        records[-1]["pipe_bit_identical"] = records[-2]["pipe_bit_identical"] = same
        print(f"exp2_t q[{b}, {h}, {s}, {d}] float32: pipe=1 "
              f"{'bit-identical to' if same else 'DIFFERS from'} pipe=0")
        del q, k, v, plain, outs
        torch.cuda.empty_cache()
    return records


def _same(mine, parent, entry, args, out_shape, ints):
    """``entry`` of this tree and of the parent on ``args``, bit for bit."""
    outs = [torch.empty(out_shape, dtype=args[0].dtype, device="cuda") for _ in range(2)]
    for lib, out in zip((mine, parent), outs):
        _entry_call(lib, entry, args, out, ints)()
    torch.cuda.synchronize()
    return torch.equal(*(o.view(torch.int16 if o.dtype == torch.bfloat16 else torch.int32)
                         for o in outs))


def kept_identity(mine, parent_tc, parent_variants) -> bool:
    """The outputs this tree keeps from the parent, bit for bit: rows 11a-c,
    10, 8 ``exp`` / ``noprolog`` and 9 d on the tensor cores (bf16); rows 9
    a, b (both dtypes) and float32 d on the query-major kernel, row 9 c in
    both dtypes, and rows 11a-c, 8 (all three modes) and 10 (both loops) in
    float32, each where the parent's ``csrc/flash_variants.cu`` has its entry
    (a parent whose template still computes one in float32 is not held to
    it)."""
    cases = []
    for b, h, s, d in ((2, 4, 1024, 40), (2, 3, 576, 80)):
        anchor = 64 * 3 if s % fp.BLK_K else fp.BLK_K
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(b, h, s, d, scales=(0.05, 0.05, 1.0), dtype=dtype)
            lib = parent_tc if dtype == torch.bfloat16 else parent_variants
            if dtype == torch.bfloat16:
                for layout in LAYOUTS:
                    args = {0: (q, k, v), 1: (_sminor(q), _sminor(k), v),
                            2: (_sminor(q), _sminor(k), _sminor(v))}[layout]
                    cases.append((f"hedit_flash_packed_t_tc layout {layout}", lib,
                                  "hedit_flash_packed_t_tc", args, (b * h, d, s),
                                  (b * h, s, s, d, anchor, layout), dtype))
                for code in (1, 2):
                    cases.append((f"hedit_flash_ablate_t_tc mode {code}", lib,
                                  "hedit_flash_ablate_t_tc", (q, k, v), (b * h, d, s),
                                  (b * h, s, s, d, code), dtype))
            elif hasattr(parent_variants, "hedit_flash_packed_t"):
                for layout in LAYOUTS:
                    args = {0: (q, k, v), 1: (_sminor(q), _sminor(k), v),
                            2: (_sminor(q), _sminor(k), _sminor(v))}[layout]
                    cases.append((f"hedit_flash_packed_t layout {layout}", parent_variants,
                                  "hedit_flash_packed_t", args, (b * h, d, s),
                                  (b * h, s, s, d, anchor, layout), dtype))
                for code in range(len(fp.ABLATE_MODES)):
                    cases.append((f"hedit_flash_ablate_t mode {code}", parent_variants,
                                  "hedit_flash_ablate_t", (q, k, v), (b * h, d, s),
                                  (b * h, s, s, d, code), dtype))
            entry = "hedit_flash_exp2_t" + ("_tc" if dtype == torch.bfloat16 else "")
            if hasattr(lib, entry):
                for pipe in (0, 1):
                    cases.append((f"{entry} pipe {pipe}", lib, entry, (q, k, v), (b * h, d, s),
                                  (b * h, s, s, d, pipe), dtype))
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t[0] for t in _qkv(1, 8, 1024, 40, dtype=dtype))
        if hasattr(parent_variants, "hedit_flash_variant_c"):
            cases.append(("hedit_flash_variant_c", parent_variants, "hedit_flash_variant_c",
                          (q, k, v), (8, 40, 1024), (8, 1024, 1024, 40), dtype))
        for code in (0, 2) + ((1,) if dtype == torch.float32 else ()):
            cases.append((f"hedit_flash_variant {code}", parent_variants, "hedit_flash_variant",
                          (q, k, v), (8, 40, 1024) if code == 2 else (8, 1024, 40),
                          (8, 1024, 1024, 40, code), dtype))
        if dtype == torch.bfloat16:
            cases.append(("hedit_flash_variant_tc 1", parent_tc, "hedit_flash_variant_tc",
                          (q, k, v), (8, 1024, 40), (8, 1024, 1024, 40, 1), dtype))
    same = True
    for label, parent, entry, args, shape, ints, dtype in cases:
        equal = _same(mine, parent, entry, args, shape, ints)
        same &= equal
        print(f"identity {label} {str(dtype)[6:]} q{list(args[0].shape)}: "
              f"{'bit-identical to the parent' if equal else 'DIFFERS from the parent'}")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit")
    args = ap.parse_args(argv)
    require_cuda("flash_probe_tiles")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    builds = [(TC_SOURCE, f"variant{i}", _build.CSRC, (f"EXP2_MINB_40={n}",))
              for i, n in enumerate(VARIANTS)]
    builds.append((TC_SOURCE, "ablate_minb", _build.CSRC, (f"ABLATE_MINB_40={ABLATE_MINB}",)))
    # this tree's variants source alone, for its -Xptxas -v lines (rows 8,
    # 9 a-c, 10, 11)
    builds.append((_build.CSRC / "flash_variants.cu", "variants", _build.CSRC, ()))
    n = len(builds)
    if args.parent is not None:
        csrc = args.parent / "hedit_tpu_torch" / "csrc"
        sources = [csrc / name for name in PARENT_SOURCES]
        # float32 row 10 where the parent defines it in another source (the
        # CUDA-core template of a parent before the query-major kernel took it)
        sources += [p for p in sorted(csrc.glob("*.cu")) if p not in sources and re.search(
            r'extern "C" int hedit_flash_exp2_t\(', p.read_text())]
        builds += [(p, f"parent_{p.stem}", csrc, ()) for p in sources]
    with ThreadPoolExecutor(len(builds)) as ex:
        built = list(ex.map(lambda a: build_alone(a[0], OUT_DIR / f"{a[1]}.so", a[2], a[3]),
                            builds))
    for (source, name, *_), (_, info) in zip(builds, built):
        print(f"ptxas, {name} ({source.name}): {info}")
    mine = _build.cuda_library()
    variants = [lib for lib, _ in built[:len(VARIANTS)]]
    parent = {source.name: lib for (source, *_), (lib, _) in zip(builds[n:], built[n:])}
    parent_tc, parent_variants = parent.get("flash_probes_tc.cu"), parent.get("flash_variants.cu")
    parent_exp2 = next((lib for lib in parent.values() if hasattr(lib, "hedit_flash_exp2_t")), None)
    records = bounded_timings(mine, parent_tc)
    records += exp2_timings(mine, parent_tc, variants)
    records += ablate_timings(mine, parent_tc, built[len(VARIANTS)][0])
    records += variant_timings(mine, parent_tc, variants)
    records += variant_core_timings(mine, parent_variants)
    records += qm_f32_timings(mine, parent_variants)
    records += exp2_f32_timings(mine, parent_exp2)
    print(json.dumps({"flash_probe_tiles": records}))
    if args.parent is not None and not (
            identity(mine, parent["flash_attention_tc.cu"], exact=True)
            & kept_identity(mine, parent_tc, parent_variants)):
        print("FAILED: an output this tree keeps differs from the parent's")
        return 1
    bad = [r for r in records if not r["err_over_tol"] <= 1.0 or not r.get("pipe_bit_identical",
                                                                           True)]
    if bad:
        print(f"FAILED: outputs beyond 2^-8 of the largest value, or loops that differ: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
