"""The float32 forwards on the card: rows 1, 1p and 3 at d = 40 / 80,
(``--exact``) rows 6 and 7 at d = 40 / 80, or (``--d512``) rows 1, 3 and 6
at the VAE's d = 512.

    python -m hedit_tpu_torch.probes.flash_f32_tiles [--parent DIR]
    python -m hedit_tpu_torch.probes.flash_f32_tiles --exact [--parent DIR]
    python -m hedit_tpu_torch.probes.flash_f32_tiles --d512 [--parent DIR]

Times ``csrc/flash_attention_f32.cu`` (entry points
``hedit_flash_attention_fwd_f32``, ``..._packed_bounded_f32`` and
``..._lse_f32``) at ``CASES``: row 1 head-split at [4, 8, 1024, 80] and
[2, 8, 4096, 40], row 1p packed at [4, 1024, 8 x 80] and [2, 4096, 8 x 40],
row 3 at [1, 8, 1024, 80] and [1, 8, 4096, 40].  Each kernel is launched
through its entry point without the wrappers' host checks (CUDA-event means
of 20 launches, best of 3), beside SDPA on the same float32 values (TF32 off;
packed through strided head views) and the bound (4 B H Sq Sk D FLOP at the
float32 rate of 67 TFLOP/s), and its output is held to its plain version
(1e-4 absolute, lse2 1e-5 relative, as ``chip_smoke.py`` holds it).  The
source is also built once for each of ``VARIANTS`` (the blocks an SM the
register budget is set for, ``-DF32_MINB_40=n -DF32_MINB_80=n``; the inner
loops' unroll factor, ``-DF32_UNROLL=1``; and two timing ablations whose
outputs are wrong: no V copies, no exp2), one
``nvcc`` each, all started together; each variant is timed in turns with
the source's own, and every build prints ``-Xptxas -v``'s registers and
spills.  SDPA's float32 call is traced once with ``torch.profiler``: the
names of the kernels it launches say which backend is the yardstick.

``--parent DIR``: a checkout of an earlier commit of this repository (for
example ``git archive <commit> hedit_tpu_torch chip_smoke.py | tar -x -C
DIR``).  Its CUDA-core template (``csrc/flash_attention.cu``, whose float32
bounded instances at d = 40 / 80 served these rows before) is timed in turns
with this tree's kernel (parent, this, this, parent), and its sources are
built beside this tree's: these outputs of the two must agree bit for bit
on the same inputs, or the probe exits non-zero: the 21 outputs of
``csrc/flash_attention_tc.cu`` (``flash_exact_tiles.identity``), the
backward kernels' dq, dk, dv (tensor cores in bf16 at d = 40 / 80, the
template at d = 512 in both dtypes and, by its entry points, in bf16 at
d = 40 / 80), and the
template's forward outputs this tree keeps (float32 exact, float32 bounded
and LSE at d = 512, bf16 bounded LSE at d = 40 / 80), and the float32
kernel's bounded, LSE and packed bounded outputs (``kept_identity``).

``--exact``: the exact mode of ``csrc/flash_attention_f32.cu`` (entry points
``hedit_flash_attention_fwd_exact_f32`` and ``..._packed_exact_f32``) at
``EXACT_CASES``: row 6 head-split at [2, 8, 4096, 40], [4, 8, 1024, 80] and
ragged [1, 8, 1000, 80] against 1064 keys, row 7 packed at [2, 4096, 8 x 40]
and [4, 1024, 8 x 80]; each held within 1e-4 of its plain version at the key
tile of 64 and relaunched bit for bit, timed in turns with the parent's
template exact entries (``hedit_flash_attention_fwd_exact``,
``..._packed``; parent, this, this, parent), beside SDPA and the bound; then
the source built once for each of ``EXACT_VARIANTS`` (32 query rows a block,
the register budgets, the unroll, the ablations) and timed in turns with the
source's own, each held to the plain version where its output is meant to be
right.  With ``--parent`` only the parent's ``flash_attention.cu`` and
``flash_attention_f32.cu`` are built, and ``kept_identity`` holds the float32
kernel's bounded, LSE and packed bounded outputs and the template's kept
outputs bit for bit to the parent's; the probe exits non-zero if one
differs or an output is beyond its tolerance.

``--d512``: ``csrc/flash_attention_f32_512.cu`` (entry points
``hedit_flash_attention_fwd_f32_512``, ``..._lse_f32_512`` and
``..._exact_f32_512``) at [1, 1, 1024, 512] (the 256 px decode) and
[1, 1, 4096, 512], each mode held to its plain version and timed through its
entry point in turns with the parent's CUDA-core template in the same mode
(``hedit_flash_attention_fwd``, ``..._lse``, ``..._exact``; parent, this,
this, parent), beside SDPA and the bound; then the source built once for
each of ``D512_VARIANTS`` (the cluster size, the rows a block, which also
set a thread's register tiles, the ring's slots, the QK loop's unroll; one
``nvcc`` each, all started together with the parent's sources) and timed in
turns with the source's own, each build's ``-Xptxas -v`` registers and
spills printed, and how many clusters of 1, 2, 4 and 8 CTAs the card runs at
once.  With ``--parent`` the outputs this tree keeps are held bit
for bit to the parent's: the 21 tensor-core forward outputs, the backward
kernels' (tensor cores, the template, the fused float32 kernel's dk and
dv), the float32 kernel's at d = 40 / 80, the template's kept forward
instances and the probe kernels' (``flash_probe_tiles.kept_identity``); the
probe exits non-zero if one differs or an output is beyond its tolerance.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_attention as flash
from hedit_tpu_torch.probes.flash_exact_tiles import identity
from hedit_tpu_torch.probes.timing import best_ms, build_alone, require_cuda

OUT_DIR = _build.BUILD_DIR / "f32_tiles"
SOURCE = _build.CSRC / "flash_attention_f32.cu"
# (row, batch, heads, Sq, Sk, D): rows 1, 1p and 3 at the UNet's 32^2 and
# 64^2 self-attentions
CASES = (("1", 4, 8, 1024, 1024, 80), ("1p", 4, 8, 1024, 1024, 80), ("3", 1, 8, 1024, 1024, 80),
         ("1", 2, 8, 4096, 4096, 40), ("1p", 2, 8, 4096, 4096, 40), ("3", 1, 8, 4096, 4096, 40))
# (label, -D defines): the source's default first; other register budgets
# (blocks an SM at d = 40 and 80); the ablations, timed only
VARIANTS = (("3 blocks an SM", ()), ("2 blocks an SM", ("F32_MINB_40=2", "F32_MINB_80=2")),
            ("inner loops unrolled once", ("F32_UNROLL=1",)),
            ("no V copies", ("F32_ABLATE=1",)), ("no exp2", ("F32_ABLATE=2",)))
F32_FLOPS = 67e12
PARENT_SOURCES = ("flash_attention.cu", "flash_attention_tc.cu", "flash_attention_bwd.cu",
                  "flash_attention_bwd_tc.cu", "flash_attention_f32.cu")
# (row, (B, H, Sq, D), Sk): rows 6 and 7 (packed) in float32, exact
EXACT_CASES = (("6", (2, 8, 4096, 40), 4096), ("6", (4, 8, 1024, 80), 1024),
               ("6", (1, 8, 1000, 80), 1064), ("7", (2, 8, 4096, 40), 4096),
               ("7", (4, 8, 1024, 80), 1024))
# (label, -D defines) of the exact mode: the source's own first; the ablations
# (no V copies, no exp2) give wrong outputs and are timed only
EXACT_VARIANTS = (("64 rows a block (8 x 4 scores a thread), 2 blocks an SM", ()),
                  ("32 rows a block (4 x 4 scores), 3 blocks an SM",
                   ("F32_EXACT_ROWS=32", "F32_EXACT_MINB_40=3", "F32_EXACT_MINB_80=3")),
                  ("64 rows a block, 1 block an SM",
                   ("F32_EXACT_MINB_40=1", "F32_EXACT_MINB_80=1")),
                  ("32 rows, 4 blocks an SM",
                   ("F32_EXACT_ROWS=32", "F32_EXACT_MINB_40=4", "F32_EXACT_MINB_80=4")),
                  ("inner loops unrolled once", ("F32_UNROLL=1",)),
                  ("no V copies", ("F32_ABLATE=1",)), ("no exp2", ("F32_ABLATE=2",)))
EXACT_PARENT_SOURCES = ("flash_attention.cu", "flash_attention_f32.cu")
D512_SOURCE = _build.CSRC / "flash_attention_f32_512.cu"
# (row, Sq = Sk): rows 1, 3 and 6 at the 256 px decode's and the 512 px
# decode's VAE attention, one head of d = 512
D512_CASES = tuple((row, s) for s in (1024, 4096) for row in ("1", "3", "6"))
# (label, -D defines) of the d = 512 source: its own first
D512_VARIANTS = (("the source's: clusters of 2 or 8 by the grid, 32 rows, QK split 4", ()),
                 ("clusters of 8", ("F512_CLUSTER=8",)),
                 ("clusters of 4", ("F512_CLUSTER=4",)),
                 ("clusters of 2", ("F512_CLUSTER=2",)),
                 ("QK split 2 (8 x 4 partials)", ("F512_QK_SPLIT=2",)),
                 ("QK split 1 (4 x 4 scores)", ("F512_QK_SPLIT=1",)),
                 ("16 rows a block (PV 4 x 8, QK 8 x 4 partials)", ("F512_ROWS=16",)),
                 ("QK split 1, 4 ring slots", ("F512_QK_SPLIT=1", "F512_SLOTS=4")),
                 ("QK loop unrolled once", ("F512_UNROLL=1",)))


def _inputs(b, h, sq, sk, d, packed, seed=0, dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda") for s in (sq, sk, sk))
    if packed:
        q, k, v = (t.transpose(1, 2).reshape(b, -1, h * d) for t in (q, k, v))
    return [t.to(dtype).contiguous() for t in (q, k, v)]


def _forward(lib, entry, q, k, v, heads=None, lse=False, anchor=None):
    """(a launch of the bounded or exact forward ``entry`` through ``lib``,
    its outputs); packed when ``heads`` is given; dtype from q."""
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(q)
    if heads is not None:
        b, sq, hd = q.shape
        sk, d = k.shape[1], hd // heads
        ints, tail = (b, heads, sq, sk, d), (sq * hd, sk * hd, sk * hd)
    else:
        b, h, sq, d = q.shape
        sk = k.shape[2]
        ints, tail = (b * h, sq, sk, d), ()
    if "exact" not in entry and not entry.endswith("_packed"):
        ints += (flash.bounded_anchor(sk, d) if anchor is None else anchor,)
    ptrs = [q, k, v, out]
    if lse:
        ptrs.append(torch.empty(ints[0], 1, sq, device="cuda"))
    fn = getattr(lib, entry)
    dtype = int(q.dtype == torch.bfloat16)

    def call():
        err = fn(*(t.data_ptr() for t in ptrs), *ints, *tail, dtype, stream)
        if err:
            raise RuntimeError(f"{entry} failed (code {err})")
    return call, ptrs[3:]


def _split(t, heads):
    b, s, hd = t.shape
    return t.reshape(b, s, heads, hd // heads).transpose(1, 2)


def _entries(row):
    """(this tree's entry point, the parent template's, packed, lse) of a row."""
    packed, lse = row == "1p", row == "3"
    mine = flash.lse_entry(torch.float32, 80) if lse else flash.bounded_entry(torch.float32,
                                                                               packed, 80)
    return mine, mine[:-len("_f32")], packed, lse


def _errors(row, q, k, v, h, outs):
    """(largest out error, largest lse2 relative error) against the plain
    versions."""
    if row == "1p":
        want = flash.flash_attention_packed_bounded_reference(q, k, v, h)
        return (outs[0] - want).abs().max().item(), 0.0
    want, want_lse = flash.flash_attention_lse_reference(q, k, v)
    lse_err = ((outs[1] - want_lse).abs() / want_lse.abs()).max().item() if row == "3" else 0.0
    return (outs[0] - want).abs().max().item(), lse_err


def timings(mine, parent, variants):
    """Each case: the kernel in turns with the parent's template (where
    given), SDPA and the bound; then the ``VARIANTS`` in turns.  One record
    a case."""
    records = []
    for row, b, h, sq, sk, d in CASES:
        entry, template, packed, lse = _entries(row)
        q, k, v = _inputs(b, h, sq, sk, d, packed)
        heads = h if packed else None
        call, outs = _forward(mine, entry, q, k, v, heads, lse)
        call()
        torch.cuda.synchronize()
        err, lse_err = _errors(row, q, k, v, h, outs)
        turns = [("kernel", call)]
        if parent is not None:
            core, _ = _forward(parent, template, q, k, v, heads, lse)
            turns = [("parent template", core), *turns, *turns, ("parent template", core)]
        ms = [best_ms(fn) for _, fn in turns]
        views = [_split(t, h) for t in (q, k, v)] if packed else (q, k, v)
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(*views))
        bound_ms = 4 * b * h * sq * sk * d / F32_FLOPS * 1e3
        kernel_ms = min(t for (who, _), t in zip(turns, ms) if who == "kernel")
        calls = [_forward(lib, entry, q, k, v, heads, lse)[0] for lib in variants]
        order = [*range(len(variants)), 0]
        var_ms = [best_ms(calls[i]) for i in order]
        shape = list(q.shape)
        print(f"row {row} {shape} sk={sk} f32: "
              + ", ".join(f"{who} {t:.4f}" for (who, _), t in zip(turns, ms))
              + f" ms; SDPA {sdpa:.4f} ms, kernel / SDPA {kernel_ms / sdpa:.3f}; bound "
              f"{bound_ms:.4f} ms ({bound_ms / kernel_ms:.1%}); out err {err:.3e} (tol 1e-4)"
              + (f", lse2 rel err {lse_err:.3e} (tol 1e-5)" if lse else "")
              + "; variants " + ", ".join(f"{VARIANTS[i][0]} {t:.4f}"
                                          for i, t in zip(order, var_ms)) + " ms")
        records.append({"row": row, "shape": shape, "sk": sk, "turns": [[w, t] for (w, _), t
                                                                         in zip(turns, ms)],
                        "sdpa_ms": sdpa, "bound_ms": bound_ms, "err": err, "lse_rel_err": lse_err,
                        "variants_ms": [[VARIANTS[i][0], t] for i, t in zip(order, var_ms)]})
        del q, k, v, outs, turns, calls
        torch.cuda.empty_cache()
    return records


def sdpa_backend():
    """The kernels SDPA's float32 call launches (TF32 off), from one trace."""
    q, k, v = _inputs(1, 8, 1024, 1024, 80, False)
    F.scaled_dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if str(e.device_type).endswith("CUDA")})
    print(f"SDPA float32 [1, 8, 1024, 80] launches: {names}")
    return names


def _same(a, b):
    return all(torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
               for x, y in zip(a, b))


def _bwd_outputs(lib, tc, q, k, v, do, lse2, delta):
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ints = (q.shape[0] * q.shape[1], q.shape[2], k.shape[2], q.shape[3],
            int(q.dtype == torch.bfloat16))
    stream = torch.cuda.current_stream().cuda_stream
    suffix = "_tc" if tc else ""
    for entry, outs in ((f"hedit_flash_attention_bwd_dq{suffix}", (dq,)),
                        (f"hedit_flash_attention_bwd_dkv{suffix}", (dk, dv))):
        err = getattr(lib, entry)(*(t.data_ptr() for t in (q, k, v, do, lse2, delta, *outs)),
                                  *ints, stream)
        if err:
            raise RuntimeError(f"{entry} failed (code {err})")
    torch.cuda.synchronize()
    return dq, dk, dv


def kept_identity(mine, parent) -> bool:
    """The outputs this tree keeps from the parent, on the same inputs, bit
    for bit, each where ``parent`` holds its source: the backward kernels
    (tensor cores and template), the template's kept forward outputs, and the
    float32 kernel's bounded, LSE and packed bounded outputs at d = 40 / 80."""
    same = True
    bwd_cases = (((1, 8, 1024, 40), 1024, torch.bfloat16, True),
                 ((1, 8, 1000, 80), 1064, torch.bfloat16, True),
                 ((1, 8, 1024, 40), 1024, torch.bfloat16, False),
                 ((1, 8, 1000, 80), 1064, torch.bfloat16, False),
                 ((1, 1, 2048, 512), 2048, torch.float32, False),
                 ((1, 1, 2048, 512), 2048, torch.bfloat16, False))
    for shape, sk, dtype, tc in bwd_cases:
        lib = "flash_attention_bwd_tc.cu" if tc else "flash_attention_bwd.cu"
        if lib not in parent:
            continue
        b, h, sq, d = shape
        q, k, v = _inputs(b, h, sq, sk, d, False, seed=sq + d, dtype=dtype)
        do = torch.randn(shape, device="cuda").to(dtype)
        out, lse2 = flash.flash_attention_lse_reference(q, k, v)
        delta = (do.float() * out.float()).sum(dim=-1)
        lse2 = lse2.contiguous()
        equal = _same(_bwd_outputs(mine, tc, q, k, v, do, lse2, delta),
                      _bwd_outputs(parent[lib], tc, q, k, v, do, lse2, delta))
        same &= equal
        print(f"identity backward ({'tensor cores' if tc else 'template'}) q{list(shape)} "
              f"sk={sk} {str(dtype)[6:]}: "
              f"{'bit-identical to the parent' if equal else 'DIFFERS from the parent'}")
    forwards = [("flash_attention.cu", *case) for case in (
        ("hedit_flash_attention_fwd_exact", (2, 8, 1024, 1024, 40), False, False, torch.float32),
        ("hedit_flash_attention_fwd_exact", (1, 1, 1000, 1100, 512), False, False,
         torch.float32),
        ("hedit_flash_attention_fwd_packed", (2, 8, 1000, 1064, 80), True, False, torch.float32),
        ("hedit_flash_attention_fwd", (1, 1, 1024, 1024, 512), False, False, torch.float32),
        ("hedit_flash_attention_fwd_lse", (1, 1, 1000, 1100, 512), False, True, torch.float32),
        ("hedit_flash_attention_fwd_packed_bounded", (1, 2, 1024, 1024, 512), True, False,
         torch.float32),
        ("hedit_flash_attention_fwd_lse", (1, 8, 1024, 1024, 40), False, True, torch.bfloat16),
        ("hedit_flash_attention_fwd_lse", (1, 8, 1000, 1064, 80), False, True, torch.bfloat16))]
    forwards += [("flash_attention_f32.cu", *case) for case in (
        ("hedit_flash_attention_fwd_f32", (2, 8, 1024, 1024, 40), False, False, torch.float32),
        ("hedit_flash_attention_fwd_f32", (1, 8, 1000, 1064, 80), False, False, torch.float32),
        ("hedit_flash_attention_fwd_lse_f32", (1, 8, 1000, 1064, 80), False, True,
         torch.float32),
        ("hedit_flash_attention_fwd_lse_f32", (1, 8, 4096, 4096, 40), False, True,
         torch.float32),
        ("hedit_flash_attention_fwd_packed_bounded_f32", (2, 8, 1024, 1024, 80), True, False,
         torch.float32),
        ("hedit_flash_attention_fwd_packed_bounded_f32", (2, 8, 1000, 1064, 40), True, False,
         torch.float32))]
    for source, entry, (b, h, sq, sk, d), packed, lse, dtype in forwards:
        if source not in parent:
            continue
        q, k, v = _inputs(b, h, sq, sk, d, packed, seed=sq + sk, dtype=dtype)
        heads = h if packed else None
        outs = []
        for lib in (mine, parent[source]):
            call, got = _forward(lib, entry, q, k, v, heads, lse)
            call()
            outs.append(got)
        torch.cuda.synchronize()
        equal = _same(*outs)
        same &= equal
        print(f"identity {source} {entry} q{list(q.shape)} sk={sk} {str(dtype)[6:]}: "
              f"{'bit-identical to the parent' if equal else 'DIFFERS from the parent'}")
    return same


def exact_timings(mine, parent, variants):
    """Each of ``EXACT_CASES``: the float32 kernel's exact mode held to its
    plain version and relaunched, in turns with the parent's template exact
    entry (where given), beside SDPA and the bound; then ``EXACT_VARIANTS``
    in turns, each held to the plain version unless it is an ablation.  One
    record a case."""
    records = []
    for row, (b, h, sq, d), sk in EXACT_CASES:
        packed = row == "7"
        entry = flash.exact_entry(torch.float32, packed, d)
        template = ("hedit_flash_attention_fwd_packed" if packed
                    else "hedit_flash_attention_fwd_exact")
        q, k, v = _inputs(b, h, sq, sk, d, packed)
        heads = h if packed else None
        want = (flash.flash_attention_packed_exact_reference(q, k, v, h) if packed
                else flash.flash_attention_exact_reference(q, k, v))
        call, outs = _forward(mine, entry, q, k, v, heads)
        call()
        torch.cuda.synchronize()
        got = outs[0].clone()
        call()
        torch.cuda.synchronize()
        relaunch_same = torch.equal(got, outs[0])
        err = (got - want).abs().max().item()
        turns = [("kernel", call)]
        if parent is not None:
            core, _ = _forward(parent, template, q, k, v, heads)
            turns = [("parent template", core), *turns, *turns, ("parent template", core)]
        ms = [best_ms(fn) for _, fn in turns]
        views = [_split(t, h) for t in (q, k, v)] if packed else (q, k, v)
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(*views))
        bound_ms = 4 * b * h * sq * sk * d / F32_FLOPS * 1e3
        kernel_ms = min(t for (who, _), t in zip(turns, ms) if who == "kernel")
        var_calls = [_forward(lib, entry, q, k, v, heads) for lib in variants]
        var_errs = []
        for (label, defines), (fn, var_outs) in zip(EXACT_VARIANTS, var_calls):
            fn()
            torch.cuda.synchronize()
            ablation = any(x.startswith("F32_ABLATE") for x in defines)
            var_errs.append(None if ablation else (var_outs[0] - want).abs().max().item())
        order = [*range(len(variants)), 0]
        var_ms = [best_ms(var_calls[i][0]) for i in order]
        shape = list(q.shape)
        print(f"row {row} {shape} sk={sk} f32 exact: "
              + ", ".join(f"{who} {t:.4f}" for (who, _), t in zip(turns, ms))
              + f" ms; SDPA {sdpa:.4f} ms, kernel / SDPA {kernel_ms / sdpa:.3f}; bound "
              f"{bound_ms:.4f} ms ({bound_ms / kernel_ms:.1%}); out err {err:.3e} (tol 1e-4); "
              f"relaunched {'bit-identical' if relaunch_same else 'DIFFERENT'}; variants "
              + ", ".join(f"{EXACT_VARIANTS[i][0]} {t:.4f} ms ({bound_ms / t:.1%})"
                          for i, t in zip(order, var_ms))
              + "; variant errors " + ", ".join("ablation" if e is None else f"{e:.2e}"
                                                for e in var_errs))
        records.append({"row": row, "shape": shape, "sk": sk,
                        "turns": [[w, t] for (w, _), t in zip(turns, ms)], "sdpa_ms": sdpa,
                        "bound_ms": bound_ms, "err": err, "relaunch_bit_identical": relaunch_same,
                        "variant_errs": var_errs,
                        "variants_ms": [[EXACT_VARIANTS[i][0], t] for i, t in zip(order, var_ms)]})
        del q, k, v, outs, turns, var_calls
        torch.cuda.empty_cache()
    return records


def exact_main(parent_dir) -> int:
    """``--exact``: the builds, the timings, the identities."""
    builds = [(SOURCE, f"exact_variant{i}", _build.CSRC, defines)
              for i, (_, defines) in enumerate(EXACT_VARIANTS)]
    if parent_dir is not None:
        csrc = parent_dir / "hedit_tpu_torch" / "csrc"
        builds += [(csrc / name, f"parent_{name[:-3]}", csrc, ()) for name in EXACT_PARENT_SOURCES]
    with ThreadPoolExecutor(len(builds)) as ex:
        built = list(ex.map(lambda a: build_alone(a[0], OUT_DIR / f"{a[1]}.so", a[2], a[3]),
                            builds))
    for (source, name, *_), (_, info) in zip(builds, built):
        print(f"ptxas, {name} ({source.name}): {info}")
    mine = _build.cuda_library()
    n = len(EXACT_VARIANTS)
    parent = dict(zip(EXACT_PARENT_SOURCES, (lib for lib, _ in built[n:])))
    records = exact_timings(mine, parent.get("flash_attention.cu"), [lib for lib, _ in built[:n]])
    print(json.dumps({"flash_f32_tiles_exact": records}))
    bad = [r for r in records
           if not (r["err"] <= 1e-4 and r["relaunch_bit_identical"]
                   and all(e is None or e <= 1e-4 for e in r["variant_errs"]))]
    if bad:
        print(f"FAILED: outputs beyond their tolerance or not bit-identical when relaunched: {bad}")
        return 1
    if parent_dir is not None and not kept_identity(mine, parent):
        print("FAILED: an output this tree keeps differs from the parent's")
        return 1
    return 0


def _d512_entries(row):
    """(this tree's entry point, the template's, lse, exact) of a d = 512 row."""
    lse, exact = row == "3", row == "6"
    f32 = torch.float32
    mine = (flash.lse_entry(f32, 512) if lse else flash.exact_entry(f32, False, 512) if exact
            else flash.bounded_entry(f32, False, 512))
    return mine, mine[:-len(flash.F32_512_SUFFIX)], lse, exact


def d512_timings(mine, parent, variants):
    """Each d = 512 case: the kernel in turns with the parent's template
    (where given), SDPA and the bound, its error against the plain
    version; then ``D512_VARIANTS`` in turns.  One record a case."""
    records = []
    for row, s in D512_CASES:
        entry, template, lse, exact = _d512_entries(row)
        q, k, v = _inputs(1, 1, s, s, 512, False, seed=s)
        call, outs = _forward(mine, entry, q, k, v, lse=lse)
        call()
        torch.cuda.synchronize()
        if exact:
            want = flash.flash_attention_exact_reference(q, k, v)
            err, lse_err = (outs[0] - want).abs().max().item(), 0.0
        else:
            err, lse_err = _errors(row, q, k, v, 1, outs)
        turns = [("kernel", call)]
        if parent is not None:
            core, _ = _forward(parent, template, q, k, v, lse=lse)
            turns = [("parent template", core), *turns, *turns, ("parent template", core)]
        ms = [best_ms(fn) for _, fn in turns]
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms = 4 * s * s * 512 / F32_FLOPS * 1e3
        kernel_ms = min(t for (who, _), t in zip(turns, ms) if who == "kernel")
        calls = [_forward(lib, entry, q, k, v, lse=lse)[0] for lib in variants]
        order = [*range(len(variants)), 0]
        var_ms = [best_ms(calls[i]) for i in order]
        print(f"row {row} [1, 1, {s}, 512] f32: "
              + ", ".join(f"{who} {t:.4f}" for (who, _), t in zip(turns, ms))
              + f" ms; SDPA {sdpa:.4f} ms, kernel / SDPA {kernel_ms / sdpa:.3f}; bound "
              f"{bound_ms:.4f} ms ({bound_ms / kernel_ms:.1%}); out err {err:.3e} (tol 1e-4)"
              + (f", lse2 rel err {lse_err:.3e} (tol 1e-5)" if lse else "")
              + "; variants " + ", ".join(f"{D512_VARIANTS[i][0]} {t:.4f}"
                                          for i, t in zip(order, var_ms)) + " ms")
        records.append({"row": row, "shape": [1, 1, s, 512], "turns": [[w, t] for (w, _), t
                                                                       in zip(turns, ms)],
                        "sdpa_ms": sdpa, "bound_ms": bound_ms, "err": err, "lse_rel_err": lse_err,
                        "variants_ms": [[D512_VARIANTS[i][0], t] for i, t in zip(order, var_ms)]})
        del q, k, v, outs, turns, calls
        torch.cuda.empty_cache()
    return records


def d512_main(parent_dir) -> int:
    """``--d512``: the builds, the timings, the identities."""
    from hedit_tpu_torch.probes import flash_bwd_tiles, flash_probe_tiles

    builds = [(D512_SOURCE, f"d512_variant{i}", _build.CSRC, defines)
              for i, (_, defines) in enumerate(D512_VARIANTS)]
    sources = flash_bwd_tiles.PARENT_SOURCES
    if parent_dir is not None:
        csrc = parent_dir / "hedit_tpu_torch" / "csrc"
        builds += [(csrc / name, f"parent_{name[:-3]}", csrc, ()) for name in sources]
    builds = [b for b in builds if b[0].exists()]  # a parent may predate a source
    with ThreadPoolExecutor(len(builds)) as ex:
        built = list(ex.map(lambda a: build_alone(a[0], OUT_DIR / f"{a[1]}.so", a[2], a[3]),
                            builds))
    for (source, name, *_), (_, info) in zip(builds, built):
        print(f"ptxas, {name} ({source.name}): {info}")
    mine = _build.cuda_library()
    active = ctypes.c_int(0)
    for cluster in (1, 2, 4, 8):
        err = mine.hedit_flash_attention_f32_512_active_clusters(cluster, ctypes.byref(active))
        print(f"clusters of {cluster} the card runs at once (cudaOccupancyMaxActiveClusters, one "
              f"CTA an SM): {active.value if err == 0 else f'error {err}'}")
    n = len(D512_VARIANTS)
    parent = {source.name: lib for (source, *_), (lib, _) in zip(builds[n:], built[n:])}
    records = d512_timings(mine, parent.get("flash_attention.cu"), [lib for lib, _ in built[:n]])
    print(json.dumps({"flash_f32_tiles_d512": records}))
    bad = [r for r in records if not (r["err"] <= 1e-4 and r["lse_rel_err"] <= 1e-5)]
    if bad:
        print(f"FAILED: outputs beyond their tolerance: {bad}")
        return 1
    if parent_dir is None:
        return 0
    same = identity(mine, parent["flash_attention_tc.cu"], exact=True)
    same &= flash_bwd_tiles.kept_identity(mine, parent)
    same &= flash_probe_tiles.kept_identity(mine, parent["flash_probes_tc.cu"],
                                            parent["flash_variants.cu"])
    if not same:
        print("FAILED: an output this tree keeps differs from the parent's")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit")
    ap.add_argument("--d512", action="store_true",
                    help="rows 1, 3 and 6 in float32 at d = 512 (flash_attention_f32_512.cu)")
    ap.add_argument("--exact", action="store_true",
                    help="rows 6 and 7 in float32 at d = 40 / 80, the exact mode of "
                         "flash_attention_f32.cu")
    args = ap.parse_args(argv)
    require_cuda("flash_f32_tiles")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if args.d512:
        return d512_main(args.parent)
    if args.exact:
        return exact_main(args.parent)
    builds = [(SOURCE, f"variant{i}", _build.CSRC, defines)
              for i, (_, defines) in enumerate(VARIANTS)]
    if args.parent is not None:
        csrc = args.parent / "hedit_tpu_torch" / "csrc"
        builds += [(csrc / name, f"parent_{name[:-3]}", csrc, ()) for name in PARENT_SOURCES]
    with ThreadPoolExecutor(len(builds)) as ex:
        built = list(ex.map(lambda a: build_alone(a[0], OUT_DIR / f"{a[1]}.so", a[2], a[3]),
                            builds))
    for (source, name, *_), (_, info) in zip(builds, built):
        print(f"ptxas, {name} ({source.name}): {info}")
    mine = _build.cuda_library()
    n = len(VARIANTS)
    parent = dict(zip(PARENT_SOURCES, (lib for lib, _ in built[n:])))
    records = timings(mine, parent.get("flash_attention.cu"), [lib for lib, _ in built[:n]])
    backend = sdpa_backend()
    print(json.dumps({"flash_f32_tiles": records, "sdpa_float32_kernels": backend}))
    bad = [r for r in records if not (r["err"] <= 1e-4 and r["lse_rel_err"] <= 1e-5)]
    if bad:
        print(f"FAILED: outputs beyond their tolerance: {bad}")
        return 1
    if args.parent is not None and not (identity(mine, parent["flash_attention_tc.cu"], exact=True)
                                        & kept_identity(mine, parent)):
        print("FAILED: an output this tree keeps differs from the parent's")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
