"""The flash backward's kernels on the card: the fused float32 kernel, its
tile variants, the bf16 tensor-core kernels at d = 512, and (with ``--tc``)
the tensor-core kernels' tiles; or (``--f32-512``) the float32 kernels at
d = 512.

    python -m hedit_tpu_torch.probes.flash_bwd_tiles [--parent DIR [--nmg-loop] [--vae-loop]] [--tc]
    python -m hedit_tpu_torch.probes.flash_bwd_tiles --f32-512 [--parent DIR]

The fused float32 backward (``csrc/flash_attention_bwd_f32.cu``, entry point
``hedit_flash_attention_bwd_f32``: dq, dk and dv in one launch) is timed at
``F32_SHAPES`` (the NMG gradient call's [1, 8, 4096, 40], the 32^2 level's
[1, 8, 1024, 80] and a ragged 1000 / 1064) through its entry point, without
the wrapper's host checks (CUDA-event means of 20 launches, best of 3),
beside SDPA's float32 backward on the same values (TF32 off; its forward
recorded once, ``torch.autograd.grad`` timed) and the bound (10 B H Sq Sk D
FLOP, the function's 5 products, at the float32 rate of 67 TFLOP/s), and
held to the plain backward (1e-4 of each output's largest value).  The
source is also built once for each of ``F32_VARIANTS`` (``-D`` macros: other
query tiles and register budgets, the loops unrolled once, and a timing
ablation whose dq is wrong: no dq atomics), one ``nvcc`` each, all started
together; each variant is timed in turns with the source's own, and every
build prints ``-Xptxas -v``'s registers and spills.  SDPA's float32 backward
is traced once with ``torch.profiler``: the names of its kernels say which
backend is the yardstick.

``--parent DIR``: a checkout of an earlier commit of this repository (for
example ``git archive <commit> hedit_tpu_torch chip_smoke.py | tar -x -C
DIR``).  Its float32 backward at d = 40 / 80 (its fused kernel, or, in a
parent before that kernel, the CUDA-core template's dq and dk / dv) is
timed in turns with the fused kernel (parent, this, this, parent), and its
sources are built beside this tree's (those it has): these outputs of the
two must agree bit for bit on the same inputs, or the probe exits non-zero:
the 21 outputs of ``csrc/flash_attention_tc.cu``
(``flash_exact_tiles.identity``), the probes'
(``flash_probe_tiles.kept_identity``), the tensor-core backward in bf16 at
d = 40 / 80, the template's backward at d = 512 in both dtypes and in bf16
at d = 40 / 80, the fused float32 backward's dk and dv (its dq sums by
atomic adds), the float32 forward kernels' (``csrc/flash_attention_f32.cu``)
and the template's forward outputs (``kept_identity``).

``--nmg-loop`` (with ``--parent``): the float32 NMG loop of ``chip_smoke.py``
(``phase_nmg_identity``: 50 NMG steps of the SD-1.5 UNet in float32 with
seeded weights, its gradient calls through the float32 backward) run with
the parent's package and this tree's in turns (parent, this, this, parent),
each in a process of its own started in that tree; prints each run's loop
seconds and backward launches.

The bf16 tensor-core kernels at the VAE's d = 512 (``SHAPES_512``: the
decoder's mid-block attention [1, 1, 4096, 512] and a ragged 1000 / 1100)
through their entry points, dq and dk / dv alone and the pair in turns with
the parent's CUDA-core template (``--parent``: parent, this, this, parent),
beside SDPA's backward and the bound (6 + 8 B H Sq Sk D FLOP at 989
TFLOP/s), held to the plain backward before its final rounding (2^-8 of
each output's largest value; the probe exits non-zero beyond it).

``--vae-loop`` (with ``--parent``): the bf16 VAE decode's gradient at 512
px (``chip_smoke.py``'s ``vae_gradient`` path, whose decoder mid-block
attention takes the d = 512 backward), six calls a run, host clock, of the
parent's package and this tree's in turns, each in a process of its own.

``--tc``: ``csrc/flash_attention_bwd_tc.cu`` built once for each of
``VARIANTS`` (its six launch lines rewritten to other tiles: at d = 40 / 80
warps of 16 own rows, streamed rows a tile, blocks an SM; at d = 512 own
rows, streamed rows, warps, the score jobs' columns and contraction split,
blocks an SM), its dq and dk / dv kernels timed at ``SHAPES`` and
``SHAPES_512`` in turns with the source's own tiles (variant 0) first and
last and held to the plain backward before its final rounding (2^-8 of the
largest value; the probe exits non-zero beyond it).

``--f32-512``: the float32 backward at d = 512
(``csrc/flash_attention_bwd_f32_512.cu``: the dk / dv kernel, which stores
ds into a workspace, then the dq product over it; entry points
``hedit_flash_attention_bwd_dkv_f32_512`` and ``..._dq_f32_512``) at
``F512_SHAPES`` ([1, 1, 2048, 512], the one shape JAX's routing sends it,
[1, 1, 4096, 512] and a ragged 1000 / 1100), through its entry points: the
pair in turns with the parent's CUDA-core template (``--parent``: its dq and
dk / dv entries; parent, this, this, parent), each kernel alone, SDPA's
float32 backward on the same values (TF32 off) and the bound at five and at
seven products (67 TFLOP/s); held to the plain backward (1e-4 of each
output's largest value) and, launched twice, bit for bit.  The source is
also built once for each of ``F512_VARIANTS`` (``-D``: the score loop's
unroll, the dq product's rows a CTA, keys a stage and stages, and three
timing ablations whose outputs are wrong), one ``nvcc`` each, all started
together with the parent's sources; each variant is timed in turns with the
source's own, and every build prints ``-Xptxas -v``'s registers and spills.
With ``--parent`` the outputs this tree keeps are held bit for bit to the
parent's (the tensor-core forwards, ``kept_identity``'s backward and
forward kernels, the float32 d = 512 forward's five entry points included,
and the probe kernels); the probe exits non-zero if one differs or an
output is beyond its tolerance.
"""

from __future__ import annotations

import argparse
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
from hedit_tpu_torch.probes.flash_f32_tiles import _forward, _same
from hedit_tpu_torch.probes.flash_probe_tiles import kept_identity as probe_identity
from hedit_tpu_torch.probes.timing import best_ms, build_alone, require_cuda

OUT_DIR = _build.BUILD_DIR / "bwd_tiles"
TC_SOURCE = _build.CSRC / "flash_attention_bwd_tc.cu"
F32_SOURCE = _build.CSRC / "flash_attention_bwd_f32.cu"
# the source's launch lines, keyed by kernel and head dim: (the launcher,
# its tile arguments); a variant's tile replaces the arguments
LAUNCHES = {"dq40": ("launch_dq<40", (4, 64, 4)), "dkv40": ("launch_dkv<40", (4, 64, 4)),
            "dq80": ("launch_dq<80", (4, 128, 2)), "dkv80": ("launch_dkv<80", (4, 128, 2)),
            "dq512": ("launch_dq512<", (32, 32, 8, 32, 2, 1)),
            "dkv512": ("launch_dkv512<", (32, 32, 8, 32, 2, 1))}
# D = 40 / 80: (warps, streamed rows, blocks an SM); D = 512: (own rows,
# streamed rows, warps, job columns JN, contraction split KS, blocks an SM).
# Variant 0 is the source's own.  At D = 512: 1 jobs of 16 x 16 over the
# whole contraction; 2 two blocks an SM of 16 rows and 16-row tiles; 3
# 16-row tiles; 4 blocks of 16 rows (256 blocks at 4096, two waves of one
# block an SM); 5 64-row dq blocks (64 blocks at 4096: half the card) and
# 16 x 16 dk/dv jobs over half the contraction.
VARIANTS = (
    dict(dq40=(4, 64, 4), dkv40=(4, 64, 4), dq80=(4, 128, 2), dkv80=(4, 128, 2),
         dq512=(32, 32, 8, 32, 2, 1), dkv512=(32, 32, 8, 32, 2, 1)),
    dict(dq40=(4, 64, 5), dkv40=(4, 64, 3), dq80=(4, 64, 2), dkv80=(4, 64, 2),
         dq512=(32, 32, 8, 16, 1, 1), dkv512=(32, 32, 8, 16, 1, 1)),
    dict(dq40=(8, 64, 2), dkv40=(8, 64, 2), dq80=(2, 128, 4), dkv80=(2, 128, 4),
         dq512=(16, 16, 4, 16, 2, 2), dkv512=(16, 16, 4, 16, 2, 2)),
    dict(dq40=(4, 32, 5), dkv40=(4, 32, 4), dq80=(8, 128, 1), dkv80=(8, 128, 1),
         dq512=(32, 16, 8, 16, 2, 1), dkv512=(32, 16, 8, 16, 2, 1)),
    dict(dq40=(8, 32, 2), dkv40=(8, 32, 2), dq80=(4, 256, 1), dkv80=(4, 256, 1),
         dq512=(16, 32, 4, 32, 2, 1), dkv512=(16, 32, 4, 32, 2, 1)),
    dict(dq40=(2, 64, 8), dkv40=(2, 64, 8), dq80=(2, 64, 4), dkv80=(2, 64, 4),
         dq512=(64, 16, 8, 16, 2, 1), dkv512=(32, 32, 8, 16, 2, 1)),
)
SHAPES = (((1, 8, 4096, 40), 4096), ((1, 8, 1024, 80), 1024), ((1, 8, 1000, 80), 1064))
# the VAE decoder's mid-block attention at 512 px, and a ragged one
SHAPES_512 = (((1, 1, 4096, 512), 4096), ((1, 1, 1000, 512), 1100))
BF16_ULP = 2.0 ** -8
F32_SHAPES = SHAPES
# (label, -D defines) of the fused float32 kernel: the source's own first;
# 32-query tiles at d = 40 (58 KB of shared memory: 2 or 3 blocks an SM);
# 64-query tiles at d = 80 (137 KB: 1 block an SM); the loops unrolled once;
# and the ablation, timed only
F32_VARIANTS = (("the source's tiles", ()),
                ("d = 40: 32-query tiles", ("BWD_F32_BQ_40=32",)),
                ("d = 40: 32-query tiles, 3 blocks an SM", ("BWD_F32_BQ_40=32",
                                                            "BWD_F32_MINB_40=3")),
                ("d = 80: 64-query tiles, 1 block an SM", ("BWD_F32_BQ_80=64",
                                                           "BWD_F32_MINB_80=1")),
                ("loops unrolled once", ("BWD_F32_UNROLL=1",)),
                ("no dq atomics (dq wrong)", ("BWD_F32_ABLATE=1",)))
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
F32_TOL = 1e-4
PARENT_SOURCES = ("flash_attention.cu", "flash_attention_tc.cu", "flash_attention_f32.cu",
                  "flash_attention_bwd.cu", "flash_attention_bwd_tc.cu", "flash_probes_tc.cu",
                  "flash_variants.cu", "flash_attention_bwd_f32.cu", "flash_attention_f32_512.cu")
F512_SOURCE = _build.CSRC / "flash_attention_bwd_f32_512.cu"
# the float32 d = 512 backward: the routed shape, the 512 px decode's, a ragged one
F512_SHAPES = (((1, 1, 2048, 512), 2048), ((1, 1, 4096, 512), 4096), ((1, 1, 1000, 512), 1100))
# (label, -D defines) of its source: its own first; the ablations, timed only
F512_VARIANTS = (("the source's: score loop unrolled 4, dq 64 x 128 tiles, 16 keys a stage, "
                  "2 stages", ()),
                 ("score loop unrolled once", ("BWD512_UNROLL=1",)),
                 ("score loop unrolled fully", ("BWD512_UNROLL=16",)),
                 ("dq 32 x 256 tiles", ("BWD512_DQ_BM=32",)),
                 ("dq 8 keys a stage", ("BWD512_DQ_BK=8",)),
                 ("dq 3 stages", ("BWD512_DQ_STAGES=3",)),
                 ("dq 4 stages", ("BWD512_DQ_STAGES=4",)),
                 ("ablation: no query tile copied after the first two", ("BWD512_ABLATE=1",)),
                 ("ablation: no score products", ("BWD512_ABLATE=2",)),
                 ("ablation: no dk / dv products", ("BWD512_ABLATE=3",)))


def _launch_line(launcher: str, tile) -> str:
    return launcher + ("" if launcher.endswith("<") else ", ") + ", ".join(map(str, tile)) + ">"


def _variant_source(i: int) -> Path:
    text = TC_SOURCE.read_text()
    for key, tile in VARIANTS[i].items():
        launcher, own = LAUNCHES[key]
        line = _launch_line(launcher, own)
        if line not in text:
            raise RuntimeError(f"{TC_SOURCE.name} no longer launches {line}")
        text = text.replace(line, _launch_line(launcher, tile))
    path = OUT_DIR / f"variant{i}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def _inputs(shape, sk, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(shape, generator=g, device="cuda").to(dtype)
    k = torch.randn(shape[:2] + (sk, shape[3]), generator=g, device="cuda").to(dtype)
    v = torch.randn(k.shape, generator=g, device="cuda").to(dtype)
    do = torch.randn(shape, generator=g, device="cuda").to(dtype)
    out, lse2 = flash.flash_attention_lse_cuda(q, k, v)
    delta = (do.float() * out.float()).sum(dim=-1)
    return q, k, v, do, out, lse2, delta


def _calls(lib, entries, q, k, v, do, lse2, delta):
    """(one launch function an entry point, the outputs dq, dk, dv) through
    ``lib``: the two-kernel entries write dq, then dk and dv; a fused one all
    three."""
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ints = (q.shape[0] * q.shape[1], q.shape[2], k.shape[2], q.shape[3],
            1 if q.dtype == torch.bfloat16 else 0)
    outs = ((dq, dk, dv),) if len(entries) == 1 else ((dq,), (dk, dv))

    def launcher(entry, out):
        fn = getattr(lib, entry)

        def call():
            err = fn(*(t.data_ptr() for t in (q, k, v, do, lse2, delta, *out)), *ints,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{entry} failed (code {err})")
        return call
    return [launcher(e, o) for e, o in zip(entries, outs)], (dq, dk, dv)


def _f512_calls(lib, q, k, v, do, lse2, delta):
    """(the dk / dv launch, the dq launch, the outputs dq, dk, dv) of the
    float32 d = 512 pair through ``lib``, the workspace allocated once."""
    bh, sq, sk, d = q.shape[0] * q.shape[1], q.shape[2], k.shape[2], q.shape[3]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ds = torch.empty(flash.bwd_f32_512_workspace(bh, sq, sk), device="cuda")
    entry_dq, entry_dkv = flash.F32_512_BWD_ENTRIES

    def launcher(entry, ptrs):
        fn = getattr(lib, entry)

        def call():
            err = fn(*(t.data_ptr() for t in ptrs), bh, sq, sk, d, 0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{entry} failed (code {err})")
        return call
    return (launcher(entry_dkv, (q, k, v, do, lse2, delta, ds, dk, dv)),
            launcher(entry_dq, (k, ds, dq)), (dq, dk, dv))


def _pair(first, second):
    def call():
        first()
        second()
    return call


def f512_timings(mine, variants, parent):
    """The float32 d = 512 pair at ``F512_SHAPES``: in turns with the
    parent's template (where given), each kernel alone, SDPA's backward, the
    bounds at 5 and 7 products, relaunch identity, then ``F512_VARIANTS`` in
    turns.  One record a shape."""
    records = []
    template = ("hedit_flash_attention_bwd_dq", "hedit_flash_attention_bwd_dkv")
    for shape, sk in F512_SHAPES:
        q, k, v, do, out, lse2, delta = _inputs(shape, sk, torch.float32)
        wants = flash.flash_attention_backward_reference(q, k, v, out, lse2, do)
        fdkv, fdq, got = _f512_calls(mine, q, k, v, do, lse2, delta)
        call = _pair(fdkv, fdq)
        call()
        torch.cuda.synchronize()
        first = [t.clone() for t in got]
        call()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, got))
        errs = _errors(got, wants)
        turns = [("kernels", call)]
        if parent is not None:
            calls, _ = _calls(parent, template, q, k, v, do, lse2, delta)
            turns = [("parent template", _pair(*calls)), *turns, *turns,
                     ("parent template", _pair(*calls))]
        ms = [best_ms(fn) for _, fn in turns]
        dkv_ms, dq_ms = best_ms(fdkv), best_ms(fdq)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(*leaves)
        sdpa = best_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True))
        b, h, sq, d = shape
        bound5, bound7 = (n * b * h * sq * sk * d / F32_FLOPS * 1e3 for n in (10, 14))
        kernel_ms = min(t for (who, _), t in zip(turns, ms) if who == "kernels")
        order = [*range(len(variants)), 0]
        var_ms, var_err = [], []
        for i in order:
            vdkv, vdq, vgot = _f512_calls(variants[i], q, k, v, do, lse2, delta)
            vcall = _pair(vdkv, vdq)
            vcall()
            torch.cuda.synchronize()
            if "ABLATE" not in str(F512_VARIANTS[i][1]):
                var_err.append(max(_errors(vgot, wants)))
            var_ms.append((best_ms(vcall), best_ms(vdkv), best_ms(vdq)))
        print(f"f32 d = 512 q{list(shape)} sk={sk}: "
              + ", ".join(f"{who} {t:.4f}" for (who, _), t in zip(turns, ms))
              + f" ms (dk/dv {dkv_ms:.4f}, dq {dq_ms:.4f}); SDPA backward {sdpa:.4f} ms, "
              f"kernels / SDPA {kernel_ms / sdpa:.3f}; bound {bound5:.4f} ms at 5 products "
              f"({bound5 / kernel_ms:.1%}), {bound7:.4f} at 7 ({bound7 / kernel_ms:.1%}); rel err "
              f"dq / dk / dv {' / '.join(f'{e:.2e}' for e in errs)} (tol {F32_TOL:g}); "
              f"relaunched {'bit-identical' if same else 'DIFFERS'}; variants (pair / dk-dv / dq) "
              + ", ".join(f"{F512_VARIANTS[i][0]} {t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f}"
                          for i, t in zip(order, var_ms)) + " ms")
        records.append({"shape": list(shape), "sk": sk,
                        "turns": [[w, t] for (w, _), t in zip(turns, ms)], "dkv_ms": dkv_ms,
                        "dq_ms": dq_ms, "sdpa_ms": sdpa, "bound_ms": bound5,
                        "bound_7_products_ms": bound7, "rel_err": errs, "bit_identical": same,
                        "variant_err": max(var_err),
                        "variants_ms": [[F512_VARIANTS[i][0], *t]
                                        for i, t in zip(order, var_ms)]})
        del q, k, v, do, out, lse2, delta, lib_out, leaves, got, first
        torch.cuda.empty_cache()
    return records


def f512_main(parent_dir) -> int:
    """``--f32-512``: the builds, the timings, the identities."""
    builds = [(F512_SOURCE, f"f512_variant{i}", _build.CSRC, defines)
              for i, (_, defines) in enumerate(F512_VARIANTS)]
    if parent_dir is not None:
        csrc = parent_dir / "hedit_tpu_torch" / "csrc"
        builds += [(csrc / name, f"parent_{name[:-3]}", csrc, ()) for name in PARENT_SOURCES]
    builds = [b for b in builds if b[0].exists()]  # a parent may predate a source
    with ThreadPoolExecutor(len(builds)) as ex:
        built = list(ex.map(lambda a: build_alone(a[0], OUT_DIR / f"{a[1]}.so", a[2], a[3]),
                            builds))
    for (source, name, *_), (_, info) in zip(builds, built):
        print(f"ptxas, {name} ({source.name}): {info}")
    mine = _build.cuda_library()
    n = len(F512_VARIANTS)
    parent = {source.name: lib for (source, *_), (lib, _) in zip(builds[n:], built[n:])}
    records = f512_timings(mine, [lib for lib, _ in built[:n]],
                           parent.get("flash_attention_bwd.cu"))
    print(json.dumps({"flash_bwd_f32_512": records}))
    bad = [r for r in records if not (max(r["rel_err"]) <= F32_TOL and r["bit_identical"]
                                      and r["variant_err"] <= F32_TOL)]
    if bad:
        print(f"FAILED: outputs beyond their tolerance or not bit-identical: {bad}")
        return 1
    if parent_dir is not None and not (
            identity(mine, parent["flash_attention_tc.cu"], exact=True)
            & probe_identity(mine, parent["flash_probes_tc.cu"], parent["flash_variants.cu"])
            & kept_identity(mine, parent)):
        print("FAILED: an output this tree keeps differs from the parent's")
        return 1
    return 0


def _errors(got, wants):
    return [((a.float() - w).abs().max() / w.abs().max()).item() for a, w in zip(got, wants)]


def sweep() -> float:
    """The tensor-core kernels' tile variants (``--tc``); returns the largest
    error of any variant over its tolerance."""
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(lambda i: build_alone(_variant_source(i), OUT_DIR / f"variant{i}.so",
                                                  _build.CSRC), range(len(VARIANTS))))
    for i, (_, info) in enumerate(built):
        print(f"variant {i} {VARIANTS[i]}: {info}")
    entries = flash.bwd_entry(torch.bfloat16, 40)
    assert entries == flash.bwd_entry(torch.bfloat16, 512)
    worst = 0.0
    for shape, sk in SHAPES + SHAPES_512:
        q, k, v, do, out, lse2, delta = _inputs(shape, sk, torch.bfloat16)
        wants = flash.flash_attention_backward_reference(q, k, v, out, lse2, do,
                                                         out_dtype=torch.float32)
        d = shape[3]
        for i in [*range(len(VARIANTS)), 0]:
            (fdq, fdkv), got = _calls(built[i][0], entries, q, k, v, do, lse2, delta)
            fdq()
            fdkv()
            torch.cuda.synchronize()
            err = max(_errors(got, wants)) / BF16_ULP
            worst = max(worst, err)
            print(f"tiles q{list(shape)} sk={sk} variant {i}: dq {VARIANTS[i][f'dq{d}']} "
                  f"{best_ms(fdq):.4f} ms, dk/dv {VARIANTS[i][f'dkv{d}']} {best_ms(fdkv):.4f} "
                  f"ms, err / tol {err:.3f}")
        del q, k, v, do, out, lse2, delta, wants
        torch.cuda.empty_cache()
    return worst


def vae_timings(mine, parent):
    """The tensor-core kernels at ``SHAPES_512`` in bf16 through their entry
    points (dq, dk / dv, and the two together), the pair in turns with the
    parent's CUDA-core template (where given: parent, this, this, parent),
    SDPA's backward on the same values and the bound (6 + 8 B H Sq Sk D FLOP
    at the bf16 rate); held to the plain backward before its final rounding
    (2^-8 of each output's largest value).  One record a shape."""
    records = []
    entries = flash.bwd_entry(torch.bfloat16, 512)
    template = ("hedit_flash_attention_bwd_dq", "hedit_flash_attention_bwd_dkv")
    for shape, sk in SHAPES_512:
        q, k, v, do, out, lse2, delta = _inputs(shape, sk, torch.bfloat16)
        wants = flash.flash_attention_backward_reference(q, k, v, out, lse2, do,
                                                         out_dtype=torch.float32)
        (fdq, fdkv), got = _calls(mine, entries, q, k, v, do, lse2, delta)
        fdq()
        fdkv()
        torch.cuda.synchronize()
        errs = [e / BF16_ULP for e in _errors(got, wants)]

        def pair(first, second):
            def call():
                first()
                second()
            return call
        turns = [("kernels", pair(fdq, fdkv))]
        if parent is not None:
            (pdq, pdkv), _ = _calls(parent, template, q, k, v, do, lse2, delta)
            turns = [("parent template", pair(pdq, pdkv)), *turns, *turns,
                     ("parent template", pair(pdq, pdkv))]
        ms = [best_ms(fn) for _, fn in turns]
        dq_ms, dkv_ms = best_ms(fdq), best_ms(fdkv)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(*leaves)
        sdpa = best_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True))
        b, h, sq, d = shape
        bounds = [n * b * h * sq * sk * d / BF16_FLOPS * 1e3 for n in (6, 8)]
        kernel_ms = min(t for (who, _), t in zip(turns, ms) if who == "kernels")
        print(f"tensor cores d = 512 q{list(shape)} sk={sk}: "
              + ", ".join(f"{who} {t:.4f}" for (who, _), t in zip(turns, ms))
              + f" ms; dq {dq_ms:.4f}, dk/dv {dkv_ms:.4f} ms; SDPA backward {sdpa:.4f} ms, "
              f"kernels / SDPA {kernel_ms / sdpa:.3f}; bound {bounds[0]:.4f} + {bounds[1]:.4f} "
              f"ms ({sum(bounds) / kernel_ms:.1%}); err / tol dq / dk / dv "
              f"{' / '.join(f'{e:.3f}' for e in errs)}")
        records.append({"shape": list(shape), "sk": sk,
                        "turns": [[w, t] for (w, _), t in zip(turns, ms)], "dq_ms": dq_ms,
                        "dkv_ms": dkv_ms, "sdpa_ms": sdpa, "bound_ms": bounds,
                        "err_over_tol": errs})
        del q, k, v, do, out, lse2, delta, lib_out, leaves
        torch.cuda.empty_cache()
    return records


def f32_timings(mine, variants, parent):
    """The fused float32 kernel at ``F32_SHAPES``: in turns with the parent's
    float32 backward at d = 40 / 80 (where given: its fused kernel, or, in a
    parent before it, the template's dq and dk / dv), SDPA's backward, the
    bound and the ``F32_VARIANTS`` in turns.  One record a shape."""
    records = []
    fused = flash.bwd_entry(torch.float32, 40)
    template = ("hedit_flash_attention_bwd_dq", "hedit_flash_attention_bwd_dkv")
    parent_entries = (fused if parent is not None and hasattr(parent, fused[0]) else template)
    for shape, sk in F32_SHAPES:
        q, k, v, do, out, lse2, delta = _inputs(shape, sk, torch.float32)
        wants = flash.flash_attention_backward_reference(q, k, v, out, lse2, do)
        (call,), got = _calls(mine, fused, q, k, v, do, lse2, delta)
        call()
        torch.cuda.synchronize()
        errs = _errors(got, wants)
        turns = [("kernel", call)]
        if parent is not None:
            calls, _ = _calls(parent, parent_entries, q, k, v, do, lse2, delta)

            def both(calls=calls):
                for c in calls:
                    c()
            who = "parent fused" if parent_entries == fused else "parent template"
            turns = [(who, both), *turns, *turns, (who, both)]
        ms = [best_ms(fn) for _, fn in turns]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(*leaves)
        sdpa = best_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True))
        b, h, sq, d = shape
        bound_ms = 10 * b * h * sq * sk * d / F32_FLOPS * 1e3
        kernel_ms = min(t for (who, _), t in zip(turns, ms) if who == "kernel")
        order = [*range(len(variants)), 0]
        var_ms, var_err = [], []
        for i in order:
            (vcall,), vgot = _calls(variants[i], fused, q, k, v, do, lse2, delta)
            vcall()
            torch.cuda.synchronize()
            # the ablation leaves dq at zero: its dk and dv only
            var_err.append(max(_errors(vgot, wants)[1 if "ABLATE" in str(F32_VARIANTS[i][1])
                                                    else 0:]))
            var_ms.append(best_ms(vcall))
        print(f"fused f32 q{list(shape)} sk={sk}: "
              + ", ".join(f"{who} {t:.4f}" for (who, _), t in zip(turns, ms))
              + f" ms; SDPA backward {sdpa:.4f} ms, kernel / SDPA {kernel_ms / sdpa:.3f}; bound "
              f"{bound_ms:.4f} ms ({bound_ms / kernel_ms:.1%}); rel err dq / dk / dv "
              f"{' / '.join(f'{e:.2e}' for e in errs)} (tol {F32_TOL:g}); variants "
              + ", ".join(f"{F32_VARIANTS[i][0]} {t:.4f} (err {e:.1e})"
                          for i, t, e in zip(order, var_ms, var_err)) + " ms")
        records.append({"shape": list(shape), "sk": sk,
                        "turns": [[w, t] for (w, _), t in zip(turns, ms)], "sdpa_ms": sdpa,
                        "bound_ms": bound_ms, "rel_err": errs, "variant_err": max(var_err),
                        "variants_ms": [[F32_VARIANTS[i][0], t] for i, t in zip(order, var_ms)]})
        del q, k, v, do, out, lse2, delta, lib_out, leaves
        torch.cuda.empty_cache()
    return records


def sdpa_backend():
    """The kernels SDPA's float32 backward launches (TF32 off), from one trace."""
    q, k, v, do, *_ = _inputs((1, 8, 4096, 40), 4096, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(*leaves)
    torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(out, leaves, do, retain_graph=True)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if str(e.device_type).endswith("CUDA")})
    print(f"SDPA float32 backward [1, 8, 4096, 40] launches: {names}")
    return names


def _bwd(lib, q, k, v, do, lse2, delta):
    calls, got = _calls(lib, flash.bwd_entry(q.dtype, q.shape[3]), q, k, v, do, lse2, delta)
    for call in calls:
        call()
    torch.cuda.synchronize()
    return got


def kept_identity(mine, parent) -> bool:
    """The outputs this tree keeps from the parent, bit for bit on the same
    inputs: the backward kernels (the tensor cores in bf16; the template by
    its entry points at d = 512 in both dtypes and in bf16 at d = 40 / 80;
    the fused float32 kernel's dk and dv), the float32 forward kernels at
    d = 40 / 80 and at 512 (its five entry points, where the parent has the
    source) and the template's forward outputs."""
    same = True
    cases = [(shape, sk, dtype, lib) for shape, sk in (((1, 8, 1024, 40), 1024),
                                                       ((1, 8, 1000, 80), 1064))
             for dtype, lib in ((torch.bfloat16, "flash_attention_bwd_tc.cu"),
                                (torch.bfloat16, "flash_attention_bwd.cu"))]
    cases += [((1, 1, 2048, 512), 2048, dtype, "flash_attention_bwd.cu")
              for dtype in (torch.float32, torch.bfloat16)]
    for shape, sk, dtype, lib in cases:
        q, k, v, do, _, lse2, delta = _inputs(shape, sk, dtype, seed=shape[2] + shape[3])
        lse2 = lse2.contiguous()
        if lib == "flash_attention_bwd_tc.cu":
            outs = [_bwd(x, q, k, v, do, lse2, delta) for x in (mine, parent[lib])]
        else:  # the template by its own entry points
            outs = []
            for x in (mine, parent[lib]):
                calls, got = _calls(x, ("hedit_flash_attention_bwd_dq",
                                        "hedit_flash_attention_bwd_dkv"),
                                    q, k, v, do, lse2, delta)
                for call in calls:
                    call()
                torch.cuda.synchronize()
                outs.append(got)
        equal = _same(*outs)
        same &= equal
        print(f"identity backward ({lib}) q{list(shape)} sk={sk} {str(dtype)[6:]}: "
              f"{'bit-identical to the parent' if equal else 'DIFFERS from the parent'}")
    if "flash_attention_bwd_f32.cu" in parent:
        for shape, sk in (((1, 8, 1024, 40), 1024), ((1, 8, 1000, 80), 1064)):
            q, k, v, do, _, lse2, delta = _inputs(shape, sk, torch.float32, seed=shape[2])
            outs = [_bwd(x, q, k, v, do, lse2, delta)[1:]
                    for x in (mine, parent["flash_attention_bwd_f32.cu"])]
            equal = _same(*outs)
            same &= equal
            print(f"identity backward (flash_attention_bwd_f32.cu, dk and dv) q{list(shape)} "
                  f"sk={sk} float32: "
                  f"{'bit-identical to the parent' if equal else 'DIFFERS from the parent'}")
    forwards = [(lib, entry, case, packed, lse, dtype) for lib, entry, case, packed, lse, dtype in (
        ("flash_attention_f32.cu", "hedit_flash_attention_fwd_f32", (2, 8, 1024, 1024, 40),
         False, False, torch.float32),
        ("flash_attention_f32.cu", "hedit_flash_attention_fwd_lse_f32", (1, 8, 1000, 1064, 80),
         False, True, torch.float32),
        ("flash_attention_f32.cu", "hedit_flash_attention_fwd_packed_bounded_f32",
         (2, 8, 1024, 1024, 80), True, False, torch.float32),
        ("flash_attention_f32.cu", "hedit_flash_attention_fwd_lse_f32", (1, 8, 4096, 4096, 40),
         False, True, torch.float32),
        ("flash_attention.cu", "hedit_flash_attention_fwd_exact", (2, 8, 1024, 1024, 40), False,
         False, torch.float32),
        ("flash_attention.cu", "hedit_flash_attention_fwd_packed", (2, 8, 1000, 1064, 80), True,
         False, torch.float32),
        ("flash_attention.cu", "hedit_flash_attention_fwd", (1, 1, 1024, 1024, 512), False,
         False, torch.float32),
        ("flash_attention.cu", "hedit_flash_attention_fwd_lse", (1, 1, 1000, 1100, 512), False,
         True, torch.float32),
        ("flash_attention.cu", "hedit_flash_attention_fwd_lse", (1, 8, 1024, 1024, 40), False,
         True, torch.bfloat16),
        ("flash_attention_f32_512.cu", "hedit_flash_attention_fwd_f32_512",
         (1, 1, 1024, 1024, 512), False, False, torch.float32),
        ("flash_attention_f32_512.cu", "hedit_flash_attention_fwd_lse_f32_512",
         (1, 1, 2048, 2048, 512), False, True, torch.float32),
        ("flash_attention_f32_512.cu", "hedit_flash_attention_fwd_exact_f32_512",
         (1, 1, 1000, 1100, 512), False, False, torch.float32),
        ("flash_attention_f32_512.cu", "hedit_flash_attention_fwd_packed_bounded_f32_512",
         (1, 2, 1024, 1024, 512), True, False, torch.float32),
        ("flash_attention_f32_512.cu", "hedit_flash_attention_fwd_packed_exact_f32_512",
         (2, 2, 300, 300, 512), True, False, torch.float32))
        if lib in parent]
    for lib, entry, (b, h, sq, sk, d), packed, lse, dtype in forwards:
        g = torch.Generator(device="cuda").manual_seed(sq + sk)
        q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda") for s in (sq, sk, sk))
        if packed:
            q, k, v = (t.transpose(1, 2).reshape(b, -1, h * d) for t in (q, k, v))
        q, k, v = (t.to(dtype).contiguous() for t in (q, k, v))
        outs = []
        for x in (mine, parent[lib]):
            call, got = _forward(x, entry, q, k, v, h if packed else None, lse)
            call()
            outs.append(got)
        torch.cuda.synchronize()
        equal = _same(*outs)
        same &= equal
        print(f"identity forward {entry} ({lib}) q{list(q.shape)} sk={sk} {str(dtype)[6:]}: "
              f"{'bit-identical to the parent' if equal else 'DIFFERS from the parent'}")
    return same


NMG_LOOP = """
import torch, chip_smoke as cs
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_build()
pipe = create_sd_pipeline(tiny=False, num_inference_steps=cs.STEPS, seed=0,
                          dtype=torch.float32, device="cuda")
print("failures", cs.phase_nmg_identity(pipe)[1])
"""


def nmg_loop_turns(parent: Path) -> None:
    """``chip_smoke.phase_nmg_identity`` of the parent and of this tree in
    turns, each in its own process in its own tree."""
    here = Path(__file__).resolve().parents[2]
    for who, root in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        p = subprocess.run([sys.executable, "-c", NMG_LOOP], cwd=root, capture_output=True,
                           text=True)
        lines = [ln for ln in p.stdout.splitlines() if "NMG identity" in ln or "failures" in ln]
        print(f"nmg_f32 loop, {who} ({root}), rc {p.returncode}: " + " | ".join(lines)
              + ("" if p.returncode == 0 else p.stderr[-2000:]))


VAE_LOOP = """
import time, torch, chip_smoke as cs
cs.phase_build()
pipe, images = cs._main_path_inputs()[:2]
x0 = pipe.vae_encode(images[:1])
times = []
for i in range(6):
    cs.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latent = x0.detach().requires_grad_()
    with torch.enable_grad():
        loss = pipe.vae.decode(latent).float().square().mean()
    grad, = torch.autograd.grad(loss, latent)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
moved = {n: c for n, c in cs.read_launches().items() if "bwd" in n and c}
print("vae gradient ms", [round(t, 3) for t in times], "launches", moved,
      "finite", bool(torch.isfinite(grad).all()))
"""


def vae_loop_turns(parent: Path) -> None:
    """The bf16 VAE decode's gradient at 512 px (``chip_smoke.py``'s
    ``vae_gradient`` path: d loss / d latent, the decoder's mid-block
    attention through the d = 512 backward) six times, host clock around
    each call ended by a synchronise, of the parent and of this tree in
    turns, each in its own process in its own tree."""
    here = Path(__file__).resolve().parents[2]
    for who, root in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        p = subprocess.run([sys.executable, "-c", VAE_LOOP], cwd=root, capture_output=True,
                           text=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("vae gradient")]
        print(f"vae_gradient loop, {who} ({root}), rc {p.returncode}: " + " | ".join(lines)
              + ("" if p.returncode == 0 else p.stderr[-2000:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit")
    ap.add_argument("--tc", action="store_true", help="also sweep the tensor-core tiles")
    ap.add_argument("--nmg-loop", action="store_true",
                    help="time the float32 NMG loop of the parent and of this tree in turns")
    ap.add_argument("--vae-loop", action="store_true",
                    help="time the bf16 VAE decode's gradient of the parent and of this tree "
                         "in turns")
    ap.add_argument("--f32-512", action="store_true",
                    help="the float32 backward at d = 512 (flash_attention_bwd_f32_512.cu)")
    args = ap.parse_args(argv)
    require_cuda("flash_bwd_tiles")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if args.f32_512:
        return f512_main(args.parent)
    builds = [(F32_SOURCE, f"f32_variant{i}", _build.CSRC, defines)
              for i, (_, defines) in enumerate(F32_VARIANTS)]
    if args.parent is not None:
        csrc = args.parent / "hedit_tpu_torch" / "csrc"
        builds += [(csrc / name, f"parent_{name[:-3]}", csrc, ()) for name in PARENT_SOURCES]
    builds = [b for b in builds if b[0].exists()]  # a parent may predate a source
    with ThreadPoolExecutor(len(builds)) as ex:
        built = list(ex.map(lambda a: build_alone(a[0], OUT_DIR / f"{a[1]}.so", a[2], a[3]),
                            builds))
    for (source, name, *_), (_, info) in zip(builds, built):
        print(f"ptxas, {name} ({source.name}): {info}")
    mine = _build.cuda_library()
    n = len(F32_VARIANTS)
    parent = {source.name: lib for (source, *_), (lib, _) in zip(builds[n:], built[n:])}
    records = f32_timings(mine, [lib for lib, _ in built[:n]],
                          parent.get("flash_attention_bwd_f32.cu",
                                     parent.get("flash_attention_bwd.cu")))
    backend = sdpa_backend()
    print(json.dumps({"flash_bwd_f32_tiles": records, "sdpa_float32_backward_kernels": backend}))
    vae = vae_timings(mine, parent.get("flash_attention_bwd.cu"))
    print(json.dumps({"flash_bwd_tc_512": vae}))
    worst = sweep() if args.tc else 0.0
    if args.nmg_loop and args.parent is not None:
        nmg_loop_turns(args.parent.resolve())
    if args.vae_loop and args.parent is not None:
        vae_loop_turns(args.parent.resolve())
    bad = [r for r in records if not (max(r["rel_err"]) <= F32_TOL
                                      and r["variant_err"] <= F32_TOL)]
    bad += [r for r in vae if max(r["err_over_tol"]) > 1]
    if worst > 1:
        bad.append(f"a tile variant at {worst:.3f} of its tolerance")
    if bad:
        print(f"FAILED: outputs beyond their tolerance: {bad}")
        return 1
    if args.parent is not None and not (
            identity(mine, parent["flash_attention_tc.cu"], exact=True)
            & probe_identity(mine, parent["flash_probes_tc.cu"], parent["flash_variants.cu"])
            & kept_identity(mine, parent)):
        print("FAILED: an output this tree keeps differs from the parent's")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
