"""The float32 bounded forward (rows 1, 1p and 3 at d = 40 / 80), on the card.

    python -m hedit_tpu_torch.probes.flash_f32_tiles [--parent DIR]

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
and LSE at d = 512, bf16 bounded LSE at d = 40 / 80).
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
                  "flash_attention_bwd_tc.cu")


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
    """The backward kernels' outputs and the template's kept forward
    outputs of this tree and the parent on the same inputs, bit for bit."""
    same = True
    for shape, sk, dtype, tc in (((1, 8, 1024, 40), 1024, torch.bfloat16, True),
                                 ((1, 8, 1000, 80), 1064, torch.bfloat16, True),
                                 ((1, 8, 1024, 40), 1024, torch.bfloat16, False),
                                 ((1, 8, 1000, 80), 1064, torch.bfloat16, False),
                                 ((1, 1, 2048, 512), 2048, torch.float32, False),
                                 ((1, 1, 2048, 512), 2048, torch.bfloat16, False)):
        b, h, sq, d = shape
        q, k, v = _inputs(b, h, sq, sk, d, False, seed=sq + d, dtype=dtype)
        do = torch.randn(shape, device="cuda").to(dtype)
        out, lse2 = flash.flash_attention_lse_reference(q, k, v)
        delta = (do.float() * out.float()).sum(dim=-1)
        lse2 = lse2.contiguous()
        equal = _same(_bwd_outputs(mine, tc, q, k, v, do, lse2, delta),
                      _bwd_outputs(parent["flash_attention_bwd_tc.cu" if tc
                                          else "flash_attention_bwd.cu"],
                                   tc, q, k, v, do, lse2, delta))
        same &= equal
        print(f"identity backward ({'tensor cores' if tc else 'template'}) q{list(shape)} "
              f"sk={sk} {str(dtype)[6:]}: "
              f"{'bit-identical to the parent' if equal else 'DIFFERS from the parent'}")
    template = parent["flash_attention.cu"]
    for entry, (b, h, sq, sk, d), packed, lse, dtype in (
            ("hedit_flash_attention_fwd_exact", (2, 8, 1024, 1024, 40), False, False,
             torch.float32),
            ("hedit_flash_attention_fwd_exact", (1, 1, 1000, 1100, 512), False, False,
             torch.float32),
            ("hedit_flash_attention_fwd_packed", (2, 8, 1000, 1064, 80), True, False,
             torch.float32),
            ("hedit_flash_attention_fwd", (1, 1, 1024, 1024, 512), False, False, torch.float32),
            ("hedit_flash_attention_fwd_lse", (1, 1, 1000, 1100, 512), False, True,
             torch.float32),
            ("hedit_flash_attention_fwd_packed_bounded", (1, 2, 1024, 1024, 512), True, False,
             torch.float32),
            ("hedit_flash_attention_fwd_lse", (1, 8, 1024, 1024, 40), False, True,
             torch.bfloat16),
            ("hedit_flash_attention_fwd_lse", (1, 8, 1000, 1064, 80), False, True,
             torch.bfloat16)):
        q, k, v = _inputs(b, h, sq, sk, d, packed, seed=sq + sk, dtype=dtype)
        heads = h if packed else None
        outs = []
        for lib in (mine, template):
            call, got = _forward(lib, entry, q, k, v, heads, lse)
            call()
            outs.append(got)
        torch.cuda.synchronize()
        equal = _same(*outs)
        same &= equal
        print(f"identity template {entry} q{list(q.shape)} sk={sk} {str(dtype)[6:]}: "
              f"{'bit-identical to the parent' if equal else 'DIFFERS from the parent'}")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit")
    args = ap.parse_args(argv)
    require_cuda("flash_f32_tiles")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
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
