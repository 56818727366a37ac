"""The tensor-core flash backward's tiles, and the CUDA-core template, on the card.

    python -m hedit_tpu_torch.probes.flash_bwd_tiles [--parent DIR]

``csrc/flash_attention_bwd_tc.cu`` is built once for each variant of
``VARIANTS`` (its four launch lines rewritten to other tiles: warps of 16 own
rows, streamed rows a tile, blocks an SM), one ``nvcc -shared`` each, all
started together, into ``_build/bwd_tiles/``; ``-Xptxas -v`` gives each
kernel's registers and spills.  Each variant's dq and dk / dv kernels are
timed at the NMG gradient call's shapes and a ragged one through their entry
points, without the wrappers' host checks (CUDA-event means of 20 launches,
best of 3), in turns with the source's own tiles (variant 0) first and last,
and held to the plain backward before its final rounding (largest error over
2^-8 of the largest value, as ``chip_smoke.py`` holds the kernels).

``--parent DIR``: a checkout of an earlier commit of this repository (for
example ``git archive <commit> | tar -x -C DIR``); its CUDA-core backward
template (``csrc/flash_attention_bwd.cu``) is built beside this tree's and
both are timed in turns (parent, this, this, parent) at the template's
shapes: float32 at [1, 8, 4096, 40] and [1, 1, 4096, 512], bf16 at
[1, 1, 4096, 512].
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_attention as flash
from hedit_tpu_torch.probes.timing import cuda_ms, require_cuda

TC_SOURCE = _build.CSRC / "flash_attention_bwd_tc.cu"
# the source's launch lines, keyed by kernel and head dim
LAUNCHES = {"dq40": "launch_dq<40, 4, 64, 4>", "dkv40": "launch_dkv<40, 4, 64, 4>",
            "dq80": "launch_dq<80, 4, 128, 2>", "dkv80": "launch_dkv<80, 4, 128, 2>"}
# (warps, streamed rows, blocks an SM) of each kernel and head dim; variant 0
# is the source's own
VARIANTS = (
    dict(dq40=(4, 64, 4), dkv40=(4, 64, 4), dq80=(4, 128, 2), dkv80=(4, 128, 2)),
    dict(dq40=(4, 64, 5), dkv40=(4, 64, 3), dq80=(4, 64, 2), dkv80=(4, 64, 2)),
    dict(dq40=(8, 64, 2), dkv40=(8, 64, 2), dq80=(2, 128, 4), dkv80=(2, 128, 4)),
    dict(dq40=(4, 32, 5), dkv40=(4, 32, 4), dq80=(8, 128, 1), dkv80=(8, 128, 1)),
    dict(dq40=(8, 32, 2), dkv40=(8, 32, 2), dq80=(4, 256, 1), dkv80=(4, 256, 1)),
    dict(dq40=(2, 64, 8), dkv40=(2, 64, 8), dq80=(2, 64, 4), dkv80=(2, 64, 4)),
)
SHAPES = (((1, 8, 4096, 40), 4096), ((1, 8, 1024, 80), 1024), ((1, 8, 1000, 80), 1064))
TEMPLATE_SHAPES = (((1, 8, 4096, 40), 4096, torch.float32),
                   ((1, 1, 4096, 512), 4096, torch.bfloat16),
                   ((1, 1, 4096, 512), 4096, torch.float32))
ENTRIES = {"tc": ("hedit_flash_attention_bwd_dq_tc", "hedit_flash_attention_bwd_dkv_tc"),
           "core": ("hedit_flash_attention_bwd_dq", "hedit_flash_attention_bwd_dkv")}


def _library(source: Path, name: str, include: Path):
    """``source`` built alone into a shared library: (ctypes library with the
    loader's argument types, ptxas's register and spill lines)."""
    out = _build.BUILD_DIR / "bwd_tiles"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-I", str(include),
           str(source), "-o", str(so)]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{p.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in _build.ARGTYPES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    info = [re.sub(r".*?(Used \d+ registers).*", r"\1", line) for line in p.stderr.splitlines()
            if "registers" in line]
    spills = [line.strip() for line in p.stderr.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    return lib, " | ".join(info + spills)


def _variant_source(i: int) -> Path:
    text = TC_SOURCE.read_text()
    for key, tile in VARIANTS[i].items():
        if LAUNCHES[key] not in text:
            raise RuntimeError(f"{TC_SOURCE.name} no longer launches {LAUNCHES[key]}")
        text = text.replace(LAUNCHES[key], "launch_%s<%s, %d, %d, %d>" % (key[:-2], key[-2:],
                                                                          *tile))
    path = _build.BUILD_DIR / "bwd_tiles" / f"variant{i}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def _inputs(shape, sk, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(shape, generator=g, device="cuda").to(dtype)
    k = torch.randn(shape[:2] + (sk, shape[3]), generator=g, device="cuda").to(dtype)
    v = torch.randn(k.shape, generator=g, device="cuda").to(dtype)
    do = torch.randn(shape, generator=g, device="cuda").to(dtype)
    out, lse2 = flash.flash_attention_lse_cuda(q, k, v)
    delta = (do.float() * out.float()).sum(dim=-1)
    return q, k, v, do, out, lse2, delta


def _timers(lib, kind, q, k, v, do, lse2, delta):
    """(dq launch, dk / dv launch, their outputs) through ``lib``'s entry points."""
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ints = (q.shape[0] * q.shape[1], q.shape[2], k.shape[2], q.shape[3],
            1 if q.dtype == torch.bfloat16 else 0)

    def call(entry, *outs):
        err = getattr(lib, entry)(*(t.data_ptr() for t in (q, k, v, do, lse2, delta, *outs)),
                                  *ints, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{entry} failed (code {err})")

    dq_entry, dkv_entry = ENTRIES[kind]
    return (lambda: call(dq_entry, dq)), (lambda: call(dkv_entry, dk, dv)), (dq, dk, dv)


def _best_ms(fn):
    return min(cuda_ms(fn, reps=20) for _ in range(3))


def sweep() -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(lambda i: _library(_variant_source(i), f"variant{i}", _build.CSRC),
                            range(len(VARIANTS))))
    for i, (_, info) in enumerate(built):
        print(f"variant {i} {VARIANTS[i]}: {info}")
    for shape, sk in SHAPES:
        q, k, v, do, out, lse2, delta = _inputs(shape, sk, torch.bfloat16)
        wants = flash.flash_attention_backward_reference(q, k, v, out, lse2, do,
                                                         out_dtype=torch.float32)
        d = shape[3]
        for i in [*range(len(VARIANTS)), 0]:
            fdq, fdkv, got = _timers(built[i][0], "tc", q, k, v, do, lse2, delta)
            fdq()
            fdkv()
            torch.cuda.synchronize()
            err = max((a.float() - w).abs().max().item() / (2.0 ** -8 * w.abs().max().item())
                      for a, w in zip(got, wants))
            print(f"tiles q{list(shape)} sk={sk} variant {i}: dq {VARIANTS[i][f'dq{d}']} "
                  f"{_best_ms(fdq):.4f} ms, dk/dv {VARIANTS[i][f'dkv{d}']} {_best_ms(fdkv):.4f} "
                  f"ms, err / tol {err:.3f}")


def parent_template(parent: Path) -> None:
    csrc = parent / "hedit_tpu_torch" / "csrc"
    theirs, _ = _library(csrc / "flash_attention_bwd.cu", "parent_template", csrc)
    mine, _ = _library(_build.CSRC / "flash_attention_bwd.cu", "template", _build.CSRC)
    for shape, sk, dtype in TEMPLATE_SHAPES:
        q, k, v, do, _, lse2, delta = _inputs(shape, sk, dtype)
        turns = []
        for who, lib in (("parent", theirs), ("this", mine), ("this", mine), ("parent", theirs)):
            fdq, fdkv, _ = _timers(lib, "core", q, k, v, do, lse2, delta)
            turns.append(f"{who} {_best_ms(fdq):.4f} / {_best_ms(fdkv):.4f}")
        print(f"template q{list(shape)} sk={sk} {str(dtype)[6:]} dq / dk-dv ms: "
              + ", ".join(turns))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit")
    args = ap.parse_args(argv)
    require_cuda("flash_bwd_tiles")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sweep()
    if args.parent is not None:
        parent_template(args.parent)


if __name__ == "__main__":
    main()
