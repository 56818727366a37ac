"""Build and load the port's CUDA kernels.

The CUDA sources under ``csrc/`` are compiled by ``nvcc`` into one shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds.  Each ``.cu`` is compiled to an object by
its own ``nvcc``, all started together, and one more call links them.  The
library lands in
``hedit_tpu_torch/_build/`` (git-ignored), named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.

Everything happens at first use, never at import: the CPU-only test
environment imports every module of the port and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# every pointer and the stream as c_void_p: ctypes would pass a bare Python
# int as a 32-bit int and cut the pointer
ARGTYPES = {
    # q, k, v, out | bh, sq, sk, d, anchor, dtype | stream
    "hedit_flash_attention_fwd": [_P] * 4 + [_I] * 6 + [_P],
    # q, k, v, out, lse | bh, sq, sk, d, anchor, dtype | stream
    "hedit_flash_attention_fwd_lse": [_P] * 5 + [_I] * 6 + [_P],
    # q, k, v, out | bh, sq, sk, d, dtype | stream
    "hedit_flash_attention_fwd_exact": [_P] * 4 + [_I] * 5 + [_P],
    # q, k, v, out | b, h, sq, sk, d | batch strides of q, k, v | dtype | stream
    "hedit_flash_attention_fwd_packed": [_P] * 4 + [_I] * 5 + [_L] * 3 + [_I, _P],
    # q, k, v, out | b, h, sq, sk, d, anchor | batch strides of q, k, v | dtype | stream
    "hedit_flash_attention_fwd_packed_bounded": [_P] * 4 + [_I] * 6 + [_L] * 3 + [_I, _P],
    # hedit_flash_attention_fwd and ..._packed_bounded in bf16 on the tensor
    # cores (flash_attention_tc.cu), the same arguments
    "hedit_flash_attention_fwd_tc": [_P] * 4 + [_I] * 6 + [_P],
    "hedit_flash_attention_fwd_packed_bounded_tc": [_P] * 4 + [_I] * 6 + [_L] * 3 + [_I, _P],
    # hedit_flash_attention_fwd_lse in bf16 on the tensor cores, the same arguments
    "hedit_flash_attention_fwd_lse_tc": [_P] * 5 + [_I] * 6 + [_P],
    # the three bounded entries in float32 at d = 40 / 80 (flash_attention_f32.cu),
    # the same arguments
    "hedit_flash_attention_fwd_f32": [_P] * 4 + [_I] * 6 + [_P],
    "hedit_flash_attention_fwd_packed_bounded_f32": [_P] * 4 + [_I] * 6 + [_L] * 3 + [_I, _P],
    "hedit_flash_attention_fwd_lse_f32": [_P] * 5 + [_I] * 6 + [_P],
    # the exact entries (head-split and packed) in float32 at d = 40 / 80, the
    # same file, the same arguments
    "hedit_flash_attention_fwd_exact_f32": [_P] * 4 + [_I] * 5 + [_P],
    "hedit_flash_attention_fwd_packed_exact_f32": [_P] * 4 + [_I] * 5 + [_L] * 3 + [_I, _P],
    # the bounded, LSE and exact entries (head-split and packed) in float32 at
    # d = 512 (flash_attention_f32_512.cu), the same arguments
    "hedit_flash_attention_fwd_f32_512": [_P] * 4 + [_I] * 6 + [_P],
    "hedit_flash_attention_fwd_packed_bounded_f32_512": [_P] * 4 + [_I] * 6 + [_L] * 3 + [_I, _P],
    "hedit_flash_attention_fwd_lse_f32_512": [_P] * 5 + [_I] * 6 + [_P],
    "hedit_flash_attention_fwd_exact_f32_512": [_P] * 4 + [_I] * 5 + [_P],
    "hedit_flash_attention_fwd_packed_exact_f32_512": [_P] * 4 + [_I] * 5 + [_L] * 3 + [_I, _P],
    # cluster | out (int *): the clusters of the float32 d = 512 kernel the card
    # runs at once
    "hedit_flash_attention_f32_512_active_clusters": [_I, _P],
    # hedit_flash_attention_fwd_exact and ..._packed in bf16 on the tensor
    # cores, the same arguments
    "hedit_flash_attention_fwd_exact_tc": [_P] * 4 + [_I] * 5 + [_P],
    "hedit_flash_attention_fwd_packed_exact_tc": [_P] * 4 + [_I] * 5 + [_L] * 3 + [_I, _P],
    # q, k, v, dout, lse, delta, dq | bh, sq, sk, d, dtype | stream
    "hedit_flash_attention_bwd_dq": [_P] * 7 + [_I] * 5 + [_P],
    # q, k, v, dout, lse, delta, dk, dv | bh, sq, sk, d, dtype | stream
    "hedit_flash_attention_bwd_dkv": [_P] * 8 + [_I] * 5 + [_P],
    # the same two in bf16 on the tensor cores (flash_attention_bwd_tc.cu)
    "hedit_flash_attention_bwd_dq_tc": [_P] * 7 + [_I] * 5 + [_P],
    "hedit_flash_attention_bwd_dkv_tc": [_P] * 8 + [_I] * 5 + [_P],
    # q, k, v, dout, lse, delta, dq, dk, dv | bh, sq, sk, d, dtype | stream: the
    # fused float32 backward at d = 40 / 80 (flash_attention_bwd_f32.cu)
    "hedit_flash_attention_bwd_f32": [_P] * 9 + [_I] * 5 + [_P],
    # float32 at d = 512 (flash_attention_bwd_f32_512.cu), two launches: q, k,
    # v, dout, lse, delta, ds (the workspace), dk, dv | bh, sq, sk, d, dtype |
    # stream; then k, ds, dq | bh, sq, sk, d, dtype | stream
    "hedit_flash_attention_bwd_dkv_f32_512": [_P] * 9 + [_I] * 5 + [_P],
    "hedit_flash_attention_bwd_dq_f32_512": [_P] * 3 + [_I] * 5 + [_P],
    # q, k, v, out | bh, sq, sk, d, anchor, layout, dtype | stream
    "hedit_flash_packed_t": [_P] * 4 + [_I] * 7 + [_P],
    # hedit_flash_packed_t in bf16 on the tensor cores (flash_probes_tc.cu),
    # the same arguments
    "hedit_flash_packed_t_tc": [_P] * 4 + [_I] * 7 + [_P],
    # q, k, v, out | bh, sq, sk, d, pipe, dtype | stream
    "hedit_flash_exp2_t": [_P] * 4 + [_I] * 6 + [_P],
    # hedit_flash_exp2_t in bf16 on the tensor cores, the same arguments
    "hedit_flash_exp2_t_tc": [_P] * 4 + [_I] * 6 + [_P],
    # q, k, v, out | bh, sq, sk, d, mode, dtype | stream
    "hedit_flash_ablate_t": [_P] * 4 + [_I] * 6 + [_P],
    # hedit_flash_ablate_t in bf16 on the tensor cores, the same arguments
    "hedit_flash_ablate_t_tc": [_P] * 4 + [_I] * 6 + [_P],
    # q, k, v, out, scores, sums | bh, sq, sk, d, dtype | stream: its dots mode,
    # also storing the float32 scores and row sums
    "hedit_flash_ablate_dots_check_tc": [_P] * 6 + [_I] * 5 + [_P],
    # q, k, v, out | bh, sq, sk, d, variant, dtype | stream
    "hedit_flash_variant": [_P] * 4 + [_I] * 6 + [_P],
    # q, k, v, out | bh, sq, sk, d, dtype | stream: row 9 c (kern_c)
    "hedit_flash_variant_c": [_P] * 4 + [_I] * 5 + [_P],
    # hedit_flash_variant in bf16 on the tensor cores (variant 1), the same arguments
    "hedit_flash_variant_tc": [_P] * 4 + [_I] * 6 + [_P],
    # a, b, o, ws | m, n, k, reps, layout, rm, rn, tx, ty, kt, chunk, ksplits,
    # rchunk, rsplits, dtype | stream (float32, CUDA cores)
    "hedit_mm_loop": [_P] * 4 + [_I] * 15 + [_P],
    # a, b, o, ws | m, n, k, reps, layout, bm, bn, chunk, splits, dtype | stream
    # (bf16, tensor cores, mm_probe_tc.cu)
    "hedit_mm_loop_tc": [_P] * 4 + [_I] * 10 + [_P],
    # x, w, b, y, partials | batch, hw, c, groups, cb, cluster, pixels, threads,
    # apply_pixels, apply_threads | eps | silu, dtype | stream
    "hedit_group_norm_nhwc": [_P] * 5 + [_I] * 10 + [_F] + [_I] * 2 + [_P],
    # hw, c, groups, cb, cluster, pixels, threads, dtype | out (int *)
    "hedit_group_norm_active_clusters": [_I] * 8 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def cuda_library() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` for sm_90a if needed and return the loaded library."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libhedit_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _compile([p for p in srcs if p.suffix == ".cu"], so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _compile(cus, so: Path) -> None:
    """One ``nvcc -c`` a source, all running at once, then the link."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (p.stem + ".o") for p in cus]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", str(o)] for p, o in zip(cus, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        results = [(c, p, *p.communicate()) for c, p in zip(cmds, procs)]  # waits for every one
        out = Path(tmp) / so.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *(str(o) for o in objs)]
        if all(p.returncode == 0 for _, p, _, _ in results):
            p = subprocess.run(link, capture_output=True, text=True)
            results.append((link, p, p.stdout, p.stderr))
        failed = [(c, p, o, e) for c, p, o, e in results if p.returncode != 0]
        if failed:
            raise RuntimeError("\n".join(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{o}\n{e}"
                                         for c, p, o, e in failed))
        os.replace(out, so)  # atomic: a concurrent loader never sees half a file

