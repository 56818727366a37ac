"""Build and load the port's CUDA kernels.

The CUDA sources under ``csrc/`` are compiled by ``nvcc`` into one shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds.  The library lands in
``hedit_tpu_torch/_build/`` (git-ignored), named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Triton's compile cache is pointed at the same directory.

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
              "-shared", "-Xcompiler", "-fPIC")

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
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(str(p) for p in srcs if p.suffix == ".cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(so))
    fn = lib.hedit_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def configure_triton_cache() -> None:
    """Keep Triton's compiled kernels beside the CUDA library."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
