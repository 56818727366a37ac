"""What the probes share: the card check, CUDA-event timing and a build of
one CUDA source alone (the tile probes' variants)."""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import torch

from hedit_tpu_torch import _build


def require_cuda(what: str) -> None:
    """Raise unless a CUDA device is present: the probes time the card."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times the CUDA kernels and needs a CUDA device")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` in ms, over ``reps`` calls after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_ms(fn, reps: int = 10, warmup: int = 2, replays: int = 3) -> float:
    """Mean device time of ``fn`` in ms: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times after one warm replay, so no host work
    sits between the launches (``cuda_ms`` measures the host's pace when
    it is slower than the kernel).  ``warmup`` eager calls first, on a side
    stream, as capture requires."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def best_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """The least of ``tries`` ``cuda_ms`` readings of ``reps`` calls."""
    return min(cuda_ms(fn, reps=reps) for _ in range(tries))


def build_alone(source: Path, so: Path, include: Path):
    """``source`` built alone into the shared library ``so`` with the port's
    nvcc flags: (ctypes library with the loader's argument types for the
    entry points it has, ptxas's register and spill lines)."""
    so.parent.mkdir(parents=True, exist_ok=True)
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
    lines = p.stderr.splitlines()
    info = [re.sub(r".*?(Used \d+ registers).*", r"\1", line) for line in lines
            if "registers" in line]
    spills = [line.strip() for line in lines
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    return lib, " | ".join(info + spills)
