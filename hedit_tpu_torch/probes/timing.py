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


def build_alone(source: Path, so: Path, include: Path, defines=()):
    """``source`` built alone into the shared library ``so`` with the port's
    nvcc flags and ``-D`` each of ``defines``: (ctypes library with the
    loader's argument types for the entry points it has, ptxas's register
    and spill lines)."""
    so.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-I", str(include),
           *(f"-D{d}" for d in defines), str(source), "-o", str(so)]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{p.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in _build.ARGTYPES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    return lib, " | ".join(_ptxas_kernels(p.stderr))


def _ptxas_kernels(log: str):
    """One line a kernel of ``-Xptxas -v``'s log: its name with its template
    arguments (``kernel<80,8,1,...>``, read from the mangled name), its
    registers, and its spills where it has any."""
    found, name = [], "?"
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            # the kernel's identifier: the one whose length prefix is its length
            names = [m.group(2) for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*?_kernel)I)", mangled)
                     if int(m.group(1)) == len(m.group(2))]
            # int and bool arguments (Li40E, Lb1E), and enum ones of the
            # sources' anonymous namespace (LNS_2OpE3E)
            args = re.findall(r"L(?:[ib]|NS_\d+\w+?E|N12_GLOBAL__N_1\d+[A-Za-z_]\w*?E)(\d+)E",
                              mangled)
            name = (names[0] if names else mangled) + (f"<{','.join(args)}>" if args else "")
        elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            found.append(f"{name}: {line.strip()}")
        else:
            used = re.search(r"Used \d+ registers", line)
            if used:
                found.append(f"{name}: {used.group(0)}")
    return found
