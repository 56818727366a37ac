"""What the probes share: the card check and CUDA-event timing."""

from __future__ import annotations

import torch


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
