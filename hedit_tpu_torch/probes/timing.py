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
