"""Trajectory capture / injection: the pixel-level parity route
(own copy of ``hedit_tpu/io_utils/trajectory.py``; the two packages read each
other's files).

h-Edit-R outputs depend on the sampled inversion trajectory (the independent
q(x_t | x0) draws and the derived residuals), so a pixel-level comparison
across frameworks injects a CAPTURED trajectory instead of sampling a new
one.  ``main_p2p`` exposes this as ``--save_trajectory`` / ``--load_trajectory``.

File format: a NumPy ``.npz`` of ONE image with keys
  * ``xts``: [S+1, H, W, C] float (required; ``xts[0] = x0``, ``xts[S] = xT``)
  * ``zs``: [S, H, W, C] posterior residuals (optional; when absent the edit
    loops derive them, ``derive_zs``)
  * ``noise_added``: [S+1, H, W, C] raw q-sampling noises (optional,
    diagnostic only)
  * ``num_steps``: scalar S (optional consistency check)

The layout is detected on load: a capture may store NCHW arrays with or
without a singleton batch axis ([S+1, 1, C, H, W] or [S+1, C, H, W]); they are
transposed to NHWC.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hedit_tpu_torch.invert.ddpm import InversionResult


def _to_nhwc(arr: np.ndarray, name: str) -> np.ndarray:
    """[T, ...] stack of latents -> [T, H, W, C] (C in {3, 4})."""
    if arr.ndim == 5:
        if arr.shape[1] != 1:
            raise ValueError(f"{name}: expected singleton batch dim, got {arr.shape}")
        arr = arr[:, 0]
    if arr.ndim != 4:
        raise ValueError(f"{name}: expected 4D/5D stack, got {arr.shape}")
    if arr.shape[-1] in (3, 4):
        return arr  # already NHWC
    if arr.shape[1] in (3, 4):
        return arr.transpose(0, 2, 3, 1)  # NCHW capture
    raise ValueError(f"{name}: cannot infer layout from shape {arr.shape} "
                     "(channel dim must be 3 or 4)")


def save_trajectory(path: str, inv: InversionResult) -> None:
    """Write a one-image InversionResult (NHWC, exact float32) to ``path``."""
    if inv.xts.shape[0] != 1:
        raise ValueError(f"a trajectory file holds one image, got {inv.xts.shape[0]}")
    data = {"xts": inv.xts[0].cpu().numpy(),
            "num_steps": np.asarray(inv.xts.shape[1] - 1, np.int64)}
    if inv.zs is not None:
        data["zs"] = inv.zs[0].cpu().numpy()
    if inv.noise_added is not None:
        data["noise_added"] = inv.noise_added[0].cpu().numpy()
    np.savez(path, **data)


def load_trajectory(path: str, expect_steps: Optional[int] = None,
                    device="cpu") -> InversionResult:
    """Read a captured trajectory (either package's, or an NCHW one) as a
    one-image InversionResult on ``device``."""
    with np.load(path) as f:
        xts = _to_nhwc(np.asarray(f["xts"], np.float32), "xts")
        zs = _to_nhwc(np.asarray(f["zs"], np.float32), "zs") if "zs" in f else None
        noise = (_to_nhwc(np.asarray(f["noise_added"], np.float32), "noise_added")
                 if "noise_added" in f else None)
        if "num_steps" in f:
            S = int(f["num_steps"])
            if xts.shape[0] != S + 1:
                raise ValueError(f"trajectory file claims {S} steps but xts has "
                                 f"{xts.shape[0]} entries (want S+1)")
    if expect_steps is not None and xts.shape[0] != expect_steps + 1:
        raise ValueError(f"trajectory has {xts.shape[0] - 1} steps, run expects {expect_steps}")
    if zs is not None and zs.shape[0] != xts.shape[0] - 1:
        raise ValueError(f"zs/xts length mismatch: {zs.shape[0]} vs {xts.shape[0]}")

    def put(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))[None].to(device)

    return InversionResult(xT=put(xts[-1]), zs=put(zs), xts=put(xts), noise_added=put(noise))
