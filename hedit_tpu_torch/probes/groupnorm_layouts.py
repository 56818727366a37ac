"""GroupNorm(+SiLU) and the layouts around it on the card.

    python -m hedit_tpu_torch.probes.groupnorm_layouts [--parent DIR]

At each GroupNorm shape of the SD-1.5 paths (``SHAPES``), in bf16 and
float32: the CUDA kernel on channels-last x (its regime, tile and cluster
size, and how many of its clusters the card runs at once), the one PyTorch
call that computes the same function (``F.silu(F.group_norm(...))``) on the
same channels-last x and on its NCHW-contiguous copy, and the least time
the card could take (x read once, y written once, w and b read once, at
3.35 TB/s).  Then one 3x3 convolution of the UNet at three shapes in bf16,
NCHW against channels-last (the transposes cuDNN adds to NCHW).

``--parent DIR``: a checkout of an earlier commit of this repository (for
example ``git archive <commit> | tar -x -C DIR``); its ``ops/groupnorm.py``
``group_norm`` is timed on the NCHW-contiguous x at the same shapes, in a
process of its own started from DIR, once before and once after this
process's timings.  Device time: CUDA-event means of 10 calls captured in
one CUDA graph (``cuda_graph_ms``); eager: of 10 calls launched from Python
(``cuda_ms``), which is the host's pace where it is slower than the kernel.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

from hedit_tpu_torch.ops import groupnorm as gn
from hedit_tpu_torch.probes.timing import cuda_graph_ms, cuda_ms, require_cuda

HBM_BYTES_S = 3.35e12
# (shape, eps, act) of the table in PERF.md section 6, row 2
SHAPES = (((8, 320, 64, 64), 1e-5), ((2, 320, 64, 64), 1e-5), ((8, 960, 64, 64), 1e-5),
          ((8, 640, 64, 64), 1e-5), ((8, 1920, 32, 32), 1e-5), ((8, 1280, 8, 8), 1e-5),
          ((8, 2560, 8, 8), 1e-5), ((2, 512, 64, 64), 1e-6), ((2, 128, 512, 512), 1e-6),
          ((2, 256, 256, 256), 1e-6))
CONV_SHAPES = ((8, 320, 64, 64), (8, 640, 32, 32), (8, 1280, 16, 16))

# run in the parent checkout, after this module's ``cuda_graph_ms`` (the
# parent may not have it): its group_norm on NCHW-contiguous inputs
_PARENT_CODE = r"""
import json, sys, torch
from hedit_tpu_torch.ops import groupnorm as gn
from hedit_tpu_torch.probes.timing import cuda_ms
out = []
for shape, eps, dtype in json.loads(sys.argv[1]):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dt)
    w = torch.randn(shape[1], generator=g, device="cuda").to(dt)
    b = torch.randn(shape[1], generator=g, device="cuda").to(dt)
    before = gn.launches
    fn = lambda: gn.group_norm(x, w, b, groups=32, eps=eps, act="silu")
    out.append(dict(shape=shape, dtype=dtype, ms=cuda_graph_ms(fn), eager_ms=cuda_ms(fn),
                    launched=gn.launches - before))
print(json.dumps(out))
"""


def _inputs(shape, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    w = torch.randn(shape[1], generator=g, device="cuda").to(dtype)
    b = torch.randn(shape[1], generator=g, device="cuda").to(dtype)
    return x.contiguous(memory_format=torch.channels_last), w, b


def active_clusters(tile: gn.Plan, hw: int, c: int, dtype) -> int:
    """How many clusters of ``tile``'s slice kernel the card runs at once."""
    import ctypes

    from hedit_tpu_torch._build import cuda_library

    n = ctypes.c_int(0)
    err = cuda_library().hedit_group_norm_active_clusters(
        hw, c, 32, tile.cb, tile.cluster, tile.pixels, tile.threads,
        0 if dtype == torch.float32 else 1, ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"hedit_group_norm_active_clusters failed (code {err}) for {tile}")
    return n.value


def groupnorm_rows():
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape, eps in SHAPES:
            x, w, b = _inputs(shape, dtype)
            xn = x.contiguous()
            call = dict(groups=32, eps=eps, act="silu")
            bsz, c, h, wd = shape
            tile = gn.plan(bsz, h * wd, c, 32, x.element_size(),
                           torch.cuda.get_device_properties(0).multi_processor_count)
            bound_ms = x.element_size() * (2 * x.numel() + 2 * c) / HBM_BYTES_S * 1e3
            kernel = lambda: gn.group_norm_cuda(x, w, b, **call)  # noqa: E731
            ms = cuda_graph_ms(kernel)
            rows.append(dict(
                shape=list(shape), dtype=str(dtype)[6:], regime=tile.regime, cb=tile.cb,
                cluster=tile.cluster, pixels=tile.pixels, threads=tile.threads,
                active_clusters=active_clusters(tile, h * wd, c, dtype),
                ms=ms, eager_ms=cuda_ms(kernel), bound_ms=bound_ms, share=bound_ms / ms,
                library_cl_ms=cuda_graph_ms(lambda: F.silu(F.group_norm(x, 32, w, b, eps))),
                library_nchw_ms=cuda_graph_ms(
                    lambda: F.silu(F.group_norm(xn, 32, w, b, eps)))))
            del x, xn
    return rows


def conv_rows():
    rows = []
    for shape in CONV_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        c = shape[1]
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        conv = torch.nn.Conv2d(c, c, 3, padding=1, device="cuda", dtype=torch.bfloat16)
        with torch.no_grad():
            nchw = cuda_graph_ms(lambda: conv(x))
            conv.to(memory_format=torch.channels_last)
            xc = x.contiguous(memory_format=torch.channels_last)
            cl = cuda_graph_ms(lambda: conv(xc))
        rows.append(dict(shape=list(shape), nchw_ms=nchw, channels_last_ms=cl))
    return rows


def parent_rows(parent: str):
    cases = [[list(shape), eps, dtype] for dtype in ("bfloat16", "float32")
             for shape, eps in SHAPES]
    env = dict(os.environ, PYTHONPATH=os.path.abspath(parent))
    code = "import torch\n" + inspect.getsource(cuda_graph_ms) + _PARENT_CODE
    out = subprocess.run([sys.executable, "-c", code, json.dumps(cases)],
                         cwd=parent, env=env, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"the parent's timing failed:\n{out.stdout}\n{out.stderr}")
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    if not all(r["launched"] > 0 for r in rows):
        raise RuntimeError(f"the parent's group_norm launched no kernel: {rows}")
    return rows


def run(parent=None):
    require_cuda("groupnorm_layouts")
    result = {}
    if parent:
        result["parent_before"] = parent_rows(parent)
    result["groupnorm"] = groupnorm_rows()
    result["conv"] = conv_rows()
    if parent:
        result["parent_after"] = parent_rows(parent)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    args = ap.parse_args(argv)
    result = run(args.parent)
    for key, rows in result.items():
        for r in rows:
            print(f"{key}: {json.dumps(r)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
