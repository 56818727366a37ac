"""The tensor-core LSE forward's tiles (row 3 in bf16), on the card.

    python -m hedit_tpu_torch.probes.flash_lse_tiles [--parent DIR]

``csrc/flash_attention_tc.cu`` is built once for each variant of
``VARIANTS`` (the launch lines of ``forward_lse_tc`` rewritten to other
tiles: warps of 16 query rows a block, blocks an SM as the register budget),
one ``nvcc -shared`` each, all started together, into ``_build/lse_tiles/``;
``-Xptxas -v`` gives each kernel's registers and spills.  Each variant's
``hedit_flash_attention_fwd_lse_tc`` is timed at the NMG gradient call's
one-image shapes and the VAE's, through its entry point without the
wrapper's host checks (CUDA-event means of 20 launches, best of 3), in turns
with the source's own tiles (variant 0) first and last, and held to the
bounded plain version before its final rounding (largest error over 2^-8 of
the largest value, as ``chip_smoke.py`` holds the kernel) and its lse2
(largest error over log2(1 + 2^-8)).  Beside them, on the same inputs: the
CUDA-core template's entry point ``hedit_flash_attention_fwd_lse`` in bf16
(row 3 before it moved to the tensor cores) and SDPA's forward.

``--parent DIR``: a checkout of an earlier commit of this repository (for
example ``git archive <commit> | tar -x -C DIR``); its CUDA-core forward
template (``csrc/flash_attention.cu``) is built beside this tree's and both
are timed in turns (parent, this, this, parent) at ``TEMPLATE_CASES``: the
LSE entry (row 3 on the float32 paths) and the exact entries (rows 6 and 7
at their callers' shapes; bf16 takes the tensor cores), in float32.
"""

from __future__ import annotations

import argparse
import math
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_attention as flash
from hedit_tpu_torch.probes.timing import best_ms, build_alone, require_cuda

TC_SOURCE = _build.CSRC / "flash_attention_tc.cu"
# forward_lse_tc's launch lines, keyed by head dim
LAUNCHES = {40: "launch_tc<40, 4, 1, 64, 5, true>", 80: "launch_tc<80, 4, 1, 64, 3, true>"}
# (warps along the rows, blocks an SM) of each head dim; variant 0 is the
# source's own, variant 1 at d = 80 the packed forward's.  Shared memory
# holds 5 (d = 40, 64 rows) to 7 (32 rows) blocks an SM at d = 40, 2 (128
# rows) to 4 (32 rows) at d = 80.
VARIANTS = (
    {40: (4, 5), 80: (4, 3)},
    {40: (2, 7), 80: (8, 2)},
    {40: (2, 5), 80: (2, 4)},
    {40: (4, 4), 80: (4, 2)},
)
SHAPES = (((1, 8, 4096, 40), 4096), ((1, 8, 1024, 80), 1024), ((1, 1, 4096, 512), 4096))
ENTRY = "hedit_flash_attention_fwd_lse_tc"
# (entry point, q shape [B, H, S, D], Sk, dtype) of the template's timings
TEMPLATE_CASES = (("hedit_flash_attention_fwd_lse", (1, 8, 4096, 40), 4096, torch.float32),
                  ("hedit_flash_attention_fwd_lse", (1, 1, 4096, 512), 4096, torch.float32),
                  ("hedit_flash_attention_fwd_exact", (8, 8, 4096, 40), 4096, torch.float32),
                  ("hedit_flash_attention_fwd_packed", (8, 8, 4096, 40), 4096, torch.float32))


def _library(source: Path, name: str, include: Path = _build.CSRC):
    return build_alone(source, _build.BUILD_DIR / "lse_tiles" / f"{name}.so", include)


def _variant_source(i: int) -> Path:
    text = TC_SOURCE.read_text()
    for d, (wr, minb) in VARIANTS[i].items():
        if LAUNCHES[d] not in text:
            raise RuntimeError(f"{TC_SOURCE.name} no longer launches {LAUNCHES[d]}")
        wc, bk = LAUNCHES[d].split(", ")[2:4]
        text = text.replace(LAUNCHES[d], f"launch_tc<{d}, {wr}, {wc}, {bk}, {minb}, true>")
    path = _build.BUILD_DIR / "lse_tiles" / f"variant{i}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def _launcher(lib, entry, q, k, v):
    """(a launch of ``entry`` through ``lib`` into out and lse2, out, lse2)."""
    out = torch.empty_like(q)
    lse2 = torch.empty(q.shape[0] * q.shape[1], 1, q.shape[2], device="cuda")
    d, sk = q.shape[3], k.shape[2]
    ints = (q.shape[0] * q.shape[1], q.shape[2], sk, d, flash.bounded_anchor(sk, d), 1)

    def call():
        err = getattr(lib, entry)(*(t.data_ptr() for t in (q, k, v, out, lse2)), *ints,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{entry} failed (code {err})")
    return call, out, lse2


def sweep() -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(lambda i: _library(_variant_source(i), f"variant{i}"),
                            range(len(VARIANTS))))
    for i, (_, info) in enumerate(built):
        print(f"variant {i} {VARIANTS[i]}: {info}")
    for shape, sk in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(shape[:2] + (sk, shape[3]), generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        want, want_lse = flash.flash_attention_lse_reference(q, k, v, out_dtype=torch.float32)
        d = shape[3]
        for i in [*range(len(VARIANTS)), 0] if d in LAUNCHES else [0]:
            call, out, lse2 = _launcher(built[i][0], ENTRY, q, k, v)
            call()
            torch.cuda.synchronize()
            err = (out.float() - want).abs().max().item() / (2.0 ** -8 * want.abs().max().item())
            err_lse = (lse2 - want_lse).abs().max().item() / math.log2(1 + 2.0 ** -8)
            tiles = VARIANTS[i].get(d, "the source's")
            print(f"lse tiles q{list(shape)} sk={sk} variant {i} {tiles}: {best_ms(call):.4f} ms, "
                  f"out err / tol {err:.3f}, lse2 err / tol {err_lse:.3f}")
        template, _, _ = _launcher(_build.cuda_library(), "hedit_flash_attention_fwd_lse",
                                   q, k, v)
        print(f"lse q{list(shape)} sk={sk}: the CUDA-core template in bf16 "
              f"{best_ms(template):.4f} ms, SDPA forward "
              f"{best_ms(lambda: F.scaled_dot_product_attention(q, k, v)):.4f} ms")


def _template_call(lib, entry, q, k, v):
    """A launch of the template's ``entry`` through ``lib`` (head-split LSE
    or exact; packed exact on the heads laid out [B, S, H*D])."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dtype = 1 if q.dtype == torch.bfloat16 else 0
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, entry)
    if entry.endswith("_packed"):
        qp, kp, vp = (t.transpose(1, 2).reshape(b, -1, h * d).contiguous() for t in (q, k, v))
        out = torch.empty_like(qp)
        args = ((qp, kp, vp, out), (b, h, sq, sk, d, sq * h * d, sk * h * d, sk * h * d))
    elif entry.endswith("_lse"):
        out, lse2 = torch.empty_like(q), torch.empty(b * h, 1, sq, device="cuda")
        args = ((q, k, v, out, lse2), (b * h, sq, sk, d, flash.bounded_anchor(sk, d)))
    else:
        args = ((q, k, v, torch.empty_like(q)), (b * h, sq, sk, d))

    def call():
        err = fn(*(t.data_ptr() for t in args[0]), *args[1], dtype, stream)
        if err:
            raise RuntimeError(f"{entry} failed (code {err})")
    return call


def parent_template(parent: Path) -> None:
    csrc = parent / "hedit_tpu_torch" / "csrc"
    with ThreadPoolExecutor(2) as ex:
        (theirs, _), (mine, _) = ex.map(lambda a: _library(*a), (
            (csrc / "flash_attention.cu", "parent_template", csrc),
            (_build.CSRC / "flash_attention.cu", "template", _build.CSRC)))
    for entry, shape, sk, dtype in TEMPLATE_CASES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn(shape, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(shape[:2] + (sk, shape[3]), generator=g, device="cuda").to(dtype)
                for _ in range(2))
        turns = [f"{who} {best_ms(_template_call(lib, entry, q, k, v)):.4f}"
                 for who, lib in (("parent", theirs), ("this", mine), ("this", mine),
                                  ("parent", theirs))]
        print(f"template {entry} q{list(shape)} sk={sk} {str(dtype)[6:]} ms: " + ", ".join(turns))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit")
    args = ap.parse_args(argv)
    require_cuda("flash_lse_tiles")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sweep()
    if args.parent is not None:
        parent_template(args.parent)


if __name__ == "__main__":
    main()
