"""Rows 11b and 11c (the S-minor bounded probes) in bf16 on the tensor cores, on the card.

    python -m hedit_tpu_torch.probes.flash_sminor_tiles [--parent DIR]

Times ``csrc/flash_probes_tc.cu`` (entry point ``hedit_flash_packed_t_tc``)
in its two layouts, 1 (q, k ``[BH, D, S]``, v ``[BH, S, D]``: row 11b,
``_packed_t_kernel_sminor``) and 2 (q, k, v ``[BH, D, S]``: row 11c,
``_packed_t_kernel_all_sminor``), at ``CASES``: the probe's [16, 8, 4096,
40] and [16, 8, 1024, 80], anchored on the first 512 keys.  Each kernel is
launched through its entry point without the wrappers' host checks
(CUDA-event means of 20 launches, best of 3).  Beside it, on the same
values: the packed bounded tensor-core kernel on ``[B, S, H*D]`` (the
port's own route; the ratio is what the S-minor layout costs) and SDPA on
``[B, H, S, D]``.  Each output is held to its plain version before the
final rounding (largest error over 2^-8 of the largest value, as
``chip_smoke.py`` holds it).  ``csrc/flash_probes_tc.cu`` is also built
alone with ``-Xptxas -v``: each instance's registers and spills.

``--parent DIR``: a checkout of an earlier commit of this repository (for
example ``git archive <commit> | tar -x -C DIR``).  Its CUDA-core
template's S-minor entries in bf16 (``csrc/flash_probes.cu``: rows 11b and
11c before they moved to the tensor cores; this tree's template takes them
in float32 only) are timed in turns with this tree's kernel (parent, this,
this, parent), and its ``csrc/flash_attention_tc.cu`` is built beside this
tree's: the bounded and LSE tensor-core forwards of the two must agree bit
for bit on the smoke's inputs (``flash_exact_tiles.identity``); the probe
exits non-zero if they do not.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_probes as fp
from hedit_tpu_torch.probes.flash_exact_tiles import _call, identity
from hedit_tpu_torch.probes.timing import best_ms, build_alone, require_cuda

OUT_DIR = _build.BUILD_DIR / "sminor_tiles"
# (batch, heads, S, D): the probe's shape and the UNet's d = 80 level
CASES = ((16, 8, 4096, 40), (16, 8, 1024, 80))
# the entry point's layout codes and the probes' layout names
LAYOUTS = {1: "packed_t_sminor", 2: "packed_t_all_sminor"}


def _sminor(t):
    return t.transpose(-1, -2).contiguous()


def _probe_call(lib, entry, args, out, layout, anchor):
    """A launch of ``entry`` (``hedit_flash_packed_t[_tc]``) on the S-minor
    ``args`` of ``layout``, writing ``out`` [B, H*D, S]."""
    b, h, d, s = args[0].shape
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, entry)

    def call():
        err = fn(*(t.data_ptr() for t in (*args, out)), b * h, s, s, d, anchor, layout, 1, stream)
        if err:
            raise RuntimeError(f"{entry} failed (code {err})")
    return call


def timings(mine, parent):
    """Both layouts at ``CASES``: the tensor-core kernel, in turns with the
    parent's template where there is one, the packed bounded tensor-core
    kernel and SDPA; returns one record a case."""
    records = []
    for b, h, s, d in CASES:
        g = torch.Generator(device="cuda").manual_seed(s + d)
        q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        packed = [t.transpose(1, 2).reshape(b, s, h * d).contiguous() for t in (q, k, v)]
        bounded, _ = _call(mine, "hedit_flash_attention_fwd_packed_bounded_tc", *packed, heads=h)
        p_ms = best_ms(bounded)
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        del packed
        for layout, name in LAYOUTS.items():
            args = (_sminor(q), _sminor(k), _sminor(v) if layout == 2 else v)
            out = torch.empty(b, h * d, s, dtype=torch.bfloat16, device="cuda")
            tc = _probe_call(mine, "hedit_flash_packed_t_tc", args, out, layout, fp.BLK_K)
            tc()
            plain = getattr(fp, f"flash_{name}_reference")(*args, fp.BLK_K,
                                                           out_dtype=torch.float32)
            torch.cuda.synchronize()
            err = (out.float() - plain).abs().max().item() / (2.0 ** -8 * plain.abs().max().item())
            del plain
            torch.cuda.empty_cache()
            turns = [("tensor cores", tc)]
            if parent is not None:
                core = _probe_call(parent, "hedit_flash_packed_t", args,
                                   torch.empty_like(out), layout, fp.BLK_K)
                turns = [("parent template", core), *turns, *turns, ("parent template", core)]
            ms = [best_ms(fn) for _, fn in turns]
            tc_ms = min(t for (who, _), t in zip(turns, ms) if who == "tensor cores")
            bound_ms = 4 * b * h * s * s * d / 989e12 * 1e3
            print(f"{name} (layout {layout}) q[{b}, {h}, {s}, {d}] bf16: "
                  + ", ".join(f"{who} {t:.4f}" for (who, _), t in zip(turns, ms))
                  + f" ms; packed bounded (tensor cores) {p_ms:.4f} ms, S-minor / packed "
                  f"{tc_ms / p_ms:.3f}; SDPA {sdpa:.4f} ms, kernel / SDPA {tc_ms / sdpa:.3f}; "
                  f"bound {bound_ms:.4f} ms ({bound_ms / tc_ms:.1%}); out err / tol {err:.3f}")
            records.append({"layout": name, "shape": [b, h, s, d], "turns": [
                [who, t] for (who, _), t in zip(turns, ms)], "packed_bounded_ms": p_ms,
                "sdpa_ms": sdpa, "bound_ms": bound_ms, "err_over_tol": err})
            del args, out
        del q, k, v
        torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit")
    args = ap.parse_args(argv)
    require_cuda("flash_sminor_tiles")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    builds = [(_build.CSRC / "flash_probes_tc.cu", "probes_tc", _build.CSRC)]
    if args.parent is not None:
        csrc = args.parent / "hedit_tpu_torch" / "csrc"
        builds += [(csrc / "flash_probes.cu", "parent_template", csrc),
                   (csrc / "flash_attention_tc.cu", "parent_tc", csrc)]
    with ThreadPoolExecutor(len(builds)) as ex:
        built = list(ex.map(lambda a: build_alone(a[0], OUT_DIR / f"{a[1]}.so", a[2]), builds))
    for (source, name, _), (_, info) in zip(builds, built):
        print(f"ptxas, {name} ({source.name}): {info}")
    mine = _build.cuda_library()
    records = timings(mine, built[1][0] if args.parent is not None else None)
    print(json.dumps({"flash_sminor_tiles": records}))
    if args.parent is not None and not identity(mine, built[2][0]):
        print("FAILED: the bounded or LSE tensor-core forward differs from the parent's")
        return 1
    bad = [r for r in records if not r["err_over_tol"] <= 1.0]
    if bad:
        print(f"FAILED: outputs beyond 2^-8 of the largest value: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
