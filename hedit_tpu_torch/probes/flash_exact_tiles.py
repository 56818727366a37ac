"""The exact forwards (rows 6 and 7) in bf16 on the tensor cores, on the card.

    python -m hedit_tpu_torch.probes.flash_exact_tiles [--parent DIR]

Times the exact mode of ``csrc/flash_attention_tc.cu`` (entry points
``hedit_flash_attention_fwd_exact_tc`` and ``..._packed_exact_tc``) at
``CASES``: row 6 head-split at the UNet's 64^2 and 32^2 self-attentions
[8, 8, 4096, 40] and [4, 8, 1024, 80] and the VAE's [1, 1, 4096, 512], row
7 on packed heads at the controlled call's [8, 4096, 8 x 40].  Beside it, on the same inputs: the
bounded tensor-core kernel (the ratio of the two is what the running max
costs) and SDPA.  Each kernel is launched through its entry point without the wrappers' host
checks (CUDA-event means of 20 launches, best of 3); the tensor-core exact
output is held to ``flash_attention_exact_reference`` before its final
rounding (largest error over 2^-8 of the largest value, as ``chip_smoke.py``
holds it).  ``csrc/flash_attention_tc.cu`` is also built alone with
``-Xptxas -v``: each instantiation's registers and spills; and once for each
of ``VARIANTS`` (the d = 40 and d = 80 exact launch lines rewritten to other
warps and register budgets, one ``nvcc`` each, all started together), each
variant's exact entry timed at [8, 8, 4096, 40] and [4, 8, 1024, 80] in
turns with the source's own.

``--parent DIR``: a checkout of an earlier commit of this repository (for
example ``git archive <commit> | tar -x -C DIR``).  Its CUDA-core template's
exact entries in bf16 (``csrc/flash_attention.cu``: rows 6 and 7 before they
moved to the tensor cores; this tree's template takes float32 only) are
timed in turns with this tree's tensor-core exact kernel (parent, this,
this, parent), and its tensor-core source is
built beside this tree's: the bounded forward (head-split and packed) and
the LSE forward of the two must agree bit for bit on the smoke's inputs
(the exact mode is a compile-time flag of the same kernel); the probe exits
non-zero if they do not.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_attention as flash
from hedit_tpu_torch.probes.timing import best_ms, build_alone, require_cuda

OUT_DIR = _build.BUILD_DIR / "exact_tiles"
TC_SOURCE = _build.CSRC / "flash_attention_tc.cu"
# forward_exact_tc's launch lines by head dim, and the (warps along the rows,
# blocks an SM) each variant rewrites them to; variant 0 is the source's own
LAUNCHES = {40: "launch_tc<40, 4, 1, 64, 5, false, true>",
            80: "launch_tc<80, 8, 1, 64, 2, false, true>"}
VARIANTS = ({40: (4, 5), 80: (8, 2)}, {40: (4, 4), 80: (8, 1)}, {40: (2, 7), 80: (4, 3)},
            {40: (8, 2), 80: (4, 2)})
VARIANT_SHAPES = ((8, 8, 4096, 40), (4, 8, 1024, 80))
# (batch, heads, Sq, Sk, D, packed): rows 6 and 7 at their shapes
CASES = ((8, 8, 4096, 4096, 40, False), (8, 8, 4096, 4096, 40, True),
         (4, 8, 1024, 1024, 80, False), (1, 1, 4096, 4096, 512, False))
# the bit-identity inputs at chip_smoke.py's bounded and LSE shapes, (batch,
# heads, Sq, Sk, D, packed, saturating)
IDENTITY_CASES = ((8, 8, 4096, 4096, 40, False, False), (4, 8, 1024, 1024, 80, False, False),
                  (1, 1, 4096, 4096, 512, False, False), (1, 8, 1000, 1064, 80, False, False),
                  (8, 8, 4096, 4096, 40, True, False), (2, 8, 1000, 1064, 40, True, False),
                  (1, 8, 4096, 4096, 40, False, True), (1, 8, 4096, 4096, 40, True, True))


def _inputs(b, h, sq, sk, d, packed, seed=0, saturate=False):
    """Seeded bf16 q, k, v: [B, H, S, D], or [B, S, H*D] when ``packed``.
    ``saturate``: chip_smoke.py's saturating input (every query's score with
    a key set by the key's first component; key 600 more than 116 log2
    units above the 512-key anchor window's max, keys 700-763 below the
    clamp)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda") for s in (sq, sk, sk))
    if saturate:
        q, k = q * 0.1, k * 0.5
        q[..., 0] = 8.0
        k[:, :, 600, 0] = 80.0
        k[:, :, 700:764, 0] = 60.0
    if packed:
        q, k, v = (t.transpose(1, 2).reshape(b, -1, h * d) for t in (q, k, v))
    return [t.to(torch.bfloat16).contiguous() for t in (q, k, v)]


def _call(lib, entry, q, k, v, heads=None, lse=False):
    """(a launch of ``entry`` through ``lib``, its outputs): head-split
    entries take [B, H, S, D], packed ones (``heads`` given) [B, S, H*D];
    the bounded entries JAX's anchor, the LSE one also lse2."""
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(q)
    if heads is not None:
        b, sq, hd = q.shape
        sk, d = k.shape[1], hd // heads
        ints = (b, heads, sq, sk, d)
        tail = (sq * hd, sk * hd, sk * hd)
    else:
        b, h, sq, d = q.shape
        sk = k.shape[2]
        ints, tail = (b * h, sq, sk, d), ()
    bounded = "exact" not in entry and not entry.endswith("_packed")
    if bounded:
        ints += (flash.bounded_anchor(sk, d),)
    ptrs = [q, k, v, out]
    if lse:
        ptrs.append(torch.empty(ints[0], 1, sq, device="cuda"))
    fn = getattr(lib, entry)

    def call():
        err = fn(*(t.data_ptr() for t in ptrs), *ints, *tail, 1, stream)
        if err:
            raise RuntimeError(f"{entry} failed (code {err})")
    return call, ptrs[3:]


def _split(t, heads):
    b, s, hd = t.shape
    return t.reshape(b, s, heads, hd // heads).transpose(1, 2)


def timings(mine, parent) -> None:
    """Rows 6 and 7: the tensor-core exact kernel, in turns with the
    parent's template where there is one, the bounded tensor-core kernel and
    SDPA on the same inputs."""
    for b, h, sq, sk, d, packed in CASES:
        q, k, v = _inputs(b, h, sq, sk, d, packed)
        heads = h if packed else None
        kind = "packed" if packed else "head-split"
        exact, (out,) = _call(mine, flash.exact_entry(torch.bfloat16, packed, d), q, k,
                              v, heads)
        exact()
        plain = (flash.flash_attention_packed_exact_reference(q, k, v, h, out_dtype=torch.float32)
                 if packed else flash.flash_attention_exact_reference(q, k, v,
                                                                      out_dtype=torch.float32))
        torch.cuda.synchronize()
        err = (out.float() - plain).abs().max().item() / (2.0 ** -8 * plain.abs().max().item())
        del plain
        turns = [("tensor cores", exact)]
        if parent is not None:
            core, _ = _call(parent, "hedit_flash_attention_fwd_packed" if packed
                            else "hedit_flash_attention_fwd_exact", q, k, v, heads)
            turns = [("parent template", core), *turns, *turns, ("parent template", core)]
        bounded, _ = _call(mine, flash.bounded_entry(torch.bfloat16, packed, d), q, k, v,
                            heads)
        views = [_split(t, h) for t in (q, k, v)] if packed else (q, k, v)
        ms = [best_ms(fn) for _, fn in turns]
        b_ms = best_ms(bounded)
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(*views))
        print(f"exact {kind} q{list(q.shape)} sk={sk} bf16: "
              + ", ".join(f"{name} {t:.4f}" for (name, _), t in zip(turns, ms))
              + f" ms; bounded (tensor cores) {b_ms:.4f} ms, bounded / exact "
              f"{b_ms / min(t for (name, _), t in zip(turns, ms) if name == 'tensor cores'):.3f}; "
              f"SDPA {sdpa:.4f} ms; out err / tol {err:.3f}")


def _variant_source(i: int) -> Path:
    text = TC_SOURCE.read_text()
    for d, (wr, minb) in VARIANTS[i].items():
        if LAUNCHES[d] not in text:
            raise RuntimeError(f"{TC_SOURCE.name} no longer launches {LAUNCHES[d]}")
        text = text.replace(LAUNCHES[d], f"launch_tc<{d}, {wr}, 1, 64, {minb}, false, true>")
    path = OUT_DIR / f"variant{i}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def variants(libs) -> None:
    """The exact kernel's tile variants at d = 40 and 80, in turns (variant
    0, the source's own, first and last)."""
    for b, h, s, d in VARIANT_SHAPES:
        q, k, v = _inputs(b, h, s, s, d, False)
        plain = flash.flash_attention_exact_reference(q, k, v, out_dtype=torch.float32)
        for i in [*range(len(VARIANTS)), 0]:
            call, (out,) = _call(libs[i], "hedit_flash_attention_fwd_exact_tc", q, k, v)
            call()
            torch.cuda.synchronize()
            err = (out.float() - plain).abs().max().item() / (2.0 ** -8 * plain.abs().max().item())
            wr, minb = VARIANTS[i][d]
            print(f"exact tiles variant {i} ({16 * wr} rows a block, {minb} blocks an SM) "
                  f"q{[b, h, s, d]}: {best_ms(call):.4f} ms, out err / tol {err:.3f}")


def identity(mine, parent, exact=False) -> bool:
    """The bounded and LSE (and with ``exact`` the exact) tensor-core
    forwards of this tree and the parent on the same inputs, bit for bit."""
    same = True
    for i, (b, h, sq, sk, d, packed, saturate) in enumerate(IDENTITY_CASES):
        q, k, v = _inputs(b, h, sq, sk, d, packed, seed=i, saturate=saturate)
        heads = h if packed else None
        entries = [(flash.bounded_entry(torch.bfloat16, packed, d), False)]
        if not packed:
            entries.append((flash.lse_entry(torch.bfloat16, d), True))
        if exact:
            entries.append((flash.exact_entry(torch.bfloat16, packed, d), False))
        for entry, lse in entries:
            outs = []
            for lib in (mine, parent):
                call, got = _call(lib, entry, q, k, v, heads, lse)
                call()
                outs.append(got)
            torch.cuda.synchronize()
            equal = all(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                                    c.view(torch.int16) if c.dtype == torch.bfloat16 else c)
                        for a, c in zip(*outs))
            same &= equal
            print(f"identity {entry} q{list(q.shape)} sk={sk}"
                  f"{' saturating' if saturate else ''}: "
                  f"{'bit-identical to the parent' if equal else 'DIFFERS from the parent'}")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit")
    args = ap.parse_args(argv)
    require_cuda("flash_exact_tiles")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    builds = [(_variant_source(i), f"variant{i}", _build.CSRC) for i in range(len(VARIANTS))]
    if args.parent is not None:
        csrc = args.parent / "hedit_tpu_torch" / "csrc"
        builds += [(csrc / "flash_attention_tc.cu", "parent_tc", csrc),
                   (csrc / "flash_attention.cu", "parent_template", csrc)]
    with ThreadPoolExecutor(len(builds)) as ex:
        built = list(ex.map(lambda a: build_alone(a[0], OUT_DIR / f"{a[1]}.so", a[2]), builds))
    for (source, name, _), (_, info) in zip(builds, built):
        print(f"ptxas, {name} ({source.name}): {info}")
    mine = _build.cuda_library()
    n = len(VARIANTS)
    timings(mine, built[n + 1][0] if args.parent is not None else None)
    variants([lib for lib, _ in built[:n]])
    if args.parent is not None and not identity(mine, built[n][0]):
        print("FAILED: the bounded or LSE tensor-core forward differs from the parent's")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
