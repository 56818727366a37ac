"""End-to-end smoke of the PyTorch port on one CUDA GPU (an NVIDIA H100).

    python3 chip_smoke.py              # the smoke, phases 1-12
    python3 chip_smoke.py --profile    # where a flagship step's time goes

Phases, each printed on its own lines; any failure exits non-zero without
the final result line:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: the CUDA flash-attention library from ``hedit_tpu_torch/csrc`` and
   the Triton GroupNorm kernel, timed;
3. each of the six kernels against its plain PyTorch version at the main
   paths' shapes: max abs error against a stated tolerance; CUDA-event time
   of the kernel, of the plain version and of the one PyTorch library call
   for the same function (a yardstick only, the port never calls it); the
   least time the card could take (``bound_ms``).  For the packed-head
   forward also the time of what it replaces on the path (three head-split
   copies, the head-split kernel, the merge).  Then the GroupNorm gradient;
4. the flagship path: the SD-1.5 pipeline at full width with seeded weights
   in bfloat16, two seeded 512x512 images and seeded token ids, CLIP encode ->
   VAE encode -> q-sampled trajectory -> 50-step h-Edit-R + P2P flagship loop
   with a non-neutral control and an active LocalBlend -> VAE decode; checks
   finite [2, 512, 512, 3] outputs, that its kernels were launched and that
   the head-split forward served the VAE's one-head attention only;
5. the NMG path: the same pipeline on the DDIM grid, one seeded image, CLIP
   encode -> VAE encode -> 50-step DDIM inversion -> 50 NMG + P2P steps, each
   differentiating through the UNet, with a non-neutral control and an active
   LocalBlend -> VAE decode; checks a finite [1, 512, 512, 3] output and that
   every kernel was launched; prints the time split and peak memory;
6. the h-Edit-D path, as ``main_p2p --mode h_edit_D_p2p --eta 0 --implicit
   --optimization_steps 2`` runs it: one image, 50-step DDIM inversion, then
   50 steps of the general h-Edit + P2P loop (one base call and two controlled
   4-row calls a step, residuals derived in the loop), same control and blend;
7. the EF path, as ``main_p2p --mode ef_p2p --eta 1 --cfg_src 3.5`` runs it:
   one image, the DDPM inversion's residual pass at 20 rows a call, then 50
   indexed 3-row steps with cond_start = 1;
8. the golden identity in float32 (TF32 off): target = source,
   cfg_tar == cfg_src_edit and a neutral control reproduce xts[0], through the
   general loop under the flagship configuration;
9. the UNet gradient at full width in float32: d loss / d x of one NMG step
   with the kernels against the same gradient with the plain versions
   substituted here;
10. the NMG loop in float32 under a neutral control: its edit branch equals
    plain DDIM sampling computed here;
11. in float32: the EF pair loop without a stored trajectory on the DDPM
    inversion's residuals reconstructs the source latent; explicit h-Edit-D
    with target = source, cfg_tar == cfg_src_edit and a neutral control
    returns the source latent;
12. a JSON line of the kernels, then the result line
    ``{"ok": true, "device": {...}}``.

It exits non-zero before printing anything when no CUDA device is present.

``--profile`` runs phases 1 and 2, then times flagship steps of the main
path (the same SD-1.5 bf16 inputs, 2 images) on the host clock and under
``torch.profiler``, and prints the device time by kernel class, the top
kernels and the device's idle share, all read from one trace.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from hedit_tpu_torch import _build  # noqa: E402
from hedit_tpu_torch.control.p2p import (  # noqa: E402
    MAX_LEN, LocalBlendState, P2PControl, neutral_blend, neutral_control, stack_blends,
    stack_controls,
)
from hedit_tpu_torch.core.schedule import Schedule  # noqa: E402
from hedit_tpu_torch.edit.baselines import ef_or_pnp_inv_p2p, nmg_gradient, nmg_p2p  # noqa: E402
from hedit_tpu_torch.edit.h_edit import HEditConfig  # noqa: E402
from hedit_tpu_torch.edit.h_edit_p2p import h_edit_p2p, h_edit_p2p_flagship  # noqa: E402
from hedit_tpu_torch.invert.ddim import invert_ddim  # noqa: E402
from hedit_tpu_torch.invert.ddpm import invert_ddpm, sample_xts_from_x0  # noqa: E402
from hedit_tpu_torch.ops import attention as attn  # noqa: E402
from hedit_tpu_torch.ops import flash_attention as flash  # noqa: E402
from hedit_tpu_torch.ops import groupnorm as gn  # noqa: E402
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline  # noqa: E402

STEPS = 50
N_IMAGES = 2
SOT, EOT = 49406, 49407  # CLIP's start- and end-of-text ids
# Tolerances of the kernel comparisons.  float32: 1e-4, room for the kernels'
# other summation order (TF32 off on both sides): absolute for the forward
# kernels, whose outputs of these inputs reach 0.03-0.15 (flash) and ~5
# (GroupNorm), and relative to the largest value of each output for the LSE
# forward and the gradients (dq, dk reach ~1e-2, dv ~0.3, lse2 ~10).
# bfloat16 flash, forward and backward: the kernels compute in float32 from
# the bf16 inputs and round once, so each output is held to the plain version
# run in float32 on the same input values, within one bf16 ulp at its largest
# value, 2^-8 * max (the rounding is half an ulp; the backward also reads the
# forward's bf16-rounded output through delta).  lse2 is float32 for either
# dtype.  bfloat16 GroupNorm: one output ulp, 2^-7 * max|y|, against the plain
# version in bf16: both normalise in float32 and round once.
F32_TOL = 1e-4
BF16_ULP = 2.0 ** -8
# The golden identity's float32 tolerance: 50 reverse steps, each re-anchored
# on the trajectory; eps from a batch-1 and a batch-4 UNet call differ by
# float32 rounding, amplified by at most sqrt(abar_0 / abar_T) ~ 15.
GOLDEN_TOL = 1e-3
# The full-width UNet gradient, kernels against plain versions, float32:
# largest difference over the largest element.  The loss is an L1 distance,
# so its gradient carries the sign of every element of (predicted - stored);
# the stored point is seeded noise an O(1) distance away, which float32 drift
# cannot flip.
UNET_GRAD_TOL = 1e-3
# The NMG loop's edit branch against plain DDIM sampling, float32, relative to
# the largest latent (~80 with seeded weights): as in the golden identity, a
# batch-4 and a batch-2 UNet call differ in the last bits, and 50 free-running
# CFG steps carry that along; the golden identity's bound.
NMG_EDIT_TOL = 1e-3
# The EF reconstruction and the h-Edit-D identity, float32, relative to the
# largest latent: 50 reverse steps that each land on the stored trajectory by
# its own residual; what is left is the float32 difference between the
# inversion's UNet call (10 or 1 rows) and the loop's (4 or 1), as in the
# golden identity.
RECON_TOL = 1e-3
# --profile traces edit steps 0-11: inside the self-edit window (steps 0-16),
# with LocalBlend active from step 10
PROFILE_STEPS = 12
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): device
# memory rate, bf16 tensor-core rate, float32 rate outside the tensor cores.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def cuda_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps=3):
    """Host-clock mean of ``fn`` ended by a synchronise, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound(flops, nbytes, dtype):
    """(bound_ms, bound_by): the least time the card could take, the larger of
    operations over the peak rate of the inputs' type and bytes (each input
    read once, each output written once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def reset_launches():
    flash.launches = flash.launches_lse = flash.launches_bwd_dq = flash.launches_bwd_dkv = 0
    flash.launches_packed = 0
    gn.launches = 0


def read_launches():
    return {"flash_attention": flash.launches, "groupnorm": gn.launches,
            "flash_attention_lse": flash.launches_lse, "flash_bwd_dq": flash.launches_bwd_dq,
            "flash_bwd_dkv": flash.launches_bwd_dkv, "flash_packed": flash.launches_packed}


def check_forward_routing(counts, path, failures):
    """On a path without a gradient every UNet attention of kernel size reads
    the packed projections; the head-split forward serves only the VAE's
    one-head attention, one launch in the encoder and one in the decoder."""
    if counts["flash_packed"] <= 0 or counts["groupnorm"] <= 0:
        failures.append(f"a kernel was not launched on the {path} path: {counts}")
    if counts["flash_attention"] != 2:
        failures.append(f"the head-split forward was launched {counts['flash_attention']} times "
                        f"on the {path} path, not by the two VAE attentions alone")


def phase_card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch.cuda: {torch.cuda.get_device_name(0)}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")


def phase_build():
    t0 = time.perf_counter()
    _build.cuda_library()
    t1 = time.perf_counter()
    x = torch.randn(1, 64, 8, 8, device="cuda")
    w, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    gn.group_norm_triton(x, w, b, groups=32, act="silu")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"build: nvcc csrc/*.cu and load {t1 - t0:.1f} s, "
          f"triton groupnorm compile and first launch {t2 - t1:.1f} s")


def _row(rows, failures, name, label, ok, **numbers):
    """Record one kernel comparison and print it."""
    lib = numbers["library_ms"]
    print(f"{label}: max_abs_err {numbers['max_abs_err']:.3e} (tol {numbers['tol']:.3g}) "
          f"kernel {numbers['ms']:.3f} ms plain {numbers['plain_ms']:.3f} ms library "
          f"{'none' if lib is None else format(lib, '.3f') + ' ms'} bound "
          f"{numbers['bound_ms']:.4f} ms ({numbers['bound_by']}) {'OK' if ok else 'FAIL'}")
    rows.append(dict(name=name, **numbers))
    if not ok:
        failures.append(label)


def _qkv(g, qshape, sk, dtype):
    q = torch.randn(qshape, generator=g, device="cuda").to(dtype)
    k = torch.randn(qshape[:2] + (sk, qshape[3]), generator=g, device="cuda").to(dtype)
    v = torch.randn(k.shape, generator=g, device="cuda").to(dtype)
    return q, k, v


def _flash_forward_cases(g, rows, failures):
    """Kernel 1: the forward without a gradient."""
    cases = [((8, 8, 4096, 40), 4096, torch.bfloat16),   # controlled call, 2 images
             ((4, 8, 4096, 40), 4096, torch.bfloat16),   # controlled call, 1 image
             ((4, 8, 1024, 80), 1024, torch.bfloat16),
             ((1, 1, 4096, 512), 4096, torch.bfloat16),  # VAE mid block
             ((1, 8, 1000, 80), 1064, torch.bfloat16),   # ragged, Sq != Sk
             ((2, 8, 4096, 40), 4096, torch.float32),
             ((2, 8, 1000, 40), 1000, torch.float32),    # ragged Sq and Sk
             ((4, 8, 1024, 80), 1024, torch.float32),
             ((1, 8, 1000, 80), 1064, torch.float32),
             ((1, 1, 4096, 512), 4096, torch.float32)]
    for qshape, sk, dtype in cases:
        q, k, v = _qkv(g, qshape, sk, dtype)
        got = flash.flash_attention_cuda(q, k, v)
        want = flash.reference_attention(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else BF16_ULP * want.abs().max().item()
        bh, sq, d = qshape[0] * qshape[1], qshape[2], qshape[3]
        bound_ms, by = bound(4 * bh * sq * sk * d, q.element_size() * bh * d * 2 * (sq + sk), dtype)
        _row(rows, failures, "flash_attention",
             f"flash q{list(qshape)} sk={sk} {str(dtype)[6:]}",
             err <= tol and bool(torch.isfinite(got).all()), max_abs_err=err, tol=tol,
             ms=cuda_ms(lambda: flash.flash_attention_cuda(q, k, v)),
             plain_ms=cuda_ms(lambda: flash.reference_attention(q, k, v)),
             library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
             bound_ms=bound_ms, bound_by=by)


def _flash_packed_cases(g, rows, failures):
    """Kernel 6: the forward on packed heads [B, S, H*D], against the plain
    version in float32 on the same input values; beside it the route it
    replaces on the path (three head-split copies, kernel 1, the merge)."""
    cases = [(8, 4096, 4096, 320, torch.bfloat16, False),   # controlled call, 2 images
             (4, 1024, 1024, 640, torch.bfloat16, False),
             (2, 4096, 4096, 320, torch.float32, False),
             (4, 1024, 1024, 640, torch.float32, False),
             (2, 1000, 1064, 320, torch.bfloat16, False),   # ragged, Sq != Sk
             (2, 1000, 1064, 640, torch.float32, False),
             (4, 1024, 1024, 640, torch.bfloat16, True),    # a row slice of a larger batch
             (4, 4096, 4096, 320, torch.float32, True)]
    heads = 8
    for b, sq, sk, hd, dtype, strided in cases:
        groups = 3 if strided else 1
        q, k, v = (torch.randn(b, groups, s, hd, generator=g, device="cuda")
                   .to(dtype)[:, groups // 2] for s in (sq, sk, sk))
        got = flash.flash_attention_packed_cuda(q, k, v, heads)
        want = flash.flash_attention_packed_reference(q.float(), k.float(), v.float(), heads)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else BF16_ULP * want.abs().max().item()
        bound_ms, by = bound(4 * b * sq * sk * hd, q.element_size() * b * hd * 2 * (sq + sk), dtype)
        split = lambda t: t.reshape(b, -1, heads, hd // heads).transpose(1, 2)  # noqa: E731
        _row(rows, failures, "flash_packed",
             f"flash packed q[{b}, {sq}, {hd}] sk={sk} {str(dtype)[6:]}"
             f"{' batch-strided' if strided else ''}",
             err <= tol and bool(torch.isfinite(got).all()) and got.is_contiguous(),
             max_abs_err=err, tol=tol,
             ms=cuda_ms(lambda: flash.flash_attention_packed_cuda(q, k, v, heads)),
             plain_ms=cuda_ms(lambda: flash.flash_attention_packed_reference(q, k, v, heads)),
             # the library call reads the same packed tensors through strided head views
             library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(split(q), split(k),
                                                                       split(v))),
             bound_ms=bound_ms, bound_by=by,
             split_path_ms=cuda_ms(lambda: attn.merge_heads(flash.flash_attention_cuda(
                 attn.split_heads(q, heads), attn.split_heads(k, heads),
                 attn.split_heads(v, heads)))))
        print(f"  the head-split route at the same shape (3 copies + kernel 1 + merge): "
              f"{rows[-1]['split_path_ms']:.3f} ms")


def _flash_gradient_cases(g, rows, failures):
    """Kernels 3-5: the LSE forward (out, lse2) and dq, dk / dv, through
    ``flash_attention_diff`` and autograd, against the plain versions in
    float32 on the same input values."""
    cases = [((1, 8, 4096, 40), 4096, torch.bfloat16),   # the NMG gradient call, 1 image
             ((1, 8, 1024, 80), 1024, torch.bfloat16),
             ((1, 8, 4096, 40), 4096, torch.float32),
             ((1, 8, 1024, 80), 1024, torch.float32),
             ((1, 8, 1000, 80), 1064, torch.float32)]    # ragged, Sq != Sk
    for qshape, sk, dtype in cases:
        q, k, v = _qkv(g, qshape, sk, dtype)
        do = torch.randn(qshape, generator=g, device="cuda").to(dtype)
        label = f"q{list(qshape)} sk={sk} {str(dtype)[6:]}"
        bh, sq, d = qshape[0] * qshape[1], qshape[2], qshape[3]
        es = q.element_size()
        rel = F32_TOL if dtype == torch.float32 else BF16_ULP
        finite = lambda *ts: all(bool(torch.isfinite(t).all()) for t in ts)  # noqa: E731

        out, lse2 = flash.flash_attention_lse_cuda(q, k, v)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        dq, dk, dv = torch.autograd.grad(flash.flash_attention_diff(*leaves), leaves, do)
        want_out, want_lse = flash.flash_attention_lse_reference(q.float(), k.float(), v.float())
        want_dq, want_dk, want_dv = flash.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), want_out, want_lse, do.float())
        torch.cuda.synchronize()

        def gap(got, want):  # (largest error, tolerance) of one output
            return (got.float() - want).abs().max().item(), rel * want.abs().max().item()

        # the library call for the same functions: SDPA's forward under a
        # recorded gradient (it saves its log-sum-exp), and its backward,
        # which gives dq, dk and dv in one call (no call gives one alone)
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(*leaves)
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True))

        err_o, tol_o = gap(out, want_out)
        err_l = (lse2 - want_lse).abs().max().item()
        tol_l = F32_TOL * want_lse.abs().max().item()
        bound_ms, by = bound(4 * bh * sq * sk * d, es * bh * d * 2 * (sq + sk) + 4 * bh * sq, dtype)
        print(f"flash lse {label}: lse2 max_abs_err {err_l:.3e} (tol {tol_l:.3g})")
        _row(rows, failures, "flash_attention_lse", f"flash lse {label}",
             err_o <= tol_o and err_l <= tol_l and finite(out, lse2), max_abs_err=err_o,
             tol=tol_o, ms=cuda_ms(lambda: flash.flash_attention_lse_cuda(q, k, v)),
             plain_ms=cuda_ms(lambda: flash.flash_attention_lse_reference(q, k, v)),
             library_ms=lib_fwd, bound_ms=bound_ms, bound_by=by)

        delta = (do.float() * out.float()).sum(dim=-1)
        # the plain version and the library call give dq, dk and dv in one call
        together = "plain_ms and library_ms are of dq, dk and dv together"
        plain_bwd = cuda_ms(lambda: flash.flash_attention_backward_reference(q, k, v, out, lse2, do))
        in_bytes = es * bh * d * 2 * (sq + sk) + 8 * bh * sq  # q, dO, k, v; lse2, delta
        err, tol = gap(dq, want_dq)
        bound_ms, by = bound(6 * bh * sq * sk * d, in_bytes + es * bh * sq * d, dtype)
        _row(rows, failures, "flash_bwd_dq", f"flash dq {label}", err <= tol and finite(dq),
             max_abs_err=err, tol=tol,
             ms=cuda_ms(lambda: flash.flash_bwd_dq_cuda(q, k, v, do, lse2, delta)),
             plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=bound_ms, bound_by=by,
             plain_covers=together)
        (err_k, tol_k), (err_v, tol_v) = gap(dk, want_dk), gap(dv, want_dv)
        print(f"flash dk/dv {label}: dk max_abs_err {err_k:.3e} (tol {tol_k:.3g}), "
              f"dv {err_v:.3e} (tol {tol_v:.3g})")
        bound_ms, by = bound(8 * bh * sq * sk * d, in_bytes + es * bh * 2 * sk * d, dtype)
        worst = max((err_k, tol_k), (err_v, tol_v), key=lambda et: et[0] / et[1])
        _row(rows, failures, "flash_bwd_dkv", f"flash dk/dv {label}",
             err_k <= tol_k and err_v <= tol_v and finite(dk, dv), max_abs_err=worst[0],
             tol=worst[1], ms=cuda_ms(lambda: flash.flash_bwd_dkv_cuda(q, k, v, do, lse2, delta)),
             plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=bound_ms, bound_by=by,
             plain_covers=together)

        # dq and dk / dv share one plain version and one library call, so the
        # two are read together: both kernels against each
        both = rows[-2]["ms"] + rows[-1]["ms"]
        print(f"flash backward {label}: dq + dk/dv kernels {both:.3f} ms, plain version "
              f"{plain_bwd:.3f} ms, library {lib_bwd:.3f} ms")


def _groupnorm_cases(g, rows, failures):
    """Kernel 2, and the gradient of its autograd wrapper (forward the kernel,
    backward plain tensor code) against autograd of the plain version in
    float32 on the same input values."""
    for shape in ((8, 320, 64, 64), (4, 320, 64, 64), (4, 640, 32, 32), (4, 1280, 8, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            for eps in (1e-5, 1e-6):
                x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
                w = torch.randn(shape[1], generator=g, device="cuda").to(dtype)
                b = torch.randn(shape[1], generator=g, device="cuda").to(dtype)
                call = dict(groups=32, eps=eps, act="silu")
                got = gn.group_norm_triton(x, w, b, **call)
                want = gn.group_norm_reference(x, w, b, **call)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = (F32_TOL if dtype == torch.float32
                       else 2.0 ** -7 * want.float().abs().max().item())
                # two passes for the statistics, normalise, affine, SiLU: ~12
                # operations an element; x read once, y written once
                bound_ms, by = bound(12 * x.numel(), x.element_size() * (2 * x.numel() + 2 * shape[1]),
                                     torch.float32)
                _row(rows, failures, "groupnorm",
                     f"groupnorm+silu {list(shape)} {str(dtype)[6:]} eps={eps:g}",
                     err <= tol and bool(torch.isfinite(got).all()), max_abs_err=err, tol=tol,
                     ms=cuda_ms(lambda: gn.group_norm_triton(x, w, b, **call)),
                     plain_ms=cuda_ms(lambda: gn.group_norm_reference(x, w, b, **call)),
                     library_ms=cuda_ms(lambda: F.silu(F.group_norm(x, 32, w, b, eps))),
                     bound_ms=bound_ms, bound_by=by)
    for shape in ((1, 320, 64, 64), (1, 1280, 8, 8)):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
            w = torch.randn(shape[1], generator=g, device="cuda").to(dtype)
            b = torch.randn(shape[1], generator=g, device="cuda").to(dtype)
            dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
            before = gn.launches
            dx, = torch.autograd.grad(
                gn.group_norm(x.requires_grad_(), w, b, groups=32, act="silu"), x, dy)
            xf = x.detach().float().requires_grad_()
            want, = torch.autograd.grad(
                gn.group_norm_reference(xf, w.float(), b.float(), groups=32, act="silu"), xf,
                dy.float())
            torch.cuda.synchronize()
            err = (dx.float() - want).abs().max().item()
            tol = (F32_TOL if dtype == torch.float32 else BF16_ULP) * want.abs().max().item()
            ok = err <= tol and bool(torch.isfinite(dx).all()) and gn.launches == before + 1
            print(f"groupnorm+silu gradient {list(shape)} {str(dtype)[6:]}: dx max_abs_err "
                  f"{err:.3e} (tol {tol:.3g}) {'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"groupnorm gradient {shape} {dtype}")


def phase_kernels():
    """Each kernel against its plain version; returns (report rows, failures).
    The first row of each kernel is at a shape of the main paths and is the
    one the kernels line reports."""
    g = torch.Generator(device="cuda").manual_seed(1234)
    rows, failures = [], []
    _flash_forward_cases(g, rows, failures)
    _flash_packed_cases(g, rows, failures)
    _flash_gradient_cases(g, rows, failures)
    _groupnorm_cases(g, rows, failures)
    return rows, failures


def _token_ids(rng, n_images):
    """Per image [uncond, src, src, tar] ids; tar differs from src in two words."""
    ids = np.full((n_images, 4, MAX_LEN), EOT, np.int64)
    ids[:, :, 0] = SOT
    for i in range(n_images):
        src = rng.randint(0, SOT, 8)
        tar = src.copy()
        tar[2:4] = rng.randint(0, SOT, 2)
        ids[i, 1, 1:9] = ids[i, 2, 1:9] = src
        ids[i, 3, 1:9] = tar
    return ids


def _edit_control(num_steps, heads, image):
    """A non-neutral P2P replace control with reweighting and an active
    LocalBlend on the two edited words (token positions 3 and 4)."""
    # cross-attention replaced over the first 40% of the steps, every token
    alpha = np.zeros((num_steps + 1, MAX_LEN), np.float32)
    alpha[:int(0.4 * (num_steps + 1))] = 1.0
    eq = np.ones(MAX_LEN, np.float32)
    eq[3:5] = 2.0 + image
    words = np.zeros((2, MAX_LEN), np.float32)
    words[:, 3:5] = 1.0
    t = lambda a: torch.from_numpy(np.asarray(a))[None]  # noqa: E731
    control = P2PControl(cross_alpha=t(alpha), refine_mapper=t(np.zeros(MAX_LEN, np.int64)),
                         refine_alphas=t(np.ones(MAX_LEN, np.float32)),
                         replace_mapper=t(np.eye(MAX_LEN, dtype=np.float32)), equalizer=t(eq),
                         mode="replace", use_reweight=True,
                         self_replace_until=int(num_steps * 0.35), cond_start=2, blend_px=256)
    blend = LocalBlendState(alpha_layers=t(words), store_sum=torch.zeros(1, 5, 2, heads, 256, 77),
                            start_blend=torch.tensor([int(0.2 * num_steps)]), res=16)
    return control, blend


def _main_path_inputs():
    """The SD-1.5 bf16 pipeline and the main paths' seeded inputs: images,
    token ids, and the stacked control and LocalBlend of N_IMAGES images."""
    t0 = time.perf_counter()
    pipe = create_sd_pipeline(tiny=False, num_inference_steps=STEPS, seed=0,
                              dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    print(f"main paths: SD-1.5 bf16 pipeline on the card in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(7)
    images = torch.rand(N_IMAGES, 512, 512, 3, generator=g, device="cuda") * 2 - 1
    ids = torch.from_numpy(_token_ids(np.random.RandomState(7), N_IMAGES))
    controls = [_edit_control(STEPS, 8, i) for i in range(N_IMAGES)]
    control = stack_controls([c for c, _ in controls]).to("cuda")
    blend = stack_blends([b for _, b in controls]).to("cuda")
    return pipe, images, ids, control, blend


def phase_flagship_path(pipe, images, ids, control, blend):
    """The flagship edit of N_IMAGES images; returns (launch counts, failures)."""
    failures = []
    cfg = HEditConfig()

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx4 = pipe.encode_token_ids(ids.reshape(-1, MAX_LEN)).reshape(N_IMAGES, 4, MAX_LEN, -1)
    x0s = pipe.vae_encode(images)
    xts = torch.stack([sample_xts_from_x0(pipe.schedule, x[None],
                                          torch.Generator(device="cuda").manual_seed(i))
                       for i, x in enumerate(x0s)])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    edited = h_edit_p2p_flagship(pipe.unet, pipe.schedule, cfg, xts=xts, ctx4=ctx4,
                                 control=control, local_blend=blend, after_skip_steps=STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = pipe.vae_decode(edited)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = read_launches()
    per_image = (t3 - t0) / N_IMAGES
    print(f"flagship path: {per_image:.3f} s/image over {N_IMAGES} images "
          f"(encode {t1 - t0:.2f} s, {STEPS}-step loop {t2 - t1:.2f} s, decode {t3 - t2:.2f} s); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, weights included")
    print(f"flagship path launches: {json.dumps(counts)}")
    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(edited).all())
    moved = (edited - xts[:, 0]).abs().max().item()
    print(f"flagship path output {list(out.shape)} finite={finite} "
          f"max|edited - source latent| {moved:.3e}")
    if tuple(out.shape) != (N_IMAGES, 512, 512, 3) or not finite:
        failures.append("flagship path output is not finite [2, 512, 512, 3]")
    check_forward_routing(counts, "flagship", failures)
    return counts, failures


def phase_nmg_path(pipe, images, ids):
    """The NMG + P2P edit of one image, as ``main_p2p --mode nmg_p2p --eta 0``
    runs it; returns (launch counts, failures)."""
    failures = []
    pipe = dataclasses.replace(pipe, schedule=Schedule.create(STEPS, steps_offset=0))
    control, blend = (state.to("cuda") for state in _edit_control(STEPS, 8, 0))

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx3 = pipe.encode_token_ids(ids[0, [0, 1, 3]]).reshape(1, 3, MAX_LEN, -1)  # uncond, src, tar
    x0 = pipe.vae_encode(images[:1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    inv = invert_ddim(pipe.unet, pipe.schedule, x0, uncond_ctx=ctx3[:, 0], src_ctx=ctx3[:, 1],
                      cfg_scale=1.0, skip_zs=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    edited, recon = nmg_p2p(pipe.unet, pipe.schedule, xts=inv.xts, ctx3=ctx3, cfg_tar=7.5,
                            control=control, local_blend=blend, after_skip_steps=STEPS)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    out = pipe.vae_decode(edited)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"NMG path: {t4 - t0:.3f} s/image over 1 image (encode {t1 - t0:.2f} s, {STEPS}-step "
          f"DDIM inversion {t2 - t1:.2f} s, {STEPS}-step NMG loop {t3 - t2:.2f} s = "
          f"{(t3 - t2) / STEPS * 1e3:.1f} ms a step, decode {t4 - t3:.2f} s); peak memory "
          f"{peak:.2f} GiB, weights included")
    print(f"NMG path launches: {json.dumps(counts)}")
    finite = all(bool(torch.isfinite(t).all()) for t in (out, edited, recon, inv.xts))
    print(f"NMG path output {list(out.shape)} finite={finite} max|edited - source latent| "
          f"{(edited - x0).abs().max().item():.3e} max|reconstruction - source latent| "
          f"{(recon - x0).abs().max().item():.3e}")
    if tuple(out.shape) != (1, 512, 512, 3) or not finite:
        failures.append("NMG path output is not finite [1, 512, 512, 3]")
    if min(counts.values()) <= 0:
        failures.append(f"a kernel was not launched on the NMG path: {counts}")
    if (counts["flash_attention_lse"], counts["flash_bwd_dq"], counts["flash_bwd_dkv"]) != (
            10 * STEPS,) * 3:
        failures.append(f"the NMG path's gradient kernels were not launched once for each of "
                        f"10 layers a step: {counts}")

    # where a step's time goes: its two UNet calls alone, host clock, synchronised
    t = int(pipe.schedule.timesteps[0])
    x, stored = inv.xts[:, STEPS], inv.xts[:, STEPS - 1]
    ctrl = dataclasses.replace(control, step=0, cond_start=2)
    with torch.no_grad():
        parts = [wall_ms(fn) for fn in (
            lambda: nmg_gradient(pipe.unet, pipe.schedule, x, t, ctx3[:, 0], stored),
            lambda: pipe.unet(x, t, ctx3[:, 0]),
            lambda: pipe.unet(x.expand(4, -1, -1, -1), t, ctx3[0, [0, 0, 1, 2]], ctrl, {}))]
    print(f"NMG step parts (host wall, step 0): gradient call, 1 row forward + backward "
          f"{parts[0]:.1f} ms (the same row forward only {parts[1]:.1f} ms), controlled call, "
          f"4 rows {parts[2]:.1f} ms")
    return counts, failures


def _one_image_path(name, pipe, images, ids, invert, edit, invert_label):
    """Drive one image through encode -> ``invert`` -> ``edit`` -> decode with
    the launch counts at 0 before and read after; returns (counts, failures)."""
    failures = []
    control, blend = (state.to("cuda") for state in _edit_control(STEPS, 8, 0))
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx3 = pipe.encode_token_ids(ids[0, [0, 1, 3]]).reshape(1, 3, MAX_LEN, -1)  # uncond, src, tar
    x0 = pipe.vae_encode(images[:1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    inv = invert(pipe, x0, ctx3)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    edited, recon = edit(pipe, inv, ctx3, control, blend)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    out = pipe.vae_decode(edited)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{name} path: {t4 - t0:.3f} s/image over 1 image (encode {t1 - t0:.2f} s, "
          f"{invert_label} {t2 - t1:.2f} s, {STEPS}-step loop {t3 - t2:.2f} s = "
          f"{(t3 - t2) / STEPS * 1e3:.1f} ms a step, decode {t4 - t3:.2f} s); peak memory "
          f"{peak:.2f} GiB, weights included")
    print(f"{name} path launches: {json.dumps(counts)}")
    finite = all(bool(torch.isfinite(t).all()) for t in (out, edited, recon, inv.xts))
    print(f"{name} path output {list(out.shape)} finite={finite} max|edited - source latent| "
          f"{(edited - x0).abs().max().item():.3e} max|reconstruction - source latent| "
          f"{(recon - x0).abs().max().item():.3e}")
    if tuple(out.shape) != (1, 512, 512, 3) or not finite:
        failures.append(f"{name} path output is not finite [1, 512, 512, 3]")
    check_forward_routing(counts, name, failures)
    return counts, failures


def phase_hedit_d_path(pipe, images, ids):
    """h-Edit-D + P2P, implicit with two optimisation steps, as ``main_p2p
    --mode h_edit_D_p2p --eta 0 --implicit --optimization_steps 2`` runs it:
    the DDIM grid, a DDIM inversion without a residual pass (the loop derives
    them), then eta = 1 with is_ddim_inversion."""
    pipe = dataclasses.replace(pipe, schedule=Schedule.create(STEPS, steps_offset=0))
    cfg = HEditConfig(eta=1.0, is_ddim_inversion=True, implicit=True, optimization_steps=2)

    def invert(pipe, x0, ctx3):
        return invert_ddim(pipe.unet, pipe.schedule, x0, uncond_ctx=ctx3[:, 0],
                           src_ctx=ctx3[:, 1], cfg_scale=cfg.cfg_src, skip_zs=True)

    def edit(pipe, inv, ctx3, control, blend):
        return h_edit_p2p(pipe.unet, pipe.schedule, inv.xts[:, STEPS], None, ctx3=ctx3, cfg=cfg,
                          after_skip_steps=STEPS, control=control, local_blend=blend,
                          xts=inv.xts, derive_zs=True)

    return _one_image_path("h-Edit-D", pipe, images, ids, invert, edit,
                           f"{STEPS}-step DDIM inversion")


def phase_ef_path(pipe, images, ids):
    """EF + P2P at cfg_src 3.5, as ``main_p2p --mode ef_p2p --eta 1 --cfg_src
    3.5`` runs it: the DDPM inversion with its residual pass (10 steps a call,
    uncond and cond halves: 20 rows), then the indexed 3-row steps."""
    cfg_src = 3.5

    def invert(pipe, x0, ctx3):
        return invert_ddpm(pipe.unet, pipe.schedule, x0, uncond_ctx=ctx3[:, 0],
                           src_ctx=ctx3[:, 1], cfg_scale_src=cfg_src, eta=1.0,
                           generator=torch.Generator(device="cuda").manual_seed(0),
                           step_chunk=10)

    def edit(pipe, inv, ctx3, control, blend):
        return ef_or_pnp_inv_p2p(pipe.unet, pipe.schedule, inv.xts[:, STEPS], inv.zs, ctx3=ctx3,
                                 cfg_src=cfg_src, cfg_tar=7.5, eta=1.0, after_skip_steps=STEPS,
                                 control=control, local_blend=blend, xts=inv.xts)

    return _one_image_path("EF", pipe, images, ids, invert, edit,
                           "DDPM inversion, 5 calls of 20 rows,")


def phase_golden(pipe):
    """README golden numerics on the card, SD-1.5 widths in float32."""
    g = torch.Generator(device="cuda").manual_seed(11)
    x0 = torch.randn(1, 64, 64, 4, generator=g, device="cuda")
    xts = sample_xts_from_x0(pipe.schedule, x0, g)[None]
    ids = torch.from_numpy(_token_ids(np.random.RandomState(11), 1))
    ids[:, 3] = ids[:, 1]  # target = source
    ctx4 = pipe.encode_token_ids(ids.reshape(-1, MAX_LEN)).reshape(1, 4, MAX_LEN, -1)
    t0 = time.perf_counter()
    edited = h_edit_p2p_flagship(
        pipe.unet, pipe.schedule, HEditConfig(cfg_src_edit=5.0, cfg_tar=5.0), xts=xts,
        ctx4=ctx4, control=neutral_control(STEPS, 256, cond_start=2).to("cuda"),
        local_blend=neutral_blend(STEPS, 8, 16).to("cuda"), after_skip_steps=STEPS)
    torch.cuda.synchronize()
    err = (edited - xts[:, 0]).abs().max().item()
    ok = err <= GOLDEN_TOL
    print(f"golden identity (f32, TF32 off, {STEPS} steps, {time.perf_counter() - t0:.1f} s): "
          f"max|edited - xts[0]| {err:.3e} (tol {GOLDEN_TOL:g}) {'OK' if ok else 'FAIL'}")
    return [] if ok else [f"golden identity error {err:.3e}"]


@contextlib.contextmanager
def plain_versions():
    """Substitute every kernel wrapper by its plain version: the package
    itself has no switch for this, and no CUDA path of it ever does so."""
    with contextlib.ExitStack() as stack:
        for module, name, plain in (
                (attn, "flash_attention_cuda", flash.reference_attention),
                (attn, "flash_attention_packed_cuda", flash.flash_attention_packed_reference),
                (flash, "flash_attention_lse_cuda", flash.flash_attention_lse_reference),
                (flash, "flash_attention_backward_cuda", flash.flash_attention_backward_reference),
                (gn, "group_norm_triton", gn.group_norm_reference)):
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def phase_unet_gradient(pipe):
    """d loss / d x of one NMG step through the SD-1.5 UNet in float32, with
    the kernels against the plain versions."""
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(1, 64, 64, 4, generator=g, device="cuda")
    stored = torch.randn(1, 64, 64, 4, generator=g, device="cuda")
    ids = torch.from_numpy(_token_ids(np.random.RandomState(13), 1))
    uncond = pipe.encode_token_ids(ids[0, :1])
    t = int(pipe.schedule.timesteps[STEPS // 2])
    reset_launches()
    grad_k, eps_k = nmg_gradient(pipe.unet, pipe.schedule, x, t, uncond, stored)
    counts = read_launches()
    with plain_versions():
        grad_p, eps_p = nmg_gradient(pipe.unet, pipe.schedule, x, t, uncond, stored)
    torch.cuda.synchronize()
    substituted = read_launches() == counts
    rel = ((grad_k - grad_p).abs().max() / grad_p.abs().max()).item()
    rel_eps = ((eps_k - eps_p).abs().max() / eps_p.abs().max()).item()
    launched = all(counts[k] > 0 for k in ("groupnorm", "flash_attention_lse", "flash_bwd_dq",
                                           "flash_bwd_dkv"))
    ok = (rel <= UNET_GRAD_TOL and substituted and launched
          and bool(torch.isfinite(grad_k).all()))
    print(f"UNet gradient (f32, TF32 off, t={t}): max|dx kernels - dx plain| / max|dx plain| "
          f"{rel:.3e} (tol {UNET_GRAD_TOL:g}; max|dx| {grad_p.abs().max().item():.3e}), eps "
          f"{rel_eps:.3e}; launches with the kernels {json.dumps(counts)}, none more with the "
          f"plain versions: {substituted} {'OK' if ok else 'FAIL'}")
    return [] if ok else [f"UNet gradient relative error {rel:.3e}, launches {counts}"]


def phase_nmg_identity(pipe):
    """The NMG loop in float32 with target = source under a neutral control and
    no blend: its edit branch never sees the reconstruction branch or its
    guidance, so x_edit equals plain DDIM sampling from xts[S] at the target
    scale, computed here with batch-2 UNet calls.  (x_edit does not equal
    x_orig: the reconstruction branch takes the noise-map step and then the
    pair step, two steps a loop iteration.)"""
    schedule = Schedule.create(STEPS, steps_offset=0)
    g = torch.Generator(device="cuda").manual_seed(17)
    xts = torch.randn(1, STEPS + 1, 64, 64, 4, generator=g, device="cuda")
    ids = torch.from_numpy(_token_ids(np.random.RandomState(17), 1))
    ctx3 = pipe.encode_token_ids(ids[0, [0, 1, 1]]).reshape(1, 3, MAX_LEN, -1)
    t0 = time.perf_counter()
    edited, _ = nmg_p2p(pipe.unet, schedule, xts=xts, ctx3=ctx3, cfg_tar=7.5,
                        control=neutral_control(STEPS, 256, cond_start=2).to("cuda"),
                        local_blend=neutral_blend(STEPS, 8, 16).to("cuda"),
                        after_skip_steps=STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x = xts[:, STEPS]
    with torch.no_grad():
        for t in schedule.timesteps.tolist():
            e_u, e_c = pipe.unet(torch.cat([x, x]), t, ctx3[0, [0, 2]]).float().chunk(2)
            x = schedule.reverse_step(e_u + 7.5 * (e_c - e_u), t, x, eta=0.0)
    torch.cuda.synchronize()
    scale = x.abs().max().item()
    err = (edited - x).abs().max().item() / scale
    ok = err <= NMG_EDIT_TOL and bool(torch.isfinite(edited).all())
    print(f"NMG identity (f32, TF32 off, {STEPS} steps, loop {t1 - t0:.1f} s): max|x_edit - "
          f"DDIM sampling| / max|x| {err:.3e} (tol {NMG_EDIT_TOL:g}; max|x| {scale:.3e}) "
          f"{'OK' if ok else 'FAIL'}")
    return [] if ok else [f"NMG identity error {err:.3e}"]


def phase_reconstructions(pipe):
    """Two float32 identities of the loops this script's bf16 paths cannot
    show.  (a) The EF pair loop WITHOUT a stored trajectory (4 rows an image,
    cond_start = 2) on the DDPM inversion's stored residuals: its source
    branch re-walks the q-sampled trajectory and ends on the source latent.
    (b) Explicit h-Edit-D + P2P with target = source, cfg_tar == cfg_src_edit
    and a neutral control: the correction vanishes and the edit, stepped with
    the DDIM inversion's un-normalised residuals, returns the source latent."""
    failures = []
    g = torch.Generator(device="cuda").manual_seed(19)
    x0 = torch.randn(1, 64, 64, 4, generator=g, device="cuda")
    ids = torch.from_numpy(_token_ids(np.random.RandomState(19), 1))
    ctx3 = pipe.encode_token_ids(ids[0, [0, 1, 3]]).reshape(1, 3, MAX_LEN, -1)
    neutral = dict(control=neutral_control(STEPS, 256, cond_start=2).to("cuda"),
                   local_blend=neutral_blend(STEPS, 8, 16).to("cuda"))

    t0 = time.perf_counter()
    inv = invert_ddpm(pipe.unet, pipe.schedule, x0, uncond_ctx=ctx3[:, 0], src_ctx=ctx3[:, 1],
                      cfg_scale_src=1.0, eta=1.0, generator=g, step_chunk=10)
    _, recon = ef_or_pnp_inv_p2p(pipe.unet, pipe.schedule, inv.xT, inv.zs, ctx3=ctx3, cfg_src=1.0,
                                 cfg_tar=7.5, eta=1.0, after_skip_steps=STEPS, **neutral)
    torch.cuda.synchronize()
    scale = inv.xts.abs().max().item()
    err = (recon - x0).abs().max().item() / scale
    ok = err <= RECON_TOL and bool(torch.isfinite(recon).all())
    print(f"EF reconstruction (f32, TF32 off, {STEPS} steps, {time.perf_counter() - t0:.1f} s): "
          f"max|x_orig - x0| / max|xts| {err:.3e} (tol {RECON_TOL:g}; max|xts| {scale:.3e}) "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"EF reconstruction error {err:.3e}")

    t0 = time.perf_counter()
    schedule = Schedule.create(STEPS, steps_offset=0)
    same = ctx3[:, [0, 1, 1]]                       # target = source
    inv = invert_ddim(pipe.unet, schedule, x0, uncond_ctx=same[:, 0], src_ctx=same[:, 1],
                      cfg_scale=1.0, step_chunk=10)
    cfg = HEditConfig(cfg_src_edit=5.0, cfg_tar=5.0, eta=1.0, is_ddim_inversion=True,
                      implicit=False)
    edited, _ = h_edit_p2p(pipe.unet, schedule, inv.xT, inv.zs, ctx3=same, cfg=cfg,
                           after_skip_steps=STEPS, xts=inv.xts, **neutral)
    torch.cuda.synchronize()
    scale = inv.xts.abs().max().item()
    err = (edited - x0).abs().max().item() / scale
    ok = err <= RECON_TOL and bool(torch.isfinite(edited).all())
    print(f"h-Edit-D identity (f32, TF32 off, explicit, {STEPS} + {STEPS} steps, "
          f"{time.perf_counter() - t0:.1f} s): max|edited - x0| / max|xts| {err:.3e} "
          f"(tol {RECON_TOL:g}; max|xts| {scale:.3e}) {'OK' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"h-Edit-D identity error {err:.3e}")
    return failures


# Device-time classes of a flagship step, by kernel name (first match wins).
KERNEL_CLASSES = (("flash kernel", r"flash_fwd_kernel"),
                  ("GroupNorm kernel", r"_group_norm_kernel"),
                  ("cuDNN layout transposes", r"nchwToNhwc|nhwcToNchw"),
                  ("convolutions", r"fprop|conv|dgrad"),
                  ("GEMMs", r"gemm|nvjet|cutlass"),
                  ("copies", r"copy|Copy|Memcpy|Memset"))


def _union_us(intervals):
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_profile(steps, trace_path):
    """Where a flagship step's time goes, at the main path's inputs: edit
    steps 0 to ``steps`` - 1 (the P2P edits follow the step; the UNet's work
    does not depend on the timestep, so the last ``steps`` timesteps of the
    50-step grid serve), after a warm-up run: host wall a step without the
    profiler, then one
    torch.profiler trace of the same run, read for device time by kernel
    class, the top kernels, and the device's idle share (1 - union of the
    device's kernel, copy and set intervals / the traced span, which ends
    with a torch.cuda.synchronize())."""
    from torch.profiler import ProfilerActivity, profile, record_function

    pipe, images, ids, control, blend = _main_path_inputs()
    ctx4 = pipe.encode_token_ids(ids.reshape(-1, MAX_LEN)).reshape(N_IMAGES, 4, MAX_LEN, -1)
    x0s = pipe.vae_encode(images)
    xts = torch.stack([sample_xts_from_x0(pipe.schedule, x[None],
                                          torch.Generator(device="cuda").manual_seed(i))
                       for i, x in enumerate(x0s)])[:, :steps + 1]

    def run():
        h_edit_p2p_flagship(pipe.unet, pipe.schedule, HEditConfig(), xts=xts, ctx4=ctx4,
                            control=control, local_blend=blend, after_skip_steps=steps)
        torch.cuda.synchronize()

    run()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("flagship_steps"):
            run()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise RuntimeError("the trace holds no device activity")
    span = next((e for e in events if e.get("name") == "flagship_steps"
                 and e.get("cat") == "user_annotation"), None)
    if span is None:
        print("profile: no host span in the trace; the window is the device's own extent")
        lo, hi = min(e["ts"] for e in dev), max(e["ts"] + e["dur"] for e in dev)
    else:
        lo, hi = span["ts"], span["ts"] + span["dur"]
    dev = [e for e in dev if lo <= e["ts"] <= hi]
    busy = _union_us([(e["ts"], min(e["ts"] + e["dur"], hi)) for e in dev])
    by_class, by_name = {}, {}
    for e in dev:
        name = e["name"]
        cls = next((c for c, pat in KERNEL_CLASSES if re.search(pat, name)), "other kernels")
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"]
        by_name[name] = by_name.get(name, 0.0) + e["dur"]
    total = sum(by_class.values())
    print(f"profile: {N_IMAGES} images, {steps} steps; host wall without the profiler "
          f"{', '.join(f'{w:.2f}' for w in walls)} ms a step; traced span "
          f"{(hi - lo) / 1e3 / steps:.2f} ms a step, device busy {busy / 1e3 / steps:.2f} ms "
          f"a step, idle share {1 - busy / (hi - lo):.4f}; {len(dev)} device events")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"profile class {cls}: {us / 1e3 / steps:.3f} ms a step, "
              f"{100 * us / total:.2f}% of device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"profile kernel {us / 1e3 / steps:8.3f} ms a step  {name[:150]}")
    print(f"profile trace: {trace_path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile flagship steps instead of running the smoke")
    ap.add_argument("--trace", default=os.path.join(_build.BUILD_DIR, "flagship_trace.json"),
                    help="where --profile writes its chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    phase_card()
    phase_build()
    if args.profile:
        phase_profile(PROFILE_STEPS, args.trace)
        return 0
    rows, bad = phase_kernels()
    failures += bad
    inputs = _main_path_inputs()
    flagship_counts, bad = phase_flagship_path(*inputs)
    failures += bad
    nmg_counts, bad = phase_nmg_path(*inputs[:3])
    failures += bad
    hedit_d_counts, bad = phase_hedit_d_path(*inputs[:3])
    failures += bad
    ef_counts, bad = phase_ef_path(*inputs[:3])
    failures += bad
    del inputs
    torch.cuda.empty_cache()
    pipe = create_sd_pipeline(tiny=False, num_inference_steps=STEPS, seed=0,
                              dtype=torch.float32, device="cuda")
    failures += phase_golden(pipe)
    failures += phase_unet_gradient(pipe)
    failures += phase_nmg_identity(pipe)
    failures += phase_reconstructions(pipe)

    def entry(name, route, source, replaces, path_counts):
        """The kernel's first comparison (a shape of its main path) and its
        launches on that path; max_abs_err is the largest of all its cases."""
        mine = [r for r in rows if r["name"] == name]
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": path_counts[name],
                "launches_by_path": {"flagship": flagship_counts[name], "nmg": nmg_counts[name],
                                     "h_edit_d": hedit_d_counts[name], "ef": ef_counts[name]},
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                **{k: mine[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                           "plain_covers", "split_path_ms") if k in mine[0]}}

    fwd_cu, bwd_cu = ("hedit_tpu_torch/csrc/flash_attention.cu",
                      "hedit_tpu_torch/csrc/flash_attention_bwd.cu")
    jax_flash = "hedit_tpu/ops/flash_attention.py"
    print(json.dumps({"kernels": [
        entry("flash_attention", "cuda", fwd_cu, f"{jax_flash}:220", flagship_counts),
        entry("groupnorm", "triton", "hedit_tpu_torch/ops/groupnorm.py",
              "hedit_tpu/ops/groupnorm.py:100", flagship_counts),
        entry("flash_attention_lse", "cuda", fwd_cu, f"{jax_flash}:464", nmg_counts),
        entry("flash_bwd_dq", "cuda", bwd_cu, f"{jax_flash}:553", nmg_counts),
        entry("flash_bwd_dkv", "cuda", bwd_cu, f"{jax_flash}:593", nmg_counts),
        entry("flash_packed", "cuda", fwd_cu, f"{jax_flash}:340", flagship_counts)]}))
    if failures:
        print("FAILED: " + "; ".join(failures))
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
