"""End-to-end smoke of the PyTorch port on one CUDA GPU (an NVIDIA H100).

    python3 chip_smoke.py              # the smoke, phases 1-19
    python3 chip_smoke.py --profile    # where a flagship step's time goes

Phases, each printed on its own lines; any failure exits non-zero without
the final result line:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: the CUDA library from ``hedit_tpu_torch/csrc`` (flash attention,
   the probes' kernels, GroupNorm), timed;
3. each kernel of the paths against its plain PyTorch version at the paths'
   shapes: max abs error against a stated tolerance; CUDA-event time of the
   kernel, of the plain version and of the one PyTorch library call for the
   same function (a yardstick only, the port never calls it); the least time
   the card could take (``bound_ms``).  The bounded (max-free) and the exact
   forwards run bf16 on the tensor cores (``csrc/flash_attention_tc.cu``)
   and float32 on the CUDA-core template (``csrc/flash_attention.cu``), but
   the bounded forward and its LSE form in float32 at d = 40 / 80 on the
   float32 kernel (``csrc/flash_attention_f32.cu``: the anchor window's
   scores computed once, CUDA cores), and all three modes in float32 at
   d = 512 on the float32 d = 512 kernel (``csrc/flash_attention_f32_512.cu``:
   a cluster of CTAs splits the keys, the window scored once; each case at
   [1, 1, 1024, 512], [1, 1, 4096, 512] and ragged 1000 / 1100 timed beside
   the template's same mode, ``core_ms``, and SDPA, launched twice,
   bit-identical, and the saturating input at [1, 1, 4096, 512]), whose
   refusals (a misaligned pointer, a stride that is not a multiple of 4, an
   anchor window beyond 512 keys, 1024 at d = 512) are checked too; the
   tensor-core bounded kernel is also timed beside the
   CUDA-core template's LSE entry (in bf16, row 3 before it moved) at the
   same inputs, and the
   tensor-core wrappers' refusals (a misaligned pointer, an odd stride,
   float16) are checked.  The bounded and the exact forward are timed at
   the same shapes, head-split and packed (the exact kernels held to
   ``flash_attention_exact_reference`` at their key tile, JAX's bf16
   roundings included), and a saturating input shows the two forms apart,
   also laid out packed through ``fused_attention_packed``.  For the
   packed-head forwards also the time of the head-split route (three
   head-split copies, kernel 1, the merge).  The LSE forward (bf16 on the
   tensor cores, ``csrc/flash_attention_tc.cu``, timed beside the CUDA-core
   template on the same inputs; float32 on the float32 kernel, lse2 within
   1e-5 relative, at d = 512 on the float32 d = 512 kernel, also at
   [1, 1, 1024, 512] and ragged) and the backward
   at the NMG gradient call's shapes and a ragged one: bf16 dq and dk / dv
   on the tensor cores (``csrc/flash_attention_bwd_tc.cu``), timed beside
   the CUDA-core template (``csrc/flash_attention_bwd.cu``) on the same
   inputs and launched twice, bit-identical; float32 at d = 40 / 80 on the
   fused kernel
   (``csrc/flash_attention_bwd_f32.cu``: dq, dk and dv in one launch,
   launched twice: dk and dv bit-identical, dq's largest difference printed;
   its refusals checked); ``flash_attention_diff``'s backward
   routed as JAX routes it on the TPU (the kernels from 2048 tokens, the
   gradient of ``reference_attention`` below); the backward at the VAE's
   head dim (bf16 on the tensor cores at [1, 1, 4096, 512], also ragged at
   1000 / 1100; float32 on ``csrc/flash_attention_bwd_f32_512.cu``, a dk /
   dv kernel that stores ds and a dq product over it, at [1, 1, 2048, 512],
   the one shape JAX's routing sends it, at [1, 1, 4096, 512], its launches
   counted from 0 as the path ``backward_f32_512``, and ragged 1000 / 1100,
   each launched twice, bit-identical, beside the CUDA-core template's
   entry points, ``core_ms``), also through ``fused_attention`` under a
   gradient (bf16: the kernels; float32: the kernels at 2048 tokens,
   ``reference_attention`` at 4096, outside the K/V budget); the backward
   wrappers' refusals (a misaligned pointer at d = 40 and 512, float16; the
   float32 ones' a misaligned pointer, a stride that is not a multiple of 4,
   bf16, a head dim of the other float32 kernel, and float32 through the
   two-kernel wrappers).  Then GroupNorm + SiLU
   (``csrc/group_norm.cu``) on channels-last inputs at every GroupNorm shape
   of the paths' table (``GN_SHAPES``), bf16 and float32, eps 1e-5 and
   1e-6, with its regime and cluster, two launches bit-identical, a float32
   input at 1e3 + N(0, 1) against the float64 function, its refusals, and
   its gradient (dx channels-last);
4. the probes (TPU kernels 10, 11, 8, 9 and 12): the three bounded forwards
   with the packed transposed output and the exact exp2 forward in both key
   loops (bf16 on the tensor cores, ``csrc/flash_probes_tc.cu``, held
   before the final rounding, the two loops bit for bit; float32: all four
   on the query-major kernel of ``csrc/flash_variants.cu``, relaunched bit
   for bit, the exp2 one at d = 40 and 80) and a
   saturating input, the three ablations of the bounded loop (float32 on
   the query-major kernel, relaunched bit for bit; the ``dots`` one held
   element by element to its conditioning, the rows it excuses counted),
   the exact float32 forward in
   its three layouts and with a bf16 PV product (a, b and float32 d on one
   query-major kernel, ``csrc/flash_variants.cu``, c on its own; each
   relaunch bit-identical, a's output b's transposed bit for bit), and the
   nudged-matmul loop
   in its nine cases and a ragged one a layout (bf16 on the tensor cores,
   ``csrc/mm_probe_tc.cu``, K split over blocks where its output tiles are
   few; float32 on the CUDA-core kernel, ``csrc/mm_probe.cu``, the
   contraction split over blocks, in every case too; all-ones
   outputs held bit for bit, relaunches bit-identical; the library call one
   ``torch.mm`` of the nudged A's side by side along K, 64 torch.matmul
   calls timed for information), each against its plain
   version at its probe's shapes; then the probes' own entry points
   (``hedit_tpu_torch.probes.flash_nhd_variants``, ``...flash_v4_variants``,
   ``...flash_ablate``, ``...flash_variants``, ``...mm_probe``), each driven
   once with the counts at 0 before and read after, ``flash_nhd_variants``
   and ``flash_v4_variants`` also in float32 (row 11 on the query-major
   kernel, row 10 on the template; row 6, the v4 probe's base, on the
   float32 kernel), and
   ``mm_probe`` in float32 too (row 12's CUDA-core kernel);
5. the flagship path: the SD-1.5 pipeline at full width with seeded weights
   in bfloat16, two seeded 512x512 images and seeded token ids, CLIP encode ->
   VAE encode -> q-sampled trajectory -> 50-step h-Edit-R + P2P flagship loop
   with a non-neutral control and an active LocalBlend -> VAE decode; checks
   finite [2, 512, 512, 3] outputs, that its kernels were launched as
   predicted (GroupNorm: 6,152 calls, every input channels-last) and that
   the head-split forward served the VAE's one-head attention only;
6. the NMG path: the same pipeline on the DDIM grid, one seeded image, CLIP
   encode -> VAE encode -> 50-step DDIM inversion -> 50 NMG + P2P steps, each
   differentiating through the UNet, with a non-neutral control and an active
   LocalBlend -> VAE decode; checks a finite [1, 512, 512, 3] output and that
   each of its kernels was launched (the tensor-core LSE forward 500 times,
   the tensor-core backward 250 times each: the 4096-token layers; the
   1024-token ones take the gradient of ``reference_attention``, as on the
   TPU; the CUDA-core templates never); prints the time split and peak
   memory;
7. the h-Edit-D path, as ``main_p2p --mode h_edit_D_p2p --eta 0 --implicit
   --optimization_steps 2`` runs it: one image, 50-step DDIM inversion, then
   50 steps of the general h-Edit + P2P loop (one base call and two controlled
   4-row calls a step, residuals derived in the loop), same control and blend;
8. the EF path, as ``main_p2p --mode ef_p2p --eta 1 --cfg_src 3.5`` runs it:
   one image, the DDPM inversion's residual pass at 20 rows a call, then 50
   indexed 3-row steps with cond_start = 1;
9. the MasaCtrl path, as ``main_masactrl --mode h_edit_R_masactrl`` runs it
   at its defaults: one image, the empty source prompt, the DDPM inversion's
   residual pass at 10 rows a call, then 50 steps of one 1-row base call, one
   1-row source call and one 4-row MasaCtrl call; checks the launches of the
   bounded head-split, GroupNorm and bounded packed kernels against the
   prediction (every bf16 path: the tensor-core packed kernel serves each
   UNet self-attention of >= 1024 tokens without a gradient, the tensor-core
   head-split one the VAE's two attentions; the CUDA-core bounded entries and
   the exact kernels none); then the PnP path, as ``main_plugnplay --mode
   h_edit_R_pnp`` runs it at its defaults: one image, source and target
   prompts, the same inversion, then 50 steps of one 1-row base call, one
   uncontrolled 2-row call and the 2-row PnP pair call (q / k injected into
   the self-attentions of up blocks 1-3, conv features at up block 1's second
   resnet), its launches checked the same way (GroupNorm 9,507 calls, every
   input channels-last, the injected features included), and the same edit
   with every gate off, which must differ by more than 1e-2 of max|xts|;
   then the null-text + PnP path, as ``main_plugnplay --mode nt_pnp`` runs
   it at its defaults: one image, the DDIM inversion without its residual
   pass, then 50 steps of a 1-row source call, up to 10 Adam iterations on
   the uncond embedding (each a 1-row UNet forward and backward with respect
   to it) and the two 2-row pair calls; its launches checked against a
   prediction in terms of K, the Adam iterations taken (rows 1p, 3, 4 and 5,
   GroupNorm), and its source branch's reconstruction error beside the same
   run with no Adam iteration;
10. the VAE decode's gradient in bf16 at 512 px (the style reward's route,
    whose mode is not ported yet): the decoder's mid-block attention takes
    the tensor-core LSE forward and the tensor-core backward at d = 512,
    once each, and the template's backward none;
11. the exact forwards' own path (no editing path runs them): one call of
    the head-split one at each shape of JAX ``flash_attention``'s callers
    (bf16 on the tensor cores; float32, its oracle test's, on the float32
    kernel's exact mode, the template's counters held at 0),
    one of the packed one at each shape of ``flash_attention_packed``'s
    (float32) and one bf16 call at the UNet's controlled call [8, 4096, 320];
    one float32 call of each at the VAE's d = 512 (the float32 d = 512
    kernel); then the float32 d = 512 kernel's packed bounded entry, once
    (``packed_bounded_f32_512``: no path packs heads at d = 512);
12. the golden identity in float32 (TF32 off): target = source,
    cfg_tar == cfg_src_edit and a neutral control reproduce xts[0], through
    the general loop under the flagship configuration; the edit decoded (the
    VAE's float32 attention at 4096 tokens is outside the K/V budget: exact
    ``reference_attention``, no launch), then decoded at 256 px, where it
    fits: the float32 bounded kernel for the UNet's packed self-attentions
    and the float32 d = 512 kernel for the VAE's one head (the template
    never), their launches counted; then the VAE decode's gradient in
    float32 at 256 px (``vae_gradient_f32``): row 3 on the float32 d = 512
    kernel once, its backward autograd of ``reference_attention`` (1024
    tokens, below ``_BWD_MIN_SEQ``); then at 256 x 512 px (2048 tokens, the
    budget exactly): row 3 once and the float32 d = 512 backward once, the
    gradient held to the same gradient with the plain versions substituted;
13. the UNet gradient at full width in float32: d loss / d x of one NMG step
    with the kernels against the same gradient with the plain versions
    substituted here; then null-text's d loss / d u (the gradient with
    respect to the uncond embedding) the same way, and outer step 0's
    10-iteration Adam chain with the kernels and with the plain versions,
    the loss trajectories within 1e-3 relative;
14. the NMG loop in float32 under a neutral control: its edit branch equals
    plain DDIM sampling computed here; its launches counted (the float32
    LSE kernel 500, the fused float32 backward 250, the template's none);
15. in float32: the EF pair loop without a stored trajectory on the DDPM
    inversion's residuals reconstructs the source latent; explicit h-Edit-D
    with target = source, cfg_tar == cfg_src_edit and a neutral control
    returns the source latent;
16. in float32: h-Edit-R + MasaCtrl, active at its defaults, with target =
    source = the empty prompt and cfg_tar == cfg_src_edit returns xts[0];
    h-Edit-R + PnP at its default gates with target = source and
    cfg_tar == cfg_src_edit == 5 likewise, on the float32 packed kernel;
17. a JSON line of the kernels (each with its launches on its path: rows 1
    and 1p, the tensor-core kernel, and row 2 in both its regimes on the
    flagship path, rows 1p (the float32 kernel) and 1 (the float32 d = 512
    kernel) on the float32 golden path, row 3 on the float32 d = 512 kernel
    on ``vae_gradient_f32``, 3-5 on the NMG path (on
    the tensor cores, 4 + 5 also on the VAE decode's gradient; row 3 on the
    float32 kernel and 4 + 5 on the fused float32 kernel on the float32 NMG
    loop, 4 + 5 on the float32 d = 512 kernels on ``vae_gradient_f32``, and
    on phase 3's float32 [1, 1, 4096, 512] case, ``backward_f32_512``),
    6 and 7 on their own (tensor cores, the float32 kernel and the float32
    d = 512 kernel; its packed bounded entry on ``packed_bounded_f32_512``),
    8-12 on their probes' entry points, 11b and 11c on the tensor cores in
    bf16 and on the query-major kernel in float32, 12 on the tensor cores in bf16 and
    on the CUDA cores in float32), then the result line
    ``{"ok": true, "device": {...}}``.

It exits non-zero before printing anything when no CUDA device is present.

``--profile`` runs phases 1 and 2, then times flagship steps of the main
path (the same SD-1.5 bf16 inputs, 2 images), then NMG + P2P steps (1
image: the gradient call and the controlled call), each on the host clock
and under ``torch.profiler``, and prints the device time by kernel class,
the top kernels and the device's idle share, each path read from one
trace.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
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
from hedit_tpu_torch.control.pnp import pnp_step_gates  # noqa: E402
from hedit_tpu_torch.edit.h_edit_ctrl import h_edit_masactrl, h_edit_pnp  # noqa: E402
from hedit_tpu_torch.edit.h_edit_p2p import h_edit_p2p, h_edit_p2p_flagship  # noqa: E402
from hedit_tpu_torch.edit import pnp_baselines  # noqa: E402
from hedit_tpu_torch.invert.ddim import invert_ddim  # noqa: E402
from hedit_tpu_torch.invert.ddpm import invert_ddpm, sample_xts_from_x0  # noqa: E402
from hedit_tpu_torch.ops import attention as attn  # noqa: E402
from hedit_tpu_torch.ops import flash_attention as flash  # noqa: E402
from hedit_tpu_torch.ops import flash_probes as fp  # noqa: E402
from hedit_tpu_torch.ops import groupnorm as gn  # noqa: E402
from hedit_tpu_torch.ops import mm_probe as mp  # noqa: E402
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline  # noqa: E402
from hedit_tpu_torch.probes.timing import cuda_graph_ms, cuda_ms  # noqa: E402

STEPS = 50
N_IMAGES = 2
SOT, EOT = 49406, 49407  # CLIP's start- and end-of-text ids
# Tolerances of the kernel comparisons.  float32: 1e-4, room for the kernels'
# other summation order (TF32 off on both sides): absolute for the forward
# kernels, whose outputs of these inputs reach 0.03-0.15 (flash) and ~5
# (GroupNorm), and relative to the largest value of each output for the LSE
# forward and the gradients (dq, dk reach ~1e-2, dv ~0.3, lse2 ~10).
# bfloat16 flash, forward and backward: the kernels round to bf16 where the
# TPU kernels do (the bounded forwards q * scale and p; the backward qs, ks,
# ds and p for dv), and so do the plain versions, which leave out only the
# final rounding of their outputs (``out_dtype=float32``); each output is
# held to that within 2^-8 of its largest value.  The tensor-core kernel sums its products in
# another order than cuBLAS does for the plain version, so the two float32
# outputs differ in their last bits and, rounded to bf16, by one ulp of an
# element where it lies near a rounding boundary; on the saturating input
# (thousands of near-equal rows) that one ulp lands in the top binade of
# some element, above 2^-8 * max, even for the float64 bounded function
# rounded once.  Held to the output before its rounding, a kernel is within
# half an ulp (<= 2^-8 * max) plus its float32 error.  lse2 is float32 for either
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


def wall_ms(fn, reps=3):
    """Host-clock mean of ``fn`` ended by a synchronise, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound(nbytes, *work):
    """(bound_ms, bound_by): the least time the card could take, the larger of
    bytes (each input read once, each output written once) over the memory
    rate and the operations over the peak rate of the type their arithmetic
    runs in.  ``work``: (flops, type) pairs, one for each part of the
    function that runs in its own type (a product of bf16 values into
    float32 at the bf16 rate, a product the function upcasts first at the
    float32 rate)."""
    t_ops = sum(flops / PEAK_FLOPS[dtype] for flops, dtype in work)
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# each kernel's launch counter: (module, attribute)
COUNTERS = {"flash_attention": (flash, "launches_tc"), "groupnorm": (gn, "launches"),
            "groupnorm_streamed": (gn, "launches_streamed"),
            "flash_attention_core": (flash, "launches"),
            "flash_attention_lse": (flash, "launches_lse_tc"),
            "flash_attention_lse_core": (flash, "launches_lse"),
            "flash_bwd_dq": (flash, "launches_bwd_dq_tc"),
            "flash_bwd_dkv": (flash, "launches_bwd_dkv_tc"),
            "flash_bwd_f32": (flash, "launches_bwd_f32"),
            "flash_bwd_f32_512": (flash, "launches_bwd_f32_512"),
            "flash_packed": (flash, "launches_packed_tc"),
            "flash_packed_core": (flash, "launches_packed"),
            "flash_attention_exact": (flash, "launches_exact_tc"),
            "flash_attention_exact_core": (flash, "launches_exact"),
            "flash_packed_bounded": (flash, "launches_packed_bounded_tc"),
            "flash_packed_bounded_core": (flash, "launches_packed_bounded"),
            "flash_attention_f32": (flash, "launches_f32"),
            "flash_packed_bounded_f32": (flash, "launches_packed_bounded_f32"),
            "flash_attention_lse_f32": (flash, "launches_lse_f32"),
            "flash_attention_exact_f32": (flash, "launches_exact_f32"),
            "flash_packed_f32": (flash, "launches_packed_f32"),
            "flash_attention_f32_512": (flash, "launches_f32_512"),
            "flash_attention_lse_f32_512": (flash, "launches_lse_f32_512"),
            "flash_attention_exact_f32_512": (flash, "launches_exact_f32_512"),
            "flash_packed_bounded_f32_512": (flash, "launches_packed_bounded_f32_512"),
            "flash_packed_f32_512": (flash, "launches_packed_f32_512"),
            **{f"flash_{lay}": (fp, f"launches_{lay}_tc") for lay in fp._LAYOUTS},
            **{f"flash_{lay}_core": (fp, f"launches_{lay}") for lay in fp._LAYOUTS},
            "flash_exp2_t": (fp, "launches_exp2_t_tc"),
            "flash_exp2_t_core": (fp, "launches_exp2_t"),
            **{f"flash_ablate_{m}": (fp, f"launches_ablate_{m}_tc") for m in fp.ABLATE_MODES},
            **{f"flash_ablate_{m}_core": (fp, f"launches_ablate_{m}") for m in fp.ABLATE_MODES},
            # dots' check-only instance: launched by the check alone, on no path
            "flash_ablate_dots_check": (fp, "launches_ablate_dots_check_tc"),
            # rows 9 a, b (the query-major kernel) and c (its own), bf16 and float32
            **{f"flash_variant_{v}": (fp, f"launches_variant_{v}_tc") for v in "abc"},
            **{f"flash_variant_{v}_f32": (fp, f"launches_variant_{v}_f32") for v in "abc"},
            "flash_variant_d": (fp, "launches_variant_d_tc"),
            "flash_variant_d_core": (fp, "launches_variant_d"),
            **{f"mm_loop_{lay}": (mp, f"launches_{lay}") for lay in mp.LAYOUTS},
            **{f"mm_loop_{lay}_core": (mp, f"launches_{lay}_core") for lay in mp.LAYOUTS}}


# GroupNorm calls of the bf16 pipeline's UNet and VAE, and of those the
# calls whose input was channels-last (forward pre-hooks, ``hook_groupnorm``)
GN_INPUTS = {"calls": 0, "channels_last": 0}
# GroupNorm calls of each path (flagship: 61 a UNet call x 100 calls + 22 in
# the VAE encoder + 30 in the decoder); null-text + PnP's in terms of K, its
# Adam iterations (one 1-row gradient call each): the inversion's 50 calls, 3
# a step and K
GN_CALLS = {"flagship": 6152, "NMG": 9202, "h-Edit-D": 12252, "EF": 3407, "MasaCtrl": 9507,
            "PnP": 9507, "nt_pnp": lambda K: 61 * (STEPS + 3 * STEPS + K) + 52}


def reset_launches():
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)
    GN_INPUTS.update(calls=0, channels_last=0)


def hook_groupnorm(*models):
    """Count every GroupNorm input of ``models``, and the channels-last ones."""
    def hook(_, args):
        GN_INPUTS["calls"] += 1
        GN_INPUTS["channels_last"] += args[0].is_contiguous(memory_format=torch.channels_last)
    for model in models:
        for m in model.modules():
            if isinstance(m, gn.FusedGroupNorm):
                m.register_forward_pre_hook(hook)


# rows 6 and 7, the exact forwards: bf16 on the tensor cores, float32 on the
# float32 kernel (d = 40 / 80) or the float32 d = 512 kernel; the CUDA-core
# template's counters, which no wrapper moves
EXACT_NAMES = ("flash_attention_exact", "flash_attention_exact_core", "flash_packed",
               "flash_packed_core", "flash_attention_exact_f32", "flash_packed_f32",
               "flash_attention_exact_f32_512", "flash_packed_f32_512")


def read_launches():
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def check_forward_routing(counts, path, failures, packed, gn_calls=None):
    """On a bf16 path every UNet self-attention of kernel size without a
    gradient reads the packed projections through the tensor-core packed
    kernel, ``packed`` launches (10 self-attentions of >= 1024 tokens a UNet
    call); the tensor-core head-split kernel serves only the VAE's one-head
    attention, one launch in the encoder and one in the decoder; the
    CUDA-core bounded entries (float32) and the exact kernels (rows 6 and
    7, on either cores) never run, nor the float32 kernel.  (Row 3, the LSE
    forward, has its own counters.)
    GroupNorm: ``gn_calls`` (default ``GN_CALLS[path]``) kernel calls, each on
    a channels-last input, and the streamed regime in the VAE."""
    gn_calls = GN_CALLS[path] if gn_calls is None else gn_calls
    if (counts["groupnorm"], GN_INPUTS["calls"], GN_INPUTS["channels_last"]) != (
            gn_calls,) * 3 or counts["groupnorm_streamed"] <= 0:
        failures.append(f"the {path} path called the GroupNorm kernel {counts['groupnorm']} "
                        f"times (streamed {counts['groupnorm_streamed']}), on "
                        f"{GN_INPUTS['channels_last']} channels-last of {GN_INPUTS['calls']} "
                        f"inputs (expected {gn_calls} of {gn_calls})")
    print(f"{path} path GroupNorm: {counts['groupnorm']} kernel calls ({gn_calls} "
          f"predicted), {counts['groupnorm_streamed']} of them streamed, "
          f"{GN_INPUTS['channels_last']} of {GN_INPUTS['calls']} inputs channels-last")
    exact = {n: counts[n] for n in EXACT_NAMES}
    if counts["flash_packed_bounded"] != packed or any(exact.values()):
        failures.append(f"the {path} path launched the tensor-core packed kernel "
                        f"{counts['flash_packed_bounded']} times (expected {packed}) and the "
                        f"exact kernels {exact} times (expected 0)")
    if counts["flash_attention"] != 2:
        failures.append(f"the tensor-core head-split forward was launched "
                        f"{counts['flash_attention']} times on the {path} path, not by the two "
                        f"VAE attentions alone")
    core = {n: counts[n] for n in ("flash_attention_core", "flash_packed_bounded_core",
                                   "flash_attention_f32", "flash_packed_bounded_f32",
                                   "flash_attention_lse_f32", "flash_attention_f32_512",
                                   "flash_packed_bounded_f32_512",
                                   "flash_attention_lse_f32_512")}
    if any(core.values()):
        failures.append(f"the {path} path launched the CUDA-core bounded entries {core} in "
                        f"bf16 (expected 0)")


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
    print(f"build: nvcc csrc/*.cu (one nvcc a source, in parallel) and load "
          f"{time.perf_counter() - t0:.1f} s")


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


def _saturating_qkv(g, dtype):
    """q, k, v [1, 8, 4096, 40]: every query's score with a key is set by the
    key's first component.  The anchor window (the first 512 keys) scores a
    few log2 units; key 600 scores ~146, more than 116 above the window's max,
    so the bounded form clamps it to 2^100; keys 700-763 score ~109, below the
    clamp.  Exact attention is key 600's value row; the bounded form gives the
    64 keys about a tenth of the weight."""
    q = torch.randn(1, 8, 4096, 40, generator=g, device="cuda") * 0.1
    q[..., 0] = 8.0
    k = torch.randn(1, 8, 4096, 40, generator=g, device="cuda") * 0.5
    v = torch.randn(1, 8, 4096, 40, generator=g, device="cuda")
    k[:, :, 600, 0] = 80.0
    k[:, :, 700:764, 0] = 60.0
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _forward_plain(q, k, v, exact):
    """The plain version a forward kernel is held to, its output left
    unrounded (see ``BF16_ULP``): the exact one at the kernel's key tile or
    the bounded one, each with q * scale and p rounded to the inputs' dtype
    at the kernel's steps."""
    plain = (flash.flash_attention_exact_reference if exact
             else flash.flash_attention_bounded_reference)
    return plain(q, k, v, out_dtype=torch.float32)


def _route(entry):
    """(name suffix, label) of a forward entry point's kernel: the
    tensor-core kernel, the float32 kernel (``csrc/flash_attention_f32.cu``),
    the float32 d = 512 kernel (``csrc/flash_attention_f32_512.cu``) or the
    CUDA-core template."""
    if entry.endswith("_tc"):
        return "", "tensor cores"
    if entry.endswith(flash.F32_512_SUFFIX):
        return flash.F32_512_SUFFIX, "CUDA cores, float32 d = 512 kernel"
    if entry.endswith("_f32"):
        return "_f32", "CUDA cores, float32 kernel"
    return "_core", "CUDA cores, template"


# shapes at which the tensor-core forward is also timed against the CUDA-core
# bounded template (its LSE entry in bf16: the same work and one float a row)
CORE_SHAPES = ((8, 8, 4096, 40), (4, 8, 1024, 80), (1, 1, 4096, 512))


def _template_ms(entry, q, k, v, heads=None):
    """CUDA-event ms of the CUDA-core template's forward ``entry`` (bounded
    ``hedit_flash_attention_fwd``, LSE ``..._lse`` or exact ``..._exact``,
    head-split; with ``heads``, the exact ``..._packed`` on packed heads) at
    the inputs: the template beside the kernel that took its place
    (``core_ms``: the tensor cores in bf16, the float32 kernels), launched by
    its entry point, as no wrapper reaches it."""
    if heads is not None:
        ints = flash._check_packed(q, k, v, heads, entry)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        return cuda_ms(lambda: flash._launch(entry, q, [q, k, v, out], ints))
    bh, sq, sk, d = q.shape[0] * q.shape[1], q.shape[2], k.shape[2], q.shape[3]
    ptrs = [q, k, v, torch.empty_like(q)]
    if entry.endswith("_lse"):
        ptrs.append(torch.empty(bh, 1, sq, device="cuda"))
    ints = (bh, sq, sk, d) + (() if entry.endswith("_exact") else (flash.bounded_anchor(sk, d),))
    return cuda_ms(lambda: flash._launch(entry, q, ptrs, ints))


def _relaunch_same(call, outs):
    """Whether a second launch of ``call`` gives ``outs`` bit for bit."""
    again = call()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(again, outs))


def _flash_forward_cases(g, rows, failures):
    """Kernels 1 (bounded) and 6 (exact), head-split, each bf16 on the
    tensor cores and float32 on the CUDA cores, against its plain version
    and timed at the same shapes; the first case of each is its row's shape
    in the kernels line (kernel 1: the VAE's attention, its only use on the
    paths; kernel 6: the UNet's self-attention at 64^2, where JAX's
    ``flash_attention`` callers time it).  At ``CORE_SHAPES`` the
    tensor-core bounded kernel is timed beside the CUDA-core template (the
    exact one beside the parent's template by ``probes/flash_exact_tiles``);
    the float32 kernels' exact rows (d = 40 / 80 and 512) and the float32
    d = 512 rows beside the template's same mode (``core_ms``), each
    launched twice (``relaunch_bit_identical``).  Then the saturating
    case."""
    cases = [((1, 1, 4096, 512), 4096, torch.bfloat16),  # VAE mid block
             ((8, 8, 4096, 40), 4096, torch.bfloat16),   # UNet 64^2 self-attention, 8 rows
             ((4, 8, 1024, 80), 1024, torch.bfloat16),   # UNet 32^2, 4 rows
             ((1, 8, 1000, 80), 1064, torch.bfloat16),   # ragged, Sq != Sk
             ((1, 1, 1000, 512), 4096, torch.bfloat16),  # ragged Sq at the VAE's width
             ((1, 8, 1024, 40), 1000, torch.bfloat16),   # ragged Sk
             ((2, 8, 4096, 40), 4096, torch.float32),
             ((2, 8, 1000, 40), 1000, torch.float32),    # ragged Sq and Sk
             ((4, 8, 1024, 80), 1024, torch.float32),
             ((1, 8, 1000, 80), 1064, torch.float32),
             ((1, 1, 1024, 512), 1024, torch.float32),   # the 256 px decode's VAE attention
             ((1, 1, 4096, 512), 4096, torch.float32),
             ((1, 1, 1000, 512), 1100, torch.float32)]   # ragged, the window shorter than Sk
    exact_first = [cases[1]] + cases[:1] + cases[2:]
    for wrapper, exact, order in ((flash.flash_attention_cuda, False, cases),
                                  (flash.flash_attention_exact_cuda, True, exact_first)):
        for qshape, sk, dtype in order:
            q, k, v = _qkv(g, qshape, sk, dtype)
            got = wrapper(q, k, v)
            want = _forward_plain(q, k, v, exact)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            tol = F32_TOL if dtype == torch.float32 else BF16_ULP * want.abs().max().item()
            bh, sq, d = qshape[0] * qshape[1], qshape[2], qshape[3]
            bound_ms, by = bound(q.element_size() * bh * d * 2 * (sq + sk),
                                 (4 * bh * sq * sk * d, dtype))
            plain = (flash.flash_attention_exact_reference if exact
                     else flash.flash_attention_bounded_reference)
            tc = dtype == torch.bfloat16
            suffix, where = _route(flash.exact_entry(dtype, False, d) if exact
                                   else flash.bounded_entry(dtype, False, d))
            name = ("flash_attention_exact" if exact else "flash_attention") + suffix
            form = f"{'exact' if exact else 'bounded'} ({where})"
            extra = ({"core_ms": _template_ms("hedit_flash_attention_fwd_lse", q, k, v)}
                     if tc and not exact and qshape in CORE_SHAPES and sk == qshape[2] else {})
            if suffix == flash.F32_512_SUFFIX or (suffix == "_f32" and exact):
                # the float32 d = 512 kernel, and the float32 kernel's exact
                # mode: beside the template it replaced (the same mode by its
                # entry point), launched twice
                extra = {"core_ms": _template_ms("hedit_flash_attention_fwd"
                                                 + ("_exact" if exact else ""), q, k, v),
                         "relaunch_bit_identical": _relaunch_same(lambda: (wrapper(q, k, v),),
                                                                  (got,))}
            _row(rows, failures, name, f"flash {form} q{list(qshape)} sk={sk} {str(dtype)[6:]}",
                 err <= tol and bool(torch.isfinite(got).all())
                 and extra.get("relaunch_bit_identical", True), max_abs_err=err, tol=tol,
                 ms=cuda_ms(lambda: wrapper(q, k, v)),
                 plain_ms=cuda_ms(lambda: plain(q, k, v)),
                 library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                 bound_ms=bound_ms, bound_by=by, shape=list(qshape), dtype=str(dtype)[6:], **extra)
            if "relaunch_bit_identical" in extra:
                _print_redesign(rows[-1], where)
            elif extra:
                print(f"  the CUDA-core bounded template (its LSE entry) at the same inputs: "
                      f"{extra['core_ms']:.3f} ms, tensor cores {rows[-1]['ms']:.3f} ms "
                      f"({extra['core_ms'] / rows[-1]['ms']:.2f}x faster)")
    for qshape in CORE_SHAPES:
        b_ms, e_ms = (next(r["ms"] for r in rows if r["name"] == n and r["shape"] == list(qshape)
                           and r["dtype"] == "bfloat16")
                      for n in ("flash_attention", "flash_attention_exact"))
        print(f"tensor-core bounded vs tensor-core exact q{list(qshape)} bfloat16: {b_ms:.3f} ms "
              f"vs {e_ms:.3f} ms (bounded / exact {b_ms / e_ms:.3f})")

    _f32_512_lse_cases(g, rows, failures)

    # saturation: the bounded kernels follow their plain versions, the exact
    # kernel its own, and the two forms are far apart; float32 also at
    # d = 512 (the float32 d = 512 kernel in its three modes)
    for dtype, sat in ((torch.bfloat16, _saturating_qkv), (torch.float32, _saturating_qkv),
                       (torch.float32, _saturating_qkv_512)):
        q, k, v = sat(g, dtype)
        d = q.shape[-1]
        before = read_launches()
        bounded = flash.flash_attention_cuda(q, k, v).float()
        out, lse2 = flash.flash_attention_lse_cuda(q, k, v)
        exact = flash.flash_attention_exact_cuda(q, k, v).float()
        moved = {n: c - before[n] for n, c in read_launches().items() if c != before[n]}
        suffix = _route(flash.bounded_entry(dtype, False, d))[0]
        routed = {"flash_attention" + suffix: 1, "flash_attention_lse" + suffix: 1,
                  "flash_attention_exact" + _route(flash.exact_entry(dtype, False, d))[0]: 1}
        want_out, want_lse = flash.flash_attention_lse_reference(q, k, v,
                                                                 out_dtype=torch.float32)
        want_bounded = _forward_plain(q, k, v, exact=False)
        want_exact = _forward_plain(q, k, v, exact=True)
        torch.cuda.synchronize()
        tol = F32_TOL if dtype == torch.float32 else BF16_ULP * want_out.abs().max().item()
        tol_e = F32_TOL if dtype == torch.float32 else BF16_ULP * want_exact.abs().max().item()
        errs = [(bounded - want_bounded).abs().max().item(),
                (out.float() - want_out).abs().max().item(),
                (exact - want_exact).abs().max().item()]
        err_lse = ((lse2 - want_lse).abs() / want_lse.abs()).max().item()
        gap = (bounded - exact).abs().max().item()
        ok = (errs[0] <= tol and errs[1] <= tol and errs[2] <= tol_e and err_lse <= 1e-5
              and gap > 20 * tol and lse2.min().item() > 100.0 and moved == routed)
        print(f"flash saturating q{list(q.shape)} {str(dtype)[6:]}: bounded / LSE / exact "
              f"({'tensor' if dtype == torch.bfloat16 else 'CUDA'} cores) "
              f"max_abs_err {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} (tol {tol:.3g}), "
              f"lse2 relative {err_lse:.3e} (tol 1e-5, min lse2 {lse2.min().item():.2f}); "
              f"max|bounded - exact| {gap:.3e} (must exceed {20 * tol:.3g}); launches {moved} "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash saturating case {dtype} d = {d}")
        if dtype == torch.bfloat16:
            _rounding_diagnostic(q, k, v, bounded, want_out.to(dtype).float(), tol)


def _saturating_qkv_512(g, dtype):
    """q, k, v [1, 1, 4096, 512], the saturating input at the VAE's width:
    every query's score with a key is set by the key's first component; the
    anchor window (the first 1024 keys) scores a few log2 units; key 1500
    scores ~146, more than 116 above the window's max (clamped to 2^100 by
    the bounded form); keys 1510-1573 score ~109."""
    q = torch.randn(1, 1, 4096, 512, generator=g, device="cuda") * 0.1
    q[..., 0] = 8.0 * (512 / 40) ** 0.5
    k = torch.randn(1, 1, 4096, 512, generator=g, device="cuda") * 0.5
    v = torch.randn(1, 1, 4096, 512, generator=g, device="cuda")
    k[:, :, 1500, 0] = 80.0
    k[:, :, 1510:1574, 0] = 60.0
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _print_redesign(row, where="CUDA cores, float32 d = 512 kernel"):
    """A float32 kernel's row beside the template it replaced and SDPA, with
    its share of the bound."""
    print(f"  {where}: {row['ms']:.4f} ms, the template's same mode "
          f"{row['core_ms']:.4f} ms ({row['core_ms'] / row['ms']:.2f}x), SDPA "
          f"{row['library_ms']:.4f} ms (kernel / SDPA {row['ms'] / row['library_ms']:.2f}), "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_ms'] / row['ms']:.1%}); relaunched "
          f"{'bit-identical' if row['relaunch_bit_identical'] else 'DIFFERENT'}")


def _f32_512_lse_cases(g, rows, failures):
    """Row 3 in float32 at d = 512 on the float32 d = 512 kernel at the
    256 px decode's [1, 1, 1024, 512] (the shape of its path,
    ``vae_gradient_f32``) and a ragged [1, 1, 1000, 512] against 1100 keys:
    out within 1e-4 and lse2 within 1e-5 relative of
    ``flash_attention_lse_reference``; beside the template's LSE entry and
    SDPA, launched twice, bit-identical.  ([1, 1, 4096, 512] runs with the
    backward, ``_flash_gradient_cases``.)"""
    for qshape, sk in (((1, 1, 1024, 512), 1024), ((1, 1, 1000, 512), 1100)):
        q, k, v = _qkv(g, qshape, sk, torch.float32)
        out, lse2 = flash.flash_attention_lse_cuda(q, k, v)
        want, want_lse = flash.flash_attention_lse_reference(q, k, v)
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        err_l = ((lse2 - want_lse).abs() / want_lse.abs()).max().item()
        same = _relaunch_same(lambda: flash.flash_attention_lse_cuda(q, k, v), (out, lse2))
        sq = qshape[2]
        bound_ms, by = bound(4 * 512 * 2 * (sq + sk) + 4 * sq, (4 * sq * sk * 512, torch.float32))
        suffix, where = _route(flash.lse_entry(torch.float32, 512))
        print(f"flash lse ({where}) q{list(qshape)} sk={sk} float32: lse2 max_rel_err "
              f"{err_l:.3e} (tol 1e-05)")
        _row(rows, failures, "flash_attention_lse" + suffix,
             f"flash lse ({where}) q{list(qshape)} sk={sk} float32",
             err <= F32_TOL and err_l <= 1e-5 and same and bool(torch.isfinite(out).all()),
             max_abs_err=err, tol=F32_TOL,
             ms=cuda_ms(lambda: flash.flash_attention_lse_cuda(q, k, v)),
             plain_ms=cuda_ms(lambda: flash.flash_attention_lse_reference(q, k, v)),
             library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
             bound_ms=bound_ms, bound_by=by, shape=list(qshape), lse_max_rel_err=err_l,
             core_ms=_template_ms("hedit_flash_attention_fwd_lse", q, k, v),
             relaunch_bit_identical=same)
        _print_redesign(rows[-1])


def _rounding_diagnostic(q, k, v, got, want_rounded, tol):
    """Why bf16 bounded outputs are held to the plain version before its
    final rounding (``BF16_ULP``): on the saturating input the float64
    bounded function (q * scale and p rounded to bf16 as the kernels do,
    everything else in float64), rounded once, misses the plain version
    rounded to bf16 by one ulp at some elements, as the tensor-core kernel
    does.  Printed, not checked."""
    d, sk = q.shape[-1], k.shape[-2]
    qs = q * torch.tensor(1.0 / d ** 0.5 * math.log2(math.e), dtype=q.dtype)
    s64 = torch.matmul(qs.double(), k.double().transpose(-1, -2))
    shift = s64[..., :flash.bounded_anchor(sk, d)].amax(dim=-1, keepdim=True) + 16.0
    p = torch.exp2(torch.clamp(s64 - shift, max=100.0)).to(v.dtype).double()
    exact = (torch.matmul(p, v.double()) / p.sum(dim=-1, keepdim=True)).to(q.dtype).float()
    for label, x in (("the float64 bounded function", exact), ("the tensor-core kernel", got)):
        e = (x - want_rounded).abs()
        print(f"  rounding: {label} rounded once against the plain version rounded to bf16: "
              f"max {e.max().item():.3e}, {int((e > tol).sum())} of {e.numel()} elements beyond "
              f"{tol:.3g}, {int((e > 0).sum())} differ")
    del s64, p


def _flash_packed_cases(g, rows, failures):
    """The forwards on packed heads [B, S, H*D], each bf16 on the tensor
    cores and float32 on the CUDA cores: kernel 7 (exact, on no path)
    against its plain version at the kernel's key tile, and the bounded one
    (the route of every UNet self-attention on the paths) against its plain
    version, which rounds q * scale and p at the kernel's steps, with its
    output before the final rounding (``BF16_ULP``); beside each the
    head-split route at the same shape (three head-split copies, kernel 1,
    the merge).  Then the saturating input laid out packed through
    ``fused_attention_packed``: the bounded plain version within one output
    ulp, exact attention far off, one launch of the dtype's kernel.  Then the
    tensor-core wrappers' refusals: a misaligned pointer, an odd stride,
    float16, in either mode.  Both plain versions round q * scale and p at
    the kernel's steps and are read before their final rounding
    (``BF16_ULP``).  Float32 at d = 512 (one head of the VAE's width, and
    two heads as a batch-strided slice) runs the float32 d = 512 kernel's
    packed entries.  The float32 exact rows at d = 40 / 80 stand beside the
    template's packed exact entry (``core_ms``) and are launched twice
    (``relaunch_bit_identical``)."""
    cases = [(8, 4096, 4096, 320, torch.bfloat16, False, 8),   # controlled call, 2 images
             (4, 1024, 1024, 640, torch.bfloat16, False, 8),
             (2, 4096, 4096, 320, torch.float32, False, 8),
             (4, 1024, 1024, 640, torch.float32, False, 8),
             (2, 1000, 1064, 320, torch.bfloat16, False, 8),   # ragged, Sq != Sk
             (2, 1000, 1064, 640, torch.float32, False, 8),
             (4, 1024, 1024, 640, torch.bfloat16, True, 8),    # a row slice of a larger batch
             (4, 4096, 4096, 320, torch.float32, True, 8),
             (1, 1024, 1024, 512, torch.float32, False, 1),    # d = 512
             (2, 600, 1100, 1024, torch.float32, True, 2)]
    for wrapper, plain, exact in (
            (flash.flash_attention_packed_cuda, flash.flash_attention_packed_exact_reference,
             True),
            (flash.flash_attention_packed_bounded_cuda,
             flash.flash_attention_packed_bounded_reference, False)):
        for b, sq, sk, hd, dtype, strided, heads in cases:
            groups = 3 if strided else 1
            q, k, v = (torch.randn(b, groups, s, hd, generator=g, device="cuda")
                       .to(dtype)[:, groups // 2] for s in (sq, sk, sk))
            got = wrapper(q, k, v, heads)
            want = plain(q, k, v, heads, out_dtype=torch.float32)
            suffix, where = _route(flash.exact_entry(dtype, True, hd // heads) if exact
                                   else flash.bounded_entry(dtype, True, hd // heads))
            name = ("flash_packed" if exact else "flash_packed_bounded") + suffix
            form = f"{'exact' if exact else 'bounded'} ({where})"
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            tol = F32_TOL if dtype == torch.float32 else BF16_ULP * want.abs().max().item()
            bound_ms, by = bound(q.element_size() * b * hd * 2 * (sq + sk),
                                 (4 * b * sq * sk * hd, dtype))
            split = lambda t: t.reshape(b, -1, heads, hd // heads).transpose(1, 2)  # noqa: E731
            extra = {}
            if exact and suffix == "_f32":
                # the float32 kernel's exact mode beside the template's packed
                # exact entry, launched twice
                extra = {"core_ms": _template_ms("hedit_flash_attention_fwd_packed", q, k, v,
                                                 heads),
                         "relaunch_bit_identical": _relaunch_same(
                             lambda: (wrapper(q, k, v, heads),), (got,))}
            _row(rows, failures, name,
                 f"flash packed {form} q[{b}, {sq}, {hd}] sk={sk} "
                 f"{str(dtype)[6:]}{' batch-strided' if strided else ''}",
                 err <= tol and bool(torch.isfinite(got).all()) and got.is_contiguous()
                 and extra.get("relaunch_bit_identical", True),
                 max_abs_err=err, tol=tol, ms=cuda_ms(lambda: wrapper(q, k, v, heads)),
                 plain_ms=cuda_ms(lambda: plain(q, k, v, heads)),
                 # the library call reads the same packed tensors through strided head views
                 library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                     split(q), split(k), split(v))),
                 bound_ms=bound_ms, bound_by=by, shape=[b, sq, hd], dtype=str(dtype)[6:],
                 split_path_ms=cuda_ms(lambda: attn.merge_heads(flash.flash_attention_cuda(
                     attn.split_heads(q, heads), attn.split_heads(k, heads),
                     attn.split_heads(v, heads)))), **extra)
            print(f"  the head-split route at the same shape (3 copies + kernel 1 + merge): "
                  f"{rows[-1]['split_path_ms']:.3f} ms")
            if extra:
                _print_redesign(rows[-1], where)
    for shape in ([8, 4096, 320], [4, 1024, 640]):
        b_ms, e_ms = (next(r["ms"] for r in rows if r["name"] == n and r["shape"] == shape
                           and r["dtype"] == "bfloat16")
                      for n in ("flash_packed_bounded", "flash_packed"))
        print(f"tensor-core bounded vs tensor-core exact packed q{shape} bfloat16: {b_ms:.3f} ms "
              f"vs {e_ms:.3f} ms (bounded / exact {b_ms / e_ms:.3f})")

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (attn.merge_heads(t).contiguous() for t in _saturating_qkv(g, dtype))
        before = read_launches()
        with torch.no_grad():
            got = attn.fused_attention_packed(q, k, v, 8).float()
        want = flash.flash_attention_packed_bounded_reference(q, k, v, 8, out_dtype=torch.float32)
        exact = flash.flash_attention_packed_reference(q.float(), k.float(), v.float(), 8)
        torch.cuda.synchronize()
        moved = {n: c - before[n] for n, c in read_launches().items() if c != before[n]}
        kernel = "flash_packed_bounded" + _route(flash.bounded_entry(dtype, True, 40))[0]
        tol = F32_TOL if dtype == torch.float32 else BF16_ULP * want.abs().max().item()
        err, gap = (got - want).abs().max().item(), (got - exact).abs().max().item()
        ok = err <= tol and gap > 20 * tol and moved == {kernel: 1}
        print(f"flash packed saturating q[1, 4096, 320] {str(dtype)[6:]} through "
              f"fused_attention_packed: max_abs_err {err:.3e} against the bounded plain version "
              f"(tol {tol:.3g}), max|routed - exact| {gap:.3e} (must exceed {20 * tol:.3g}), "
              f"launches {moved} {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash packed saturating case {dtype}")
    _tc_refusals(g, failures)
    _f32_refusals(g, failures)


def _tc_refusals(g, failures):
    """The tensor-core wrappers (bounded, LSE and exact) raise, and launch
    nothing, on a pointer that is not 16-byte aligned, a batch stride that is
    not a multiple of 8, and float16; they never hand such an input to the
    CUDA-core template."""
    buf = torch.randn(2 * 1024 * 320 + 8, generator=g, device="cuda").to(torch.bfloat16)
    misaligned = buf[1:1 + 1024 * 320].view(1, 1024, 320)             # 2 bytes off
    odd = buf.as_strided((2, 1024, 320), (1024 * 320 + 3, 320, 1))     # batch stride 327,683
    head = buf[1:1 + 1024 * 40].view(1, 1, 1024, 40)
    cases = (("misaligned pointer, packed", flash.flash_attention_packed_bounded_cuda,
              (misaligned,) * 3 + (8,)),
             ("misaligned pointer, head-split", flash.flash_attention_cuda, (head,) * 3),
             ("misaligned pointer, LSE", flash.flash_attention_lse_cuda, (head,) * 3),
             ("odd batch stride, packed", flash.flash_attention_packed_bounded_cuda,
              (odd,) * 3 + (8,)),
             ("float16", flash.flash_attention_cuda, (head.contiguous().half(),) * 3),
             ("misaligned pointer, packed exact", flash.flash_attention_packed_cuda,
              (misaligned,) * 3 + (8,)),
             ("misaligned pointer, head-split exact", flash.flash_attention_exact_cuda,
              (head,) * 3),
             ("odd batch stride, packed exact", flash.flash_attention_packed_cuda,
              (odd,) * 3 + (8,)),
             ("float16, exact", flash.flash_attention_exact_cuda, (head.contiguous().half(),) * 3))
    _check_refusals("tensor-core", cases, failures)


def _check_refusals(kind, cases, failures):
    """Each (label, wrapper, args) of ``cases`` raises ValueError and
    launches nothing."""
    for label, wrapper, args in cases:
        before = read_launches()
        try:
            wrapper(*args)
            refused = False
        except ValueError as e:
            refused, why = True, str(e)
        torch.cuda.synchronize()
        ok = refused and read_launches() == before
        print(f"{kind} refusal, {label}: {'refused: ' + why if refused else 'TAKEN'}; "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kind} wrapper took {label}")


def _f32_refusals(g, failures):
    """The float32 kernels' wrappers (bounded head-split and packed, LSE,
    exact head-split and packed) raise, and launch nothing, on a pointer
    that is not 16-byte aligned, a batch stride that is not a multiple of 4
    and an anchor window beyond the head dim's (512 keys at d = 40 / 80,
    1024 at 512); they never hand such an input to the template or a plain
    version."""
    buf = torch.randn(2 * 1024 * 320 + 8, generator=g, device="cuda")
    misaligned = buf[1:1 + 1024 * 320].view(1, 1024, 320)              # 4 bytes off
    odd = buf.as_strided((2, 1024, 320), (1024 * 320 + 2, 320, 1))      # batch stride 327,682
    head = buf[1:1 + 1024 * 40].view(1, 1, 1024, 40)
    dense = buf[:1024 * 320].view(1, 1024, 320)
    cases = (("misaligned pointer, packed", flash.flash_attention_packed_bounded_cuda,
              (misaligned,) * 3 + (8,)),
             ("misaligned pointer, head-split", flash.flash_attention_cuda, (head,) * 3),
             ("misaligned pointer, LSE", flash.flash_attention_lse_cuda, (head,) * 3),
             ("misaligned pointer, exact", flash.flash_attention_exact_cuda, (head,) * 3),
             ("misaligned pointer, packed exact", flash.flash_attention_packed_cuda,
              (misaligned,) * 3 + (8,)),
             ("batch stride not a multiple of 4, packed",
              flash.flash_attention_packed_bounded_cuda, (odd,) * 3 + (8,)),
             ("batch stride not a multiple of 4, packed exact", flash.flash_attention_packed_cuda,
              (odd,) * 3 + (8,)),
             ("a 600-key anchor window, packed", flash.flash_attention_packed_bounded_cuda,
              (dense,) * 3 + (8, 600)))
    _check_refusals("float32 kernel", cases, failures)
    buf = torch.randn(2 * 1200 * 512 + 8, generator=g, device="cuda")
    head = buf[1:1 + 1024 * 512].view(1, 1, 1024, 512)                 # 4 bytes off
    odd = buf.as_strided((2, 1024, 512), (1024 * 512 + 2, 512, 1))      # batch stride 524,290
    dense = buf[:1200 * 512].view(1, 1200, 512)
    cases = (("misaligned pointer, head-split", flash.flash_attention_cuda, (head,) * 3),
             ("misaligned pointer, LSE", flash.flash_attention_lse_cuda, (head,) * 3),
             ("misaligned pointer, exact", flash.flash_attention_exact_cuda, (head,) * 3),
             ("batch stride not a multiple of 4, packed exact", flash.flash_attention_packed_cuda,
              (odd,) * 3 + (1,)),
             ("a 1100-key anchor window, packed", flash.flash_attention_packed_bounded_cuda,
              (dense,) * 3 + (1, 1100)))
    _check_refusals("float32 d = 512 kernel", cases, failures)


BWD_NAMES = ("flash_attention_lse", "flash_attention_lse_core", "flash_attention_lse_f32",
             "flash_attention_lse_f32_512",
             "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_f32", "flash_bwd_f32_512")


def _bwd_template_ms(part, q, k, v, do, lse2, delta):
    """CUDA-event ms of the CUDA-core template's backward entry ``part`` (0
    dq, 1 dk / dv) on inputs that the wrappers send to the tensor cores or
    the float32 d = 512 kernels: the template's time beside theirs
    (``core_ms``).  Launched by its entry point directly, as no wrapper
    launches it."""
    bh, sq, sk, d = q.shape[0] * q.shape[1], q.shape[2], k.shape[2], q.shape[3]
    outs = (torch.empty_like(q),) if part == 0 else (torch.empty_like(k), torch.empty_like(v))
    entry = ("hedit_flash_attention_bwd_dq", "hedit_flash_attention_bwd_dkv")[part]
    return cuda_ms(lambda: flash._launch(entry, q, (q, k, v, do, lse2, delta, *outs),
                                         (bh, sq, sk, d)))


def _diff_route(q, k, dtype, fwd=True):
    """The launches ``flash_attention_diff`` makes on CUDA tensors of these
    shapes (or, ``fwd=False``, its backward alone), as JAX routes it on the
    TPU: the LSE forward of ``lse_entry``; the backward kernels of
    ``bwd_entry`` where ``bwd_takes_kernels`` (the tensor-core pair, the
    fused float32 kernel or the float32 d = 512 pair), else none (autograd
    of ``reference_attention``)."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    lse = "flash_attention_lse" + _route(flash.lse_entry(dtype, d))[0]
    kernels = flash.bwd_takes_kernels(sq, sk, d, q.element_size(), interpret=False)
    entries = flash.bwd_entry(dtype, d)
    fused, tc = len(entries) == 1, entries[0].endswith("_tc")
    f512 = entries == flash.F32_512_BWD_ENTRIES
    return {**{n: int(fwd and n == lse) for n in ("flash_attention_lse",
                                                 "flash_attention_lse_core",
                                                 "flash_attention_lse_f32",
                                                 "flash_attention_lse_f32_512")},
            "flash_bwd_dq": int(kernels and tc), "flash_bwd_dkv": int(kernels and tc),
            "flash_bwd_f32": int(kernels and fused), "flash_bwd_f32_512": int(kernels and f512)}


# the VAE decoder's mid-block attention at 512 px: one head of 4096 tokens at d = 512
VAE_SHAPE = (1, 1, 4096, 512)
# at 256 x 512 px (a 32 x 64 latent): 2048 tokens, the float32 backward kernels' one shape
VAE_2048 = (1, 1, 2048, 512)


def _flash_gradient_cases(g, rows, failures, counts):
    """Kernels 3-5: the bounded LSE forward (out, lse2) against its plain
    version, out before its final rounding (bf16 on the tensor cores,
    ``flash_attention_lse``, timed beside the CUDA-core template on the same
    inputs, ``core_ms``; float32 on the float32 kernel, ``flash_attention_lse_f32``,
    lse2 within 1e-5 relative, or at d = 512 the float32 d = 512 kernel,
    ``flash_attention_lse_f32_512``, beside the template too),
    and dq, dk / dv of the backward kernels (``flash_attention_backward_cuda``)
    against the plain backward on the same inputs, fed that forward's out and
    lse2, before its final rounding (``out_dtype=float32``).  bf16 runs the
    tensor-core backward (``flash_bwd_dq`` / ``flash_bwd_dkv``; at the VAE's
    d = 512 at [1, 1, 4096, 512] and a ragged 1000 / 1100), timed
    beside the CUDA-core template on the same inputs (``core_ms``) and
    launched twice, bit-identical; float32 at the UNet's head dims the fused
    kernel (``flash_bwd_f32``, ``_fused_backward_row``); float32 at d = 512
    the float32 d = 512 pair (``flash_bwd_f32_512``, ``_f32_512_backward_row``:
    [1, 1, 2048, 512], the routed shape, first; [1, 1, 4096, 512], counted
    from 0 as the path ``backward_f32_512``; ragged 1000 / 1100).  bf16 tolerance: both
    sides round qs, ks, ds and p (for dv) to bf16 as the TPU kernels do; the
    kernels sum in another order, so a ds (or p) value may round to the
    other bf16 neighbour, and one such flip moves an output by at most 2^-7
    |ds| |k| (or |q|), a small part of a sum over hundreds of terms; with
    half an ulp of the kernel's own rounding, each output is held within
    2^-8 of its largest value.  Then ``flash_attention_diff`` through
    autograd: its launches as JAX routes them (``_diff_route``) and its
    gradient equal to the kernels' where it takes them, else to autograd of
    ``reference_attention``.  Then the backward wrappers' refusals."""
    cases = [((1, 8, 4096, 40), 4096, torch.bfloat16),   # the NMG gradient call, 64^2 level
             ((1, 8, 1024, 80), 1024, torch.bfloat16),   # its 32^2 level
             ((1, 8, 1000, 80), 1064, torch.bfloat16),   # ragged, Sq != Sk
             ((1, 8, 4096, 40), 4096, torch.float32),
             ((1, 8, 1024, 80), 1024, torch.float32),
             ((1, 8, 1000, 80), 1064, torch.float32),
             (VAE_SHAPE, 4096, torch.bfloat16),          # the style reward's route
             ((1, 1, 1000, 512), 1100, torch.bfloat16),  # ragged at the VAE's width
             (VAE_2048, 2048, torch.float32),            # its float32 route: 256 x 512 px
             (VAE_SHAPE, 4096, torch.float32),
             ((1, 1, 1000, 512), 1100, torch.float32)]
    for qshape, sk, dtype in cases:
        q, k, v = _qkv(g, qshape, sk, dtype)
        do = torch.randn(qshape, generator=g, device="cuda").to(dtype)
        label = f"q{list(qshape)} sk={sk} {str(dtype)[6:]}"
        bh, sq, d = qshape[0] * qshape[1], qshape[2], qshape[3]
        es = q.element_size()
        entries = flash.bwd_entry(dtype, d)
        fused, f512 = len(entries) == 1, entries == flash.F32_512_BWD_ENTRIES
        lse_suffix, form_lse = _route(flash.lse_entry(dtype, d))
        # the template's LSE entry beside the kernels that took its place
        beside_template = lse_suffix in ("", flash.F32_512_SUFFIX)
        rel = F32_TOL if dtype == torch.float32 else BF16_ULP
        finite = lambda *ts: all(bool(torch.isfinite(t).all()) for t in ts)  # noqa: E731

        # the float32 [1, 1, 4096, 512] case is a path of its own, counted from 0
        own_path = f512 and tuple(qshape) == VAE_SHAPE
        if own_path:
            reset_launches()
        out, lse2 = flash.flash_attention_lse_cuda(q, k, v)
        dq, dk, dv = flash.flash_attention_backward_cuda(q, k, v, out, lse2, do)
        if own_path:
            torch.cuda.synchronize()
            counts["backward_f32_512"] = read_launches()
        # the bounded plain forward rounds at the kernel's steps; the plain
        # backward reads the kernel forward's out and lse2
        want_out, want_lse = flash.flash_attention_lse_reference(q, k, v, out_dtype=torch.float32)
        want_dq, want_dk, want_dv = flash.flash_attention_backward_reference(
            q, k, v, out, lse2, do, out_dtype=torch.float32)
        torch.cuda.synchronize()

        gap = functools.partial(_gap, rel)

        # the library call for the same functions: SDPA's forward under a
        # recorded gradient (it saves its log-sum-exp), and its backward,
        # which gives dq, dk and dv in one call (no call gives one alone)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(*leaves)
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True))

        err_o, tol_o = gap(out, want_out)
        # float32: 1e-5 relative to each row's lse2 (float32 ulps of values of
        # ~10); bf16: a rounding of one p that falls the other way moves a
        # row's sum by at most one ulp of its largest term
        if dtype == torch.float32:
            err_l, tol_l = ((lse2 - want_lse).abs() / want_lse.abs()).max().item(), 1e-5
        else:
            err_l, tol_l = (lse2 - want_lse).abs().max().item(), math.log2(1 + BF16_ULP)
        bound_ms, by = bound(es * bh * d * 2 * (sq + sk) + 4 * bh * sq,
                             (4 * bh * sq * sk * d, dtype))
        kind = "rel" if dtype == torch.float32 else "abs"
        print(f"flash lse ({form_lse}) {label}: lse2 max_{kind}_err {err_l:.3e} (tol {tol_l:.3g})")
        core = ({"core_ms": _template_ms("hedit_flash_attention_fwd_lse", q, k, v)}
                if beside_template else {})
        _row(rows, failures, "flash_attention_lse" + lse_suffix,
             f"flash lse ({form_lse}) {label}",
             err_o <= tol_o and err_l <= tol_l and finite(out, lse2), max_abs_err=err_o,
             tol=tol_o, ms=cuda_ms(lambda: flash.flash_attention_lse_cuda(q, k, v)),
             plain_ms=cuda_ms(lambda: flash.flash_attention_lse_reference(q, k, v)),
             library_ms=lib_fwd, bound_ms=bound_ms, bound_by=by, shape=list(qshape), **core)
        if beside_template:
            print(f"  the CUDA-core template's LSE entry at the same inputs: "
                  f"{core['core_ms']:.3f} ms, tensor cores {rows[-1]['ms']:.3f} ms, SDPA forward "
                  f"{lib_fwd:.3f} ms, bound {bound_ms:.4f} ms")

        delta = (do.float() * out.float()).sum(dim=-1)
        # the plain version and the library call give dq, dk and dv in one call
        plain_bwd = cuda_ms(lambda: flash.flash_attention_backward_reference(q, k, v, out, lse2, do))
        in_bytes = es * bh * d * 2 * (sq + sk) + 8 * bh * sq  # q, dO, k, v; lse2, delta
        row = (_fused_backward_row if fused else _f32_512_backward_row if f512
               else _backward_rows)
        row(rows, failures, label, q, k, v, do, lse2, delta, (dq, dk, dv),
            (want_dq, want_dk, want_dv), plain_bwd, lib_bwd, in_bytes)

        # flash_attention_diff's backward, routed as JAX routes it on the TPU;
        # at the VAE's width also fused_attention, the style reward's route
        # (float32 at 4096 tokens is outside the K/V budget: reference_attention)
        routes = [("flash_attention_diff", flash.flash_attention_diff, _diff_route(q, k, dtype))]
        if d == 512:
            fits = attn.flash_route(sq, sk, d, es)
            routes.append(("fused_attention", attn.fused_attention,
                           _diff_route(q, k, dtype, fwd=fits) if fits
                           else dict.fromkeys(BWD_NAMES, 0)))
        for what, fn, routed in routes:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            before = read_launches()
            got = torch.autograd.grad(fn(*leaves), leaves, do)
            torch.cuda.synchronize()
            moved = {n: read_launches()[n] - before[n] for n in BWD_NAMES}
            kernels = (routed["flash_bwd_dq"] + routed["flash_bwd_f32"]
                       + routed["flash_bwd_f32_512"]) > 0
            want = ((dq, dk, dv) if kernels else
                    torch.autograd.grad(flash.reference_attention(*leaves), leaves, do))
            gaps = [gap(a, w.float()) for a, w in zip(got, want)]
            ok = moved == routed and all(e <= t for e, t in gaps) and finite(*got)
            print(f"flash {what} gradient {label}: backward by "
                  f"{'the kernels' if kernels else 'autograd of reference_attention'}, "
                  f"dq / dk / dv max_abs_err against it "
                  f"{' / '.join(f'{e:.3e} (tol {t:.3g})' for e, t in gaps)}, launches "
                  f"{moved} {'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{what} gradient {label}: launched {moved}, expected {routed}")
    _bwd_refusals(g, failures)


def _gap(rel, got, want):
    """(largest error, tolerance rel * the largest value) of one output."""
    return (got.float() - want).abs().max().item(), rel * want.abs().max().item()


def _backward_rows(rows, failures, label, q, k, v, do, lse2, delta, got, wants, plain_bwd,
                   lib_bwd, in_bytes):
    """Rows 4 and 5 in bf16 as two kernels on the tensor cores
    (``flash_bwd_dq_cuda``, ``flash_bwd_dkv_cuda``) at d = 40 / 80 / 512,
    timed beside the CUDA-core template on the same inputs (``core_ms``);
    each launched a second time, its outputs bit-identical: one writer an
    element, no atomics."""
    es = q.element_size()
    bh, sq, sk, d = q.shape[0] * q.shape[1], q.shape[2], k.shape[2], q.shape[3]
    finite = lambda *ts: all(bool(torch.isfinite(t).all()) for t in ts)  # noqa: E731
    together = "plain_ms and library_ms are of dq, dk and dv together"
    (dq, dk, dv), (want_dq, want_dk, want_dv) = got, wants
    again_dq = flash.flash_bwd_dq_cuda(q, k, v, do, lse2, delta)
    again_dk, again_dv = flash.flash_bwd_dkv_cuda(q, k, v, do, lse2, delta)
    torch.cuda.synchronize()
    same_dq = torch.equal(again_dq, dq)
    same_dkv = torch.equal(again_dk, dk) and torch.equal(again_dv, dv)
    same = same_dq and same_dkv
    print(f"flash backward {label}: launched again, dq "
          f"{'bit-identical' if same_dq else 'DIFFERS'}, dk and dv "
          f"{'bit-identical' if same_dkv else 'DIFFER'}")
    err, tol = _gap(BF16_ULP, dq, want_dq)
    bound_ms, by = bound(in_bytes + es * bh * sq * d, (6 * bh * sq * sk * d, q.dtype))
    _row(rows, failures, "flash_bwd_dq", f"flash dq (tensor cores) {label}",
         err <= tol and finite(dq) and same, max_abs_err=err, tol=tol,
         ms=cuda_ms(lambda: flash.flash_bwd_dq_cuda(q, k, v, do, lse2, delta)),
         plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=bound_ms, bound_by=by,
         plain_covers=together, shape=list(q.shape),
         core_ms=_bwd_template_ms(0, q, k, v, do, lse2, delta), relaunch_bit_identical=same)
    (err_k, tol_k), (err_v, tol_v) = _gap(BF16_ULP, dk, want_dk), _gap(BF16_ULP, dv, want_dv)
    print(f"flash dk/dv {label}: dk max_abs_err {err_k:.3e} (tol {tol_k:.3g}), "
          f"dv {err_v:.3e} (tol {tol_v:.3g})")
    bound_ms, by = bound(in_bytes + es * bh * 2 * sk * d, (8 * bh * sq * sk * d, q.dtype))
    worst = max((err_k, tol_k), (err_v, tol_v), key=lambda et: et[0] / et[1])
    _row(rows, failures, "flash_bwd_dkv", f"flash dk/dv (tensor cores) {label}",
         err_k <= tol_k and err_v <= tol_v and finite(dk, dv) and same, max_abs_err=worst[0],
         tol=worst[1], ms=cuda_ms(lambda: flash.flash_bwd_dkv_cuda(q, k, v, do, lse2, delta)),
         plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=bound_ms, bound_by=by,
         plain_covers=together, shape=list(q.shape),
         core_ms=_bwd_template_ms(1, q, k, v, do, lse2, delta), relaunch_bit_identical=same)
    # dq and dk / dv share one plain version and one library call, so the
    # two are read together: both kernels against each
    both = rows[-2]["ms"] + rows[-1]["ms"]
    bounds = rows[-2]["bound_ms"] + rows[-1]["bound_ms"]
    print(f"flash backward {label}: dq + dk/dv kernels (tensor cores) {both:.3f} ms (the "
          f"CUDA-core template on the same inputs {rows[-2]['core_ms'] + rows[-1]['core_ms']:.3f}"
          f" ms), plain version {plain_bwd:.3f} ms, library {lib_bwd:.3f} ms, bound "
          f"{bounds:.4f} ms ({bounds / both:.1%})")


def _fused_backward_row(rows, failures, label, q, k, v, do, lse2, delta, got, wants, plain_bwd,
                        lib_bwd, in_bytes):
    """Rows 4 + 5 in float32 at d = 40 / 80 as one fused kernel
    (``flash_bwd_f32_cuda``, ``csrc/flash_attention_bwd_f32.cu``): dq, dk
    and dv each within ``F32_TOL`` of its largest value; launched a second
    time, dk and dv bit-identical and dq (summed over key blocks by atomic
    adds in launch order) within dq's tolerance, its largest difference
    printed.  Charged at the function's 5 products, 10 B H Sq Sk D FLOP (the
    two template kernels' 7 printed beside it)."""
    bh, sq, sk, d = q.shape[0] * q.shape[1], q.shape[2], k.shape[2], q.shape[3]
    errs = [_gap(F32_TOL, a, w) for a, w in zip(got, wants)]
    again = flash.flash_bwd_f32_cuda(q, k, v, do, lse2, delta)
    torch.cuda.synchronize()
    dq_diff = (again[0] - got[0]).abs().max().item()
    dq_rel = dq_diff / max(got[0].abs().max().item(), 1e-30)
    same_dkv = torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    bound_ms, by = bound(in_bytes + 4 * bh * d * 2 * (sq + sk),
                         (10 * bh * sq * sk * d, torch.float32))
    bound7, _ = bound(in_bytes + 4 * bh * d * 2 * (sq + sk), (14 * bh * sq * sk * d, torch.float32))
    worst = max(errs, key=lambda et: et[0] / et[1])
    print(f"flash dq / dk / dv (CUDA cores, fused float32 kernel) {label}: max_abs_err "
          f"{' / '.join(f'{e:.3e} (tol {t:.3g})' for e, t in errs)}; second launch: dq largest "
          f"difference {dq_diff:.3e} ({dq_rel:.3e} of max|dq|), dk and dv "
          f"{'bit-identical' if same_dkv else 'DIFFER'}; bound at 7 products {bound7:.4f} ms")
    _row(rows, failures, "flash_bwd_f32", f"flash backward (CUDA cores, fused float32) {label}",
         all(e <= t for e, t in errs) and finite and same_dkv and dq_diff <= errs[0][1],
         max_abs_err=worst[0], tol=worst[1],
         ms=cuda_ms(lambda: flash.flash_bwd_f32_cuda(q, k, v, do, lse2, delta)),
         plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=bound_ms, bound_by=by,
         bound_7_products_ms=bound7, dq_run_to_run=dq_diff, dkv_bit_identical=same_dkv,
         plain_covers="plain_ms and library_ms are of dq, dk and dv, as the kernel",
         shape=list(q.shape))
    print(f"flash backward {label}: fused float32 kernel {rows[-1]['ms']:.3f} ms, plain version "
          f"{plain_bwd:.3f} ms, library {lib_bwd:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_ms / rows[-1]['ms']:.1%})")


def _f32_512_backward_row(rows, failures, label, q, k, v, do, lse2, delta, got, wants, plain_bwd,
                          lib_bwd, in_bytes):
    """Rows 4 + 5 in float32 at d = 512 (``flash_bwd_f32_512_cuda``,
    ``csrc/flash_attention_bwd_f32_512.cu``): the dk / dv kernel, which
    stores ds, then the dq product over it.  dq, dk and dv each within
    ``F32_TOL`` of its largest value; launched a second time, all three
    bit-identical (one writer an element, a fixed order); timed whole and by
    entry point (``dkv_ms``, ``dq_ms``: the workspace allocated once), beside
    the CUDA-core template's two entry points on the same inputs
    (``core_ms``).  Charged at the function's 5 products, 10 B H Sq Sk D
    FLOP (the template's 7 printed beside it)."""
    bh, sq, sk, d = q.shape[0] * q.shape[1], q.shape[2], k.shape[2], q.shape[3]
    errs = [_gap(F32_TOL, a, w) for a, w in zip(got, wants)]
    again = flash.flash_bwd_f32_512_cuda(q, k, v, do, lse2, delta)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(again, got))
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    out_bytes = 4 * bh * d * (sq + 2 * sk)
    bound_ms, by = bound(in_bytes + out_bytes, (10 * bh * sq * sk * d, torch.float32))
    bound7, _ = bound(in_bytes + out_bytes, (14 * bh * sq * sk * d, torch.float32))
    entry_dq, entry_dkv = flash.F32_512_BWD_ENTRIES
    ds = torch.empty(flash.bwd_f32_512_workspace(bh, sq, sk), device="cuda")
    dq_, dk_, dv_ = (torch.empty_like(t) for t in got)
    dkv_ms = cuda_ms(lambda: flash._launch(entry_dkv, q, (q, k, v, do, lse2, delta, ds, dk_, dv_),
                                           (bh, sq, sk, d)))
    dq_ms = cuda_ms(lambda: flash._launch(entry_dq, q, (k, ds, dq_), (bh, sq, sk, d)))
    core_ms = (_bwd_template_ms(0, q, k, v, do, lse2, delta)
               + _bwd_template_ms(1, q, k, v, do, lse2, delta))
    worst = max(errs, key=lambda et: et[0] / et[1])
    print(f"flash dq / dk / dv (CUDA cores, float32 d = 512 kernels) {label}: max_abs_err "
          f"{' / '.join(f'{e:.3e} (tol {t:.3g})' for e, t in errs)}; second launch: dq, dk and "
          f"dv {'bit-identical' if same else 'DIFFER'}; bound at 7 products {bound7:.4f} ms")
    _row(rows, failures, "flash_bwd_f32_512",
         f"flash backward (CUDA cores, float32 d = 512) {label}",
         all(e <= t for e, t in errs) and finite and same, max_abs_err=worst[0], tol=worst[1],
         ms=cuda_ms(lambda: flash.flash_bwd_f32_512_cuda(q, k, v, do, lse2, delta)),
         plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=bound_ms, bound_by=by,
         bound_7_products_ms=bound7, relaunch_bit_identical=same, core_ms=core_ms,
         dkv_ms=dkv_ms, dq_ms=dq_ms,
         plain_covers="plain_ms and library_ms are of dq, dk and dv, as the kernels",
         shape=list(q.shape))
    ms = rows[-1]["ms"]
    print(f"flash backward {label}: float32 d = 512 kernels {ms:.3f} ms (dk / dv {dkv_ms:.3f} + "
          f"dq {dq_ms:.3f} by entry point), the CUDA-core template on the same inputs "
          f"{core_ms:.3f} ms ({core_ms / ms:.2f}x), plain version {plain_bwd:.3f} ms, library "
          f"{lib_bwd:.3f} ms ({lib_bwd / ms:.2f}x), bound {bound_ms:.4f} ms ({bound_ms / ms:.1%}; "
          f"{bound7 / ms:.1%} of the 7-product bound)")


def _bwd_refusals(g, failures):
    """The backward wrappers raise, and launch nothing, on a bf16 operand
    that is not 16-byte aligned (the tensor-core kernels copy 16 bytes at a
    time; at d = 40 and at the VAE's 512) and on float16; they never hand
    such an input to the CUDA-core template."""
    cases = []
    for d in (40, 512):
        buf = torch.randn(2 * 1024 * d + 16, generator=g, device="cuda").to(torch.bfloat16)
        misaligned = buf[1:1 + 1024 * d].view(1, 1, 1024, d)   # 2 bytes off
        aligned = buf[8:8 + 1024 * d].view(1, 1, 1024, d)      # 16 bytes on
        cases += [(f"misaligned q, d = {d}", (misaligned, aligned, aligned, aligned)),
                  (f"misaligned dO, d = {d}", (aligned, aligned, aligned, misaligned))]
    half = aligned.half()
    cases.append(("float16", (half, half, half, half)))
    lse2 = torch.zeros(1, 1, 1024, device="cuda")
    delta = torch.zeros(1, 1024, device="cuda")
    for label, (q, k, v, do) in cases:
        for wrapper in (flash.flash_bwd_dq_cuda, flash.flash_bwd_dkv_cuda):
            before = read_launches()
            try:
                wrapper(q, k, v, do, lse2, delta)
                refused = False
            except ValueError as e:
                refused, why = True, str(e)
            torch.cuda.synchronize()
            ok = refused and read_launches() == before
            print(f"backward refusal, {label}, {wrapper.__name__}: "
                  f"{'refused: ' + why if refused else 'TAKEN'}; {'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{wrapper.__name__} took {label}")
    _f32_bwd_refusals(g, failures)


def _f32_bwd_refusals(g, failures):
    """The float32 backward wrappers raise, and launch nothing: the fused
    one (d = 40 / 80) on an operand that is not 16-byte aligned, an element
    stride that is not a multiple of 4 (a one-head view whose head stride is
    odd), a bf16 input and d = 512; the d = 512 one on a misaligned q or dO,
    a bf16 input and d = 40; the two-kernel (tensor-core) wrappers on float32
    at d = 40 and 512, naming the float32 wrapper.  None hands such an input
    to the template or a plain version."""
    buf = torch.randn(2 * 1024 * 40 + 16, generator=g, device="cuda")
    misaligned = buf[1:1 + 1024 * 40].view(1, 1, 1024, 40)               # 4 bytes off
    aligned = buf[4:4 + 1024 * 40].view(1, 1, 1024, 40)                  # 16 bytes on
    odd = buf.as_strided((1, 1, 1024, 40), (1024 * 40 + 2, 1024 * 40 + 2, 40, 1))
    lse2 = torch.zeros(1, 1, 1024, device="cuda")
    delta = torch.zeros(1, 1024, device="cuda")
    rest = (lse2, delta)
    bf16 = aligned.to(torch.bfloat16)
    cases = (("misaligned q", flash.flash_bwd_f32_cuda, (misaligned,) + (aligned,) * 3 + rest),
             ("misaligned dO", flash.flash_bwd_f32_cuda, (aligned,) * 3 + (misaligned,) + rest),
             ("a head stride not a multiple of 4", flash.flash_bwd_f32_cuda,
              (odd,) + (aligned,) * 3 + rest),
             ("bf16", flash.flash_bwd_f32_cuda, (bf16,) * 4 + rest),
             ("float32 at d = 40, dq alone", flash.flash_bwd_dq_cuda, (aligned,) * 4 + rest),
             ("float32 at d = 40, dk / dv alone", flash.flash_bwd_dkv_cuda, (aligned,) * 4 + rest),
             ("float32 at d = 40, the d = 512 wrapper", flash.flash_bwd_f32_512_cuda,
              (aligned,) * 4 + rest))
    buf = torch.randn(2 * 1024 * 512 + 16, generator=g, device="cuda")
    misaligned = buf[1:1 + 1024 * 512].view(1, 1, 1024, 512)             # 4 bytes off
    aligned = buf[4:4 + 1024 * 512].view(1, 1, 1024, 512)                # 16 bytes on
    bf16 = aligned.to(torch.bfloat16)
    cases += (("d = 512, misaligned q", flash.flash_bwd_f32_512_cuda,
               (misaligned,) + (aligned,) * 3 + rest),
              ("d = 512, misaligned dO", flash.flash_bwd_f32_512_cuda,
               (aligned,) * 3 + (misaligned,) + rest),
              ("d = 512, bf16", flash.flash_bwd_f32_512_cuda, (bf16,) * 4 + rest),
              ("d = 512, the fused wrapper", flash.flash_bwd_f32_cuda, (aligned,) * 4 + rest),
              ("float32 at d = 512, dq alone", flash.flash_bwd_dq_cuda, (aligned,) * 4 + rest),
              ("float32 at d = 512, dk / dv alone", flash.flash_bwd_dkv_cuda,
               (aligned,) * 4 + rest))
    _check_refusals("float32 backward", cases, failures)


# Every GroupNorm shape of the paths' table (PERF.md section 6, row 2): the
# controlled and base calls' 320-channel levels, up_blocks[3]'s and [2]'s
# norm1, the bottom levels, the VAE's mid block and its two largest levels
# (streamed; the full resolution first, the kernels line's shape)
GN_SHAPES = ((8, 320, 64, 64), (2, 320, 64, 64), (8, 960, 64, 64), (8, 640, 64, 64),
             (8, 1920, 32, 32), (8, 1280, 8, 8), (8, 2560, 8, 8), (2, 512, 64, 64),
             (2, 128, 512, 512), (2, 256, 256, 256))


def _gn_inputs(g, shape, dtype, scale=2.0, offset=0.5):
    x = (torch.randn(shape, generator=g, device="cuda") * scale + offset).to(dtype)
    w = torch.randn(shape[1], generator=g, device="cuda").to(dtype)
    b = torch.randn(shape[1], generator=g, device="cuda").to(dtype)
    return x.contiguous(memory_format=torch.channels_last), w, b


def _gn_float64(x, w, b, eps):
    """The two-pass GroupNorm + SiLU in float64."""
    shape = (1, x.shape[1], 1, 1)
    xd = x.double().reshape(x.shape[0], 32, -1)
    d = xd - xd.mean(dim=2, keepdim=True)
    y = (d * torch.rsqrt((d * d).mean(dim=2, keepdim=True) + eps)).reshape(x.shape)
    y = y * w.double().reshape(shape) + b.double().reshape(shape)
    return y * torch.sigmoid(y)


def _groupnorm_cases(g, rows, failures):
    """Kernel 2 on channels-last inputs at every shape of ``GN_SHAPES``,
    bf16 and float32, eps 1e-5 and 1e-6, against its plain version; two
    launches bit-identical; the cancellation case; the refusals; and the
    gradient of its autograd wrapper (forward the kernel, backward plain
    tensor code) against autograd of the plain version in float32 on the
    same input values."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        for shape in GN_SHAPES:
            bsz, c, h, w_ = shape
            tile = gn.plan(bsz, h * w_, c, 32, dtype.itemsize, sms)
            for eps in (1e-5, 1e-6):
                x, w, b = _gn_inputs(g, shape, dtype)
                call = dict(groups=32, eps=eps, act="silu")
                got = gn.group_norm_cuda(x, w, b, **call)
                again = gn.group_norm_cuda(x, w, b, **call)
                want = gn.group_norm_reference(x, w, b, **call)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = (F32_TOL if dtype == torch.float32
                       else 2.0 ** -7 * want.float().abs().max().item())
                same = torch.equal(got, again)
                layout = got.is_contiguous(memory_format=torch.channels_last)
                # two passes for the statistics, normalise, affine, SiLU: ~12
                # operations an element; x read once, y written once
                nbytes = x.element_size() * (2 * x.numel() + 2 * c)
                bound_ms, by = bound(nbytes, (12 * x.numel(), torch.float32))
                extra = {}
                if tile.regime == "streamed":  # x read twice: the kernel's own traffic
                    extra["traffic_bound_ms"] = (nbytes + x.element_size() * x.numel()) \
                        / HBM_BYTES_S * 1e3
                # device time, CUDA-graph replays: launched from Python one at a
                # time, a call of ~10-60 us takes the host's pace (eager_ms)
                kernel = lambda: gn.group_norm_cuda(x, w, b, **call)  # noqa: E731
                ms, eager_ms = cuda_graph_ms(kernel), cuda_ms(kernel)
                name = "groupnorm" if tile.regime == "resident" else "groupnorm_streamed"
                _row(rows, failures, name,
                     f"groupnorm+silu {list(shape)} {str(dtype)[6:]} eps={eps:g} {tile.regime} "
                     f"cb={tile.cb} x {tile.pixels} px, cluster {tile.cluster}, share of the "
                     f"bound {bound_ms / ms:.1%}, eager {eager_ms:.4f} ms; "
                     f"bit-identical twice {same}, y channels-last {layout}",
                     err <= tol and same and layout and bool(torch.isfinite(got).all()),
                     max_abs_err=err, tol=tol, ms=ms, eager_ms=eager_ms,
                     plain_ms=cuda_graph_ms(lambda: gn.group_norm_reference(x, w, b, **call)),
                     library_ms=cuda_graph_ms(lambda: F.silu(F.group_norm(x, 32, w, b, eps))),
                     bound_ms=bound_ms, bound_by=by, regime=tile.regime, cluster=tile.cluster,
                     cb=tile.cb, shape=list(shape), **extra)
                del x, got, again, want
    # cancellation: x = 1e3 + N(0, 1) in float32, against the float64
    # function.  A float32 mean near 1e3 can be no closer to the exact one
    # than half an ulp of 1e3 (2^-14 is one), and an error e of the mean
    # moves y by e * rstd * |w|: the tolerance is F32_TOL plus one such ulp.
    # A one-pass variance E[x^2] - E[x]^2 cannot pass: one ulp of E[x^2] ~ 1e6
    # is 0.0625, 6% of the variance.
    for shape in ((8, 320, 64, 64), (2, 128, 512, 512)):
        x, w, b = _gn_inputs(g, shape, torch.float32, scale=1.0, offset=1e3)
        got = gn.group_norm_cuda(x, w, b, groups=32, eps=1e-6, act="silu")
        want = _gn_float64(x, w, b, 1e-6)
        plain = gn.group_norm_reference(x, w, b, groups=32, eps=1e-6, act="silu")
        xd = x.double().reshape(shape[0], 32, -1)
        rstd = torch.rsqrt(xd.var(dim=2, unbiased=False) + 1e-6).max().item()
        tol = F32_TOL + 2.0 ** -14 * rstd * w.abs().max().item()
        err = (got.double() - want).abs().max().item()
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"groupnorm+silu {list(shape)} float32 at 1e3 + N(0, 1): max_abs_err against the "
              f"float64 function {err:.3e} (tol {tol:.3e}; the plain float32 version's "
              f"{(plain.double() - want).abs().max().item():.3e}) {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"groupnorm cancellation {shape}")
        del x, got, want, plain, xd
    x, w, b = _gn_inputs(g, (2, 64, 8, 8), torch.float32)
    flat = torch.empty(x.numel() + 1, device="cuda")
    refusals = {
        "NCHW-contiguous x": lambda: gn.group_norm_cuda(x.contiguous(), w, b, groups=32),
        "float16": lambda: gn.group_norm_cuda(x.half(), w.half(), b.half(), groups=32),
        "C % G != 0": lambda: gn.group_norm_cuda(x, w, b, groups=48),
        "misaligned view": lambda: gn.group_norm_cuda(
            flat[1:].view(2, 8, 8, 64).permute(0, 3, 1, 2), w, b, groups=32)}
    took = []
    for what, fn in refusals.items():
        try:
            fn()
        except ValueError:
            continue
        took.append(what)
    print(f"groupnorm refusals ({', '.join(refusals)}): "
          f"{'OK' if not took else 'FAIL: took ' + ', '.join(took)}")
    failures += [f"group_norm_cuda took a {what}" for what in took]
    for shape in ((1, 320, 64, 64), (1, 1280, 8, 8)):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = _gn_inputs(g, shape, dtype)
            dy = torch.randn(shape, generator=g, device="cuda").to(dtype).contiguous(
                memory_format=torch.channels_last)
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
            layout = dx.is_contiguous(memory_format=torch.channels_last)
            ok = (err <= tol and bool(torch.isfinite(dx).all()) and gn.launches == before + 1
                  and layout)
            print(f"groupnorm+silu gradient {list(shape)} {str(dtype)[6:]}: dx max_abs_err "
                  f"{err:.3e} (tol {tol:.3g}), dx channels-last {layout} "
                  f"{'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"groupnorm gradient {shape} {dtype}")


def phase_kernels():
    """Each kernel against its plain version; returns (report rows, failures,
    {path: counts}).  The first row of each kernel is at a shape of the main
    paths and is the one the kernels line reports.  The one path it drives is
    ``backward_f32_512``: the backward of the float32 [1, 1, 4096, 512] case
    through ``flash_attention_backward_cuda``, on the float32 d = 512
    kernels (the counts at 0 before, read after)."""
    g = torch.Generator(device="cuda").manual_seed(1234)
    rows, failures, counts = [], [], {}
    _flash_forward_cases(g, rows, failures)
    _flash_packed_cases(g, rows, failures)
    _flash_gradient_cases(g, rows, failures, counts)
    _groupnorm_cases(g, rows, failures)
    return rows, failures, counts


# The probes' shapes (scripts/flash_nhd_variants.py: B=16, S=4096, H=8,
# D=40; scripts/flash_v4_variants.py: [4, 32, 4096, 40]), bf16, and one
# float32 case each at a smaller batch (row 10 also at d = 80, where its
# float32 kernel takes 32-key tiles).
NHD_SHAPES = (((16, 8, 4096, 40), torch.bfloat16), ((2, 8, 4096, 40), torch.float32))
V4_SHAPES = (((4, 32, 4096, 40), torch.bfloat16), ((1, 8, 4096, 40), torch.float32),
             ((1, 8, 1024, 80), torch.float32))


def _sminor(t):
    return t.transpose(-1, -2).contiguous()


# the bounded probes' layouts and their operands from [B, H, S, D] tensors
PROBE_LAYOUTS = {"packed_t": lambda q, k, v: (q, k, v),
                 "packed_t_sminor": lambda q, k, v: (_sminor(q), _sminor(k), v),
                 "packed_t_all_sminor": lambda q, k, v: (_sminor(q), _sminor(k), _sminor(v))}


def _probe_plain(plain, args, dtype):
    """The plain version ``plain`` a probe kernel (rows 8 ``exp`` /
    ``noprolog``, 9 d, 10, 11) is held to: in bf16 (the tensor-core
    kernels) before the final rounding, as rows 1, 3, 6 and 7; the CUDA-core
    kernels' float32 outputs in their dtype."""
    if dtype == torch.bfloat16:
        return lambda: plain(*args, out_dtype=torch.float32)
    return lambda: plain(*args)


def _probe_name(name, dtype):
    """The kernels line's name of a probe kernel: the float32 instances on
    the CUDA cores (rows 8, 10 and 11 on the query-major kernel, float32 9
    d) are ``..._core``."""
    return f"{name}{'_core' if dtype == torch.float32 else ''}"


def _probe_kernel_cases(g, rows, failures):
    """TPU kernels 11 (three layouts) and 10 (both loops) against their plain
    versions at the probes' shapes: bf16 within one output ulp (on the
    tensor cores, before the final rounding), float32 within 1e-4 (on the
    query-major kernel, relaunched bit for bit; kernel 10's plain version at
    the kernel's key tile, ``fp.exp2_key_tile``); the two loops of kernel 10
    bit for bit; the library call is SDPA on the same [B, H, S,
    D] values, the bound 4 B H S^2 D operations over the bf16 (or float32)
    peak.  Then kernel 11 on the saturating input (anchor 512, key 600
    beyond it), float32 relaunched bit for bit too."""
    def hold(name, label, got, want, dtype, ms, plain_ms, library_ms, shape, **extra):
        want = want.float()
        err = (got.float() - want).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else BF16_ULP * want.abs().max().item()
        b, h, sq, d = shape
        bound_ms, by = bound(4 * b * h * sq * d * got.element_size(),
                             (4 * b * h * sq * sq * d, dtype))
        if "relaunch_bit_identical" in extra:
            print(f"{label}: relaunch bit-identical {extra['relaunch_bit_identical']}")
        _row(rows, failures, name, label,
             err <= tol and extra.get("relaunch_bit_identical", True)
             and bool(torch.isfinite(got).all()),
             max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=bound_ms, bound_by=by, shape=list(shape), **extra)

    for shape, dtype in NHD_SHAPES:
        q, k, v = _qkv(g, shape, shape[2], dtype)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        for layout, make in PROBE_LAYOUTS.items():
            args = make(q, k, v)
            wrapper = getattr(fp, f"flash_{layout}_cuda")
            plain = _probe_plain(getattr(fp, f"flash_{layout}_reference"), args, dtype)
            got = wrapper(*args)
            want = plain()
            torch.cuda.synchronize()
            extra = {}
            if dtype == torch.float32:  # the query-major kernel
                extra["relaunch_bit_identical"] = _relaunch_same(lambda: (wrapper(*args),), (got,))
            hold(_probe_name(f"flash_{layout}", dtype),
                 f"flash {layout} q{list(shape)} {str(dtype)[6:]}",
                 got, want, dtype, cuda_ms(lambda: wrapper(*args)), cuda_ms(plain), lib, shape,
                 **extra)
            del got, want
            torch.cuda.empty_cache()
        del q, k, v, args

    for shape, dtype in V4_SHAPES:
        q, k, v = _qkv(g, shape, shape[2], dtype)
        got, got_pipe = (fp.flash_exp2_t_cuda(q, k, v, pipe) for pipe in (False, True))
        blk_k = fp.exp2_key_tile(dtype, shape[3])
        plain = functools.partial(fp.flash_exp2_t_reference, blk_k=blk_k)
        want = _probe_plain(plain, (q, k, v), dtype)()
        torch.cuda.synchronize()
        pipe_err = (got_pipe.float() - want.float()).abs().max().item()
        same = bool(torch.equal(got, got_pipe))
        extra = {}
        if dtype == torch.float32:  # the query-major kernel
            extra["relaunch_bit_identical"] = _relaunch_same(
                lambda: (fp.flash_exp2_t_cuda(q, k, v, False),
                         fp.flash_exp2_t_cuda(q, k, v, True)), (got, got_pipe))
        # the TPU wrapper's 512-key blocks round p against other points
        blk512 = (got.float() - fp.flash_exp2_t_reference(q, k, v, blk_k=fp.BLK_K).float()
                  ).abs().max().item()
        print(f"flash exp2_t q{list(shape)} {str(dtype)[6:]}: pipe=True max_abs_err "
              f"{pipe_err:.3e}, identical to pipe=False: {same}; against the plain version "
              f"with 512-key blocks {blk512:.3e} (the kernel's: {blk_k})")
        hold(_probe_name("flash_exp2_t", dtype),
             f"flash exp2_t q{list(shape)} {str(dtype)[6:]} pipe=False", got,
             want, dtype, cuda_ms(lambda: fp.flash_exp2_t_cuda(q, k, v, False)),
             cuda_ms(lambda: plain(q, k, v)),
             cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)), shape,
             pipe_ms=cuda_ms(lambda: fp.flash_exp2_t_cuda(q, k, v, True)),
             pipe_max_abs_err=pipe_err, key_tile=blk_k, **extra)
        print(f"  pipe=True {rows[-1]['pipe_ms']:.3f} ms against pipe=False "
              f"{rows[-1]['ms']:.3f} ms")
        if not same:
            failures.append(f"flash exp2_t {shape} {dtype}: the two loops differ")
        del q, k, v, got, got_pipe, want
        torch.cuda.empty_cache()

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _saturating_qkv(g, dtype)
        exact = fp._packed_t(flash.reference_attention(q.float(), k.float(), v.float()))
        for layout, make in PROBE_LAYOUTS.items():
            args = make(q, k, v)
            wrapper = getattr(fp, f"flash_{layout}_cuda")
            raw = wrapper(*args)
            got = raw.float()
            want = _probe_plain(getattr(fp, f"flash_{layout}_reference"), args, dtype)().float()
            torch.cuda.synchronize()
            tol = F32_TOL if dtype == torch.float32 else BF16_ULP * want.abs().max().item()
            err, gap = (got - want).abs().max().item(), (got - exact).abs().max().item()
            same = dtype != torch.float32 or _relaunch_same(lambda: (wrapper(*args),), (raw,))
            ok = err <= tol and gap > 20 * tol and same
            print(f"flash {layout} saturating q[1, 8, 4096, 40] {str(dtype)[6:]}: max_abs_err "
                  f"{err:.3e} (tol {tol:.3g}), max|probe - exact| {gap:.3e} (must exceed "
                  f"{20 * tol:.3g}), relaunch bit-identical {same} {'OK' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash {layout} saturating case {dtype}")


# The cost probes' shapes (scripts/flash_ablate.py: [4, 32, 4096, 40];
# scripts/flash_variants.py: [4 * 8, 4096, 40]), bf16, and one float32 case
# each at a smaller batch; mm_probe.py's nine cases (hedit_tpu_torch/probes/
# mm_probe.py:CASES) and a ragged one in each layout, in bf16 and float32.
ABLATE_SHAPES = (((4, 32, 4096, 40), torch.bfloat16), ((1, 8, 4096, 40), torch.float32))
VARIANT_SHAPES = (((32, 4096, 40), torch.bfloat16), ((8, 4096, 40), torch.float32))
# the largest share of rows the dots ablation's check may excuse
EXCUSED_SHARE = 1e-3
# TPU kernel 12's ragged case (M, N, K) in each layout and dtype: no
# contiguous dim a multiple of 8 (the tensor-core kernel's element loads), N
# not one of 4 (the CUDA-core kernel's element loads of B and stores), K
# split in three with a ragged last split (in float32 the reps in 64 ranges
# too)
MM_RAGGED = (100, 70, 37)


def _ablate_cases(g, rows, failures):
    """TPU kernel 8, each mode, against its plain version, inputs drawn as
    the probe draws them (q, k * 0.05); bf16 on the tensor cores, float32 on
    the template.  exp, noprolog: bf16 within one output ulp before the
    final rounding, float32 within 1e-4.  Float32 runs on the query-major
    kernel, and each mode's relaunch gives the same bits.  dots: the sum of p is as often
    negative as positive (then the floor makes the output acc * 1e30).  In
    bf16 it is held on the kernel's own numbers
    (``fp.check_ablate_dots_kernel``, every image in passes of 8): (i) the
    output bit for bit the check instance's, which also stores its float32
    scores and row sums; (ii) every score within the tensor cores' bound
    (``ablate_dots_score_tolerance``, three k16 steps at d = 40) of the
    exact q . k; (iii) every row sum the kernel's order of its own rounded
    scores, bit for bit; (iv) every output within one ulp, a float32
    rounding and the numerator's summation bound over the kernel's sum of
    the exact numerator over that sum.  No row is excused (the share is
    printed and held to ``EXCUSED_SHARE``).  In float32 each
    element is held within ``ablate_dots_tolerance``, and the rows whose sum
    lies within its reach of zero are excused and counted: at most 0.1%.
    Library call: SDPA with scale = ln 2 (softmax(s ln 2) = exp2(s) / sum:
    the exp function up to p's rounding and the layout); none computes dots."""
    for shape, dtype in ABLATE_SHAPES:
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=g, device="cuda") * c for c in (0.05, 0.05, 1.0))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=math.log(2.0)))
        bound_ms, by = bound(4 * b * h * s * d * q.element_size(), (4 * b * h * s * s * d, dtype))
        for mode in fp.ABLATE_MODES:
            got = fp.flash_ablate_t_cuda(q, k, v, mode)
            label = f"flash ablate {mode} q{list(shape)} {str(dtype)[6:]}"
            extra = {}
            if mode == "dots" and dtype == torch.bfloat16:
                worst = fp.check_ablate_dots_kernel(q, k, v, got)
                torch.cuda.synchronize()
                share = worst["excused_rows"] / worst["row_count"]
                ok = (worst["bit_identical"] and worst["sums_differing_rows"] == 0
                      and worst["score_err_over_tol"] <= 1.0 and worst["out_err_over_tol"] <= 1.0
                      and share <= EXCUSED_SHARE)
                max_err, tol_at = worst["err_at_worst"], worst["tol_at_worst"]
                extra = {"check_bit_identical": worst["bit_identical"],
                         "score_err_over_tol": worst["score_err_over_tol"],
                         "sums_differing_rows": worst["sums_differing_rows"],
                         "max_err_over_tol": worst["out_err_over_tol"],
                         "excused_rows": worst["excused_rows"], "row_count": worst["row_count"],
                         "negative_sum_rows": worst["floored_rows"]}
                print(f"{label}, on its own scores and sums: output "
                      f"{'bit-identical to' if worst['bit_identical'] else 'DIFFERS from'} the "
                      f"check instance's; scores err / tol {worst['score_err_over_tol']:.3f}; "
                      f"{worst['sums_differing_rows']} row sums off the kernel's order; output "
                      f"err / tol {worst['out_err_over_tol']:.3f}; {worst['excused_rows']} of "
                      f"{worst['row_count']} rows excused ({100 * share:.4f}%, at most "
                      f"{100 * EXCUSED_SHARE}%), {worst['floored_rows']} rows floored (sum of p "
                      f"<= 1e-30); no library call computes dots")
            elif mode == "dots":
                want = fp.flash_ablate_t_reference(q, k, v, mode)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                tol, excused = fp.ablate_dots_tolerance(q, k, v, want)
                ratio = torch.where(excused[:, None, :], torch.zeros_like(err), err / tol)
                worst = int(ratio.argmax())
                share = excused.float().mean().item()
                ok = ratio.max().item() <= 1.0 and share <= EXCUSED_SHARE
                max_err, tol_at = err.flatten()[worst].item(), tol.flatten()[worst].item()
                extra = {"max_err_over_tol": ratio.max().item(), "excused_rows": int(excused.sum()),
                         "row_count": excused.numel(), "negative_sum_rows": int((
                             got.float().abs().amax(dim=1) > 1e20).sum())}
                print(f"{label}: {extra['excused_rows']} of {extra['row_count']} rows excused "
                      f"({100 * share:.4f}%, at most {100 * EXCUSED_SHARE}%), "
                      f"{extra['negative_sum_rows']} rows floored (sum of p <= 0); largest "
                      f"err / tol {extra['max_err_over_tol']:.3f}; no library call computes dots")
                del tol, excused, ratio, want, err
            else:
                want = _probe_plain(fp.flash_ablate_t_reference, (q, k, v, mode), dtype)()
                torch.cuda.synchronize()
                max_err = (got.float() - want.float()).abs().max().item()
                tol_at = (F32_TOL if dtype == torch.float32
                          else BF16_ULP * want.float().abs().max().item())
                ok = max_err <= tol_at
            if dtype == torch.float32:  # the query-major kernel
                extra["relaunch_bit_identical"] = _relaunch_same(
                    lambda: (fp.flash_ablate_t_cuda(q, k, v, mode),), (got,))
                print(f"{label}: relaunch bit-identical {extra['relaunch_bit_identical']}")
                ok &= extra["relaunch_bit_identical"]
            _row(rows, failures, _probe_name(f"flash_ablate_{mode}", dtype), label,
                 ok and bool(torch.isfinite(got).all()), max_abs_err=max_err, tol=tol_at,
                 ms=cuda_ms(lambda: fp.flash_ablate_t_cuda(q, k, v, mode)),
                 plain_ms=cuda_ms(lambda: fp.flash_ablate_t_reference(q, k, v, mode), reps=3),
                 library_ms=None if mode == "dots" else lib, bound_ms=bound_ms, bound_by=by,
                 shape=list(shape), **extra)
            del got
            torch.cuda.empty_cache()
        del q, k, v


def _variant_cases(g, rows, failures):
    """TPU kernel 9's layouts a, b, c and a with pv_bf16 (d) against their
    plain versions (d with the kernels' 64-key blocks of the running max):
    bf16 within one output ulp (d on the tensor cores, before the final
    rounding), float32 within 1e-4.  a and b run on the query-major kernel
    in both dtypes, c on its own (``flash_variant_{a,b,c}`` in bf16, their
    scores' product on the tensor cores; ``..._f32``), float32 d on the
    query-major kernel, bf16 d on the tensor cores (``_probe_name`` names
    it).  The kernels of ``csrc/flash_variants.cu`` (a, b, c, float32 d)
    are relaunched and must give the same bits, and b's output must be a's
    transposed, bit for bit (one arithmetic, two stores).  The TPU kernels
    upcast q, k, v before both products, but the scale can follow the QK
    product: with bf16 inputs it is a product of bf16 values, bound at the
    bf16 rate for a, b, c and d alike; PV takes float32 p in a, b and c (the
    float32 rate), bf16 p and v in d (the bf16 rate).  Float32 inputs: both
    at the float32 rate.  Library call: SDPA on the float32-upcast inputs (a, b, c), SDPA
    in the inputs' dtype (d)."""
    for shape, dtype in VARIANT_SHAPES:
        bh, s, d = shape
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3))
        # as [1, B*H, S, D]: SDPA's fused backends take 4-D inputs only
        q32, k32, v32 = (t.float()[None] for t in (q, k, v))
        lib32 = cuda_ms(lambda: F.scaled_dot_product_attention(q32, k32, v32))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]))
        del q32, k32, v32
        nbytes = 4 * bh * s * d * q.element_size()
        product = 2 * bh * s * s * d
        outs = {}
        for name in ("a", "b", "c", "d"):
            if name in "ad":
                kernel = functools.partial(fp.flash_variant_a_cuda, pv_bf16=name == "d")
                plain = functools.partial(fp.flash_variant_a_reference, pv_bf16=name == "d")
            else:
                kernel = getattr(fp, f"flash_variant_{name}_cuda")
                plain = getattr(fp, f"flash_variant_{name}_reference")
            got = outs[name] = kernel(q, k, v)
            want = (_probe_plain(plain, (q, k, v), dtype) if name == "d"
                    else lambda: plain(q, k, v))()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = F32_TOL if dtype == torch.float32 else BF16_ULP * want.float().abs().max().item()
            pv_type = dtype if name == "d" else torch.float32
            bound_ms, by = bound(nbytes, (product, dtype), (product, pv_type))
            kname = (_probe_name("flash_variant_d", dtype) if name == "d" else
                     f"flash_variant_{name}{'_f32' if dtype == torch.float32 else ''}")
            extra, same = {}, True
            if name != "d" or dtype == torch.float32:  # csrc/flash_variants.cu
                same = _relaunch_same(lambda: (kernel(q, k, v),), (got,))
                extra["relaunch_bit_identical"] = same
            if name == "b":
                extra["transpose_of_a_bit_identical"] = torch.equal(got,
                                                                    outs["a"].transpose(-1, -2))
                same &= extra["transpose_of_a_bit_identical"]
            label = f"flash variant {name} q{list(shape)} {str(dtype)[6:]}"
            if extra:
                print(f"{label}: {extra}")
            _row(rows, failures, kname, label,
                 err <= tol and same and bool(torch.isfinite(got).all()), max_abs_err=err,
                 tol=tol, ms=cuda_ms(lambda: kernel(q, k, v)),
                 plain_ms=cuda_ms(lambda: plain(q, k, v)),
                 library_ms=lib if name == "d" else lib32, bound_ms=bound_ms, bound_by=by,
                 shape=list(shape), **extra)
            del got, want
        del q, k, v, outs
        torch.cuda.empty_cache()


def _mm_loop_cases(g, rows, failures):
    """TPU kernel 12 in mm_probe.py's nine cases and ``MM_RAGGED`` in each
    layout, in bf16 on the tensor cores and in float32 on the CUDA cores
    (``..._core``): on the probe's all-ones input every output is exactly
    K * 2080, held bit for bit; on seeded input within 4 sqrt(64 K) 2^-24
    times the sum of the magnitudes of each output's terms (float32
    reordering; bf16 products are exact), and launched twice,
    bit-identical.  Each row prints its plan (bf16: K splits; float32:
    ``core_plan``'s tile and slices).  Timed on the ones, the kernel and the
    library call by CUDA-graph replays (a 10-100 us call launched from
    Python takes the host's pace).  Library call: one ``torch.mm`` of
    ``mm_library_operands`` (the nudged A's side by side along K, B stacked
    64 times, made outside the timing) into float32 (``library_mm``); for
    information only, ``matmuls_ms`` times 64 torch.matmul calls of the
    pre-nudged A by B in the case's dtype (bf16 products, each rounded to
    bf16) added into a float32 sum."""
    from hedit_tpu_torch.probes.mm_probe import library_mm, seeded_cases

    for name, a_shape, b_shape, layout, kk in seeded_cases(MM_RAGGED):
        for dtype in (torch.bfloat16, torch.float32):
            tc = dtype == torch.bfloat16
            a1 = torch.ones(a_shape, dtype=dtype, device="cuda")
            b1 = torch.ones(b_shape, dtype=dtype, device="cuda")
            ones = mp.mm_loop_cuda(a1, b1, layout)
            a = torch.randn(a_shape, generator=g, device="cuda").to(dtype)
            b = torch.randn(b_shape, generator=g, device="cuda").to(dtype)
            got, again = mp.mm_loop_cuda(a, b, layout), mp.mm_loop_cuda(a, b, layout)
            want = mp.mm_loop_reference(a, b, layout)
            tol = 4 * math.sqrt(mp.REPS * kk) * 2.0 ** -24 * mp.mm_loop_magnitude(a, b, layout)
            torch.cuda.synchronize()
            exact = bool((ones == kk * mp.REPS * (mp.REPS + 1) // 2).all())
            same = torch.equal(got, again)
            ratio = ((got - want).abs() / tol).max().item()
            am, bk = mp._canonical(a1, b1, layout)
            a_nudged = [mp.nudged(am, i).to(dtype) for i in range(mp.REPS)]
            a_cat, b_rep = mp.mm_library_operands(a1, b1, layout)
            mo, no = ones.shape

            def matmuls():
                acc = torch.zeros(mo, no, device="cuda")
                for a_i in a_nudged:
                    acc += torch.matmul(a_i, bk)
                return acc
            bound_ms, by = bound(a1.numel() * a1.element_size() + b1.numel() * b1.element_size()
                                 + 4 * mo * no, (2 * mp.REPS * mo * no * kk, dtype))
            if tc:
                chunk, splits = mp.split_k_plan(mo, no, kk)
                plan = {"splits": splits, "chunk": chunk}
                where = f"tensor cores, {splits} splits"
            else:
                core = mp.core_plan(mo, no, kk)
                plan = {"splits": core.slices, "tile": list(core.tile), "chunk": core.chunk,
                        "rsplits": core.rsplits}
                where = (f"CUDA cores, tile {core.tile[0]}x{core.tile[1]}, {core.slices} slices: "
                         f"{core.ksplits} K chunks of {core.chunk} x {core.rsplits} rep ranges")
            label = f"mm_loop {name} ({layout}, K={kk}) {str(dtype)[6:]} ({where})"
            print(f"{label}: all-ones output exactly K * 2080: {exact}; seeded input "
                  f"largest err / tol {ratio:.3e}; relaunch bit-identical {same}")
            _row(rows, failures, f"mm_loop_{layout}{'' if tc else '_core'}", label,
                 exact and same and ratio <= 1.0,
                 max_abs_err=(got - want).abs().max().item(), tol=tol.max().item(),
                 ms=cuda_graph_ms(lambda: mp.mm_loop_cuda(a1, b1, layout)),
                 plain_ms=cuda_ms(lambda: mp.mm_loop_reference(a1, b1, layout), reps=3),
                 library_ms=cuda_graph_ms(lambda: library_mm(a_cat, b_rep)),
                 matmuls_ms=cuda_ms(matmuls), bound_ms=bound_ms, bound_by=by,
                 shape=[name, list(a_shape), list(b_shape)], ones_exact=exact,
                 relaunch_bit_identical=same, **plan)
            print(f"  64 torch.matmul calls added into a float32 sum (information only): "
                  f"{rows[-1]['matmuls_ms']:.3f} ms")
            del a_nudged, a_cat, b_rep
        torch.cuda.empty_cache()


def phase_probes(rows):
    """Kernels 10, 11, 8, 9 and 12 against their plain versions, then their
    own path: the five probe entry points (``hedit_tpu_torch.probes``), each
    driven once with the counts at 0 before and read after, and the four
    flash ones once more in float32 (``..._f32``: the CUDA-core instances
    of rows 8, 10 and 11, which bf16 no longer reaches (8 and 11 on the
    query-major kernel, 10 on the template), and the float32 instances of
    rows 9 a-d).  Returns ({probe: counts}, failures)."""
    from hedit_tpu_torch.probes import (
        flash_ablate, flash_nhd_variants, flash_v4_variants, flash_variants, mm_probe,
    )

    failures = []
    g = torch.Generator(device="cuda").manual_seed(31)
    _probe_kernel_cases(g, rows, failures)
    torch.cuda.empty_cache()
    _ablate_cases(g, rows, failures)
    _variant_cases(g, rows, failures)
    _mm_loop_cases(g, rows, failures)
    torch.cuda.empty_cache()
    counts, results_of = {}, {}
    for name, run in (("flash_nhd_variants", flash_nhd_variants.run),
                      ("flash_nhd_variants_f32",
                       lambda: flash_nhd_variants.run(reps=2, dtype=torch.float32)),
                      ("flash_v4_variants", flash_v4_variants.run),
                      ("flash_v4_variants_f32",
                       lambda: flash_v4_variants.run(reps=2, dtype=torch.float32)),
                      ("flash_ablate", flash_ablate.run),
                      ("flash_ablate_f32", lambda: flash_ablate.run(reps=2, dtype=torch.float32)),
                      ("flash_variants", flash_variants.run),
                      ("flash_variants_f32",
                       lambda: flash_variants.run(reps=2, dtype=torch.float32)),
                      ("mm_probe", mm_probe.run),
                      ("mm_probe_f32", lambda: mm_probe.run(reps=2, dtype=torch.float32))):
        reset_launches()
        t0 = time.perf_counter()
        results = results_of[name] = run()
        torch.cuda.synchronize()
        counts[name] = read_launches()
        print(f"probe {name} ({time.perf_counter() - t0:.1f} s): {json.dumps(results)}")
        print(f"probe {name} launches: {json.dumps(counts[name])}")
    # rows 8, 10 and 11: bf16 chains and loops on the tensor cores, float32
    # ones on the query-major kernel of the CUDA cores, never the other;
    # dots' check instance on neither path; row 9: bf16 d on the tensor
    # cores, a, b, c and float32 d on the
    # kernels of csrc/flash_variants.cu, the bf16 instances on the bf16 path
    # and the float32 ones on the float32 path; row 6, the v4 probe's base,
    # on the tensor cores or the float32 kernel, never the template
    tc = tuple(f"flash_{lay}" for lay in fp._LAYOUTS)
    core = tuple(f"{n}_core" for n in tc)
    ablate_tc = tuple(f"flash_ablate_{m}" for m in fp.ABLATE_MODES)
    ablate_core = tuple(f"{n}_core" for n in ablate_tc)
    variants = ("flash_variant_a", "flash_variant_b", "flash_variant_c")
    variants_f32 = tuple(f"{n}_f32" for n in variants)
    # row 12: bf16 on the tensor cores, float32 on the CUDA-core kernel
    mm_tc = tuple(f"mm_loop_{lay}" for lay in mp.LAYOUTS)
    mm_core = tuple(f"{n}_core" for n in mm_tc)
    for name, launched, idle in (
            ("flash_nhd_variants", tc + ("flash_packed_bounded",), core),
            ("flash_nhd_variants_f32",
             core + ("flash_packed_bounded" + _route(flash.bounded_entry(torch.float32, True,
                                                                         40))[0],), tc),
            ("flash_v4_variants", ("flash_exp2_t", "flash_attention_exact"),
             ("flash_exp2_t_core",)),
            ("flash_v4_variants_f32",
             ("flash_exp2_t_core",
              "flash_attention_exact" + _route(flash.exact_entry(torch.float32, False, 40))[0]),
             ("flash_exp2_t", "flash_attention_exact_core")),
            ("flash_ablate", ablate_tc, ablate_core + ("flash_ablate_dots_check",)),
            ("flash_ablate_f32", ablate_core, ablate_tc + ("flash_ablate_dots_check",)),
            ("flash_variants", variants + ("flash_variant_d",),
             variants_f32 + ("flash_variant_d_core",)),
            ("flash_variants_f32", variants_f32 + ("flash_variant_d_core",),
             variants + ("flash_variant_d",)),
            ("mm_probe", mm_tc, mm_core), ("mm_probe_f32", mm_core, mm_tc)):
        seen = counts[name]
        if min(seen[n] for n in launched) <= 0 or any(seen[n] for n in idle):
            failures.append(f"{name} launched {({n: seen[n] for n in launched + idle})}: "
                            f"expected each of {launched} and none of {idle}")
    for name in ("mm_probe", "mm_probe_f32"):
        if not all(r["exact"] for r in results_of[name].values()):
            failures.append(f"{name}: an all-ones output is not K * 2080: {results_of[name]}")
    for name in ("flash_ablate", "flash_ablate_f32"):
        if not all(results_of[name][m]["finite"] for m in fp.ABLATE_MODES):
            failures.append(f"{name}: an output is not finite: {results_of[name]}")
    torch.cuda.empty_cache()
    return counts, failures


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
    hook_groupnorm(pipe.unet, pipe.vae)
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
    check_forward_routing(counts, "flagship", failures, packed=2 * 10 * STEPS)
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
    # the gradient call's 10 self-attentions a step: the LSE forward on the
    # tensor cores for each; the tensor-core backward for the 5 of 4096
    # tokens, autograd of reference_attention for the 5 of 1024 (JAX's
    # _BWD_MIN_SEQ); never a CUDA-core template
    nmg_routed = {"flash_attention_lse": 10 * STEPS, "flash_attention_lse_core": 0,
                  "flash_attention_lse_f32": 0, "flash_attention_lse_f32_512": 0,
                  "flash_bwd_dq": 5 * STEPS, "flash_bwd_dkv": 5 * STEPS, "flash_bwd_f32": 0,
                  "flash_bwd_f32_512": 0}
    print(f"NMG path gradient launches: {json.dumps({n: counts[n] for n in BWD_NAMES})} "
          f"(predicted {json.dumps(nmg_routed)})")
    if {n: counts[n] for n in BWD_NAMES} != nmg_routed:
        failures.append(f"the NMG path's gradient kernels were not launched as predicted "
                        f"({nmg_routed}): {counts}")
    # the inversion's 50 one-row calls and the controlled call of each step
    check_forward_routing(counts, "NMG", failures, packed=10 * (STEPS + STEPS))

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


def _one_image_path(name, pipe, images, ids, invert, edit, invert_label, packed,
                    ctx_rows=(0, 1, 3), gn_calls=None):
    """Drive one image through encode -> ``invert`` -> ``edit`` -> decode with
    the launch counts at 0 before and read after; ``ctx_rows`` pick [uncond,
    src, tar] of the image's token ids; ``packed``: the bounded packed
    kernel's expected launches, ``gn_calls`` the GroupNorm kernel's (default
    ``GN_CALLS[name]``), each a number or a function of nothing called after
    the run.  Returns (counts, failures)."""
    failures = []
    control, blend = (state.to("cuda") for state in _edit_control(STEPS, 8, 0))
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx3 = pipe.encode_token_ids(ids[0, list(ctx_rows)]).reshape(1, 3, MAX_LEN, -1)
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
    check_forward_routing(counts, name, failures, packed() if callable(packed) else packed,
                          gn_calls() if callable(gn_calls) else gn_calls)
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

    # 10 self-attentions of >= 1024 tokens a UNet call: the inversion's 50
    # one-row calls, then one base and two controlled calls a step
    return _one_image_path("h-Edit-D", pipe, images, ids, invert, edit,
                           f"{STEPS}-step DDIM inversion", packed=10 * (STEPS + 3 * STEPS))


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

    # the residual pass's 5 calls, then one indexed call a step
    return _one_image_path("EF", pipe, images, ids, invert, edit,
                           "DDPM inversion, 5 calls of 20 rows,", packed=10 * (5 + STEPS))


def phase_masactrl_path(pipe, images, ids):
    """h-Edit-R + MasaCtrl, as ``main_masactrl --mode h_edit_R_masactrl`` runs
    it at its defaults (eta 1, cfg_src 1, cfg_src_edit 5, cfg_tar 7.5, --step 4
    --layer 10): the empty source prompt, the DDPM inversion with its residual
    pass (5 calls of 10 rows), then 50 steps of one 1-row base call, one 1-row
    source call and one 4-row MasaCtrl call on the trajectory.  Every one of
    those calls runs the 10 self-attentions of >= 1024 tokens on the packed
    kernel, the remapped k / v of MasaCtrl's layers included."""
    cfg = HEditConfig(eta=1.0, cfg_src=1.0, cfg_src_edit=5.0, cfg_tar=7.5)

    def invert(pipe, x0, ctx3):
        return invert_ddpm(pipe.unet, pipe.schedule, x0, uncond_ctx=ctx3[:, 0],
                           src_ctx=ctx3[:, 1], cfg_scale_src=cfg.cfg_src, eta=cfg.eta,
                           generator=torch.Generator(device="cuda").manual_seed(0),
                           step_chunk=10)

    def edit(pipe, inv, ctx3, control, blend):
        return h_edit_masactrl(pipe.unet, pipe.schedule, inv.xts[:, STEPS], inv.zs, ctx3=ctx3,
                               cfg=cfg, after_skip_steps=STEPS, start_step=4, start_layer=10,
                               xts=inv.xts)

    # [uncond, src, tar]: MasaCtrl's source prompt is the empty one, uncond's
    want = 3 * 10 * STEPS + 5 * 10
    counts, failures = _one_image_path("MasaCtrl", pipe, images, ids, invert, edit,
                                       "DDPM inversion, 5 calls of 10 rows,", packed=want,
                                       ctx_rows=(0, 0, 3))
    print(f"MasaCtrl path: tensor-core packed-kernel launches {counts['flash_packed_bounded']} "
          f"(predicted {want}: 3 UNet calls a step x 10 + the residual pass's 5 calls x 10), "
          f"tensor-core head-split {counts['flash_attention']} (predicted 2)")
    return counts, failures


# main_plugnplay's defaults: the injection fractions and the h-Edit scales
PNP_F_T, PNP_ATTN_T = 0.45, 0.35
PNP_CFG = HEditConfig(eta=1.0, cfg_src=1.0, cfg_src_edit=5.0, cfg_tar=7.5)
# the edit with injection must differ from the edit without by more than this
# share of max|xts|
PNP_CONTRAST = 1e-2


def phase_pnp_path(pipe, images, ids):
    """h-Edit-R + PnP, as ``main_plugnplay --mode h_edit_R_pnp`` runs it at its
    defaults (eta 1, cfg_src 1, cfg_src_edit 5, cfg_tar 7.5, --pnp_f_t 0.45
    --pnp_attn_t 0.35): the source prompt row 1 of the image's ids, the
    target row 3, the DDPM inversion with its residual pass (5 calls of 10
    rows), then 50 steps of one 1-row base call, one uncontrolled 2-row call
    (cond_out_src and uncond_out_tar) and the 2-row PnP pair call on the
    trajectory.  Every one of those calls runs the 10 self-attentions of
    >= 1024 tokens on the packed kernel, the injected q / k included.  Then
    the same edit with every gate off: injection must move the edit by more
    than ``PNP_CONTRAST`` of max|xts|."""
    qk_mask, conv_mask = pnp_step_gates(STEPS, PNP_ATTN_T, PNP_F_T)
    runs = {}

    def invert(pipe, x0, ctx3):
        return invert_ddpm(pipe.unet, pipe.schedule, x0, uncond_ctx=ctx3[:, 0],
                           src_ctx=ctx3[:, 1], cfg_scale_src=PNP_CFG.cfg_src, eta=PNP_CFG.eta,
                           generator=torch.Generator(device="cuda").manual_seed(0),
                           step_chunk=10)

    def edit(pipe, inv, ctx3, control, blend, qk=qk_mask, conv=conv_mask):
        edited, recon = h_edit_pnp(pipe.unet, pipe.schedule, inv.xts[:, STEPS], inv.zs,
                                   ctx3=ctx3, cfg=PNP_CFG, after_skip_steps=STEPS, qk_mask=qk,
                                   conv_mask=conv, xts=inv.xts)
        runs.update(inv=inv, ctx3=ctx3, edited=edited)
        return edited, recon

    want = 3 * 10 * STEPS + 5 * 10
    counts, failures = _one_image_path("PnP", pipe, images, ids, invert, edit,
                                       "DDPM inversion, 5 calls of 10 rows,", packed=want)
    print(f"PnP path: tensor-core packed-kernel launches {counts['flash_packed_bounded']} "
          f"(predicted {want}: 3 UNet calls a step x 10 + the residual pass's 5 calls x 10), "
          f"tensor-core head-split {counts['flash_attention']} (predicted 2); gates on for "
          f"{sum(qk_mask)} (q / k) and {sum(conv_mask)} (conv) of {STEPS} steps")
    inv, edited = runs["inv"], runs["edited"]
    off, _ = edit(pipe, inv, runs["ctx3"], None, None, [False] * STEPS, [False] * STEPS)
    torch.cuda.synchronize()
    scale = inv.xts.abs().max().item()
    moved = (edited - off).abs().max().item() / scale
    ok = moved > PNP_CONTRAST and bool(torch.isfinite(off).all())
    print(f"PnP injection contrast: max|edited - edited without injection| / max|xts| "
          f"{moved:.3e} (must exceed {PNP_CONTRAST:g}; max|xts| {scale:.3e}) "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"PnP injection moved the edit by {moved:.3e} of max|xts|")
    return counts, failures


@contextlib.contextmanager
def adam_record():
    """Each call of ``pnp_baselines.null_text_adam`` while open: its
    iterations taken, one list an image, appended to the list yielded."""
    real, taken = pnp_baselines.null_text_adam, []

    def record(loss_grad, u0, **kw):
        u, losses = real(loss_grad, u0, **kw)
        taken.append(torch.isfinite(losses).sum(0).tolist())
        return u, losses

    with mock.patch.object(pnp_baselines, "null_text_adam", record):
        yield taken


def phase_nt_pnp_path(pipe, images, ids):
    """Null-text + PnP, as ``main_plugnplay --mode nt_pnp`` runs it at its
    defaults: the DDIM grid, the source prompt row 1 of the image's ids and
    the target row 3, a DDIM inversion at cfg_src 1 without its residual
    pass (the loop reads none), then 50 steps of one 1-row call
    cond_src = eps(x_orig, t, src), up to 10 Adam iterations on the uncond
    embedding (each a 1-row UNet forward and backward with respect to it,
    epsilon 1e-5, lr 1e-2) and the two 2-row pair calls at cfg_tar 7.5,
    gates 0.45 / 0.35.  Launches, with K the Adam iterations of the run (the
    routes of ``flash_route`` and ``bwd_takes_kernels``, JAX's on the TPU):
    the packed kernel 10 x (the inversion's 50 + 3 x 50 calls) + K, the
    first self-attention of each gradient call coming before any
    cross-attention, so without a gradient; the LSE forward 9 K (the other
    self-attentions of >= 1024 tokens), the tensor-core dq and dk / dv 4 K
    (those of 4096 tokens; the 5 of 1024 take autograd of
    ``reference_attention``, below ``_BWD_MIN_SEQ``); GroupNorm 61 x (200 +
    K) + 52; 2 head-split in the VAE; no float32, exact or probe kernel.
    Then the same edit with no Adam iteration: the source branch's
    reconstruction error max|x_orig - xts[0]| / max|xts| of both."""
    pipe = dataclasses.replace(pipe, schedule=Schedule.create(STEPS, steps_offset=0))
    qk_mask, conv_mask = pnp_step_gates(STEPS, PNP_ATTN_T, PNP_F_T)
    runs = {}

    def invert(pipe, x0, ctx3):
        return invert_ddim(pipe.unet, pipe.schedule, x0, uncond_ctx=ctx3[:, 0],
                           src_ctx=ctx3[:, 1], cfg_scale=1.0, skip_zs=True)

    def edit(pipe, inv, ctx3, control, blend, optimization_steps=10):
        edited, recon = pnp_baselines.null_text_pnp(
            pipe.unet, pipe.schedule, inv.xts[:, STEPS], xts=inv.xts, ctx3=ctx3, cfg_tar=7.5,
            after_skip_steps=STEPS, qk_mask=qk_mask, conv_mask=conv_mask,
            optimization_steps=optimization_steps)
        runs.update(inv=inv, ctx3=ctx3, recon=recon)
        return edited, recon

    with adam_record() as taken:
        counts, failures = _one_image_path(
            "nt_pnp", pipe, images, ids, invert, edit, f"{STEPS}-step DDIM inversion",
            packed=lambda: 10 * (STEPS + 3 * STEPS) + sum(map(sum, taken)),
            gn_calls=lambda: GN_CALLS["nt_pnp"](sum(map(sum, taken))))
    K = sum(map(sum, taken))
    per_step = [sum(n) for n in taken]
    routed = {"flash_attention_lse": 9 * K, "flash_attention_lse_core": 0,
              "flash_attention_lse_f32": 0, "flash_attention_lse_f32_512": 0,
              "flash_bwd_dq": 4 * K, "flash_bwd_dkv": 4 * K, "flash_bwd_f32": 0,
              "flash_bwd_f32_512": 0}
    got = {n: counts[n] for n in BWD_NAMES}
    print(f"nt_pnp path: K = {K} Adam iterations over {len(taken)} steps (fewest "
          f"{min(per_step)}, most {max(per_step)} a step); packed-kernel launches "
          f"{counts['flash_packed_bounded']} (predicted 10 x {4 * STEPS} + K = "
          f"{10 * 4 * STEPS + K}); gradient launches {json.dumps(got)} (predicted 9 K LSE, "
          f"4 K dq and dk / dv: {json.dumps(routed)})")
    if got != routed or len(taken) != STEPS:
        failures.append(f"the nt_pnp path's gradient kernels were not launched as predicted "
                        f"({routed}, K = {K}): {got}")
    inv = runs["inv"]
    scale = inv.xts.abs().max().item()
    err = (runs["recon"] - inv.xts[:, 0]).abs().max().item() / scale
    with adam_record() as none:
        edit(pipe, inv, runs["ctx3"], None, None, optimization_steps=0)
    torch.cuda.synchronize()
    err0 = (runs["recon"] - inv.xts[:, 0]).abs().max().item() / scale
    ok = not none and math.isfinite(err) and math.isfinite(err0)
    print(f"nt_pnp reconstruction: max|x_orig - xts[0]| / max|xts| {err:.3e} with the Adam "
          f"loop, {err0:.3e} with 0 iterations (max|xts| {scale:.3e}) {'OK' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"nt_pnp reconstruction {err:.3e} / {err0:.3e}")
    return counts, failures


def phase_vae_gradient(pipe, images):
    """The gradient of a loss on the decoded image with respect to the
    latent, in bf16 at 512 px: the route of the style reward's gradient
    through the VAE decode (JAX's ``edit/style.py``; the style mode itself is
    not ported yet, ROADMAP queue 1 item 10).  The decoder's mid-block
    attention [1, 1, 4096, 512] fits JAX's K/V budget in bf16, so under the
    gradient it takes the tensor-core LSE forward and the tensor-core dq and
    dk / dv kernels at d = 512, once each.  Checks a finite gradient of the
    latent's shape and those launches, no other backward kernel's (the
    template's none).  Returns (counts, failures)."""
    x0 = pipe.vae_encode(images[:1])
    reset_launches()
    t0 = time.perf_counter()
    latent = x0.detach().requires_grad_()
    with torch.enable_grad():
        loss = pipe.vae.decode(latent).float().square().mean()
    grad, = torch.autograd.grad(loss, latent)
    torch.cuda.synchronize()
    counts = read_launches()
    moved = {n: counts[n] for n in BWD_NAMES}
    routed = {**dict.fromkeys(BWD_NAMES, 0), "flash_attention_lse": 1, "flash_bwd_dq": 1,
              "flash_bwd_dkv": 1}
    ok = (moved == routed and grad.shape == x0.shape and bool(torch.isfinite(grad).all())
          and grad.abs().max().item() > 0)
    print(f"VAE decode gradient (bf16, 512 px, {time.perf_counter() - t0:.2f} s): d loss / d "
          f"latent {list(grad.shape)} finite, max|grad| {grad.abs().max().item():.3e}; "
          f"launches {json.dumps(moved)} (predicted {json.dumps(routed)}) "
          f"{'OK' if ok else 'FAIL'}")
    return counts, [] if ok else [f"VAE decode gradient: launches {moved}, expected {routed}"]


# JAX's public exact ``flash_attention`` is called by the JAX package's kernel
# probes only (scripts/flash_profile.py, scripts/micro_bench2.py): the UNet's
# self-attention at 64^2 and 32^2 and the 64^2 cross-attention, 4 rows, bf16
EXACT_CALLER_SHAPES = (((4, 8, 4096, 40), 4096), ((4, 8, 1024, 80), 1024),
                       ((4, 8, 4096, 40), 77))
# JAX's exact ``flash_attention`` in float32: its oracle test
# (tests/test_models.py:test_flash_attention_oracle) at the head dims the
# kernels take, [1, 2, Sq, D] against Sk keys
EXACT_F32_CALLER_SHAPES = (((1, 2, 256, 40), 256), ((1, 2, 300, 40), 300), ((1, 2, 128, 80), 400))
# JAX's exact ``flash_attention_packed`` has one caller, its oracle test
# (tests/test_models.py:test_flash_attention_packed_oracle), float32:
# (batch, heads, Sq, Sk, D)
EXACT_PACKED_CALLER_SHAPES = ((2, 3, 300, 300, 40), (1, 8, 256, 256, 40), (2, 2, 128, 400, 80))
# and one bf16 call on packed heads at the UNet's controlled call, 2 images
# (batch, heads, Sq, Sk, D), so the tensor-core packed entry runs on the path
EXACT_PACKED_BF16_SHAPES = ((8, 8, 4096, 4096, 40),)
# JAX's exact forwards have no caller at d = 512: one float32 call each at the
# VAE's width, the 256 px decode's [1, 1, 1024, 512] (one head), so the
# float32 d = 512 kernel's exact entries run on the path
EXACT_F32_512_SHAPES = (((1, 1, 1024, 512), 1024),)
EXACT_PACKED_F32_512_SHAPES = ((1, 1, 1024, 1024, 512),)


def phase_exact_path():
    """Kernels 6 and 7's own path: no editing path of either package runs
    the exact forwards, so each is driven as JAX's callers drive its twin,
    once at each of their shapes (bf16 on the tensor cores, float32 on the
    float32 kernel's exact mode), and once in float32 at the VAE's d = 512
    (the float32 d = 512 kernel), the counts at 0 before and read after,
    the template's at 0 too; each output
    checked finite and within tolerance of its plain version at the kernel's
    key tile (``flash_attention_exact_reference`` and its packed twin,
    before their final rounding: bf16 one output ulp, float32 1e-4)."""
    failures = []
    g = torch.Generator(device="cuda").manual_seed(23)
    inputs = [_qkv(g, qshape, sk, torch.bfloat16) for qshape, sk in EXACT_CALLER_SHAPES]
    inputs += [_qkv(g, qshape, sk, torch.float32)
               for qshape, sk in EXACT_F32_CALLER_SHAPES + EXACT_F32_512_SHAPES]
    packed = [[torch.randn(b, s, h * d, generator=g, device="cuda").to(dtype)
               for s in (sq, sk, sk)] + [h]
              for shapes, dtype in ((EXACT_PACKED_CALLER_SHAPES, torch.float32),
                                    (EXACT_PACKED_BF16_SHAPES, torch.bfloat16),
                                    (EXACT_PACKED_F32_512_SHAPES, torch.float32))
              for b, h, sq, sk, d in shapes]
    reset_launches()
    outs = [flash.flash_attention_exact_cuda(q, k, v) for q, k, v in inputs]
    packed_outs = [flash.flash_attention_packed_cuda(*args) for args in packed]
    torch.cuda.synchronize()
    counts = read_launches()
    for args, out in zip(inputs + packed, outs + packed_outs):
        plain = (flash.flash_attention_exact_reference if len(args) == 3
                 else flash.flash_attention_packed_exact_reference)
        want = plain(*args, out_dtype=torch.float32)
        err = (out.float() - want).abs().max().item()
        tol = F32_TOL if out.dtype == torch.float32 else BF16_ULP * want.abs().max().item()
        if not (bool(torch.isfinite(out).all()) and err <= tol):
            failures.append(f"exact forward path q{list(args[0].shape)} k{list(args[1].shape)} "
                            f"{out.dtype}: err {err:.3e} (tol {tol:.3g})")
    print(f"exact forward path (JAX flash_attention's callers' shapes "
          f"{[list(q.shape) + [k.shape[2], str(q.dtype)[6:]] for q, k, _ in inputs]}; "
          f"flash_attention_packed's {[list(s) for s in EXACT_PACKED_CALLER_SHAPES]}, f32, "
          f"and {[list(s) for s in EXACT_PACKED_BF16_SHAPES]}, bf16; float32 at d = 512 "
          f"{[list(s) for s, _ in EXACT_F32_512_SHAPES]}, packed "
          f"{[list(s) for s in EXACT_PACKED_F32_512_SHAPES]}): launches "
          f"{json.dumps(counts)} {'OK' if not failures else 'FAIL'}")
    expected = {"flash_attention_exact": len(EXACT_CALLER_SHAPES),
                "flash_attention_exact_core": 0,
                "flash_packed": len(EXACT_PACKED_BF16_SHAPES),
                "flash_packed_core": 0,
                "flash_attention_exact_f32": len(EXACT_F32_CALLER_SHAPES),
                "flash_packed_f32": len(EXACT_PACKED_CALLER_SHAPES),
                "flash_attention_exact_f32_512": len(EXACT_F32_512_SHAPES),
                "flash_packed_f32_512": len(EXACT_PACKED_F32_512_SHAPES)}
    if {n: counts[n] for n in EXACT_NAMES} != expected:
        failures.append(f"exact forward launches {({n: counts[n] for n in EXACT_NAMES})}, "
                        f"expected {expected}")
    return counts, failures


def phase_packed_bounded_512():
    """The packed entry of the float32 d = 512 kernel's bounded mode: no
    path of either package packs heads at d = 512 (the VAE's attention has
    one head and takes the head-split entry), so it is driven once here, as
    ``flash_attention_packed_bounded_cuda`` would serve one head of the
    256 px decode's [1, 1024, 512], the counts at 0 before and read after;
    its output within 1e-4 of the bounded plain version.  Returns (counts,
    failures)."""
    g = torch.Generator(device="cuda").manual_seed(29)
    q, k, v = (torch.randn(1, 1024, 512, generator=g, device="cuda") for _ in range(3))
    reset_launches()
    out = flash.flash_attention_packed_bounded_cuda(q, k, v, 1)
    torch.cuda.synchronize()
    counts = read_launches()
    err = (out - flash.flash_attention_packed_bounded_reference(q, k, v, 1)).abs().max().item()
    moved = {n: c for n, c in counts.items() if c}
    ok = err <= F32_TOL and moved == {"flash_packed_bounded_f32_512": 1}
    print(f"packed bounded forward at d = 512 (float32, [1, 1024, 512], one head): max_abs_err "
          f"{err:.3e} (tol {F32_TOL:g}), launches {moved} {'OK' if ok else 'FAIL'}")
    return counts, [] if ok else [f"packed bounded d = 512: err {err:.3e}, launches {moved}"]


def phase_golden(pipe):
    """README golden numerics on the card, SD-1.5 widths in float32, then the
    edit decoded: the float32 bounded kernel (``csrc/flash_attention_f32.cu``)
    for the UNet's packed self-attentions, its launches counted from 0.  The VAE's
    one-head attention at 512 px (4096 tokens, 16 MiB of float32 K/V) is
    outside the K/V budget and takes ``reference_attention``, as on the TPU;
    the edit decoded once more at 256 px (a 32 x 32 latent: 1024 tokens,
    4 MiB) takes the float32 d = 512 kernel's head-split bounded forward
    (``csrc/flash_attention_f32_512.cu``), once, and the CUDA-core template
    never.  Returns (counts, failures)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    x0 = torch.randn(1, 64, 64, 4, generator=g, device="cuda")
    xts = sample_xts_from_x0(pipe.schedule, x0, g)[None]
    ids = torch.from_numpy(_token_ids(np.random.RandomState(11), 1))
    ids[:, 3] = ids[:, 1]  # target = source
    ctx4 = pipe.encode_token_ids(ids.reshape(-1, MAX_LEN)).reshape(1, 4, MAX_LEN, -1)
    reset_launches()
    t0 = time.perf_counter()
    edited = h_edit_p2p_flagship(
        pipe.unet, pipe.schedule, HEditConfig(cfg_src_edit=5.0, cfg_tar=5.0), xts=xts,
        ctx4=ctx4, control=neutral_control(STEPS, 256, cond_start=2).to("cuda"),
        local_blend=neutral_blend(STEPS, 8, 16).to("cuda"), after_skip_steps=STEPS)
    image = pipe.vae_decode(edited)
    torch.cuda.synchronize()
    at_512 = read_launches()["flash_attention_f32_512"]
    t1 = time.perf_counter()
    small = pipe.vae_decode(edited[:, ::2, ::2])
    torch.cuda.synchronize()
    decode_256 = time.perf_counter() - t1
    counts = read_launches()
    err = (edited - xts[:, 0]).abs().max().item()
    finite = bool(torch.isfinite(image).all()) and bool(torch.isfinite(small).all())
    ok = (err <= GOLDEN_TOL and finite and at_512 == 0 and counts["flash_attention_f32_512"] == 1
          and counts["flash_packed_bounded_f32"] == 2 * 10 * STEPS
          and counts["flash_attention_core"] == counts["flash_packed_bounded_core"] == 0
          and counts["flash_attention_f32"] == 0
          and counts["flash_attention"] == counts["flash_packed_bounded"] == 0)
    print(f"golden identity (f32, TF32 off, {STEPS} steps, {time.perf_counter() - t0:.1f} s): "
          f"max|edited - xts[0]| {err:.3e} (tol {GOLDEN_TOL:g}); decoded {list(image.shape)} "
          f"and {list(small.shape)} finite={finite} (the 256 px decode {decode_256 * 1e3:.1f} "
          f"ms, host clock, its first call); float32 d = 512 kernel launches {at_512} at 512 px "
          f"(predicted 0: outside the K/V budget) and "
          f"{counts['flash_attention_f32_512'] - at_512} at 256 px (predicted 1); template "
          f"bounded head-split {counts['flash_attention_core']}, packed "
          f"{counts['flash_packed_bounded_core']} (predicted 0); float32 kernel packed "
          f"{counts['flash_packed_bounded_f32']} (predicted {2 * 10 * STEPS}: two UNet calls "
          f"a step x 10), head-split {counts['flash_attention_f32']} (predicted 0); tensor-core "
          f"{counts['flash_attention']} / {counts['flash_packed_bounded']} (predicted 0) "
          f"{'OK' if ok else 'FAIL'}")
    return counts, [] if ok else [f"golden identity error {err:.3e}, launches {counts}"]


def _vae_latent_grad(pipe, latent):
    """d loss / d latent of a loss on the decoded image."""
    latent = latent.detach().requires_grad_()
    with torch.enable_grad():
        loss = pipe.vae.decode(latent).float().square().mean()
    grad, = torch.autograd.grad(loss, latent)
    return grad


def phase_vae_gradient_f32(pipe):
    """The gradient of a loss on the decoded image with respect to the
    latent in float32: the route of the float32 style gradient through such
    a decode, at two sizes, each call's launches counted from 0.

    256 px (a 32 x 32 latent): the decoder's mid-block attention
    [1, 1, 1024, 512] fits JAX's K/V budget in float32 (4 MiB), so under the
    gradient it takes row 3's forward on the float32 d = 512 kernel, once;
    1024 tokens are below ``_BWD_MIN_SEQ``, so its backward is autograd of
    ``reference_attention``, as on the TPU: no backward kernel.

    256 x 512 px (a 32 x 64 latent): [1, 1, 2048, 512] fills the budget
    exactly (8 MiB) and reaches ``_BWD_MIN_SEQ``: row 3's forward once and
    the float32 d = 512 backward (``flash_bwd_f32_512``) once, the template
    never; the gradient held, within ``UNET_GRAD_TOL`` of its largest value,
    to the same gradient with ``plain_versions()`` substituted.

    Checks finite, nonzero gradients of the latents' shapes and those
    launches.  Returns (the 256 x 512 px call's counts, failures)."""
    g = torch.Generator(device="cuda").manual_seed(17)
    failures = []
    watched = BWD_NAMES + ("flash_attention_f32_512", "flash_attention_core")
    for hw, routed_bwd in (((32, 32), 0), ((32, 64), 1)):
        latent = torch.randn(1, *hw, 4, generator=g, device="cuda")
        reset_launches()
        t0 = time.perf_counter()
        grad = _vae_latent_grad(pipe, latent)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_launches()
        moved = {n: counts[n] for n in watched}
        routed = {**dict.fromkeys(moved, 0), "flash_attention_lse_f32_512": 1,
                  "flash_bwd_f32_512": routed_bwd}
        ok = (moved == routed and grad.shape == latent.shape
              and bool(torch.isfinite(grad).all()) and grad.abs().max().item() > 0)
        against = ""
        if routed_bwd:
            with plain_versions():
                want = _vae_latent_grad(pipe, latent)
            err = ((grad - want).abs().max() / want.abs().max()).item()
            ok = ok and err <= UNET_GRAD_TOL
            against = (f"; against the plain versions max|diff| / max|grad| {err:.3e} (tol "
                       f"{UNET_GRAD_TOL:g})")
        px = f"{8 * hw[0]} x {8 * hw[1]} px"
        print(f"VAE decode gradient (f32, {px}, {seconds:.2f} s): d loss / d latent "
              f"{list(grad.shape)} finite, max|grad| {grad.abs().max().item():.3e}{against}; "
              f"launches {json.dumps(moved)} (predicted {json.dumps(routed)}) "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"VAE decode gradient f32 at {px}: launches {moved}, expected "
                            f"{routed}{against}")
    return counts, failures


@contextlib.contextmanager
def plain_versions():
    """Substitute every kernel wrapper by its plain version: the package
    itself has no switch for this, and no CUDA path of it ever does so.
    ``flash_diff_backward`` keeps the card's routing: its kernel route calls
    ``flash_attention_backward_cuda``, substituted here, and its other route
    is autograd of ``reference_attention``, plain already."""
    with contextlib.ExitStack() as stack:
        for module, name, plain in (
                (attn, "flash_attention_cuda", flash.flash_attention_bounded_reference),
                (attn, "flash_attention_packed_bounded_cuda",
                 flash.flash_attention_packed_bounded_reference),
                (flash, "flash_attention_lse_cuda", flash.flash_attention_lse_reference),
                (flash, "flash_attention_backward_cuda", flash.flash_attention_backward_reference),
                (gn, "group_norm_cuda", gn.group_norm_reference)):
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
    launched = (all(counts[k] > 0 for k in ("groupnorm", "flash_attention_lse_f32",
                                            "flash_bwd_f32"))
                and counts["flash_attention_lse"] == counts["flash_attention_lse_core"] == 0
                and counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 0
                and counts["flash_bwd_f32_512"] == 0)
    ok = (rel <= UNET_GRAD_TOL and substituted and launched
          and bool(torch.isfinite(grad_k).all()))
    print(f"UNet gradient (f32, TF32 off, t={t}): max|dx kernels - dx plain| / max|dx plain| "
          f"{rel:.3e} (tol {UNET_GRAD_TOL:g}; max|dx| {grad_p.abs().max().item():.3e}), eps "
          f"{rel_eps:.3e}; launches with the kernels {json.dumps(counts)}, none more with the "
          f"plain versions: {substituted} {'OK' if ok else 'FAIL'}")
    return [] if ok else [f"UNet gradient relative error {rel:.3e}, launches {counts}"]


# the float32 null-text chain, kernels against plain versions: the largest
# relative difference of the 10 losses
NULL_TEXT_LOSS_TOL = 1e-3


def phase_null_text_gradient(pipe):
    """Null-text's gradient in float32: d loss / d u of one Adam iteration
    (``null_text_loss``, the loss of the source branch's CFG step at t = the
    middle timestep of the DDIM grid against a stored point), the kernels
    against the plain versions within ``UNET_GRAD_TOL``; the kernels
    launched are the float32 LSE forward (9), the fused float32 backward (4)
    and, for the first self-attention, before any cross-attention, the
    float32 packed kernel (1).  Then outer step 0's whole 10-iteration Adam
    chain both ways: the loss trajectories within ``NULL_TEXT_LOSS_TOL``
    relative; the largest |u_opt| difference outside the set |g| <= 1e-8
    of the first gradient printed, not held (Adam's eps turns a rounding
    difference there into a step of O(lr))."""
    schedule = Schedule.create(STEPS, steps_offset=0)
    g = torch.Generator(device="cuda").manual_seed(37)
    x = torch.randn(1, 64, 64, 4, generator=g, device="cuda")
    stored = torch.randn(1, 64, 64, 4, generator=g, device="cuda")
    ids = torch.from_numpy(_token_ids(np.random.RandomState(37), 1))
    uncond, src = pipe.encode_token_ids(ids[0, [0, 1]]).chunk(2)
    rows = torch.arange(1, device="cuda")
    failures = []

    def loss_grad(t):
        with torch.no_grad():
            cond = pipe.unet(x, t, src)
        return pnp_baselines.null_text_loss(pipe.unet, schedule, x, t, cond, stored, 7.5)

    t = int(schedule.timesteps[STEPS // 2])
    kernels = loss_grad(t)
    reset_launches()
    loss_k, grad_k = kernels(uncond, rows)
    counts = read_launches()
    with plain_versions():
        loss_p, grad_p = loss_grad(t)(uncond, rows)
    torch.cuda.synchronize()
    substituted = read_launches() == counts
    rel = ((grad_k - grad_p).abs().max() / grad_p.abs().max()).item()
    routed = {"flash_attention_lse_f32": 9, "flash_bwd_f32": 4, "flash_packed_bounded_f32": 1}
    others = {n: c for n, c in counts.items() if c and n not in routed and n != "groupnorm"}
    launched = {n: counts[n] for n in routed} == routed and not others
    ok = rel <= UNET_GRAD_TOL and substituted and launched and bool(torch.isfinite(grad_k).all())
    print(f"null-text gradient (f32, TF32 off, t={t}): max|du kernels - du plain| / max|du "
          f"plain| {rel:.3e} (tol {UNET_GRAD_TOL:g}; max|du| {grad_p.abs().max().item():.3e}), "
          f"loss {loss_k.item():.6e} / {loss_p.item():.6e}; launches {json.dumps(counts)} "
          f"(predicted {json.dumps(routed)} and GroupNorm), none more with the plain "
          f"versions: {substituted} {'OK' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"null-text gradient relative error {rel:.3e}, launches {counts}")

    t0 = time.perf_counter()
    t = int(schedule.timesteps[0])
    adam = dict(optimization_steps=10, lr=torch.tensor(1e-2, device="cuda"),
                thresh=torch.tensor(1e-5, device="cuda"))
    g0 = loss_grad(t)(uncond, rows)[1].abs()
    u_k, losses_k = pnp_baselines.null_text_adam(loss_grad(t), uncond, **adam)
    with plain_versions():
        u_p, losses_p = pnp_baselines.null_text_adam(loss_grad(t), uncond, **adam)
    torch.cuda.synchronize()
    both = torch.isfinite(losses_k) & torch.isfinite(losses_p)
    rel = ((losses_k - losses_p).abs() / losses_p.abs())[both].max().item()
    live = g0 > 1e-8
    du = (u_k - u_p).abs()
    ok = (rel <= NULL_TEXT_LOSS_TOL and bool(both.all()) and bool(torch.isfinite(u_k).all()))
    print(f"null-text Adam chain (f32, outer step 0, t={t}, 10 iterations, "
          f"{time.perf_counter() - t0:.1f} s): losses {losses_k[:, 0].tolist()}; max relative "
          f"difference kernels / plain {rel:.3e} (tol {NULL_TEXT_LOSS_TOL:g}); max|u_opt "
          f"kernels - plain| outside |g| <= 1e-8 {du[live].max().item():.3e} "
          f"({live.float().mean().item():.4f} of the coordinates), inside "
          f"{du[~live].max().item() if (~live).any() else 0.0:.3e} (printed, not held) "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"null-text Adam chain losses differ by {rel:.3e}")
    return failures


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
    reset_launches()
    t0 = time.perf_counter()
    edited, _ = nmg_p2p(pipe.unet, schedule, xts=xts, ctx3=ctx3, cfg_tar=7.5,
                        control=neutral_control(STEPS, 256, cond_start=2).to("cuda"),
                        local_blend=neutral_blend(STEPS, 8, 16).to("cuda"),
                        after_skip_steps=STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = read_launches()
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
    # float32: the float32 LSE kernel, 10 layers a step (d = 40 and 80), and
    # the fused float32 backward for the 5 of 4096 tokens (autograd of
    # reference_attention for the 5 of 1024); the template's parts none
    bwd = {n: counts[n] for n in BWD_NAMES}
    routed = {"flash_attention_lse": 0, "flash_attention_lse_core": 0,
              "flash_attention_lse_f32": 10 * STEPS, "flash_attention_lse_f32_512": 0,
              "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_f32": 5 * STEPS,
              "flash_bwd_f32_512": 0}
    print(f"NMG identity launches: {bwd} (predicted {routed})")
    if bwd != routed:
        ok = False
    return counts, [] if ok else [f"NMG identity error {err:.3e}, launches {bwd}"]


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


def phase_masactrl_identity(pipe):
    """h-Edit-R + MasaCtrl in float32 with target = source = uncond = the empty
    prompt and cfg_tar == cfg_src_edit, MasaCtrl active at its defaults (from
    step 4, pair 10 on): x_opt starts at the trajectory, so MasaCtrl's remap
    maps equal rows onto each other, the correction vanishes, and the edit
    returns the source latent xts[0]."""
    g = torch.Generator(device="cuda").manual_seed(29)
    x0 = torch.randn(1, 64, 64, 4, generator=g, device="cuda")
    ids = torch.from_numpy(_token_ids(np.random.RandomState(29), 1))
    ctx3 = pipe.encode_token_ids(ids[0, [0, 0, 0]]).reshape(1, 3, MAX_LEN, -1)
    t0 = time.perf_counter()
    inv = invert_ddpm(pipe.unet, pipe.schedule, x0, uncond_ctx=ctx3[:, 0], src_ctx=ctx3[:, 1],
                      cfg_scale_src=1.0, eta=1.0, generator=g, step_chunk=10)
    reset_launches()
    edited, _ = h_edit_masactrl(pipe.unet, pipe.schedule, inv.xT, inv.zs, ctx3=ctx3,
                                cfg=HEditConfig(cfg_src_edit=5.0, cfg_tar=5.0),
                                after_skip_steps=STEPS, start_step=4, start_layer=10,
                                xts=inv.xts)
    torch.cuda.synchronize()
    counts = read_launches()
    scale = inv.xts.abs().max().item()
    err = (edited - inv.xts[:, 0]).abs().max().item() / scale
    ok = (err <= GOLDEN_TOL and bool(torch.isfinite(edited).all())
          and counts["flash_packed_bounded_f32"] > 0)
    print(f"MasaCtrl identity (f32, TF32 off, {STEPS} + {STEPS} steps, "
          f"{time.perf_counter() - t0:.1f} s): max|edited - xts[0]| / max|xts| {err:.3e} "
          f"(tol {GOLDEN_TOL:g}; max|xts| {scale:.3e}); loop launches {json.dumps(counts)} "
          f"{'OK' if ok else 'FAIL'}")
    return [] if ok else [f"MasaCtrl identity error {err:.3e}"]


def phase_pnp_identity(pipe):
    """h-Edit-R + PnP in float32 with target = source, cfg_tar == cfg_src_edit
    == 5 and the CLI's default gates: x_opt starts on the trajectory, the
    pair's rows are equal, so the injection copies equal rows, the correction
    vanishes, and the edit returns the source latent xts[0]."""
    g = torch.Generator(device="cuda").manual_seed(31)
    x0 = torch.randn(1, 64, 64, 4, generator=g, device="cuda")
    ids = torch.from_numpy(_token_ids(np.random.RandomState(31), 1))
    ctx3 = pipe.encode_token_ids(ids[0, [0, 1, 1]]).reshape(1, 3, MAX_LEN, -1)
    qk_mask, conv_mask = pnp_step_gates(STEPS, PNP_ATTN_T, PNP_F_T)
    t0 = time.perf_counter()
    inv = invert_ddpm(pipe.unet, pipe.schedule, x0, uncond_ctx=ctx3[:, 0], src_ctx=ctx3[:, 1],
                      cfg_scale_src=1.0, eta=1.0, generator=g, step_chunk=10)
    reset_launches()
    edited, _ = h_edit_pnp(pipe.unet, pipe.schedule, inv.xT, inv.zs, ctx3=ctx3,
                           cfg=HEditConfig(cfg_src_edit=5.0, cfg_tar=5.0),
                           after_skip_steps=STEPS, qk_mask=qk_mask, conv_mask=conv_mask,
                           xts=inv.xts)
    torch.cuda.synchronize()
    counts = read_launches()
    scale = inv.xts.abs().max().item()
    err = (edited - inv.xts[:, 0]).abs().max().item() / scale
    ok = (err <= GOLDEN_TOL and bool(torch.isfinite(edited).all())
          and counts["flash_packed_bounded_f32"] > 0)
    print(f"PnP identity (f32, TF32 off, {STEPS} + {STEPS} steps, "
          f"{time.perf_counter() - t0:.1f} s): max|edited - xts[0]| / max|xts| {err:.3e} "
          f"(tol {GOLDEN_TOL:g}; max|xts| {scale:.3e}); loop launches {json.dumps(counts)} "
          f"{'OK' if ok else 'FAIL'}")
    return [] if ok else [f"PnP identity error {err:.3e}"]


# Device-time classes of a step, by kernel name (first match wins).  Row 3,
# the LSE forward, is the tensor-core forward kernel instantiated with
# LSE = true (its last template argument; "Lb1E" mangled); on the bf16 paths
# the CUDA-core forward template runs nowhere.
KERNEL_CLASSES = (("flash LSE forward (tensor cores)",
                   r"flash_fwd_tc_kernel(<[^>]*true>|I.*Lb1EE)"),
                  ("flash kernel (tensor cores)", r"flash_fwd_tc_kernel"),
                  ("flash backward (tensor cores)", r"flash_bwd_(dq|dkv)_tc_kernel"),
                  ("flash backward (CUDA cores, fused float32 kernel)", r"flash_bwd_f32_kernel"),
                  ("flash backward (CUDA cores)", r"flash_bwd_(dq|dkv)_kernel"),
                  ("flash forward (CUDA cores, float32 kernel)", r"flash_fwd_f32_kernel"),
                  ("flash forward (CUDA cores)", r"flash_fwd_kernel"),
                  ("GroupNorm kernel", r"gn_slice_kernel|gn_apply_kernel"),
                  ("cuDNN layout transposes", r"nchwToNhwc|nhwcToNchw"),
                  ("convolutions", r"fprop|conv|dgrad"),
                  ("GEMMs", r"gemm|nvjet|cutlass"),
                  ("copies", r"copy|Copy|Memcpy|Memset"),
                  # reference_attention's softmax, forward and autograd: the
                  # cross-attentions and the backward below _BWD_MIN_SEQ
                  ("softmax", r"[sS]oft[mM]ax"))


def _union_us(intervals):
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _profile_steps(label, run, steps, images, trace_path):
    """Where a step's time goes: ``run`` (``steps`` steps, ending in a
    synchronise) once as a warm-up, three times on the host clock without the
    profiler, then once under one torch.profiler trace, read for device time
    by kernel class, the top kernels, and the device's idle share (1 - union
    of the device's kernel, copy and set intervals / the traced span)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    run()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            run()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise RuntimeError("the trace holds no device activity")
    span = next((e for e in events if e.get("name") == label
                 and e.get("cat") == "user_annotation"), None)
    if span is None:
        print(f"profile {label}: no host span in the trace; the window is the device's own extent")
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
    print(f"profile {label}: {images} images, {steps} steps; host wall without the profiler "
          f"{', '.join(f'{w:.2f}' for w in walls)} ms a step; traced span "
          f"{(hi - lo) / 1e3 / steps:.2f} ms a step, device busy {busy / 1e3 / steps:.2f} ms "
          f"a step, idle share {1 - busy / (hi - lo):.4f}; {len(dev)} device events")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"profile {label} class {cls}: {us / 1e3 / steps:.3f} ms a step, "
              f"{100 * us / total:.2f}% of device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"profile {label} kernel {us / 1e3 / steps:8.3f} ms a step  {name[:150]}")
    print(f"profile {label} trace: {trace_path}")


def phase_profile(steps, trace_path):
    """Where a step's time goes on two paths, at the main paths' inputs.
    The flagship: edit steps 0 to ``steps`` - 1 of N_IMAGES images (the P2P
    edits follow the step; the UNet's work does not depend on the timestep,
    so the last ``steps`` timesteps of the 50-step grid serve).  NMG + P2P:
    ``steps`` steps of one image, each the gradient call (one 1-row UNet
    forward and backward through the LSE forward and the backward kernels)
    and the 4-row controlled call, from a seeded trajectory (the work does
    not depend on its values).  Each after a warm-up run (``_profile_steps``);
    the NMG trace is written beside ``trace_path``."""
    pipe, images, ids, control, blend = _main_path_inputs()
    ctx4 = pipe.encode_token_ids(ids.reshape(-1, MAX_LEN)).reshape(N_IMAGES, 4, MAX_LEN, -1)
    x0s = pipe.vae_encode(images)
    xts = torch.stack([sample_xts_from_x0(pipe.schedule, x[None],
                                          torch.Generator(device="cuda").manual_seed(i))
                       for i, x in enumerate(x0s)])[:, :steps + 1]

    def flagship():
        h_edit_p2p_flagship(pipe.unet, pipe.schedule, HEditConfig(), xts=xts, ctx4=ctx4,
                            control=control, local_blend=blend, after_skip_steps=steps)
        torch.cuda.synchronize()

    _profile_steps("flagship_steps", flagship, steps, N_IMAGES, trace_path)

    ddim = Schedule.create(STEPS, steps_offset=0)
    ctx3 = ctx4[:1, [0, 1, 3]]  # uncond, src, tar, as the NMG path
    one_control, one_blend = (state.to("cuda") for state in _edit_control(STEPS, 8, 0))
    g = torch.Generator(device="cuda").manual_seed(11)
    nmg_xts = torch.randn(1, steps + 1, 64, 64, 4, generator=g, device="cuda")

    def nmg():
        nmg_p2p(pipe.unet, ddim, xts=nmg_xts, ctx3=ctx3, cfg_tar=7.5, control=one_control,
                local_blend=one_blend, after_skip_steps=steps)
        torch.cuda.synchronize()

    root, ext = os.path.splitext(trace_path)
    _profile_steps("nmg_steps", nmg, steps, 1, f"{root}_nmg{ext}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile flagship and NMG steps instead of running the smoke")
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
    rows, bad, kernel_counts = phase_kernels()
    failures += bad
    probe_counts, bad = phase_probes(rows)
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
    masactrl_counts, bad = phase_masactrl_path(*inputs[:3])
    failures += bad
    pnp_counts, bad = phase_pnp_path(*inputs[:3])
    failures += bad
    nt_pnp_counts, bad = phase_nt_pnp_path(*inputs[:3])
    failures += bad
    vae_grad_counts, bad = phase_vae_gradient(*inputs[:2])
    failures += bad
    del inputs
    exact_counts, bad = phase_exact_path()
    failures += bad
    packed_512_counts, bad = phase_packed_bounded_512()
    failures += bad
    torch.cuda.empty_cache()
    pipe = create_sd_pipeline(tiny=False, num_inference_steps=STEPS, seed=0,
                              dtype=torch.float32, device="cuda")
    golden_counts, bad = phase_golden(pipe)
    failures += bad
    vae_grad_f32_counts, bad = phase_vae_gradient_f32(pipe)
    failures += bad
    failures += phase_unet_gradient(pipe)
    failures += phase_null_text_gradient(pipe)
    nmg_f32_counts, bad = phase_nmg_identity(pipe)
    failures += bad
    failures += phase_reconstructions(pipe)
    failures += phase_masactrl_identity(pipe)
    failures += phase_pnp_identity(pipe)
    paths = {"flagship": flagship_counts, "nmg": nmg_counts, "h_edit_d": hedit_d_counts,
             "ef": ef_counts, "masactrl": masactrl_counts, "pnp": pnp_counts,
             "nt_pnp": nt_pnp_counts,
             "vae_gradient": vae_grad_counts,
             "exact_forward": exact_counts, "golden_f32": golden_counts,
             "vae_gradient_f32": vae_grad_f32_counts, "packed_bounded_f32_512": packed_512_counts,
             "nmg_f32": nmg_f32_counts, **kernel_counts, **probe_counts}
    # no path but the probes' own launches a probe kernel (rows 8-12)
    probe_kernels = [n for n, (module, _) in COUNTERS.items() if module in (fp, mp)]
    for path in paths.keys() - probe_counts.keys():
        launched = {n: paths[path][n] for n in probe_kernels if paths[path][n]}
        if launched:
            failures.append(f"the {path} path launched probe kernels: {launched}")
    print(f"probe kernels launched off the probes' paths: none expected, "
          f"{sum(paths[p][n] for p in paths.keys() - probe_counts.keys() for n in probe_kernels)}")
    # no bf16 path launches a float32 backward kernel
    bf16_paths = ("flagship", "nmg", "h_edit_d", "ef", "masactrl", "pnp", "nt_pnp",
                  "vae_gradient")
    fused = {p: paths[p]["flash_bwd_f32"] + paths[p]["flash_bwd_f32_512"] for p in bf16_paths}
    print(f"float32 backward kernels launched on the bf16 paths: {fused} (none expected)")
    if any(fused.values()):
        failures.append(f"a bf16 path launched a float32 backward kernel: {fused}")

    def entry(name, route, source, replaces, path, **extra):
        """The kernel's first comparison (a shape of its path) and its launches
        on ``path``, one of ``paths``; max_abs_err is the largest of all its
        cases."""
        mine = [r for r in rows if r["name"] == name]
        if paths[path][name] <= 0:
            failures.append(f"{name} was not launched on the {path} path")
        cores = extra.pop("cores", "tensor (mma.sync, bf16)"
                          if source in (tc_cu, bwd_tc_cu, probes_tc_cu, mm_tc_cu) else "CUDA")
        return {"name": name, "route": route, "source": source, "replaces": replaces, **extra,
                "cores": cores,
                "launches": paths[path][name], "path": path,
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                **{k: mine[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                           "plain_covers", "split_path_ms", "pipe_ms", "shape",
                                           "core_ms", "matmuls_ms", "bound_7_products_ms",
                                           "dq_run_to_run", "dkv_bit_identical", "dkv_ms", "dq_ms",
                                           "relaunch_bit_identical", "lse_max_rel_err",
                                           "transpose_of_a_bit_identical",
                                           "max_err_over_tol", "excused_rows", "row_count",
                                           "negative_sum_rows", "check_bit_identical",
                                           "score_err_over_tol", "sums_differing_rows",
                                           "regime", "cluster", "cb", "traffic_bound_ms",
                                           "eager_ms", "key_tile")
                   if k in mine[0]}}

    def at_shape(name, shape):
        """The numbers of ``name``'s row at ``shape`` (a kernel whose first row,
        the kernels line's, is at another path's shape)."""
        mine = next(r for r in rows if r["name"] == name and r["shape"] == list(shape))
        return {k: mine[k] for k in ("ms", "core_ms", "plain_ms", "library_ms", "bound_ms",
                                     "bound_by", "bound_7_products_ms", "dkv_ms", "dq_ms",
                                     "pipe_ms", "key_tile", "relaunch_bit_identical",
                                     "max_abs_err", "shape") if k in mine}

    tc_cu, bwd_tc_cu, probes_tc_cu = ("hedit_tpu_torch/csrc/flash_attention_tc.cu",
                                      "hedit_tpu_torch/csrc/flash_attention_bwd_tc.cu",
                                      "hedit_tpu_torch/csrc/flash_probes_tc.cu")
    tc_route = "cuda"
    f32_cu = "hedit_tpu_torch/csrc/flash_attention_f32.cu"
    f32_512_cu = "hedit_tpu_torch/csrc/flash_attention_f32_512.cu"
    bwd_f32_cu = "hedit_tpu_torch/csrc/flash_attention_bwd_f32.cu"
    bwd_f32_512_cu = "hedit_tpu_torch/csrc/flash_attention_bwd_f32_512.cu"
    variants_cu, mm_cu, mm_tc_cu = ("hedit_tpu_torch/csrc/flash_variants.cu",
                                    "hedit_tpu_torch/csrc/mm_probe.cu",
                                    "hedit_tpu_torch/csrc/mm_probe_tc.cu")

    def mm_cases(name):
        """Row 12's numbers in each case of kernel ``name``."""
        return {r["shape"][0]: {key: r[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err", "splits", "tile")
            if key in r} for r in rows if r["name"] == name}
    gn_cu = "hedit_tpu_torch/csrc/group_norm.cu"
    jax_flash = "hedit_tpu/ops/flash_attention.py"
    print(json.dumps({"kernels": [
        entry("flash_attention", tc_route, tc_cu, f"{jax_flash}:220", "flagship"),
        entry("groupnorm", "cuda", gn_cu, "hedit_tpu/ops/groupnorm.py:100", "flagship"),
        entry("groupnorm_streamed", "cuda", gn_cu, "hedit_tpu/ops/groupnorm.py:100",
              "flagship"),
        entry("flash_attention_lse", tc_route, tc_cu, f"{jax_flash}:464", "nmg"),
        entry("flash_attention_lse_f32", "cuda", f32_cu, f"{jax_flash}:464", "nmg_f32"),
        entry("flash_bwd_dq", tc_route, bwd_tc_cu, f"{jax_flash}:553", "nmg",
              vae_d512=at_shape("flash_bwd_dq", VAE_SHAPE)),
        entry("flash_bwd_dkv", tc_route, bwd_tc_cu, f"{jax_flash}:593", "nmg",
              vae_d512=at_shape("flash_bwd_dkv", VAE_SHAPE)),
        entry("flash_bwd_f32", "cuda", bwd_f32_cu, f"{jax_flash}:553", "nmg_f32",
              also_replaces=f"{jax_flash}:593"),
        entry("flash_bwd_f32_512", "cuda", bwd_f32_512_cu, f"{jax_flash}:553", "vae_gradient_f32",
              also_replaces=f"{jax_flash}:593",
              vae_4096=at_shape("flash_bwd_f32_512", VAE_SHAPE),
              ragged=at_shape("flash_bwd_f32_512", (1, 1, 1000, 512))),
        entry("flash_attention_exact", tc_route, tc_cu, f"{jax_flash}:60", "exact_forward"),
        entry("flash_attention_exact_f32", "cuda", f32_cu, f"{jax_flash}:60", "exact_forward"),
        entry("flash_packed", tc_route, tc_cu, f"{jax_flash}:340", "exact_forward"),
        entry("flash_packed_f32", "cuda", f32_cu, f"{jax_flash}:340", "exact_forward"),
        entry("flash_packed_bounded", tc_route, tc_cu, f"{jax_flash}:220", "flagship"),
        entry("flash_attention_f32_512", "cuda", f32_512_cu, f"{jax_flash}:220", "golden_f32",
              vae_4096=at_shape("flash_attention_f32_512", VAE_SHAPE)),
        entry("flash_attention_lse_f32_512", "cuda", f32_512_cu, f"{jax_flash}:464",
              "vae_gradient_f32", vae_4096=at_shape("flash_attention_lse_f32_512", VAE_SHAPE)),
        entry("flash_attention_exact_f32_512", "cuda", f32_512_cu, f"{jax_flash}:60",
              "exact_forward", vae_4096=at_shape("flash_attention_exact_f32_512", VAE_SHAPE)),
        entry("flash_packed_bounded_f32_512", "cuda", f32_512_cu, f"{jax_flash}:220",
              "packed_bounded_f32_512"),
        entry("flash_packed_f32_512", "cuda", f32_512_cu, f"{jax_flash}:340", "exact_forward"),
        entry("flash_packed_bounded_f32", "cuda", f32_cu, f"{jax_flash}:220", "golden_f32"),
        entry("flash_packed_t", "cuda", probes_tc_cu, "scripts/flash_nhd_variants.py:93",
              "flash_nhd_variants"),
        entry("flash_packed_t_core", "cuda", variants_cu, "scripts/flash_nhd_variants.py:93",
              "flash_nhd_variants_f32"),
        entry("flash_packed_t_sminor", "cuda", probes_tc_cu,
              "scripts/flash_nhd_variants.py:101", "flash_nhd_variants"),
        entry("flash_packed_t_all_sminor", "cuda", probes_tc_cu,
              "scripts/flash_nhd_variants.py:136", "flash_nhd_variants"),
        entry("flash_packed_t_sminor_core", "cuda", variants_cu,
              "scripts/flash_nhd_variants.py:101", "flash_nhd_variants_f32"),
        entry("flash_packed_t_all_sminor_core", "cuda", variants_cu,
              "scripts/flash_nhd_variants.py:136", "flash_nhd_variants_f32"),
        entry("flash_exp2_t", "cuda", probes_tc_cu, "scripts/flash_v4_variants.py:34",
              "flash_v4_variants"),
        entry("flash_exp2_t_core", "cuda", variants_cu, "scripts/flash_v4_variants.py:34",
              "flash_v4_variants_f32", d80=at_shape("flash_exp2_t_core", (1, 8, 1024, 80))),
        *(entry(f"flash_ablate_{m}", "cuda", probes_tc_cu, "scripts/flash_ablate.py:34",
                "flash_ablate") for m in fp.ABLATE_MODES),
        *(entry(f"flash_ablate_{m}_core", "cuda", variants_cu, "scripts/flash_ablate.py:34",
                "flash_ablate_f32") for m in fp.ABLATE_MODES),
        *(entry(f"flash_variant_{v}", "cuda", variants_cu,
                f"scripts/flash_variants.py:{line}", "flash_variants",
                cores="tensor (mma.sync, bf16) for the scores, CUDA for PV")
          for v, line in (("a", 31), ("b", 61), ("c", 87))),
        *(entry(f"flash_variant_{v}_f32", "cuda", variants_cu,
                f"scripts/flash_variants.py:{line}", "flash_variants_f32")
          for v, line in (("a", 31), ("b", 61), ("c", 87))),
        entry("flash_variant_d", "cuda", probes_tc_cu, "scripts/flash_variants.py:31",
              "flash_variants"),
        entry("flash_variant_d_core", "cuda", variants_cu, "scripts/flash_variants.py:31",
              "flash_variants_f32"),
        *(entry(f"mm_loop_{lay}", "cuda", mm_tc_cu, "scripts/mm_probe.py:37", "mm_probe",
                cases=mm_cases(f"mm_loop_{lay}"),
                launches_count="eager calls of hedit_mm_loop_tc; a call with splits > 1 "
                               "launches two kernels, the partials and their sum")
          for lay in mp.LAYOUTS),
        *(entry(f"mm_loop_{lay}_core", "cuda", mm_cu, "scripts/mm_probe.py:37", "mm_probe_f32",
                cases=mm_cases(f"mm_loop_{lay}_core"),
                launches_count="eager calls of hedit_mm_loop; a call with more than one slice "
                               "launches two kernels, the partials and their sum")
          for lay in mp.LAYOUTS)]}))
    if failures:
        print("FAILED: " + "; ".join(failures))
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
