"""End-to-end smoke of the PyTorch port on one CUDA GPU (an NVIDIA H100).

    python3 chip_smoke.py              # the smoke, phases 1-6
    python3 chip_smoke.py --profile    # where a flagship step's time goes

Phases, each printed on its own lines; any failure exits non-zero without
the final result line:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: the CUDA flash-attention library from ``hedit_tpu_torch/csrc`` and
   the Triton GroupNorm kernel, timed;
3. each kernel against its plain PyTorch version at the main path's shapes:
   max abs error against a stated tolerance, CUDA-event time of both;
4. the main path: the SD-1.5 pipeline at full width with seeded weights in
   bfloat16, two seeded 512x512 images and seeded token ids, CLIP encode ->
   VAE encode -> q-sampled trajectory -> 50-step h-Edit-R + P2P flagship loop
   with a non-neutral control and an active LocalBlend -> VAE decode; checks
   finite [2, 512, 512, 3] outputs and that both kernels were launched;
5. the golden identity in float32 (TF32 off): target = source,
   cfg_tar == cfg_src_edit and a neutral control reproduce xts[0];
6. a JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}``.

It exits non-zero before printing anything when no CUDA device is present.

``--profile`` runs phases 1 and 2, then times flagship steps of the main
path (the same SD-1.5 bf16 inputs, 2 images) on the host clock and under
``torch.profiler``, and prints the device time by kernel class, the top
kernels and the device's idle share, all read from one trace.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from hedit_tpu_torch import _build  # noqa: E402
from hedit_tpu_torch.control.p2p import (  # noqa: E402
    MAX_LEN, LocalBlendState, P2PControl, neutral_blend, neutral_control, stack_blends,
    stack_controls,
)
from hedit_tpu_torch.edit.h_edit import HEditConfig  # noqa: E402
from hedit_tpu_torch.edit.h_edit_p2p import h_edit_p2p_flagship  # noqa: E402
from hedit_tpu_torch.invert.ddpm import sample_xts_from_x0  # noqa: E402
from hedit_tpu_torch.ops import flash_attention as flash  # noqa: E402
from hedit_tpu_torch.ops import groupnorm as gn  # noqa: E402
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline  # noqa: E402

STEPS = 50
N_IMAGES = 2
SOT, EOT = 49406, 49407  # CLIP's start- and end-of-text ids
# Tolerances of the kernel comparisons.  float32: 1e-4 absolute, room for
# the kernels' other summation order (TF32 off on both sides); the outputs of
# these inputs reach 0.03-0.15 (flash) and ~5 (GroupNorm).  bfloat16 flash:
# the kernel computes in float32 from the bf16 inputs and rounds once, so it
# is held to the plain version run in float32 on the same input values,
# within one bf16 ulp at the largest output, 2^-8 * max|out| (the rounding is
# half an ulp).  bfloat16 GroupNorm: one output ulp, 2^-7 * max|y|, against
# the plain version in bf16: both normalise in float32 and round once.
F32_TOL = 1e-4
# The golden identity's float32 tolerance: 50 reverse steps, each re-anchored
# on the trajectory; eps from a batch-1 and a batch-4 UNet call differ by
# float32 rounding, amplified by at most sqrt(abar_0 / abar_T) ~ 15.
GOLDEN_TOL = 1e-3
# --profile traces edit steps 0-11: inside the self-edit window (steps 0-16),
# with LocalBlend active from step 10
PROFILE_STEPS = 12


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


def phase_kernels():
    """Kernel vs plain version; returns (report rows, failures)."""
    g = torch.Generator(device="cuda").manual_seed(1234)
    rows, failures = [], []
    flash_cases = [((8, 8, 4096, 40), 4096, torch.bfloat16),   # controlled call, 2 images
                   ((4, 8, 4096, 40), 4096, torch.bfloat16),
                   ((4, 8, 1024, 80), 1024, torch.bfloat16),
                   ((1, 1, 4096, 512), 4096, torch.bfloat16),  # VAE mid block
                   ((1, 8, 1000, 80), 1064, torch.bfloat16),   # ragged, Sq != Sk
                   ((2, 8, 4096, 40), 4096, torch.float32),
                   ((2, 8, 1000, 40), 1000, torch.float32),    # ragged Sq and Sk
                   ((4, 8, 1024, 80), 1024, torch.float32),
                   ((1, 8, 1000, 80), 1064, torch.float32),
                   ((1, 1, 4096, 512), 4096, torch.float32)]
    for qshape, sk, dtype in flash_cases:
        q = torch.randn(qshape, generator=g, device="cuda").to(dtype)
        k = torch.randn(qshape[:2] + (sk, qshape[3]), generator=g, device="cuda").to(dtype)
        v = torch.randn(k.shape, generator=g, device="cuda").to(dtype)
        got = flash.flash_attention_cuda(q, k, v)
        want = flash.reference_attention(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else 2.0 ** -8 * want.abs().max().item()
        ms = cuda_ms(lambda: flash.flash_attention_cuda(q, k, v))
        plain_ms = cuda_ms(lambda: flash.reference_attention(q, k, v))
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"flash q{list(qshape)} sk={sk} {str(dtype)[6:]}: max_abs_err {err:.3e} "
              f"(tol {tol:.3g}, max|out| {want.abs().max().item():.3g}) kernel {ms:.3f} ms "
              f"plain {plain_ms:.3f} ms {'OK' if ok else 'FAIL'}")
        rows.append(("flash_attention", err, ms, plain_ms))
        if not ok:
            failures.append(f"flash {qshape} {dtype}")
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
                ms = cuda_ms(lambda: gn.group_norm_triton(x, w, b, **call))
                plain_ms = cuda_ms(lambda: gn.group_norm_reference(x, w, b, **call))
                ok = err <= tol and bool(torch.isfinite(got).all())
                print(f"groupnorm+silu {list(shape)} {str(dtype)[6:]} eps={eps:g}: max_abs_err "
                      f"{err:.3e} (tol {tol:.3g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
                      f"{'OK' if ok else 'FAIL'}")
                rows.append(("groupnorm", err, ms, plain_ms))
                if not ok:
                    failures.append(f"groupnorm {shape} {dtype} {eps}")
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
    """The SD-1.5 bf16 pipeline and the main path's seeded inputs: images,
    token ids, and the stacked control and LocalBlend of N_IMAGES images."""
    t0 = time.perf_counter()
    pipe = create_sd_pipeline(tiny=False, num_inference_steps=STEPS, seed=0,
                              dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    print(f"main path: SD-1.5 bf16 pipeline on the card in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(7)
    images = torch.rand(N_IMAGES, 512, 512, 3, generator=g, device="cuda") * 2 - 1
    ids = torch.from_numpy(_token_ids(np.random.RandomState(7), N_IMAGES))
    controls = [_edit_control(STEPS, 8, i) for i in range(N_IMAGES)]
    control = stack_controls([c for c, _ in controls]).to("cuda")
    blend = stack_blends([b for _, b in controls]).to("cuda")
    return pipe, images, ids, control, blend


def phase_main_path():
    """The flagship edit of N_IMAGES images; returns (launch counts, failures)."""
    failures = []
    pipe, images, ids, control, blend = _main_path_inputs()
    cfg = HEditConfig()

    flash.launches = gn.launches = 0
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
    counts = {"flash_attention": flash.launches, "groupnorm": gn.launches}
    per_image = (t3 - t0) / N_IMAGES
    print(f"main path: {per_image:.3f} s/image over {N_IMAGES} images "
          f"(encode {t1 - t0:.2f} s, {STEPS}-step loop {t2 - t1:.2f} s, decode {t3 - t2:.2f} s)")
    print(f"main path launches: {json.dumps(counts)}")
    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(edited).all())
    moved = (edited - xts[:, 0]).abs().max().item()
    print(f"main path output {list(out.shape)} finite={finite} "
          f"max|edited - source latent| {moved:.3e}")
    if tuple(out.shape) != (N_IMAGES, 512, 512, 3) or not finite:
        failures.append("main path output is not finite [2, 512, 512, 3]")
    if min(counts.values()) <= 0:
        failures.append(f"a kernel was not launched on the main path: {counts}")
    del pipe
    torch.cuda.empty_cache()
    return counts, failures


def phase_golden():
    """README golden numerics on the card, SD-1.5 widths in float32."""
    pipe = create_sd_pipeline(tiny=False, num_inference_steps=STEPS, seed=0,
                              dtype=torch.float32, device="cuda")
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
    counts, bad = phase_main_path()
    failures += bad
    failures += phase_golden()

    def entry(name, route, source, replaces):
        mine = [r for r in rows if r[0] == name]
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": counts[name],
                "max_abs_err": max(r[1] for r in mine), "ms": mine[0][2],
                "plain_ms": mine[0][3]}

    print(json.dumps({"kernels": [
        entry("flash_attention", "cuda", "hedit_tpu_torch/csrc/flash_attention.cu",
              "hedit_tpu/ops/flash_attention.py:220"),
        entry("groupnorm", "triton", "hedit_tpu_torch/ops/groupnorm.py",
              "hedit_tpu/ops/groupnorm.py:100")]}))
    if failures:
        print("FAILED: " + "; ".join(failures))
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
