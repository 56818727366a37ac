"""GroupNorm(+SiLU) over channels-last activations: a CUDA kernel and its
plain two-pass version.

Port of ``hedit_tpu/ops/groupnorm.py``.  The TPU kernel ``_gn_kernel``
(``group_norm_pallas``, blocks of [HW, C]) becomes
``csrc/group_norm.cu`` (entry point ``hedit_group_norm_nhwc``, wrapper
``group_norm_cuda``); the plain version is the two-pass
``group_norm_reference``.

Layout: the models carry their activations in ``torch.channels_last``
(physically [B, H, W, C], as the JAX package's NHWC), so cuDNN's
convolutions take them without a layout transpose.  The kernel takes
exactly that layout and refuses any other: a pixel's channels are
consecutive, and every thread loads 16 bytes of them.  The plain versions
return their outputs in x's memory format.

What bounds it on the H100: no matrix product, about ten float32 operations
an element, so device memory (3.35 TB/s on the H100 SXM data sheet, 700 W).
Where an (image, group block) fits the shared memory of a thread-block
cluster (the resident regime) the kernel reads x once and writes y once;
the VAE's largest layers are streamed, x read twice (see the note at the
head of the source and ``plan``).  The statistics are two-pass in float32:
the one-pass E[x^2] - E[x]^2 of the TPU kernel drifts enough to break the
50-step reconstruction identity at atol 1e-3.

The gradient.  The TPU kernel has no backward kernel (the JAX package
differentiates its XLA form), so ``group_norm`` under a recorded gradient is a
``torch.autograd.Function`` whose forward is the kernel and whose backward is
plain tensor code (``group_norm_backward_reference``): it recomputes mean and
rstd from the saved input, so the forward saves nothing but its inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import torch
from torch import nn

# calls of the CUDA kernel since the last reset (read by chip_smoke.py), and
# of those the calls that took the streamed regime (two kernels a call)
launches = 0
launches_streamed = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The tile plan (a rule taken from a sweep of tiles on the H100, PERF.md
# section 6).  NUM_SMS is the H100 SXM's; a launch reads its card's own.
NUM_SMS = 132
SMEM_PER_CTA = 112 * 1024  # two CTAs an SM (228 KB, 1 KB a CTA reserved)
MAX_THREADS = 512
MIN_ROW_BYTES = 128        # a pixel's run of a group block, where C allows
MAX_CLUSTER = 16
MIN_GROWN_PIXELS = 128     # a small grid's clusters grow while slices keep this many
STREAM_CLUSTER, STREAM_THREADS = 4, 256


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``hedit_group_norm_nhwc`` tiles one call.  A CTA takes ``pixels``
    consecutive pixels x ``cb`` channels (whole groups) with ``threads``
    threads, a 16-byte column of channels each; ``cluster`` CTAs form a
    cluster.  Resident: the cluster covers an (image, group block).
    Streamed (``apply_pixels`` > 0): ``cb`` is all of C, the partials
    kernel writes the (mean, M2) per group of each cluster's span of
    ``cluster * pixels`` pixels, and the apply kernel takes
    ``apply_pixels`` pixels with ``apply_threads`` threads a CTA."""
    cb: int
    cluster: int
    pixels: int
    threads: int
    apply_pixels: int = 0
    apply_threads: int = 0

    @property
    def regime(self) -> str:
        return "streamed" if self.apply_pixels else "resident"

    def spans(self, hw: int) -> int:
        """Partials an image in the streamed regime."""
        return -(-hw // (self.cluster * self.pixels))


def _lanes(cb: int, elt: int, rows: int) -> int:
    """Pixels a CTA works on at once: its threads are ``cb * elt / 16``
    columns x lanes, each thread on at least two of its ``rows`` pixels."""
    return max(1, min(MAX_THREADS // (cb * elt // 16), -(-rows // 2)))


def slice_smem(pixels: int, cb: int, elt: int, lanes: int, cpg: int) -> int:
    """Shared memory of a slice CTA (``csrc/group_norm.cu:slice_smem``): the
    slice, the lanes' partials, four floats a group."""
    return (pixels * cb * elt + 15) // 16 * 16 + 4 * lanes * cb + 16 * (cb // cpg)


@functools.lru_cache(maxsize=None)
def plan(b: int, hw: int, c: int, groups: int, elt: int, sms: int = NUM_SMS) -> Plan:
    """The tile of a call on [b, c, hw] with ``elt``-byte elements.

    Resident where it fits: the smallest block of whole groups whose rows
    are at least ``MIN_ROW_BYTES`` (all of C where C is shorter), the fewest
    CTAs a cluster (at most 16) whose slices fit ``SMEM_PER_CTA``; a cluster
    of more than one CTA grown until the grid has three CTAs for every four
    SMs (at most to 16, and while a slice keeps ``MIN_GROWN_PIXELS``
    pixels).  One CTA is not grown: it skips the cluster exchanges, which
    cost ~1.5 us each on the H100.  Otherwise streamed:
    whole rows, clusters of ``STREAM_CLUSTER`` CTAs of ``STREAM_THREADS``
    threads filling ``SMEM_PER_CTA``, and one apply CTA an SM.  Raises on
    shapes the kernel does not take."""
    if c % groups or (c * elt) % 16:
        raise ValueError(f"GroupNorm kernel: C={c} must split into {groups} groups and "
                         f"rows of whole 16-byte units")
    vec, cpg = 16 // elt, c // groups
    row_min = min(MIN_ROW_BYTES, c * elt)
    cb = next((c // nb for nb in range(groups, 0, -1)
               if groups % nb == 0 and (c // nb * elt) % 16 == 0
               and c // nb * elt >= row_min and c // nb // vec <= MAX_THREADS), None)

    def fits(k):
        pixels = -(-hw // k)
        return slice_smem(pixels, cb, elt, _lanes(cb, elt, pixels), cpg) <= SMEM_PER_CTA

    k = None
    if cb is not None:
        k = next((k for k in range(1, min(MAX_CLUSTER, hw) + 1) if fits(k)), None)
    if k is not None:
        if k > 1:  # the cluster exchange is paid: spread over more of the SMs
            k = max(k, min(MAX_CLUSTER, hw // MIN_GROWN_PIXELS,
                           -(-(sms * 3 // 4) // (b * (c // cb)))))
        pixels = -(-hw // k)
        return Plan(cb, k, pixels, cb // vec * _lanes(cb, elt, pixels))
    vc = c // vec
    if vc > STREAM_THREADS or groups > 128:
        raise ValueError(f"GroupNorm kernel: C={c}, groups={groups} too large to stream")
    lanes = STREAM_THREADS // vc
    rows = (SMEM_PER_CTA - 4 * lanes * c - 16 * groups) // (c * elt) // lanes * lanes
    apply_lanes = MAX_THREADS // vc
    per_cta = -(-hw // max(1, sms // b))  # one apply CTA an SM
    step = 4 * apply_lanes  # the apply kernel's pixels a loop step
    apply_pixels = -(-per_cta // step) * step
    return Plan(c, STREAM_CLUSTER, rows, vc * lanes, apply_pixels, vc * apply_lanes)


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         *, groups: int, eps: float = 1e-5,
                         act: Optional[str] = None) -> torch.Tensor:
    """Two-pass GroupNorm(+SiLU) of [B, C, ...] in float32, cast back to x's
    dtype, in x's memory format."""
    b, c = x.shape[:2]
    x32 = x.float().reshape(b, groups, -1)
    mean = x32.mean(dim=2, keepdim=True)
    d = x32 - mean
    var = (d * d).mean(dim=2, keepdim=True)
    y = (d * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return _in_format_of(y.to(x.dtype), x)


def group_norm_backward_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                                  dy: torch.Tensor, *, groups: int, eps: float = 1e-5,
                                  act: Optional[str] = None, affine_grads: bool = True):
    """(dx, dweight, dbias) of GroupNorm(+SiLU) by the explicit formulas, in
    float32 from the saved input: with xhat = (x - mean) * rstd and
    z = xhat * w + b,  dz = dy * silu'(z),  g = dz * w,
    dx = rstd * (g - mean_group(g) - xhat * mean_group(g * xhat)),
    dweight = sum(dz * xhat),  dbias = sum(dz)  over batch and pixels;
    both None with ``affine_grads=False`` (frozen weights); dx in x's memory
    format."""
    b, c = x.shape[:2]
    shape = (1, c) + (1,) * (x.dim() - 2)
    x32 = x.float().reshape(b, groups, -1)
    mean = x32.mean(dim=2, keepdim=True)
    d = x32 - mean
    rstd = torch.rsqrt((d * d).mean(dim=2, keepdim=True) + eps)
    xhat = (d * rstd).reshape(x.shape)
    w32 = weight.float().reshape(shape)
    dz = dy.float().contiguous()  # NCHW as xhat: the same sums for every layout of dy
    if act == "silu":
        z = xhat * w32 + bias.float().reshape(shape)
        sig = torch.sigmoid(z)
        dz = dz * (sig * (1.0 + z * (1.0 - sig)))
    g = (dz * w32).reshape(b, groups, -1)
    xh = xhat.reshape(b, groups, -1)
    dx = rstd * (g - g.mean(dim=2, keepdim=True) - xh * (g * xh).mean(dim=2, keepdim=True))
    dx = _in_format_of(dx.reshape(x.shape).to(x.dtype), x)
    if not affine_grads:
        return dx, None, None
    reduce_dims = (0,) + tuple(range(2, x.dim()))
    return (dx, (dz * xhat).sum(dim=reduce_dims).to(weight.dtype),
            dz.sum(dim=reduce_dims).to(bias.dtype))


def _channels_last(t: torch.Tensor) -> bool:
    return t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)


def _in_format_of(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y in x's memory format: channels-last for a channels-last x."""
    if _channels_last(x) and not x.is_contiguous():
        return y.contiguous(memory_format=torch.channels_last)
    return y


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_entry = None


def _kernel_entry():
    global _entry
    if _entry is None:
        from hedit_tpu_torch._build import cuda_library
        _entry = cuda_library().hedit_group_norm_nhwc
    return _entry


def group_norm_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    *, groups: int, eps: float = 1e-5,
                    act: Optional[str] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: x a channels-last
    [B, C, H, W] CUDA tensor, weight and bias [C] of x's dtype (float32 or
    bfloat16), every pointer 16-byte aligned.  Raises on any other input:
    it never copies x into the layout and has no fallback."""
    global launches, launches_streamed
    if not (x.is_cuda and weight.is_cuda and bias.is_cuda):
        raise ValueError("group_norm_cuda needs CUDA tensors")
    if x.dim() != 4 or not _channels_last(x):
        raise ValueError("group_norm_cuda: x must be a channels-last [B, C, H, W] tensor "
                         "(x.contiguous(memory_format=torch.channels_last))")
    b, c, h, w = x.shape
    if groups < 1 or c % groups != 0 or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"bad GroupNorm shapes x{tuple(x.shape)} groups={groups} "
                         f"weight{tuple(weight.shape)} bias{tuple(bias.shape)}")
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    if x.dtype not in _DTYPE_CODES or weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise ValueError(f"unsupported dtypes {x.dtype}, {weight.dtype}, {bias.dtype}")
    weight, bias = weight.contiguous(), bias.contiguous()
    if any(t.data_ptr() % 16 for t in (x, weight, bias)):
        raise ValueError("group_norm_cuda: every pointer must be 16-byte aligned")
    index = x.get_device()
    tile = plan(b, h * w, c, groups, x.element_size(), _sms(index))
    y = torch.empty_like(x)
    part = (torch.empty(b * tile.spans(h * w) * groups * 2, dtype=torch.float32,
                        device=x.device) if tile.apply_pixels else None)
    with torch.cuda.device(index) if index != torch.cuda.current_device() \
            else contextlib.nullcontext():
        err = _kernel_entry()(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), b, h * w, c, groups, tile.cb,
            tile.cluster, tile.pixels, tile.threads, tile.apply_pixels, tile.apply_threads,
            float(eps), int(act == "silu"), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hedit_group_norm_nhwc failed (code {err}) for x{tuple(x.shape)} "
                           f"{x.dtype} {tile}")
    launches += 1
    launches_streamed += tile.regime == "streamed"
    return y


def _forward(x, weight, bias, groups, eps, act):
    fn = group_norm_cuda if x.is_cuda else group_norm_reference
    return fn(x, weight, bias, groups=groups, eps=eps, act=act)


class _GroupNormFn(torch.autograd.Function):
    """Forward: the CUDA kernel (CUDA) or the plain version (CPU).
    Backward: ``group_norm_backward_reference`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (groups, eps, act)
        return _forward(x, weight, bias, groups, eps, act)

    @staticmethod
    def backward(ctx, dy):
        groups, eps, act = ctx.args
        need = ctx.needs_input_grad
        dx, dw, db = group_norm_backward_reference(*ctx.saved_tensors, dy, groups=groups,
                                                   eps=eps, act=act,
                                                   affine_grads=need[1] or need[2])
        return (dx if need[0] else None, dw if need[1] else None, db if need[2] else None,
                None, None, None)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               groups: int, eps: float = 1e-5, act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(+SiLU) of a [B, C, H, W] tensor: the CUDA kernel for CUDA
    tensors (channels-last only), the plain version for CPU tensors; with a
    gradient when one is being recorded for x, weight or bias."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNormFn.apply(x, weight, bias, groups, eps, act)
    return _forward(x, weight, bias, groups, eps, act)


class FusedGroupNorm(nn.Module):
    """GroupNorm with an optional fused SiLU; parameters ``weight`` and
    ``bias`` as in ``torch.nn.GroupNorm`` (and the diffusers state_dict)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, groups=self.num_groups,
                          eps=self.eps, act=self.act)
