"""GroupNorm(+SiLU): a Triton kernel and its plain two-pass version.

Port of ``hedit_tpu/ops/groupnorm.py``.  The TPU kernel ``_gn_kernel``
(``group_norm_pallas``) becomes ``_group_norm_kernel`` below; the plain
version is the two-pass ``group_norm_reference``.

Layout: NCHW, contiguous, so that the (C/G) * H * W elements of one (image,
group) are one contiguous span.

What bounds it on the H100: no matrix product, about ten FLOP per element,
so it is bound by device memory (3.35 TB/s on the H100 SXM data sheet,
700 W).  The kernel runs one program per (image, group) and makes three
passes over that span: the mean, the centred sum of squares, then
normalise-affine-SiLU and store, so it reads the input three times (the
second and third mostly from L2, since a span is at most a few MB) and
writes once.  It is two-pass on purpose: the one-pass
E[x^2] - E[x]^2 of the TPU kernel drifts enough to break the 50-step
reconstruction identity at atol 1e-3.  With only B * 32 programs, the
full-resolution VAE layers (C=128 at 512x512, 1M elements a group) leave most
of the 132 SMs idle; splitting a span over several programs is the next step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hedit_tpu_torch._build import configure_triton_cache

# launches of the Triton kernel since the last reset (read by chip_smoke.py)
launches = 0

_BLOCK = 2048
_kernel = None


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         *, groups: int, eps: float = 1e-5,
                         act: Optional[str] = None) -> torch.Tensor:
    """Two-pass GroupNorm(+SiLU) over NCHW in float32, cast back to x's dtype."""
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
    return y.to(x.dtype)


def _build_kernel():
    global _kernel
    if _kernel is not None:
        return _kernel
    configure_triton_cache()
    import triton
    import triton.language as tl

    @triton.jit
    def _group_norm_kernel(x_ptr, w_ptr, b_ptr, y_ptr, span, hw, cpg, groups, eps,
                           SILU: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)                      # image * groups + group
        g = pid % groups
        base = pid.to(tl.int64) * span
        offs = tl.arange(0, BLOCK)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, span, BLOCK):
            idx = start + offs
            x = tl.load(x_ptr + base + idx, mask=idx < span, other=0.0)
            acc += x.to(tl.float32)
        mean = tl.sum(acc, axis=0) / span
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, span, BLOCK):
            idx = start + offs
            m = idx < span
            x = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            d = tl.where(m, x - mean, 0.0)
            acc += d * d
        rstd = 1.0 / tl.sqrt(tl.sum(acc, axis=0) / span + eps)
        for start in range(0, span, BLOCK):
            idx = start + offs
            m = idx < span
            x = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            c = g * cpg + idx // hw
            w = tl.load(w_ptr + c, mask=m, other=1.0).to(tl.float32)
            bb = tl.load(b_ptr + c, mask=m, other=0.0).to(tl.float32)
            y = (x - mean) * rstd * w + bb
            if SILU:
                y = y * tl.sigmoid(y)
            tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=m)

    _kernel = _group_norm_kernel
    return _kernel


def group_norm_triton(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      *, groups: int, eps: float = 1e-5,
                      act: Optional[str] = None) -> torch.Tensor:
    """Launch the Triton kernel on the current stream.  Raises on any input
    the kernel does not take."""
    global launches
    if not (x.is_cuda and weight.is_cuda and bias.is_cuda):
        raise ValueError("group_norm_triton needs CUDA tensors")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NCHW tensor")
    b, c, h, w = x.shape
    if c % groups != 0 or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"bad GroupNorm shapes x{tuple(x.shape)} groups={groups} "
                         f"weight{tuple(weight.shape)} bias{tuple(bias.shape)}")
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {x.dtype}")
    kernel = _build_kernel()
    y = torch.empty_like(x)
    cpg = c // groups
    with torch.cuda.device(x.device):
        kernel[(b * groups,)](x, weight.contiguous(), bias.contiguous(), y,
                              cpg * h * w, h * w, cpg, groups, float(eps),
                              SILU=act == "silu", BLOCK=_BLOCK, num_warps=8)
    launches += 1
    return y


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               groups: int, eps: float = 1e-5, act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(+SiLU) over NCHW: the Triton kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.is_cuda:
        return group_norm_triton(x, weight, bias, groups=groups, eps=eps, act=act)
    return group_norm_reference(x, weight, bias, groups=groups, eps=eps, act=act)


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
