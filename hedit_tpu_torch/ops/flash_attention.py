"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain versions.

Port of ``hedit_tpu/ops/flash_attention.py``.

* ``flash_attention_cuda``: the forward without a gradient.  The TPU kernel
  ``_flash_bounded_kernel`` becomes ``csrc/flash_attention.cu``.
* ``flash_attention_packed_cuda``: the same forward on the packed
  projections ``[B, S, H*D]``, heads addressed in the kernel (the TPU kernel
  ``_flash_packed_kernel``): a second entry point of the same CUDA template,
  which takes the strides of both layouts.
* ``flash_attention_diff``: the forward with a gradient, a
  ``torch.autograd.Function``.  Its forward is the same CUDA template with a
  second output, the base-2 log-sum-exp of each query row (the TPU kernel
  ``_flash_bounded_lse_kernel``); its backward launches the dq and the dk / dv
  kernels of ``csrc/flash_attention_bwd.cu`` (the TPU kernels
  ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``).

The notes at the head of the two sources give the designs and what bounds
them on the H100.  Beside each kernel stands its plain PyTorch version:
``reference_attention`` (softmax in float32),
``flash_attention_packed_reference``, ``flash_attention_lse_reference`` and
``flash_attention_backward_reference`` (the backward by its explicit
formulas, not by autograd of the forward).  The TPU kernels' VMEM residency
rule (``flash_kv_fits``) has no counterpart: the CUDA kernels stream tiles
through shared memory and have a tile shape for each head dimension they
take.

``ops/attention.py`` routes a CUDA tensor by its sequence lengths, its heads
and whether a gradient is recorded to a kernel or to the plain version
(``FLASH_MIN_SEQ``); a kernel
wrapper raises on anything it does not take and never falls back.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# launches of each CUDA kernel since the last reset (read by chip_smoke.py)
launches = 0          # forward without the log-sum-exp, head-split layout
launches_packed = 0   # the same forward on packed heads
launches_lse = 0      # forward with the log-sum-exp
launches_bwd_dq = 0
launches_bwd_dkv = 0

# UNet self-attention (40, 80) and the VAE mid-block (512); others are refused
HEAD_DIMS = (40, 80, 512)
# the backward has no tile shape for the VAE's 512: nothing differentiates the VAE
BWD_HEAD_DIMS = (40, 80)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = math.log2(math.e)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v with float32 scores and softmax.

    q [B, H, Sq, D]; k, v [B, H, Sk, D] -> [B, H, Sq, D] in q's dtype.  The
    probabilities are cast to v's dtype before the PV product, as the JAX
    oracle does."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (d ** 0.5)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def flash_attention_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     heads: int) -> torch.Tensor:
    """Plain version of the packed forward: q [B, Sq, H*D], k / v [B, Sk, H*D] ->
    [B, Sq, H*D]; head h is columns h*D .. (h+1)*D of a row."""
    def split(x):
        b, s, hd = x.shape
        return x.reshape(b, s, heads, hd // heads).transpose(1, 2)

    out = reference_attention(split(q), split(k), split(v))
    return out.transpose(1, 2).reshape(q.shape)


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward with the log-sum-exp: (out [B, H, Sq, D] in
    q's dtype, lse2 [B*H, 1, Sq] float32), lse2 = log2(sum_k exp2(s2)) with
    s2 = q k^T / sqrt(d) * log2(e), all in float32."""
    b, h, sq, d = q.shape
    s2 = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (_LOG2E / d ** 0.5)
    m = s2.amax(dim=-1, keepdim=True)
    e = torch.exp2(s2 - m)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.matmul(e / l, v.float()).to(q.dtype)
    return out, (m + torch.log2(l)).reshape(b * h, 1, sq)


def flash_attention_backward_reference(q, k, v, out, lse2, do
                                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, by the formulas of the kernels (float32):
    p = exp2(s2 - lse2), dp = dO v^T, delta = rowsum(dO * out),
    ds = p * (dp - delta); dq = ds k * scale, dk = ds^T q * scale,
    dv = p^T dO.  Returns (dq, dk, dv) in the inputs' dtypes."""
    b, h, sq, d = q.shape
    scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s2 = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * _LOG2E)
    p = torch.exp2(s2 - lse2.reshape(b, h, sq, 1))
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_device_dtype(q, k, v, what: str) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what} needs CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")


def _check_qkv(q, k, v, head_dims, what: str) -> Tuple[int, int, int, int, int]:
    """Raise on anything the kernels do not take; returns (b, h, sq, sk, d)."""
    _check_device_dtype(q, k, v, what)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if d not in head_dims or sq < 1 or sk < 1 or b * h > 65535:
        raise ValueError(f"{what} does not take q{tuple(q.shape)} k{tuple(k.shape)}: "
                         f"head dim must be one of {head_dims}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    return b, h, sq, sk, d


def _launch(name: str, q: torch.Tensor, pointers, ints) -> None:
    """Call one entry point of the CUDA library on q's device and current
    stream; raise if the launch is refused."""
    from hedit_tpu_torch._build import cuda_library

    fn = getattr(cuda_library(), name)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t in pointers), *ints, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} failed (code {err}) for q{tuple(q.shape)} {q.dtype}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on the current stream.  Raises on any input
    the kernel does not take, and if the launch is refused."""
    global launches
    b, h, sq, sk, d = _check_qkv(q, k, v, HEAD_DIMS, "flash_attention_cuda")
    out = torch.empty_like(q)
    _launch("hedit_flash_attention_fwd", q, (q, k, v, out), (b * h, sq, sk, d))
    launches += 1
    return out


def _image_stride(t: torch.Tensor, name: str) -> int:
    """The batch stride of a [B, S, H*D] tensor whose every [S, H*D] image is
    dense (a batch of one has no stride to speak of); raises otherwise."""
    b, s, hd = t.shape
    if t.stride(2) != 1 or t.stride(1) != hd:
        raise ValueError(f"{name}: every [S, H*D] image must be dense, got strides {t.stride()}")
    return t.stride(0) if b > 1 else s * hd


def flash_attention_packed_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                heads: int) -> torch.Tensor:
    """Launch the forward kernel on packed heads: q [B, Sq, H*D], k / v
    [B, Sk, H*D] -> contiguous [B, Sq, H*D].  The batch rows of an input may
    lie any stride apart (a row slice of a larger batch is taken as it is).
    Raises on any input the kernel does not take, and if the launch is
    refused."""
    global launches_packed
    what = "flash_attention_packed_cuda"
    _check_device_dtype(q, k, v, what)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, S, H*D]")
    b, sq, hd = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, hd) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if (heads < 1 or hd % heads or hd // heads not in HEAD_DIMS or sq < 1 or sk < 1
            or b * heads > 65535):
        raise ValueError(f"{what} does not take q{tuple(q.shape)} k{tuple(k.shape)} with "
                         f"{heads} heads: head dim must be one of {HEAD_DIMS}")
    strides = [_image_stride(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    out = torch.empty((b, sq, hd), dtype=q.dtype, device=q.device)
    _launch("hedit_flash_attention_fwd_packed", q, (q, k, v, out),
            (b, heads, sq, sk, hd // heads, *strides))
    launches_packed += 1
    return out


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel with its second output: (out, lse2
    [B*H, 1, Sq] float32).  Raises as ``flash_attention_cuda`` does."""
    global launches_lse
    b, h, sq, sk, d = _check_qkv(q, k, v, HEAD_DIMS, "flash_attention_lse_cuda")
    out = torch.empty_like(q)
    lse2 = torch.empty((b * h, 1, sq), dtype=torch.float32, device=q.device)
    _launch("hedit_flash_attention_fwd_lse", q, (q, k, v, out, lse2), (b * h, sq, sk, d))
    launches_lse += 1
    return out, lse2


def _check_bwd(q, k, v, do, lse2, delta, what: str) -> Tuple[int, int, int, int]:
    b, h, sq, sk, d = _check_qkv(q, k, v, BWD_HEAD_DIMS, what)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_cuda or not do.is_contiguous():
        raise ValueError(f"dO must be a contiguous CUDA {q.dtype} tensor of q's shape, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse2", lse2), ("delta", delta)):
        if (t.numel() != b * h * sq or t.dtype != torch.float32 or not t.is_cuda
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA float32 tensor of "
                             f"{b * h * sq} elements, got {tuple(t.shape)} {t.dtype}")
    return b * h, sq, sk, d


def flash_bwd_dq_cuda(q, k, v, do, lse2, delta) -> torch.Tensor:
    """Launch the dq kernel.  lse2 and delta = rowsum(dO * out) hold one
    float32 per (batch, head, query).  Raises on what the kernel does not take
    (among it head dim 512)."""
    global launches_bwd_dq
    dims = _check_bwd(q, k, v, do, lse2, delta, "flash_bwd_dq_cuda")
    dq = torch.empty_like(q)
    _launch("hedit_flash_attention_bwd_dq", q, (q, k, v, do, lse2, delta, dq), dims)
    launches_bwd_dq += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse2, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk / dv kernel; arguments as ``flash_bwd_dq_cuda``."""
    global launches_bwd_dkv
    dims = _check_bwd(q, k, v, do, lse2, delta, "flash_bwd_dkv_cuda")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("hedit_flash_attention_bwd_dkv", q, (q, k, v, do, lse2, delta, dk, dv), dims)
    launches_bwd_dkv += 1
    return dk, dv


def flash_attention_backward_cuda(q, k, v, out, lse2, do
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the two backward kernels; delta = rowsum(dO * out) is
    plain tensor code, as in the JAX package."""
    do = do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse2, delta)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse2, delta)
    return dq, dk, dv


class _FlashAttentionDiff(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse2); backward rebuilds the probabilities
    from lse2.  CUDA tensors launch the kernels, CPU tensors take the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v):
        fwd = flash_attention_lse_cuda if q.is_cuda else flash_attention_lse_reference
        out, lse2 = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse2)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse2 = ctx.saved_tensors
        bwd = flash_attention_backward_cuda if q.is_cuda else flash_attention_backward_reference
        return bwd(q, k, v, out, lse2, do)


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention with a gradient through the flash kernels (port of
    ``flash_attention_diff``): q [B, H, Sq, D], k / v [B, H, Sk, D] ->
    [B, H, Sq, D].  On CUDA tensors D must be 40 or 80 by the time the
    backward runs."""
    return _FlashAttentionDiff.apply(q, k, v)
