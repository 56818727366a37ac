"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Port of ``hedit_tpu/ops/flash_attention.py``.  The TPU kernel
``_flash_bounded_kernel`` becomes ``csrc/flash_attention.cu`` (see the note at
the head of that file for the design and what bounds it on the H100);
``reference_attention`` stays a plain PyTorch function with the softmax in
float32.  The TPU kernel's VMEM residency rule (``flash_kv_fits``) has no
counterpart: the CUDA kernel streams K and V through shared memory and has a
tile shape for each head dimension of SD-1.5 (``HEAD_DIMS``).

``ops/attention.py:fused_attention`` routes a CUDA tensor with Sq, Sk >= 1024
to ``flash_attention_cuda`` and everything else to the plain version; the
kernel wrapper raises on anything it does not take and never falls back.
"""

from __future__ import annotations

import torch

# launches of the CUDA kernel since the last reset (read by chip_smoke.py)
launches = 0

# UNet self-attention (40, 80) and the VAE mid-block (512); others are refused
HEAD_DIMS = (40, 80, 512)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v with float32 scores and softmax.

    q [B, H, Sq, D]; k, v [B, H, Sk, D] -> [B, H, Sq, D] in q's dtype.  The
    probabilities are cast to v's dtype before the PV product, as the JAX
    oracle does."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (d ** 0.5)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Raises on any input the
    kernel does not take, and if the launch is refused."""
    global launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if d not in HEAD_DIMS or sq < 1 or sk < 1 or b * h > 65535:
        raise ValueError(f"unsupported shape q{tuple(q.shape)} k{tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    from hedit_tpu_torch._build import cuda_library

    lib = cuda_library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.hedit_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, sq, sk, d, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed (code {err}) for "
                           f"q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype}")
    launches += 1
    return out
