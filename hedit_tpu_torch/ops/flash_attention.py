"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain versions.

Port of ``hedit_tpu/ops/flash_attention.py``.  Two CUDA forward sources:

* ``csrc/flash_attention_tc.cu``: the **bounded** (max-free) forward in
  bfloat16 on the tensor cores (``mma.sync``), the TPU kernel
  ``_flash_bounded_kernel`` as every bf16 path runs it.  Each query row's
  shift is anchored on the first ``anchor`` keys (``bounded_anchor``: the key
  block the JAX wrapper picks at that shape), ``shift = m0 + 16`` in base-2
  units, and every key contributes ``p = exp2(min(s - shift, 100))`` with no
  running max and no rescale; the denominator is floored at ``1.2e-38``.
* ``csrc/flash_attention.cu``: one CUDA-core template (float32 FMAs) that
  serves the same bounded forward for **float32** inputs, the bounded
  forward with the log-sum-exp (``_flash_bounded_lse_kernel``, either
  dtype), and the **exact** mode (running max and rescale: the TPU kernels
  ``_flash_kernel`` and ``_flash_packed_kernel``, on no path of either
  package).

The wrappers:

* ``flash_attention_cuda``: the bounded forward without a gradient,
  head-split (the VAE's one-head attention on the paths);
* ``flash_attention_packed_bounded_cuda``: the same forward on the packed
  projections ``[B, S, H*D]``, heads addressed in the kernel: every UNet
  self-attention without a gradient on the paths (JAX sends those to
  ``flash_attention_diff``, whose primal is ``_flash_bounded_kernel``).
  Both send a bf16 CUDA input to the tensor-core kernel and a float32 one to
  the CUDA-core template (``bounded_entry``); the tensor-core kernel's
  operands must pass ``check_tc_operands``;
* ``flash_attention_lse_cuda``: the bounded forward with the base-2
  log-sum-exp ``lse2 = shift + log2(denom)`` of each row (CUDA-core
  template), the forward of ``flash_attention_diff``, whose backward launches
  a dq and a dk / dv kernel (the TPU kernels ``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel``; ``flash_bwd_dq_cuda``, ``flash_bwd_dkv_cuda``):
  bf16 at the UNet's head dims on the tensor cores
  (``csrc/flash_attention_bwd_tc.cu``), float32 and the VAE's d = 512 on the
  CUDA-core template (``csrc/flash_attention_bwd.cu``), by ``bwd_entry``;
* ``flash_attention_exact_cuda`` (head-split) and
  ``flash_attention_packed_cuda`` (packed heads): the exact mode.

The two modes agree wherever no key scores more than 116 log2 units above
its row's anchor maximum; beyond that the bounded form saturates those keys
at 2^100 as the TPU kernel does.

The notes at the head of the sources give the designs and what bounds
them on the H100.  Beside each kernel stands its plain PyTorch version
(the bounded and the head-split exact forward wrappers take theirs for CPU
tensors): ``flash_attention_bounded_reference``,
``flash_attention_lse_reference`` and
``flash_attention_packed_bounded_reference`` (bounded, JAX's arithmetic
step by step), ``reference_attention`` (exact, softmax in float32),
``flash_attention_packed_reference`` and
``flash_attention_backward_reference`` (the backward by its explicit
formulas, not by autograd of the forward).  The TPU kernels' VMEM residency
rule (``flash_kv_fits``) has no counterpart: the CUDA kernels stream tiles
through shared memory and have a tile shape for each head dimension they
take.

``ops/attention.py`` routes a CUDA tensor by its sequence lengths, its heads
and whether a gradient is recorded to a kernel or to the plain version
(``FLASH_MIN_SEQ``); a kernel wrapper raises on any CUDA input it does not
take and never falls back.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# launches of each CUDA kernel since the last reset (read by chip_smoke.py)
launches = 0          # bounded forward without the log-sum-exp, head-split, CUDA cores
launches_tc = 0       # the same in bf16 on the tensor cores
launches_exact = 0    # exact forward, head-split
launches_packed = 0   # exact forward on packed heads
launches_packed_bounded = 0      # bounded forward on packed heads, CUDA cores
launches_packed_bounded_tc = 0   # the same in bf16 on the tensor cores
launches_lse = 0      # bounded forward with the log-sum-exp
launches_bwd_dq = 0      # backward dq, CUDA cores (float32; bf16 at d = 512)
launches_bwd_dkv = 0     # backward dk / dv, CUDA cores
launches_bwd_dq_tc = 0   # backward dq in bf16 on the tensor cores (d = 40, 80)
launches_bwd_dkv_tc = 0  # backward dk / dv in bf16 on the tensor cores

# UNet self-attention (40, 80) and the VAE mid-block (512); others are refused
HEAD_DIMS = (40, 80, 512)
# the backward's: the same, the VAE's 512 with a tile of its own (the style
# reward differentiates through the decoder's mid-block attention)
BWD_HEAD_DIMS = (40, 80, 512)
# the head dims of the bf16 backward on the tensor cores
# (``csrc/flash_attention_bwd_tc.cu``); d = 512 stays on the template
TC_BWD_HEAD_DIMS = (40, 80)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = math.log2(math.e)
DENOM_FLOOR = 1.2e-38
# the tensor-core kernel copies 16 bytes at a time (cp.async): every operand's
# address a multiple of 16 bytes, every element stride a multiple of 8
TC_ALIGN_BYTES = 16
TC_STRIDE_MULTIPLE = 8


def bounded_entry(dtype: torch.dtype, packed: bool) -> str:
    """The CUDA entry point of the bounded forward for an input of ``dtype``
    (head-split or ``packed`` heads): bfloat16 the tensor-core kernel
    (``csrc/flash_attention_tc.cu``), float32 the CUDA-core template
    (``csrc/flash_attention.cu``).  Raises for any other dtype."""
    if dtype == torch.bfloat16:
        return ("hedit_flash_attention_fwd_packed_bounded_tc" if packed
                else "hedit_flash_attention_fwd_tc")
    if dtype == torch.float32:
        return ("hedit_flash_attention_fwd_packed_bounded" if packed
                else "hedit_flash_attention_fwd")
    raise ValueError(f"the bounded forward takes float32 or bfloat16, got {dtype}")


def bwd_entry(dtype: torch.dtype, d: int) -> Tuple[str, str]:
    """The CUDA entry points (dq, dk / dv) of the backward for an input of
    ``dtype`` and head dim ``d``: bfloat16 at ``TC_BWD_HEAD_DIMS`` the
    tensor-core kernels (``csrc/flash_attention_bwd_tc.cu``); float32, and
    bfloat16 at the VAE's 512, the CUDA-core template
    (``csrc/flash_attention_bwd.cu``).  Raises for any other dtype or head
    dim."""
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward takes head dims {BWD_HEAD_DIMS}, got {d}")
    if dtype == torch.bfloat16 and d in TC_BWD_HEAD_DIMS:
        return "hedit_flash_attention_bwd_dq_tc", "hedit_flash_attention_bwd_dkv_tc"
    if dtype in (torch.float32, torch.bfloat16):
        return "hedit_flash_attention_bwd_dq", "hedit_flash_attention_bwd_dkv"
    raise ValueError(f"the backward takes float32 or bfloat16, got {dtype}")


def check_tc_operands(d: int, addresses, strides) -> None:
    """Raise unless a tensor-core kernel takes these operands: head dim
    ``d`` one of ``HEAD_DIMS``, every address (``data_ptr()``) a multiple of
    ``TC_ALIGN_BYTES`` and every element stride a multiple of
    ``TC_STRIDE_MULTIPLE``.  The kernels refuse the same; the wrappers raise
    first, and never fall back to the CUDA-core template."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the tensor-core kernels take head dims {HEAD_DIMS}, got {d}")
    bad = [a for a in addresses if a % TC_ALIGN_BYTES]
    if bad:
        raise ValueError(f"the tensor-core kernels need {TC_ALIGN_BYTES}-byte aligned "
                         f"operands, got addresses {[hex(a) for a in bad]}")
    bad = [s for s in strides if s % TC_STRIDE_MULTIPLE]
    if bad:
        raise ValueError(f"the tensor-core kernels need element strides that are multiples "
                         f"of {TC_STRIDE_MULTIPLE}, got {bad}")


def bounded_anchor(sk: int, d: int) -> int:
    """The bounded forward's anchor window: the key block ``blk_k`` that the
    JAX wrappers pick at this shape with their default blocks
    (``_shrink_blocks``, then ``min(blk_k, max(128, Sk))``): 512 keys for the
    UNet's head dims, 1024 above d = 128 (the VAE's 512).  The shift of each
    query row is anchored on its first ``min(anchor, Sk)`` keys, so the
    saturation falls on the same keys as on the TPU."""
    return min(1024 if d > 128 else 512, max(128, sk))


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v with float32 scores and softmax: the exact
    form, plain version of the exact kernels.

    q [B, H, Sq, D]; k, v [B, H, Sk, D] -> [B, H, Sq, D] in q's dtype.  The
    probabilities are cast to v's dtype before the PV product, as the JAX
    oracle does."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (d ** 0.5)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def _bounded(q, k, v, anchor, out_dtype=None):
    """(out [B, H, Sq, D] in ``out_dtype``, default q's dtype; lse2 [B, H, Sq]
    float32) of the bounded forward, in the TPU kernel's arithmetic: q scaled
    by sm_scale * log2(e) in the input dtype, scores in float32, the shift
    from the first ``anchor`` keys, p cast to the input dtype before both the
    PV product and the denominator (the TPU kernel sums p through a
    ones-column of v)."""
    d, sk = q.shape[-1], k.shape[-2]
    anchor = bounded_anchor(sk, d) if anchor is None else anchor
    qs = q * torch.tensor(1.0 / d ** 0.5 * _LOG2E, dtype=q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    shift = s[..., :min(anchor, sk)].amax(dim=-1, keepdim=True) + 16.0
    p = torch.exp2(torch.clamp(s - shift, max=100.0)).to(v.dtype).float()
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=DENOM_FLOOR)
    out = (torch.matmul(p, v.float()) / denom).to(out_dtype or q.dtype)
    return out, (shift + torch.log2(denom))[..., 0]


def flash_attention_bounded_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      anchor: Optional[int] = None,
                                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of the bounded forward (``_flash_bounded_kernel``):
    q [B, H, Sq, D], k / v [B, H, Sk, D] -> [B, H, Sq, D] in q's dtype, or
    in ``out_dtype`` (float32: the output before its final rounding).
    ``anchor`` defaults to ``bounded_anchor(Sk, D)``."""
    return _bounded(q, k, v, anchor, out_dtype)[0]


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  anchor: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the bounded forward with the log-sum-exp
    (``_flash_bounded_lse_kernel``): (out [B, H, Sq, D] in q's dtype, lse2
    [B*H, 1, Sq] float32), lse2 = shift + log2(denom) in base-2 units of the
    scaled scores.  ``anchor`` as ``flash_attention_bounded_reference``."""
    b, h, sq, _ = q.shape
    out, lse2 = _bounded(q, k, v, anchor)
    return out, lse2.reshape(b * h, 1, sq)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def flash_attention_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     heads: int) -> torch.Tensor:
    """Plain version of the packed forward: q [B, Sq, H*D], k / v [B, Sk, H*D] ->
    [B, Sq, H*D]; head h is columns h*D .. (h+1)*D of a row."""
    return _merge_heads(reference_attention(_split_heads(q, heads), _split_heads(k, heads),
                                            _split_heads(v, heads)))


def flash_attention_packed_bounded_reference(q: torch.Tensor, k: torch.Tensor,
                                             v: torch.Tensor, heads: int,
                                             anchor: Optional[int] = None,
                                             out_dtype: Optional[torch.dtype] = None
                                             ) -> torch.Tensor:
    """Plain version of the bounded forward on packed heads: q [B, Sq, H*D],
    k / v [B, Sk, H*D] -> [B, Sq, H*D] in q's dtype (or ``out_dtype``); the
    heads split, the bounded forward (``anchor`` as
    ``flash_attention_bounded_reference``), the heads merged."""
    out = _bounded(_split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads),
                   anchor, out_dtype)[0]
    return _merge_heads(out)


def flash_attention_backward_reference(q, k, v, out, lse2, do,
                                       out_dtype: Optional[torch.dtype] = None
                                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, by the formulas of the kernels:
    p = exp2(s2 - lse2), dp = dO v^T, delta = rowsum(dO * out),
    ds = p * (dp - delta); dq = ds k * scale, dk = ds^T q * scale,
    dv = p^T dO.  Returns (dq, dk, dv) in the inputs' dtypes, or in
    ``out_dtype`` (float32: the outputs before their final rounding).

    float32 inputs: float32 throughout.  bfloat16 inputs take the roundings
    of the TPU kernels ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``:
    the dq side scores ``qs k`` with qs = q * c rounded to bf16 (c = scale *
    log2(e) rounded to bf16 first, as the forward forms it), the dk / dv side
    ``q ks`` with ks = k * c rounded likewise, so the two sides see
    differently rounded scores; ds is rounded to bf16 on each side before
    its product, p to bf16 for ``p^T dO`` only; products of bf16 values sum
    in float32."""
    b, h, sq, d = q.shape
    scale = 1.0 / d ** 0.5
    lse = lse2.reshape(b, h, sq, 1)
    dof = do.float()
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    qf, kf = q.float(), k.float()
    if q.dtype == torch.bfloat16:
        c = torch.tensor(scale * _LOG2E, dtype=q.dtype)
        p_q = torch.exp2(torch.matmul((q * c).float(), kf.transpose(-1, -2)) - lse)  # dq side
        p_k = torch.exp2(torch.matmul(qf, (k * c).float().transpose(-1, -2)) - lse)  # dk / dv
        ds_q = (p_q * (dp - delta)).to(q.dtype).float()
        ds_k = (p_k * (dp - delta)).to(q.dtype).float()
        p_v = p_k.to(q.dtype).float()
    else:
        p_v = torch.exp2(torch.matmul(qf, kf.transpose(-1, -2)) * (scale * _LOG2E) - lse)
        ds_q = ds_k = p_v * (dp - delta)
    dq = torch.matmul(ds_q, kf) * scale
    dk = torch.matmul(ds_k.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p_v.transpose(-1, -2), dof)
    return tuple(t.to(out_dtype or x.dtype) for t, x in ((dq, q), (dk, k), (dv, v)))


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


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
    """The bounded forward: a CPU tensor takes the plain version, a CUDA
    tensor launches the kernel of ``bounded_entry`` on the current stream
    with the anchor of ``bounded_anchor``.  Raises on any CUDA input the
    kernel does not take, and if the launch is refused."""
    global launches, launches_tc
    if _on_cpu(q, k, v):
        return flash_attention_bounded_reference(q, k, v)
    b, h, sq, sk, d = _check_qkv(q, k, v, HEAD_DIMS, "flash_attention_cuda")
    out = torch.empty_like(q)
    entry = bounded_entry(q.dtype, packed=False)
    tc = entry.endswith("_tc")
    if tc:
        check_tc_operands(d, [t.data_ptr() for t in (q, k, v, out)], [sq * d, sk * d, d])
    _launch(entry, q, (q, k, v, out), (b * h, sq, sk, d, bounded_anchor(sk, d)))
    if tc:
        launches_tc += 1
    else:
        launches += 1
    return out


def flash_attention_exact_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                               ) -> torch.Tensor:
    """The exact forward (running max and rescale; the TPU kernel
    ``_flash_kernel`` of JAX's public ``flash_attention``): a CPU tensor takes
    ``reference_attention``, a CUDA tensor launches the kernel.  Raises as
    ``flash_attention_cuda`` does."""
    global launches_exact
    if _on_cpu(q, k, v):
        return reference_attention(q, k, v)
    b, h, sq, sk, d = _check_qkv(q, k, v, HEAD_DIMS, "flash_attention_exact_cuda")
    out = torch.empty_like(q)
    _launch("hedit_flash_attention_fwd_exact", q, (q, k, v, out), (b * h, sq, sk, d))
    launches_exact += 1
    return out


def _image_stride(t: torch.Tensor, name: str) -> int:
    """The batch stride of a [B, S, H*D] tensor whose every [S, H*D] image is
    dense (a batch of one has no stride to speak of); raises otherwise."""
    b, s, hd = t.shape
    if t.stride(2) != 1 or t.stride(1) != hd:
        raise ValueError(f"{name}: every [S, H*D] image must be dense, got strides {t.stride()}")
    return t.stride(0) if b > 1 else s * hd


def _check_packed(q, k, v, heads: int, what: str):
    """Raise on packed inputs the kernels do not take; returns the entry
    points' integer arguments (b, h, sq, sk, d, batch strides of q, k, v)."""
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
    return b, heads, sq, sk, hd // heads, *strides


def flash_attention_packed_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                heads: int) -> torch.Tensor:
    """Launch the exact forward kernel on packed heads: q [B, Sq, H*D], k / v
    [B, Sk, H*D] -> contiguous [B, Sq, H*D].  The batch rows of an input may
    lie any stride apart (a row slice of a larger batch is taken as it is).
    Raises on any input the kernel does not take, and if the launch is
    refused."""
    global launches_packed
    b, h, sq, sk, d, *strides = _check_packed(q, k, v, heads, "flash_attention_packed_cuda")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("hedit_flash_attention_fwd_packed", q, (q, k, v, out), (b, h, sq, sk, d, *strides))
    launches_packed += 1
    return out


def flash_attention_packed_bounded_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                        heads: int, anchor: Optional[int] = None
                                        ) -> torch.Tensor:
    """The bounded forward on packed heads, layouts as
    ``flash_attention_packed_cuda``: a CPU tensor takes
    ``flash_attention_packed_bounded_reference``, a CUDA tensor launches the
    kernel of ``bounded_entry`` with ``anchor`` (default
    ``bounded_anchor(Sk, D)``).  Raises on any CUDA input the kernel does not
    take, and if the launch is refused."""
    global launches_packed_bounded, launches_packed_bounded_tc
    if _on_cpu(q, k, v):
        return flash_attention_packed_bounded_reference(q, k, v, heads, anchor)
    b, h, sq, sk, d, *strides = _check_packed(q, k, v, heads,
                                              "flash_attention_packed_bounded_cuda")
    anchor = bounded_anchor(sk, d) if anchor is None else anchor
    if anchor < 1:
        raise ValueError(f"anchor must be positive, got {anchor}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    entry = bounded_entry(q.dtype, packed=True)
    tc = entry.endswith("_tc")
    if tc:
        check_tc_operands(d, [t.data_ptr() for t in (q, k, v, out)], [h * d, *strides])
    _launch(entry, q, (q, k, v, out), (b, h, sq, sk, d, anchor, *strides))
    if tc:
        launches_packed_bounded_tc += 1
    else:
        launches_packed_bounded += 1
    return out


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bounded forward with its second output: (out, lse2 [B*H, 1, Sq]
    float32).  CPU tensors take ``flash_attention_lse_reference``; otherwise
    as ``flash_attention_cuda``."""
    global launches_lse
    if _on_cpu(q, k, v):
        return flash_attention_lse_reference(q, k, v)
    b, h, sq, sk, d = _check_qkv(q, k, v, HEAD_DIMS, "flash_attention_lse_cuda")
    out = torch.empty_like(q)
    lse2 = torch.empty((b * h, 1, sq), dtype=torch.float32, device=q.device)
    _launch("hedit_flash_attention_fwd_lse", q, (q, k, v, out, lse2),
            (b * h, sq, sk, d, bounded_anchor(sk, d)))
    launches_lse += 1
    return out, lse2


def _check_bwd(q, k, v, do, lse2, delta, what: str) -> Tuple[int, int, int, int]:
    """Raise on what the backward kernels do not take; returns (bh, sq, sk, d)."""
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


def _bwd_launch(part: int, q, k, v, do, lse2, delta, outs, what: str) -> bool:
    """Launch backward kernel ``part`` (0 dq, 1 dk / dv) of ``bwd_entry`` into
    ``outs``; the tensor-core one only on operands that pass
    ``check_tc_operands``.  Returns whether it was the tensor-core one."""
    bh, sq, sk, d = _check_bwd(q, k, v, do, lse2, delta, what)
    entry = bwd_entry(q.dtype, d)[part]
    tc = entry.endswith("_tc")
    if tc:
        check_tc_operands(d, [t.data_ptr() for t in (q, k, v, do, *outs)], [sq * d, sk * d, d])
    _launch(entry, q, (q, k, v, do, lse2, delta, *outs), (bh, sq, sk, d))
    return tc


def flash_bwd_dq_cuda(q, k, v, do, lse2, delta) -> torch.Tensor:
    """Launch the dq kernel of ``bwd_entry``.  lse2 and delta = rowsum(dO *
    out) hold one float32 per (batch, head, query).  Raises on what the
    kernel does not take."""
    global launches_bwd_dq, launches_bwd_dq_tc
    dq = torch.empty_like(q)
    if _bwd_launch(0, q, k, v, do, lse2, delta, (dq,), "flash_bwd_dq_cuda"):
        launches_bwd_dq_tc += 1
    else:
        launches_bwd_dq += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse2, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk / dv kernel of ``bwd_entry``; arguments as
    ``flash_bwd_dq_cuda``."""
    global launches_bwd_dkv, launches_bwd_dkv_tc
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _bwd_launch(1, q, k, v, do, lse2, delta, (dk, dv), "flash_bwd_dkv_cuda"):
        launches_bwd_dkv_tc += 1
    else:
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
    """Forward (bounded) saves (q, k, v, out, lse2); backward rebuilds the
    probabilities from lse2.  CUDA tensors launch the kernels, CPU tensors
    take the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse2 = flash_attention_lse_cuda(q, k, v)
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
    [B, H, Sq, D].  On CUDA tensors D is one of ``BWD_HEAD_DIMS``."""
    return _FlashAttentionDiff.apply(q, k, v)
