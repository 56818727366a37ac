"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain versions.

Port of ``hedit_tpu/ops/flash_attention.py``.  Four CUDA forward sources:

* ``csrc/flash_attention_tc.cu``: the forwards in bfloat16 on the tensor
  cores (``mma.sync``).  The **bounded** (max-free) mode: the TPU kernels
  ``_flash_bounded_kernel`` and, with the base-2 log-sum-exp as a second
  output, ``_flash_bounded_lse_kernel``, as every bf16 path runs them.  Each
  query row's shift is anchored on the first ``anchor`` keys
  (``bounded_anchor``: the key block the JAX wrapper picks at that shape),
  ``shift = m0 + 16`` in base-2 units, and every key contributes
  ``p = exp2(min(s - shift, 100))`` with no running max and no rescale; the
  denominator is floored at ``1.2e-38``.  The **exact** mode (a running max
  over key tiles of ``exact_key_tile(D)`` and the rescale: the TPU kernels
  ``_flash_kernel`` and ``_flash_packed_kernel``, on no path of either
  package), with their bf16 roundings of q * scale and p.
* ``csrc/flash_attention_f32.cu``: both modes (bounded with or without the
  log-sum-exp, and exact) in **float32** at the UNet's head dims 40 and 80
  (``F32_HEAD_DIMS``), the CLIs' default precision, on the CUDA cores
  (float32 FMAs): the bounded mode's anchor window scored once and kept on
  chip, as the TPU kernel keeps block 0's; the exact mode's running max
  taken over 64-key tiles.
* ``csrc/flash_attention_f32_512.cu``: both modes (bounded with or without
  the log-sum-exp, and exact) in **float32** at the VAE's d = 512, on the
  CUDA cores: a thread-block cluster shares a block of query rows and
  splits the keys, the anchor window's scores computed once and kept on
  chip, the CTAs' partial results combined in a fixed order.
* ``csrc/flash_attention.cu``: the first CUDA-core template (float32 FMAs),
  reached by no wrapper: the probes and ``chip_smoke.py`` time it by its
  entry points beside the kernels that took its place.

The wrappers:

* ``flash_attention_cuda``: the bounded forward without a gradient,
  head-split (the VAE's one-head attention on the paths);
* ``flash_attention_packed_bounded_cuda``: the same forward on the packed
  projections ``[B, S, H*D]``, heads addressed in the kernel: every UNet
  self-attention without a gradient on the paths (JAX sends those to
  ``flash_attention_diff``, whose primal is ``_flash_bounded_kernel``).
  Both send a bf16 CUDA input to the tensor-core kernel, a float32 one at
  d = 40 / 80 to ``csrc/flash_attention_f32.cu`` and at d = 512 to
  ``csrc/flash_attention_f32_512.cu`` (``bounded_entry``); the tensor-core
  kernel's operands must pass ``check_tc_operands``, the float32 kernels'
  ``check_f32_operands``;
* ``flash_attention_lse_cuda``: the bounded forward with the base-2
  log-sum-exp ``lse2 = shift + log2(denom)`` of each row (bf16 on the tensor
  cores, float32 at d = 40 / 80 on ``csrc/flash_attention_f32.cu``, at
  d = 512 on ``csrc/flash_attention_f32_512.cu``, by ``lse_entry``), the
  forward of
  ``flash_attention_diff``.  Its backward (``flash_diff_backward``) routes
  as JAX's ``_flash_diff_bwd`` does on the TPU: where the K/V pairs fit
  ``flash_kv_fits`` and both lengths reach ``_BWD_MIN_SEQ``, a dq and a
  dk / dv kernel (the TPU kernels ``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel``; ``flash_bwd_dq_cuda``, ``flash_bwd_dkv_cuda``:
  bf16 on the tensor cores, ``csrc/flash_attention_bwd_tc.cu``, at the
  UNet's head dims and at the VAE's d = 512 (the style reward's route
  through the decode)), or, for float32 at d = 40 / 80, one fused dq / dk /
  dv kernel on the CUDA cores (``flash_bwd_f32_cuda``,
  ``csrc/flash_attention_bwd_f32.cu``), or, for float32 at d = 512, a dk /
  dv kernel that also stores ds and a dq product over it, on the CUDA cores
  (``flash_bwd_f32_512_cuda``, ``csrc/flash_attention_bwd_f32_512.cu``), as
  ``bwd_entry`` names them; elsewhere the gradient of
  ``reference_attention`` by autograd;
* ``flash_attention_exact_cuda`` (head-split) and
  ``flash_attention_packed_cuda`` (packed heads): the exact mode (bf16 on
  the tensor cores, whose operands must pass ``check_tc_operands``, float32
  at d = 40 / 80 on ``csrc/flash_attention_f32.cu``, at d = 512 on
  ``csrc/flash_attention_f32_512.cu``, whose operands must pass
  ``check_f32_operands``, by ``exact_entry``).

The two modes agree wherever no key scores more than 116 log2 units above
its row's anchor maximum; beyond that the bounded form saturates those keys
at 2^100 as the TPU kernel does.

The notes at the head of the sources give the designs and what bounds
them on the H100.  Beside each kernel stands its plain PyTorch version
(the forward wrappers take theirs for CPU tensors):
``flash_attention_bounded_reference``, ``flash_attention_lse_reference``
and ``flash_attention_packed_bounded_reference`` (bounded, JAX's arithmetic
step by step), ``flash_attention_exact_reference`` and
``flash_attention_packed_exact_reference`` (exact, JAX's arithmetic step
by step over key blocks of the kernel's tile) and
``flash_attention_backward_reference`` (the backward by its explicit
formulas, not by autograd of the forward).  ``reference_attention`` (and
``flash_attention_packed_reference`` on packed heads) is JAX's
``reference_attention``: the route of every attention that takes no
kernel, and the oracle.

``ops/attention.py`` routes a CUDA tensor to a kernel exactly where the JAX
package takes a Pallas kernel on the TPU (``FLASH_MIN_SEQ`` and
``flash_kv_fits``), and everything else to ``reference_attention``; a kernel
wrapper raises on any CUDA input it does not take and never falls back.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# launches of each CUDA kernel since the last reset (read by chip_smoke.py)
launches = 0          # bounded forward without the log-sum-exp, head-split, template (on no path)
launches_tc = 0       # the same in bf16 on the tensor cores
launches_exact = 0    # exact forward, head-split, CUDA-core template (on no path)
launches_exact_tc = 0   # the same in bf16 on the tensor cores
launches_packed = 0   # exact forward on packed heads, CUDA-core template (on no path)
launches_packed_tc = 0  # the same in bf16 on the tensor cores
launches_packed_bounded = 0      # bounded forward on packed heads, template
launches_packed_bounded_tc = 0   # the same in bf16 on the tensor cores
launches_lse = 0      # bounded forward with the log-sum-exp, template (on no path)
launches_lse_tc = 0   # the same in bf16 on the tensor cores
launches_f32 = 0                  # bounded forward, head-split, float32 at d = 40 / 80
launches_packed_bounded_f32 = 0   # the same on packed heads
launches_lse_f32 = 0              # the same with the log-sum-exp
launches_exact_f32 = 0            # exact forward, head-split, float32 at d = 40 / 80
launches_packed_f32 = 0           # the same on packed heads
launches_f32_512 = 0              # bounded forward, head-split, float32 at d = 512
launches_packed_bounded_f32_512 = 0   # the same on packed heads
launches_lse_f32_512 = 0          # the same with the log-sum-exp
launches_exact_f32_512 = 0        # exact forward, head-split, float32 at d = 512
launches_packed_f32_512 = 0       # the same on packed heads
launches_bwd_dq = 0      # backward dq, CUDA-core template (on no path)
launches_bwd_dkv = 0     # backward dk / dv, CUDA-core template (on no path)
launches_bwd_f32 = 0     # backward dq, dk and dv in one kernel, float32 at d = 40 / 80
launches_bwd_f32_512 = 0  # backward dk / dv with ds, then dq, float32 at d = 512
launches_bwd_dq_tc = 0   # backward dq in bf16 on the tensor cores (d = 40, 80, 512)
launches_bwd_dkv_tc = 0  # backward dk / dv in bf16 on the tensor cores

# UNet self-attention (40, 80) and the VAE mid-block (512); others are refused
HEAD_DIMS = (40, 80, 512)
# the backward's: the same, the VAE's 512 with a tile of its own (the style
# reward differentiates through the decoder's mid-block attention)
BWD_HEAD_DIMS = (40, 80, 512)
# the head dims of the bf16 backward on the tensor cores
# (``csrc/flash_attention_bwd_tc.cu``): all three
TC_BWD_HEAD_DIMS = (40, 80, 512)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = math.log2(math.e)
DENOM_FLOOR = 1.2e-38
# the tensor-core kernel copies 16 bytes at a time (cp.async): every operand's
# address a multiple of 16 bytes, every element stride a multiple of 8
TC_ALIGN_BYTES = 16
TC_STRIDE_MULTIPLE = 8
# the float32 forward at the UNet's head dims (``csrc/flash_attention_f32.cu``,
# both modes) and the fused float32 backward's; float32 at the VAE's 512 has a forward
# of its own (``csrc/flash_attention_f32_512.cu``, both modes, entry points
# ending in ``F32_512_SUFFIX``) and a backward of its own
# (``csrc/flash_attention_bwd_f32_512.cu``).  The float32 forwards and
# backwards copy rows 16 bytes at a time (every operand's address a
# multiple of 16 bytes, every element stride a multiple of 4) and keep at
# most ``F32_WINDOWS[d]`` anchor keys on chip: the anchor window of
# ``bounded_anchor`` at that head dim, 512 keys at 40 / 80 and 1024 at 512.
F32_HEAD_DIMS = (40, 80)
F32_ALIGN_BYTES = 16
F32_STRIDE_MULTIPLE = 4
F32_WINDOWS = {40: 512, 80: 512, 512: 1024}
F32_512_SUFFIX = "_f32_512"
# the float32 d = 512 kernel's key tile: its exact mode's running max is
# taken over tiles of this many keys
F32_512_KEY_TILE = 128
# the fused float32 backward at ``F32_HEAD_DIMS`` (``csrc/flash_attention_bwd_f32.cu``):
# one entry point writes dq, dk and dv; its operands as the forward's
F32_BWD_ENTRY = "hedit_flash_attention_bwd_f32"
# the float32 backward at d = 512 (``csrc/flash_attention_bwd_f32_512.cu``),
# (dq, dk / dv) as ``bwd_entry`` orders them: the dk / dv entry runs first and
# also stores ds into a workspace (``bwd_f32_512_workspace``), which the dq
# entry's product reads
F32_512_BWD_ENTRIES = ("hedit_flash_attention_bwd_dq_f32_512",
                       "hedit_flash_attention_bwd_dkv_f32_512")
# the head dims of the float32 backward kernels (``check_f32_bwd_operands``)
F32_BWD_HEAD_DIMS = F32_HEAD_DIMS + (512,)

# JAX's K/V residency budget and its backward threshold, copied with their
# names and values (``hedit_tpu/ops/flash_attention.py``; the port imports
# nothing of the JAX package, ``tests/test_torch_flash_routing.py`` holds the
# copies to the originals).
FLASH_KV_BUDGET_BYTES = 8 * 1024 * 1024
_BWD_MIN_SEQ = 2048


def flash_kv_fits(sk: int, d: int, itemsize: int) -> bool:
    """Whether a [*, Sk, D] K/V pair of this dtype fits the TPU kernels' VMEM
    residency budget, charged on Sk padded to 1024 keys: JAX's routing
    predicate, copied.

    The card has no VMEM, and its kernels stream K and V through shared
    memory at any length; the budget is kept because it decides which
    *function* a call computes, not only where its data lives.  Where it
    fails, the JAX package computes exact ``reference_attention`` (forward)
    or its gradient (backward), where it holds the bounded kernels' function;
    a port that routed by its own memory would compute something else (the
    VAE's float32 mid-block attention, [*, 1, 4096, 512], 16 MiB of K/V:
    bounded on the card against exact on the TPU)."""
    sk_padded = -(-sk // 1024) * 1024
    return 2 * sk_padded * d * itemsize <= FLASH_KV_BUDGET_BYTES


def bwd_takes_kernels(sq: int, sk: int, d: int, itemsize: int, interpret: bool) -> bool:
    """The backward's route, as JAX's ``_flash_diff_bwd(interpret, ...)``
    decides it: the dq and dk / dv kernels where the Q and K/V pairs fit
    ``flash_kv_fits`` and min(Sq, Sk) reaches ``_BWD_MIN_SEQ`` (or, in
    ``interpret`` mode, at every length), else the gradient of
    ``reference_attention``."""
    fits = flash_kv_fits(sq, d, itemsize) and flash_kv_fits(sk, d, itemsize)
    return fits and (min(sq, sk) >= _BWD_MIN_SEQ or interpret)


def bounded_entry(dtype: torch.dtype, packed: bool, d: int) -> str:
    """The CUDA entry point of the bounded forward for an input of ``dtype``
    and head dim ``d`` (head-split or ``packed`` heads): bfloat16 the
    tensor-core kernel (``csrc/flash_attention_tc.cu``), float32 at
    ``F32_HEAD_DIMS`` the float32 kernel (``csrc/flash_attention_f32.cu``),
    float32 at 512 the float32 d = 512 kernel (``csrc/flash_attention_f32_512.cu``),
    other float32 the CUDA-core template (``csrc/flash_attention.cu``).
    Raises for any other dtype."""
    if dtype == torch.bfloat16:
        return ("hedit_flash_attention_fwd_packed_bounded_tc" if packed
                else "hedit_flash_attention_fwd_tc")
    if dtype == torch.float32:
        entry = ("hedit_flash_attention_fwd_packed_bounded" if packed
                 else "hedit_flash_attention_fwd")
        return entry + _f32_suffix(d)
    raise ValueError(f"the bounded forward takes float32 or bfloat16, got {dtype}")


def _f32_suffix(d: int) -> str:
    """The entry-point suffix of the float32 forward kernel at head dim
    ``d``: ``_f32`` at ``F32_HEAD_DIMS``, ``F32_512_SUFFIX`` at 512, none
    (the template) elsewhere."""
    return "_f32" if d in F32_HEAD_DIMS else F32_512_SUFFIX if d == 512 else ""


def exact_entry(dtype: torch.dtype, packed: bool, d: int) -> str:
    """The CUDA entry point of the exact forward for an input of ``dtype``
    and head dim ``d`` (head-split or ``packed`` heads): bfloat16 the
    tensor-core kernel (``csrc/flash_attention_tc.cu``), float32 at
    ``F32_HEAD_DIMS`` the float32 kernel (``csrc/flash_attention_f32.cu``),
    float32 at 512 the float32 d = 512 kernel
    (``csrc/flash_attention_f32_512.cu``).  The CUDA-core template
    (``csrc/flash_attention.cu``) is named for no input.  Raises for any
    other dtype, and for float32 at a head dim neither kernel takes."""
    if dtype == torch.bfloat16:
        return ("hedit_flash_attention_fwd_packed_exact_tc" if packed
                else "hedit_flash_attention_fwd_exact_tc")
    if dtype == torch.float32:
        if d not in F32_WINDOWS:
            raise ValueError(f"the float32 exact forward takes head dims {tuple(F32_WINDOWS)}, "
                             f"got {d}")
        return ("hedit_flash_attention_fwd_packed_exact" if packed
                else "hedit_flash_attention_fwd_exact") + _f32_suffix(d)
    raise ValueError(f"the exact forward takes float32 or bfloat16, got {dtype}")


def lse_entry(dtype: torch.dtype, d: int) -> str:
    """The CUDA entry point of the bounded forward with the log-sum-exp for
    an input of ``dtype`` and head dim ``d``, chosen as ``bounded_entry``
    chooses.  Raises for any other dtype."""
    if dtype == torch.bfloat16:
        return "hedit_flash_attention_fwd_lse_tc"
    if dtype == torch.float32:
        return "hedit_flash_attention_fwd_lse" + _f32_suffix(d)
    raise ValueError(f"the LSE forward takes float32 or bfloat16, got {dtype}")


def bwd_entry(dtype: torch.dtype, d: int) -> Tuple[str, ...]:
    """The CUDA entry points of the backward for an input of ``dtype`` and
    head dim ``d``: two, (dq, dk / dv), or one that writes all three.
    bfloat16 at ``TC_BWD_HEAD_DIMS`` the tensor-core kernels
    (``csrc/flash_attention_bwd_tc.cu``); float32 at ``F32_HEAD_DIMS`` the
    fused float32 kernel (``csrc/flash_attention_bwd_f32.cu``,
    ``F32_BWD_ENTRY``); float32 at the VAE's 512 the float32 d = 512 kernels
    (``csrc/flash_attention_bwd_f32_512.cu``, ``F32_512_BWD_ENTRIES``).  The
    CUDA-core template (``csrc/flash_attention_bwd.cu``) is named for no
    input.  Raises for any other dtype or head dim."""
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward takes head dims {BWD_HEAD_DIMS}, got {d}")
    if dtype == torch.bfloat16 and d in TC_BWD_HEAD_DIMS:
        return "hedit_flash_attention_bwd_dq_tc", "hedit_flash_attention_bwd_dkv_tc"
    if dtype == torch.float32:
        return (F32_BWD_ENTRY,) if d in F32_HEAD_DIMS else F32_512_BWD_ENTRIES
    raise ValueError(f"the backward takes float32 or bfloat16, got {dtype}")


def _check_copies(what: str, head_dims, align: int, multiple: int, d: int, addresses,
                  strides) -> None:
    """Raise unless ``what`` (kernels that copy 16 bytes at a time) takes
    head dim ``d``, every address a multiple of ``align`` bytes and every
    element stride a multiple of ``multiple``."""
    if d not in head_dims:
        raise ValueError(f"{what} take head dims {head_dims}, got {d}")
    bad = [a for a in addresses if a % align]
    if bad:
        raise ValueError(f"{what} need {align}-byte aligned operands, got addresses "
                         f"{[hex(a) for a in bad]}")
    bad = [s for s in strides if s % multiple]
    if bad:
        raise ValueError(f"{what} need element strides that are multiples of {multiple}, "
                         f"got {bad}")


def check_tc_operands(d: int, addresses, strides) -> None:
    """Raise unless a tensor-core kernel takes these operands: head dim
    ``d`` one of ``HEAD_DIMS``, every address (``data_ptr()``) a multiple of
    ``TC_ALIGN_BYTES`` and every element stride a multiple of
    ``TC_STRIDE_MULTIPLE``.  The kernels refuse the same; the wrappers raise
    first, and never fall back to the CUDA-core template."""
    _check_copies("the tensor-core kernels", HEAD_DIMS, TC_ALIGN_BYTES, TC_STRIDE_MULTIPLE, d,
                  addresses, strides)


def check_f32_bwd_operands(d: int, addresses, strides) -> None:
    """Raise unless a float32 backward kernel (``csrc/flash_attention_bwd_f32.cu``
    at d = 40 / 80, ``csrc/flash_attention_bwd_f32_512.cu`` at 512) takes
    these operands: head dim ``d`` one of ``F32_BWD_HEAD_DIMS``, every
    address a multiple of ``F32_ALIGN_BYTES`` and every element stride a
    multiple of ``F32_STRIDE_MULTIPLE``.  The kernels refuse the same
    addresses; the wrappers raise first, and never fall back to the template
    or a plain version."""
    _check_copies("the float32 backward kernels", F32_BWD_HEAD_DIMS, F32_ALIGN_BYTES,
                  F32_STRIDE_MULTIPLE, d, addresses, strides)


def check_f32_operands(d: int, addresses, strides, window: Optional[int]) -> None:
    """Raise unless a float32 forward kernel (``csrc/flash_attention_f32.cu``
    at d = 40 / 80, ``csrc/flash_attention_f32_512.cu`` at 512) takes these
    operands: head dim ``d`` a key of ``F32_WINDOWS``, every address
    (``data_ptr()``) a multiple of ``F32_ALIGN_BYTES``, every element stride
    a multiple of ``F32_STRIDE_MULTIPLE`` and, for the bounded mode, the
    anchor ``window`` min(anchor, Sk) at most ``F32_WINDOWS[d]`` keys (the
    exact mode passes None).  The kernels refuse the same; the wrappers
    raise first, and never fall back to the template or a plain version."""
    _check_copies("the float32 kernels", tuple(F32_WINDOWS), F32_ALIGN_BYTES,
                  F32_STRIDE_MULTIPLE, d, addresses, strides)
    if window is not None and not 1 <= window <= F32_WINDOWS[d]:
        raise ValueError(f"the float32 kernels keep 1 to {F32_WINDOWS[d]} anchor keys on chip "
                         f"at d = {d}, got a window of {window}")


def bounded_anchor(sk: int, d: int) -> int:
    """The bounded forward's anchor window: the key block ``blk_k`` that the
    JAX wrappers pick at this shape with their default blocks
    (``_shrink_blocks``, then ``min(blk_k, max(128, Sk))``): 512 keys for the
    UNet's head dims, 1024 above d = 128 (the VAE's 512).  The shift of each
    query row is anchored on its first ``min(anchor, Sk)`` keys, so the
    saturation falls on the same keys as on the TPU."""
    return min(1024 if d > 128 else 512, max(128, sk))


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v with float32 scores and softmax: JAX's
    ``reference_attention``, the route of every attention that takes no
    kernel (and, by autograd, of the backward below ``_BWD_MIN_SEQ``), and
    the oracle.

    q [B, H, Sq, D]; k, v [B, H, Sk, D] -> [B, H, Sq, D] in q's dtype.  The
    probabilities are cast to v's dtype before the PV product, as the JAX
    oracle does."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (d ** 0.5)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def exact_key_tile(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The exact kernels' key tile at head dim ``d`` for inputs of
    ``dtype``: the block over which their running max, and with it the
    rounding of p, is taken.  64 keys at the UNet's 40 and 80
    (``csrc/flash_attention_tc.cu``, ``csrc/flash_attention_f32.cu``); at the
    VAE's 512, 32 on the tensor cores (bf16) and ``F32_512_KEY_TILE`` in
    float32 (``csrc/flash_attention_f32_512.cu``, over each CTA's share of
    the keys)."""
    if d <= 128:
        return 64
    return F32_512_KEY_TILE if dtype == torch.float32 else 32


def flash_attention_exact_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    blk_k: Optional[int] = None,
                                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of the exact forward (``_flash_kernel``) in JAX's steps:
    q * (1/sqrt(d) * log2(e)), the constant and the product rounded to the
    input dtype; float32 scores; over key blocks of ``blk_k`` (default
    ``exact_key_tile(D)``; the TPU kernel's default is 512) a running max
    m_new, p = exp2(s - m_new) rounded to the input dtype and summed from the
    rounded values (the TPU kernel's ones column of v), the accumulator and
    the sum rescaled by exp2(m_old - m_new); out = acc / sum, no floor.
    q [B, H, Sq, D], k / v [B, H, Sk, D] -> [B, H, Sq, D] in q's dtype, or in
    ``out_dtype`` (float32: the output before its final rounding).  The key
    block decides only which max each p is rounded against."""
    d, sk = q.shape[-1], k.shape[-2]
    blk_k = exact_key_tile(d, q.dtype) if blk_k is None else blk_k
    qs = (q * torch.tensor(1.0 / d ** 0.5 * _LOG2E, dtype=q.dtype)).float()
    m = torch.full(q.shape[:-1] + (1,), -math.inf, device=q.device)
    den = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device)
    for k0 in range(0, sk, blk_k):
        s = torch.matmul(qs, k[..., k0:k0 + blk_k, :].float().transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new).to(v.dtype).float()
        alpha = torch.exp2(m - m_new)
        den = den * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, v[..., k0:k0 + blk_k, :].float())
        m = m_new
    return (acc / den).to(out_dtype or q.dtype)


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
                                  anchor: Optional[int] = None,
                                  out_dtype: Optional[torch.dtype] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the bounded forward with the log-sum-exp
    (``_flash_bounded_lse_kernel``): (out [B, H, Sq, D] in q's dtype or in
    ``out_dtype``, lse2 [B*H, 1, Sq] float32), lse2 = shift + log2(denom) in
    base-2 units of the scaled scores.  ``anchor`` as
    ``flash_attention_bounded_reference``."""
    b, h, sq, _ = q.shape
    out, lse2 = _bounded(q, k, v, anchor, out_dtype)
    return out, lse2.reshape(b * h, 1, sq)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def flash_attention_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     heads: int) -> torch.Tensor:
    """``reference_attention`` on packed heads: q [B, Sq, H*D], k / v
    [B, Sk, H*D] -> [B, Sq, H*D]; head h is columns h*D .. (h+1)*D of a row."""
    return _merge_heads(reference_attention(_split_heads(q, heads), _split_heads(k, heads),
                                            _split_heads(v, heads)))


def flash_attention_packed_exact_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                           heads: int, blk_k: Optional[int] = None,
                                           out_dtype: Optional[torch.dtype] = None
                                           ) -> torch.Tensor:
    """Plain version of the exact forward on packed heads
    (``_flash_packed_kernel``), layouts as ``flash_attention_packed_reference``:
    the heads split, ``flash_attention_exact_reference`` with ``blk_k`` and
    ``out_dtype``, the heads merged."""
    out = flash_attention_exact_reference(_split_heads(q, heads), _split_heads(k, heads),
                                          _split_heads(v, heads), blk_k, out_dtype)
    return _merge_heads(out)


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


def _launch_forward(entry: str, counter: str, q: torch.Tensor, pointers, ints, d: int,
                    strides, window: Optional[int] = None) -> None:
    """Launch forward entry point ``entry`` on ``pointers`` (q, k, v, out[,
    lse2]) and count it in the module's ``counter``, or in ``counter`` plus
    the entry's suffix for a tensor-core entry (``_tc``) and the float32
    kernels' (``_f32``, ``F32_512_SUFFIX``), whose q, k, v and out must first
    pass ``check_tc_operands`` / ``check_f32_operands`` with the element
    ``strides`` of the layout (and, for the float32 kernels' bounded mode,
    the anchor ``window`` min(anchor, Sk))."""
    addresses = [t.data_ptr() for t in pointers[:4]]
    suffix = next((s for s in ("_tc", F32_512_SUFFIX, "_f32") if entry.endswith(s)), "")
    if suffix == "_tc":
        check_tc_operands(d, addresses, strides)
    elif suffix:
        check_f32_operands(d, addresses, strides, window)
    _launch(entry, q, pointers, ints)
    globals()[counter + suffix] += 1


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The bounded forward: a CPU tensor takes the plain version, a CUDA
    tensor launches the kernel of ``bounded_entry`` on the current stream
    with the anchor of ``bounded_anchor``.  Raises on any CUDA input the
    kernel does not take, and if the launch is refused."""
    if _on_cpu(q, k, v):
        return flash_attention_bounded_reference(q, k, v)
    b, h, sq, sk, d = _check_qkv(q, k, v, HEAD_DIMS, "flash_attention_cuda")
    out = torch.empty_like(q)
    anchor = bounded_anchor(sk, d)
    _launch_forward(bounded_entry(q.dtype, False, d), "launches", q, (q, k, v, out),
                    (b * h, sq, sk, d, anchor), d, [sq * d, sk * d, d], min(anchor, sk))
    return out


def flash_attention_exact_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                               ) -> torch.Tensor:
    """The exact forward (running max and rescale; the TPU kernel
    ``_flash_kernel`` of JAX's public ``flash_attention``): a CPU tensor takes
    ``flash_attention_exact_reference`` at the kernels' key tile, a CUDA
    tensor launches the kernel of ``exact_entry`` (bf16 on the tensor cores,
    whose operands must pass ``check_tc_operands``; float32 the float32
    kernel at d = 40 / 80 or the float32 d = 512 kernel, whose operands must
    pass ``check_f32_operands`` with no window).  Raises as
    ``flash_attention_cuda`` does, before any launch, and never falls back."""
    if _on_cpu(q, k, v):
        return flash_attention_exact_reference(q, k, v)
    b, h, sq, sk, d = _check_qkv(q, k, v, HEAD_DIMS, "flash_attention_exact_cuda")
    out = torch.empty_like(q)
    _launch_forward(exact_entry(q.dtype, False, d), "launches_exact", q, (q, k, v, out),
                    (b * h, sq, sk, d), d, [sq * d, sk * d, d])
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
    """Launch the exact forward kernel of ``exact_entry`` on packed heads
    (bf16 on the tensor cores, whose operands must pass
    ``check_tc_operands``; float32 at d = 40 / 80 the float32 kernel, at
    d = 512 the float32 d = 512 kernel, ``check_f32_operands`` with no
    window):
    q [B, Sq, H*D], k / v [B, Sk, H*D] -> contiguous
    [B, Sq, H*D].  The batch rows of an input may lie any stride apart (a
    row slice of a larger batch is taken as it is).  Raises on any input the
    kernel does not take, CPU tensors included, and if the launch is
    refused."""
    b, h, sq, sk, d, *strides = _check_packed(q, k, v, heads, "flash_attention_packed_cuda")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_forward(exact_entry(q.dtype, True, d), "launches_packed", q, (q, k, v, out),
                    (b, h, sq, sk, d, *strides), d, [h * d, *strides])
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
    if _on_cpu(q, k, v):
        return flash_attention_packed_bounded_reference(q, k, v, heads, anchor)
    b, h, sq, sk, d, *strides = _check_packed(q, k, v, heads,
                                              "flash_attention_packed_bounded_cuda")
    anchor = bounded_anchor(sk, d) if anchor is None else anchor
    if anchor < 1:
        raise ValueError(f"anchor must be positive, got {anchor}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_forward(bounded_entry(q.dtype, True, d), "launches_packed_bounded", q,
                    (q, k, v, out), (b, h, sq, sk, d, anchor, *strides), d, [h * d, *strides],
                    min(anchor, sk))
    return out


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bounded forward with its second output: (out, lse2 [B*H, 1, Sq]
    float32).  CPU tensors take ``flash_attention_lse_reference``; a CUDA
    tensor launches the kernel of ``lse_entry`` (bf16 on the tensor cores,
    whose operands must pass ``check_tc_operands``; float32 the float32
    kernels, ``check_f32_operands``), otherwise as ``flash_attention_cuda``."""
    if _on_cpu(q, k, v):
        return flash_attention_lse_reference(q, k, v)
    b, h, sq, sk, d = _check_qkv(q, k, v, HEAD_DIMS, "flash_attention_lse_cuda")
    out = torch.empty_like(q)
    lse2 = torch.empty((b * h, 1, sq), dtype=torch.float32, device=q.device)
    anchor = bounded_anchor(sk, d)
    _launch_forward(lse_entry(q.dtype, d), "launches_lse", q, (q, k, v, out, lse2),
                    (b * h, sq, sk, d, anchor), d, [sq * d, sk * d, d], min(anchor, sk))
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


def _bwd_launch(part: int, q, k, v, do, lse2, delta, outs, what: str) -> None:
    """Launch tensor-core backward kernel ``part`` (0 dq, 1 dk / dv) of
    ``bwd_entry`` into ``outs``, on operands that pass ``check_tc_operands``.
    Raises where ``bwd_entry`` names a float32 kernel: the fused one, which
    writes all three gradients (``flash_bwd_f32_cuda``), or the d = 512 pair,
    whose dq reads the ds its dk / dv kernel stores (``flash_bwd_f32_512_cuda``)."""
    bh, sq, sk, d = _check_bwd(q, k, v, do, lse2, delta, what)
    entries = bwd_entry(q.dtype, d)
    if len(entries) == 1:
        raise ValueError(f"{what}: float32 at d = {d} takes the fused backward, which writes "
                         f"dq, dk and dv in one launch: call flash_bwd_f32_cuda")
    if entries == F32_512_BWD_ENTRIES:
        raise ValueError(f"{what}: float32 at d = {d} takes the float32 d = 512 backward, whose "
                         f"dq reads the ds its dk / dv kernel stores: call "
                         f"flash_bwd_f32_512_cuda")
    check_tc_operands(d, [t.data_ptr() for t in (q, k, v, do, *outs)], [sq * d, sk * d, d])
    _launch(entries[part], q, (q, k, v, do, lse2, delta, *outs), (bh, sq, sk, d))


def flash_bwd_dq_cuda(q, k, v, do, lse2, delta) -> torch.Tensor:
    """Launch the tensor-core dq kernel of ``bwd_entry`` (bf16).  lse2 and
    delta = rowsum(dO * out) hold one float32 per (batch, head, query).
    Raises on what the kernel does not take, float32 included."""
    global launches_bwd_dq_tc
    dq = torch.empty_like(q)
    _bwd_launch(0, q, k, v, do, lse2, delta, (dq,), "flash_bwd_dq_cuda")
    launches_bwd_dq_tc += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse2, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the tensor-core dk / dv kernel of ``bwd_entry``; arguments as
    ``flash_bwd_dq_cuda``."""
    global launches_bwd_dkv_tc
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch(1, q, k, v, do, lse2, delta, (dk, dv), "flash_bwd_dkv_cuda")
    launches_bwd_dkv_tc += 1
    return dk, dv


def flash_bwd_f32_cuda(q, k, v, do, lse2, delta
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused float32 backward (``F32_BWD_ENTRY``): one launch
    writes dq, dk and dv (dq summed over key blocks by atomic adds, so its
    last bits may differ from launch to launch; dk and dv do not).
    Arguments as ``flash_bwd_dq_cuda``.  Raises on anything it does not take,
    operands that fail ``check_f32_bwd_operands`` included, before any
    launch."""
    global launches_bwd_f32
    bh, sq, sk, d = _check_bwd(q, k, v, do, lse2, delta, "flash_bwd_f32_cuda")
    if bwd_entry(q.dtype, d) != (F32_BWD_ENTRY,):
        raise ValueError(f"flash_bwd_f32_cuda takes float32 at head dims {F32_HEAD_DIMS}, got "
                         f"{q.dtype} at {d}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    operands = (q, k, v, do, dq, dk, dv)
    check_f32_bwd_operands(d, [t.data_ptr() for t in operands],
                           [s for t in (q, k, v, do) for s in t.stride()[:-1]])
    _launch(F32_BWD_ENTRY, q, (q, k, v, do, lse2, delta, dq, dk, dv), (bh, sq, sk, d))
    launches_bwd_f32 += 1
    return dq, dk, dv


def bwd_f32_512_workspace(bh: int, sq: int, sk: int) -> Tuple[int, int, int]:
    """The shape of the float32 d = 512 backward's workspace, ds [BH, Sk,
    ldq] float32 with ldq = Sq rounded up to 4 (rows of 16 bytes): the dk / dv
    kernel stores every ds once, the dq product reads it."""
    return bh, sk, -(-sq // 4) * 4


def flash_bwd_f32_512_cuda(q, k, v, do, lse2, delta
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the float32 backward at d = 512 (``F32_512_BWD_ENTRIES``): the
    dk / dv kernel, which forms s and dp once per (key, query) pair and
    stores ds into a workspace from torch's allocator
    (``bwd_f32_512_workspace``), then the dq product over it.  Every output
    has one writer and sums in a fixed order: two calls give the same bits.
    Arguments as ``flash_bwd_dq_cuda``.  Raises on anything it does not take,
    operands that fail ``check_f32_bwd_operands`` included, before any
    launch."""
    global launches_bwd_f32_512
    bh, sq, sk, d = _check_bwd(q, k, v, do, lse2, delta, "flash_bwd_f32_512_cuda")
    if bwd_entry(q.dtype, d) != F32_512_BWD_ENTRIES:
        raise ValueError(f"flash_bwd_f32_512_cuda takes float32 at d = 512, got {q.dtype} at {d}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ds = torch.empty(bwd_f32_512_workspace(bh, sq, sk), dtype=torch.float32, device=q.device)
    operands = (q, k, v, do, dq, dk, dv, ds)
    check_f32_bwd_operands(d, [t.data_ptr() for t in operands],
                           [s for t in operands for s in t.stride()[:-1]])
    entry_dq, entry_dkv = F32_512_BWD_ENTRIES
    _launch(entry_dkv, q, (q, k, v, do, lse2, delta, ds, dk, dv), (bh, sq, sk, d))
    _launch(entry_dq, q, (k, ds, dq), (bh, sq, sk, d))
    launches_bwd_f32_512 += 1
    return dq, dk, dv


def flash_attention_backward_cuda(q, k, v, out, lse2, do
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the backward kernels of ``bwd_entry``: the fused
    float32 one, the float32 d = 512 pair, or the tensor-core dq and dk / dv
    kernels; delta = rowsum(dO * out) is plain tensor code, as in the JAX
    package."""
    do = do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1)
    entries = bwd_entry(q.dtype, q.shape[-1])
    if len(entries) == 1:
        return flash_bwd_f32_cuda(q, k, v, do, lse2, delta)
    if entries == F32_512_BWD_ENTRIES:
        return flash_bwd_f32_512_cuda(q, k, v, do, lse2, delta)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse2, delta)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse2, delta)
    return dq, dk, dv


def flash_diff_backward(q, k, v, out, lse2, do, interpret: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_diff``, routed as JAX's
    ``_flash_diff_bwd(interpret, res, do)`` routes them
    (``bwd_takes_kernels``): the backward kernels from the saved out and
    lse2 (``flash_attention_backward_cuda`` on CUDA tensors, its plain
    version ``flash_attention_backward_reference`` on CPU tensors), or the
    gradient of ``reference_attention`` by autograd, recomputed from the
    saved q, k and v.  ``interpret=False`` is the card's routing (the TPU's);
    a CPU caller may ask for it, the plain versions standing in for the
    kernels."""
    if bwd_takes_kernels(q.shape[2], k.shape[2], q.shape[3], q.element_size(), interpret):
        kernels = flash_attention_backward_cuda if q.is_cuda else flash_attention_backward_reference
        return kernels(q, k, v, out, lse2, do)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(reference_attention(*leaves), leaves, do)


class _FlashAttentionDiff(torch.autograd.Function):
    """Forward (bounded, with lse2) saves (q, k, v, out, lse2); backward by
    ``flash_diff_backward``: a CUDA tensor takes the card's routing (the
    TPU's), a CPU tensor the plain kernels wherever they fit, as JAX's
    ``interpret=True`` does."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse2 = flash_attention_lse_cuda(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse2)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse2 = ctx.saved_tensors
        return flash_diff_backward(q, k, v, out, lse2, do, interpret=not q.is_cuda)


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention with a gradient (port of ``flash_attention_diff``): the
    bounded LSE forward at every length, the backward of
    ``flash_diff_backward``.  q [B, H, Sq, D], k / v [B, H, Sk, D] ->
    [B, H, Sq, D].  On CUDA tensors D is one of ``BWD_HEAD_DIMS``."""
    return _FlashAttentionDiff.apply(q, k, v)
