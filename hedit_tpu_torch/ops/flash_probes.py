"""The flash-attention probes: four hand-written CUDA forwards that write the
transposed output, and their plain versions.

Port of the TPU kernels of two cost probes of the JAX package (the probes'
harnesses have their own port under ``hedit_tpu_torch/probes/``):

* ``scripts/flash_nhd_variants.py``: three bounded (max-free) forwards that
  write the packed, transposed output ``[B, H*D, Sq]``, with the shift
  anchored on the first ``anchor`` keys (the TPU kernel's ``blk_k``):

  - ``flash_packed_t_cuda``: q, k, v ``[B, H, S, D]`` (``_packed_t_kernel``);
  - ``flash_packed_t_sminor_cuda``: q, k S-minor ``[B, H, D, S]``, v
    ``[B, H, S, D]`` (``_packed_t_kernel_sminor``);
  - ``flash_packed_t_all_sminor_cuda``: q, k, v ``[B, H, D, S]``
    (``_packed_t_kernel_all_sminor``).

* ``scripts/flash_v4_variants.py``: ``flash_exp2_t_cuda``, the exact forward
  with ``sm_scale * log2(e)`` folded into q, exp2, p rounded to the input
  dtype and a ``[B*H, D, Sq]`` output (``kern_exp2``); ``pipe=True`` runs
  the software-pipelined key loop.

``[B*H, D, Sq]`` and ``[B, H*D, Sq]`` are the same memory: head h of batch
row b is rows ``h*D .. (h+1)*D`` of that row's image, so the kernels write
either form with the same stores; the wrappers return the TPU wrappers' form.

As on the TPU, a probe covers only whole blocks: Sq and Sk must be multiples
of 64 (the CUDA tile), and for the bounded probes Sk a multiple of the anchor,
itself a multiple of 64; anything else raises, whatever the device.  A CPU
tensor takes the plain version (``flash_packed_t_reference`` etc.), a CUDA
tensor launches the kernel of ``csrc/flash_probes.cu`` or raises.
"""

from __future__ import annotations

import math

import torch

from hedit_tpu_torch.ops.flash_attention import (
    _bounded, _check_device_dtype, _launch, _on_cpu,
)

# launches of each CUDA kernel since the last reset (read by chip_smoke.py)
launches_packed_t = 0
launches_packed_t_sminor = 0
launches_packed_t_all_sminor = 0
launches_exp2_t = 0

PROBE_HEAD_DIMS = (40, 80)
TILE = 64          # rows of the kernels' query and key tiles
BLK_K = 512        # the TPU wrappers' default key block
_LOG2E = math.log2(math.e)
# the TPU kernel's initial running max
_NEG_INF = -1e30

# each bounded probe's layout: the entry point's `layout` code and whether
# q, k and v are S-minor
_LAYOUTS = {"packed_t": (0, (False, False, False)),
            "packed_t_sminor": (1, (True, True, False)),
            "packed_t_all_sminor": (2, (True, True, True))}


def _to_sd(t: torch.Tensor, sminor: bool) -> torch.Tensor:
    """An operand as [B, H, S, D]: S-minor [B, H, D, S] is transposed (a view)."""
    return t.transpose(-1, -2) if sminor else t


def _packed_t(out: torch.Tensor) -> torch.Tensor:
    """[B, H, Sq, D] -> the packed transposed [B, H*D, Sq]."""
    b, h, sq, d = out.shape
    return out.transpose(-1, -2).reshape(b, h * d, sq)


def _bounded_probe_reference(q, k, v, anchor: int, layout: str) -> torch.Tensor:
    qs, ks, vs = (_to_sd(t, m) for t, m in zip((q, k, v), _LAYOUTS[layout][1]))
    return _packed_t(_bounded(qs, ks, vs, anchor)[0])


def flash_packed_t_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             anchor: int = BLK_K) -> torch.Tensor:
    """Plain version of ``_packed_t_kernel``: q, k, v [B, H, S, D] -> [B, H*D,
    Sq] in q's dtype; the bounded forward of ``ops/flash_attention.py``
    (q * scale, p and the output rounded to the input dtype, the shift from
    the first ``anchor`` keys, the denominator floored at 1.2e-38)."""
    return _bounded_probe_reference(q, k, v, anchor, "packed_t")


def flash_packed_t_sminor_reference(qt: torch.Tensor, kt: torch.Tensor, v: torch.Tensor,
                                    anchor: int = BLK_K) -> torch.Tensor:
    """Plain version of ``_packed_t_kernel_sminor``: qt, kt [B, H, D, S], v
    [B, H, S, D] -> [B, H*D, Sq]."""
    return _bounded_probe_reference(qt, kt, v, anchor, "packed_t_sminor")


def flash_packed_t_all_sminor_reference(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                                        anchor: int = BLK_K) -> torch.Tensor:
    """Plain version of ``_packed_t_kernel_all_sminor``: qt, kt, vt
    [B, H, D, S] -> [B, H*D, Sq]."""
    return _bounded_probe_reference(qt, kt, vt, anchor, "packed_t_all_sminor")


def flash_exp2_t_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           blk_k: int = TILE) -> torch.Tensor:
    """Plain version of ``kern_exp2``: q, k, v [B, H, S, D] -> [B*H, D, Sq] in
    q's dtype.  q * sm_scale * log2(e) rounded to the input dtype, float32
    scores; over key blocks of ``blk_k`` a running max m, p = exp2(s - m_new)
    rounded to the input dtype, alpha = exp2(m_old - m_new), the sum from the
    rounded p; out = acc / sum, no floor.  The key block decides only the
    point p is rounded against: ``blk_k`` defaults to the CUDA kernel's 64-key
    tile, the TPU wrapper's default is ``BLK_K`` (512)."""
    b, h, sq, d = q.shape
    qs = (q * torch.tensor(1.0 / d ** 0.5 * _LOG2E, dtype=q.dtype)).float()
    m = torch.full((b, h, sq, 1), _NEG_INF, device=q.device)
    denom = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, k.shape[2], blk_k):
        s = torch.matmul(qs, k[:, :, k0:k0 + blk_k].float().transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new).to(v.dtype).float()
        alpha = torch.exp2(m - m_new)
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, v[:, :, k0:k0 + blk_k].float())
        m = m_new
    return _packed_t((acc / denom).to(q.dtype)).reshape(b * h, d, sq)


def _dims(q, k, v, sminor: tuple, what: str):
    """(b, h, sq, sk, d) of operands in the given layouts (S-minor flags of q,
    k, v); raises unless they agree and cover whole tiles."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be 4-D")
    qs, ks, vs = (_to_sd(t, m) for t, m in zip((q, k, v), sminor))
    b, h, sq, d = qs.shape
    sk = ks.shape[2]
    if ks.shape != (b, h, sk, d) or vs.shape != ks.shape:
        raise ValueError(f"{what}: shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if sq % TILE or sk % TILE or sq < TILE or sk < TILE:
        raise ValueError(f"{what}: Sq = {sq} and Sk = {sk} must be multiples of {TILE}: "
                         f"the probe covers whole blocks and masks nothing")
    return b, h, sq, sk, d


def _check_cuda(q, k, v, b, h, d, what: str) -> None:
    _check_device_dtype(q, k, v, what)
    if d not in PROBE_HEAD_DIMS or b * h > 65535:
        raise ValueError(f"{what} does not take q{tuple(q.shape)}: head dim must be one of "
                         f"{PROBE_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k, v must be contiguous")


def _bounded_probe(q, k, v, anchor: int, layout: str) -> torch.Tensor:
    what = f"flash_{layout}_cuda"
    code, sminor = _LAYOUTS[layout]
    b, h, sq, sk, d = _dims(q, k, v, sminor, what)
    if anchor < TILE or anchor % TILE or sk % anchor:
        raise ValueError(f"{what}: the anchor ({anchor} keys, the TPU kernel's blk_k) must be a "
                         f"multiple of {TILE} that divides Sk = {sk}")
    if _on_cpu(q, k, v):
        return _bounded_probe_reference(q, k, v, anchor, layout)
    _check_cuda(q, k, v, b, h, d, what)
    out = torch.empty((b, h * d, sq), dtype=q.dtype, device=q.device)
    _launch("hedit_flash_packed_t", q, (q, k, v, out),
            (b * h, sq, sk, d, anchor, code))
    globals()[f"launches_{layout}"] += 1
    return out


def flash_packed_t_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        anchor: int = BLK_K) -> torch.Tensor:
    """``_packed_t_kernel``: q, k, v [B, H, S, D] -> [B, H*D, Sq]; ``anchor``
    is the TPU wrapper's ``blk_k`` (512)."""
    return _bounded_probe(q, k, v, anchor, "packed_t")


def flash_packed_t_sminor_cuda(qt: torch.Tensor, kt: torch.Tensor, v: torch.Tensor,
                               anchor: int = BLK_K) -> torch.Tensor:
    """``_packed_t_kernel_sminor``: qt, kt [B, H, D, S], v [B, H, S, D] ->
    [B, H*D, Sq]."""
    return _bounded_probe(qt, kt, v, anchor, "packed_t_sminor")


def flash_packed_t_all_sminor_cuda(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                                   anchor: int = BLK_K) -> torch.Tensor:
    """``_packed_t_kernel_all_sminor``: qt, kt, vt [B, H, D, S] -> [B, H*D, Sq]."""
    return _bounded_probe(qt, kt, vt, anchor, "packed_t_all_sminor")


def flash_exp2_t_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pipe: bool = False) -> torch.Tensor:
    """``kern_exp2``: q, k, v [B, H, S, D] -> [B*H, D, Sq].  ``pipe`` selects
    the software-pipelined key loop (the same function).  The kernel moves its
    running max once a 64-key tile, as ``kern_exp2`` does with ``blk_k=64``
    (its wrapper's default block is 512 keys, which rounds p against other
    points): its plain version is ``flash_exp2_t_reference`` with its default
    64-key block."""
    global launches_exp2_t
    b, h, sq, sk, d = _dims(q, k, v, (False, False, False), "flash_exp2_t_cuda")
    if _on_cpu(q, k, v):
        return flash_exp2_t_reference(q, k, v)
    _check_cuda(q, k, v, b, h, d, "flash_exp2_t_cuda")
    out = torch.empty((b * h, d, sq), dtype=q.dtype, device=q.device)
    _launch("hedit_flash_exp2_t", q, (q, k, v, out), (b * h, sq, sk, d, int(bool(pipe))))
    launches_exp2_t += 1
    return out
