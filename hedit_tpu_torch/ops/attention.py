"""Attention dispatch with control hooks (port of ``hedit_tpu/ops/attention.py``).

* fused path: ``softmax(q k^T) v`` without materialised probabilities.  A CUDA
  tensor goes to the CUDA flash kernels exactly where the JAX package takes
  its Pallas kernel on the TPU (``flash_route``: Sq, Sk >= ``FLASH_MIN_SEQ``
  and the K/V pair within ``flash_kv_fits``), all in the bounded (max-free)
  form the JAX package's ``flash_attention_diff`` computes there: with
  several heads and no recorded gradient to the packed bounded forward,
  which reads the ``[B, S, H*D]`` projections as they are (no head-split
  copies); with one head (the VAE, whose head split is a view) to the
  head-split forward; under a recorded gradient to ``flash_attention_diff``
  (the head-split LSE forward, and a backward routed as JAX's).  Everything
  else, the CPU included, goes to the exact ``reference_attention``, as the
  JAX package's routing does off the TPU and outside its predicates.  The
  P2P self edit (a q/k
  row-select, ``map_qkv``) and cross edit (a linear map over the token axis,
  ``linear_token_edit``) both ride this path.
* probability path: at the P2P store layers only for the (cond_start,
  cond_start + 1) row pair of each image, the other rows riding the fused
  path; for a control without ``edit_pair`` (a store of maps) every row.
* override: a control with ``override_attention`` (mask-guided MasaCtrl)
  gets head-split views of q / k / v first and may return the output itself.

Batch layout under a control with ``num_images`` images: rows are grouped by
image, ``rows = num_images * group``, and each control edit reads row
``cond_start`` and writes row ``cond_start + 1`` of its own group only (the
JAX package gets this grouping from ``vmap``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from hedit_tpu_torch.control.base import NO_CONTROL, LayerTag
from hedit_tpu_torch.ops.flash_attention import (
    flash_attention_cuda, flash_attention_diff, flash_attention_packed_bounded_cuda,
    flash_kv_fits, reference_attention,
)

# Shortest query and key length routed to the CUDA flash kernels, JAX's value.
# The routing copies JAX's TPU routing rather than the card's speeds: it
# decides which function a call computes (bounded or exact, and the
# gradient's roundings), so the backward's own threshold (``_BWD_MIN_SEQ``,
# ``flash_diff_backward``) and the K/V budget (``flash_kv_fits``) are JAX's
# too, though the card's kernels would take those calls.
FLASH_MIN_SEQ = 1024


def flash_route(sq: int, sk: int, d: int, itemsize: int) -> bool:
    """Whether a CUDA attention of these lengths, head dim and dtype size
    takes a flash kernel: where ``hedit_tpu/ops/attention.py:fused_attention``
    takes its Pallas kernel on the TPU."""
    return min(sq, sk) >= FLASH_MIN_SEQ and flash_kv_fits(sk, d, itemsize)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*D] -> contiguous [B, H, S, D]"""
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).transpose(1, 2).contiguous()


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D]"""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _head_view(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*D] -> a [B, H, S, D] view (no copy)"""
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).transpose(1, 2)


def attention_probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Materialised softmax(q k^T / sqrt(d)) in float32: [B, H, Sq, Sk]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    return torch.softmax(s, dim=-1)


def _records_gradient(q, k, v) -> bool:
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] attention routed by device and ``flash_route``.  Under a
    recorded gradient the kernel path is ``flash_attention_diff`` (the LSE
    forward, and dq and dk / dv kernels from ``_BWD_MIN_SEQ`` tokens on);
    ``reference_attention``'s gradient is PyTorch's own autograd (the
    cross-attentions, Sk = 77, the short self-attentions and the float32
    VAE mid block)."""
    if q.is_cuda and flash_route(q.shape[2], k.shape[2], q.shape[3], q.element_size()):
        if _records_gradient(q, k, v):
            return flash_attention_diff(q, k, v)
        return flash_attention_cuda(q, k, v)
    return reference_attention(q, k, v)


def fused_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int) -> torch.Tensor:
    """[B, S, H*D] attention -> [B, Sq, H*D].  A CUDA tensor of several heads
    that ``flash_route`` sends to a kernel (on the per-head D, as JAX's
    head-split call sees it) without a recorded gradient goes to the packed
    bounded kernel as it is; everything else is split into heads (a view for
    one head) and routed by ``fused_attention``."""
    if (q.is_cuda and heads > 1
            and flash_route(q.shape[1], k.shape[1], q.shape[2] // heads, q.element_size())
            and not _records_gradient(q, k, v)):
        return flash_attention_packed_bounded_cuda(q, k, v, heads)
    return merge_heads(fused_attention(split_heads(q, heads), split_heads(k, heads),
                                       split_heads(v, heads)))


def _groups(control, rows: int) -> Tuple[int, int, int]:
    n = control.num_images
    cs = control.cond_start
    if rows % n or cs + 2 > rows // n:
        raise ValueError(f"{rows} rows do not hold {n} images with cond_start={cs}")
    return n, rows // n, cs


def controlled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         heads: int, layer: LayerTag, control=NO_CONTROL
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multi-head attention with control hooks.

    q/k/v: [B, S, H*D] projections.  Returns ([B, Sq, H*D], stored maps)."""
    override = getattr(control, "override_attention", None)
    if override is not None:
        out = override(*(_head_view(t, heads) for t in (q, k, v)), layer)
        if out is not None:
            return merge_heads(out).to(q.dtype), {}

    q, k, v = control.map_qkv(q, k, v, layer)

    def fused(qp, kp, vp):
        return fused_attention_packed(qp, kp, vp, heads)

    le = control.linear_token_edit(layer)
    if le is not None:
        # Cross edit as a token-axis linear map (P2PControl.linear_token_edit):
        # the edit row's values become b * v_edit in the main call, and one
        # extra call (q_base, k_base, A @ v_edit) adds into the edit row.
        A, b = le                                       # [n, 77, 77], [n, 77]
        n, g, cs = _groups(control, q.shape[0])
        vg = v.reshape(n, g, *v.shape[1:])
        v_e = vg[:, cs + 1].float()
        v_mod = vg.clone()
        v_mod[:, cs + 1] = (b[:, :, None] * v_e).to(v.dtype)
        out = fused(q, k, v_mod.reshape(v.shape)).to(q.dtype)
        va = torch.matmul(A, v_e).to(v.dtype)
        qg, kg = q.reshape(n, g, *q.shape[1:]), k.reshape(n, g, *k.shape[1:])
        extra = fused(qg[:, cs], kg[:, cs], va)
        out = out.reshape(n, g, *out.shape[1:])
        out[:, cs + 1] += extra.to(q.dtype)
        return out.reshape(q.shape[0], *out.shape[2:]), {}

    if control.needs_probs(layer) and not hasattr(control, "edit_pair"):
        # A store of maps (no edit): probabilities for every row.
        qh, kh, vh = (split_heads(t, heads) for t in (q, k, v))
        probs, store = control.edit_probs(attention_probs(qh, kh), layer)
        return merge_heads(torch.matmul(probs.to(vh.dtype), vh)).to(q.dtype), store

    if control.needs_probs(layer):
        # P2P's row split: probabilities only for each image's (base, edit) pair.
        n, g, cs = _groups(control, q.shape[0])
        qg, kg, vg = (t.reshape(n, g, *t.shape[1:]) for t in (q, k, v))
        pair = lambda t: split_heads(t[:, cs:cs + 2].reshape(2 * n, *t.shape[2:]), heads)  # noqa: E731
        probs = attention_probs(pair(qg), pair(kg))
        probs = probs.reshape(n, 2, *probs.shape[1:])   # [n, 2, H, Q, K]
        new_repl, store = control.edit_pair(probs[:, 0], probs[:, 1], layer)
        out_edit = merge_heads(torch.matmul(new_repl.to(v.dtype),
                                            split_heads(vg[:, cs + 1], heads)))
        keep = [r for r in range(g) if r != cs + 1]
        flat = lambda t: t[:, keep].reshape(n * (g - 1), *t.shape[2:])  # noqa: E731
        out_rest = fused(flat(qg), flat(kg), flat(vg))
        out = torch.empty((n, g) + out_rest.shape[1:], dtype=q.dtype, device=q.device)
        out[:, keep] = out_rest.reshape(n, g - 1, *out_rest.shape[1:]).to(q.dtype)
        out[:, cs + 1] = out_edit.to(q.dtype)
        return out.reshape(n * g, *out.shape[2:]), store

    return fused(q, k, v).to(q.dtype), {}
