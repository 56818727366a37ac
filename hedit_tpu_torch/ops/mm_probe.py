"""The matmul cost probe: a hand-written CUDA kernel that accumulates
``reps`` nudged matmuls in float32, and its plain version.

Port of the TPU kernel of ``scripts/mm_probe.py`` (``_loop_kernel``; the
probe's harness has its own port, ``hedit_tpu_torch/probes/mm_probe.py``)::

    o = sum_{i < reps} dot(nudge_i(a), b),   nudge_i(a) = a + i in a's dtype

in float32, with the product in one of the script's four dimension numbers
(``LAYOUTS``): ``nn`` a [M, K] b [K, N]; ``tl`` a [K, M] b [K, N]; ``tr``
a [M, K] b [N, K]; ``tm`` a [K, M] b [N, K]; the output is [M, N] float32.
The nudge is rounded to a's dtype each rep (bf16 on the probe), so it does
not factor out of the sum.

A CPU tensor takes the plain version (``mm_loop_reference``), a CUDA tensor
launches the kernel of ``csrc/mm_probe.cu`` or raises.
"""

from __future__ import annotations

import torch

from hedit_tpu_torch.ops.flash_attention import _DTYPE_CODES, _launch, _on_cpu

# launches of each layout's CUDA kernel since the last reset (read by chip_smoke.py)
launches_nn = 0
launches_tl = 0
launches_tr = 0
launches_tm = 0

REPS = 64   # the script's matmuls a call
# layout: (entry-point code, a stored [K, M], b stored [N, K])
LAYOUTS = {"nn": (0, False, False), "tl": (1, True, False), "tr": (2, False, True),
           "tm": (3, True, True)}


def _canonical(a: torch.Tensor, b: torch.Tensor, layout: str):
    """(a as [M, K], b as [K, N]) views; raises unless the layout's
    contraction dims agree."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {tuple(LAYOUTS)}, not {layout!r}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("mm_loop: a and b must be 2-D")
    _, a_t, b_t = LAYOUTS[layout]
    am, bk = (a.t() if a_t else a), (b.t() if b_t else b)
    if am.shape[1] != bk.shape[0]:
        raise ValueError(f"mm_loop {layout}: contraction mismatch a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    return am, bk


def nudged(a: torch.Tensor, i: int) -> torch.Tensor:
    """a + i rounded to a's dtype, in float32 (bf16: added in float32, then
    rounded, as ``a + jnp.bfloat16(i)`` does)."""
    return (a.float() + i).to(a.dtype).float()


def mm_loop_reference(a: torch.Tensor, b: torch.Tensor, layout: str,
                      reps: int = REPS) -> torch.Tensor:
    """Plain version of ``_loop_kernel``: [M, N] float32, each rep's product
    in float32 added to the sum."""
    am, bk = _canonical(a, b, layout)
    bf = bk.float()
    acc = torch.zeros((am.shape[0], bk.shape[1]), device=a.device)
    for i in range(reps):
        acc += torch.matmul(nudged(am, i), bf)
    return acc


def mm_loop_magnitude(a: torch.Tensor, b: torch.Tensor, layout: str,
                      reps: int = REPS) -> torch.Tensor:
    """sum_i |nudge_i(a)| |b|, [M, N] float32: the sum of the magnitudes of
    each output's reps * K terms, which scales its float32 rounding."""
    am, bk = _canonical(a, b, layout)
    bf = bk.float().abs()
    acc = torch.zeros((am.shape[0], bk.shape[1]), device=a.device)
    for i in range(reps):
        acc += torch.matmul(nudged(am, i).abs(), bf)
    return acc


def mm_loop_cuda(a: torch.Tensor, b: torch.Tensor, layout: str,
                 reps: int = REPS) -> torch.Tensor:
    """``_loop_kernel`` under the dimension numbers of ``layout``: [M, N]
    float32.  Raises on any CUDA input the kernel does not take."""
    am, bk = _canonical(a, b, layout)
    if reps < 0:
        raise ValueError(f"mm_loop: reps must be >= 0, not {reps}")
    if _on_cpu(a, b):
        return mm_loop_reference(a, b, layout, reps)
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("mm_loop_cuda needs CUDA tensors")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtypes {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mm_loop_cuda: a and b must be contiguous")
    m, k = am.shape
    n = bk.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _launch("hedit_mm_loop", a, (a, b, out), (m, n, k, reps, LAYOUTS[layout][0]))
    globals()[f"launches_{layout}"] += 1
    return out
