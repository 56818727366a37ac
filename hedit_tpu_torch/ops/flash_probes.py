"""The flash-attention probes: hand-written CUDA forwards of the JAX
package's attention cost probes, and their plain versions.

Port of the TPU kernels of four cost probes of the JAX package (the probes'
harnesses have their own port under ``hedit_tpu_torch/probes/``):

* ``scripts/flash_nhd_variants.py``: three bounded (max-free) forwards that
  write the packed, transposed output ``[B, H*D, Sq]``, with the shift
  anchored on the first ``anchor`` keys (the TPU kernel's ``blk_k``):

  - ``flash_packed_t_cuda``: q, k, v ``[B, H, S, D]`` (``_packed_t_kernel``);
  - ``flash_packed_t_sminor_cuda``: q, k S-minor ``[B, H, D, S]``, v
    ``[B, H, S, D]`` (``_packed_t_kernel_sminor``);
  - ``flash_packed_t_all_sminor_cuda``: q, k, v ``[B, H, D, S]``
    (``_packed_t_kernel_all_sminor``).

  All three run in bf16 on the tensor cores (``csrc/flash_probes_tc.cu``,
  ``probe_entry``), in float32 on the query-major kernel of
  ``csrc/flash_variants.cu`` (every operand 16-byte aligned).

* ``scripts/flash_v4_variants.py``: ``flash_exp2_t_cuda``, the exact forward
  with ``sm_scale * log2(e)`` folded into q, exp2, p rounded to the input
  dtype and a ``[B*H, D, Sq]`` output (``kern_exp2``); ``pipe=True`` runs
  the software-pipelined key loop.  bf16 on the tensor cores
  (``csrc/flash_probes_tc.cu``, ``exp2_entry``), float32 on the
  query-major kernel (``csrc/flash_variants.cu``, every operand 16-byte
  aligned), whose key tile (``exp2_key_tile``) is the block of the running
  max that its plain version takes.

* ``scripts/flash_ablate.py``: ``flash_ablate_t_cuda(q, k, v, mode)``, the
  bounded loop cut down to its floor (``make_kernel(mode)``): q unscaled, no
  prologue, p = s (``dots``), exp2(s) (``exp``) or exp2(min(s - 12.34, 100))
  (``noprolog``) rounded to the input dtype, the sum of p floored at 1e-30,
  a ``[B*H, D, Sq]`` output.  bf16 on the tensor cores
  (``csrc/flash_probes_tc.cu``, ``ablate_entry``), float32 on the
  query-major kernel (``csrc/flash_variants.cu``, every operand 16-byte
  aligned).  ``dots`` in bf16 is checked on the kernel's
  own scores and row sums (``flash_ablate_dots_check_cuda``,
  ``check_ablate_dots_kernel``).

* ``scripts/flash_variants.py``: exact forwards entirely in float32 on the
  script's ``[B*H, S, D]`` operands, in three layouts
  (``csrc/flash_variants.cu``):

  - ``flash_variant_a_cuda``: ``[Sq, D]`` output (``kern_a``);
    ``pv_bf16=True`` rounds p to bf16 for the PV product (the script's
    ``d_bf16pv``), in bf16 on the tensor cores (``csrc/flash_probes_tc.cu``,
    ``variant_entry``);
  - ``flash_variant_b_cuda``: a transposed ``[D, Sq]`` output (``kern_b``);
  - ``flash_variant_c_cuda``: key-major scores, softmax down the key axis,
    transposed output (``kern_c``), a kernel of its own in both dtypes
    (``hedit_flash_variant_c``).

  a, b and float32 a with ``pv_bf16`` share one query-major kernel
  (``hedit_flash_variant``): softmax along the row inside a warp, PV on the
  CUDA cores; the float32 instances of the bounded probes, of the exact
  exp2 probe and of the ablations run on it too (``hedit_flash_packed_t``,
  ``hedit_flash_exp2_t``, ``hedit_flash_ablate_t``).  Both kernels take the
  scores' product on the tensor cores in bf16 and by FMAs in float32, copy
  16 bytes at a time (every operand 16-byte aligned) and count their
  launches a dtype
  (``launches_variant_{a,b,c}_tc`` / ``_f32``; float32 d
  ``launches_variant_d``).

``[B*H, D, Sq]`` and ``[B, H*D, Sq]`` are the same memory: head h of batch
row b is rows ``h*D .. (h+1)*D`` of that row's image, so the kernels write
either form with the same stores; the wrappers return the TPU wrappers' form.

As on the TPU, a probe covers only whole blocks: Sq and Sk must be multiples
of 64 (the CUDA tile), and for the bounded probes Sk a multiple of the anchor,
itself a multiple of 64; anything else raises, whatever the device.  A CPU
tensor takes the plain version (``flash_packed_t_reference`` etc.), a CUDA
tensor launches the kernel or raises.  The plain versions of the ablations
and the float32 variants work through ``B*H`` in chunks: the float32 scores
of the probes' shapes take 2-8.6 GB.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from hedit_tpu_torch.ops.flash_attention import (
    _bounded, _check_device_dtype, _launch, _on_cpu, check_f32_operands, check_tc_operands,
)

# launches of each CUDA kernel since the last reset (read by chip_smoke.py)
launches_packed_t = 0
launches_packed_t_sminor = 0
launches_packed_t_all_sminor = 0
launches_packed_t_tc = 0              # the same three in bf16 on the tensor cores
launches_packed_t_sminor_tc = 0
launches_packed_t_all_sminor_tc = 0
launches_exp2_t = 0
launches_exp2_t_tc = 0                # the same in bf16 on the tensor cores
launches_ablate_dots = 0
launches_ablate_exp = 0
launches_ablate_noprolog = 0
launches_ablate_dots_tc = 0           # the same three in bf16 on the tensor cores
launches_ablate_exp_tc = 0
launches_ablate_noprolog_tc = 0
launches_ablate_dots_check_tc = 0     # dots' check-only instance (scores and sums stored)
launches_variant_a_tc = 0   # kern_a: bf16 (scores on the tensor cores), the query-major kernel
launches_variant_a_f32 = 0  # kern_a: float32, the same kernel
launches_variant_b_tc = 0   # kern_b: bf16, the same kernel
launches_variant_b_f32 = 0  # kern_b: float32, the same kernel
launches_variant_d = 0      # kern_a with pv_bf16 (the script's d_bf16pv): float32, the same kernel
launches_variant_d_tc = 0   # the same in bf16 on the tensor cores (csrc/flash_probes_tc.cu)
launches_variant_c_tc = 0   # kern_c: bf16 (scores on the tensor cores)
launches_variant_c_f32 = 0  # kern_c: float32, the same kernel

PROBE_HEAD_DIMS = (40, 80)
VARIANT_HEAD_DIM = 40       # flash_variants.py's D; the only one its kernel takes
ABLATE_MODES = ("dots", "exp", "noprolog")
ABLATE_FLOOR = 1e-30        # flash_ablate.py's floor of the sum of p
_ABLATE_SHIFT = 12.34       # flash_ablate.py's constant shift (noprolog)
_CHUNK_SCORES = 2 ** 28     # float32 scores a chunk of the plain versions holds (1 GiB)
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


def _bounded_probe_reference(q, k, v, anchor: int, layout: str, out_dtype=None) -> torch.Tensor:
    qs, ks, vs = (_to_sd(t, m) for t, m in zip((q, k, v), _LAYOUTS[layout][1]))
    return _packed_t(_bounded(qs, ks, vs, anchor, out_dtype)[0])


def flash_packed_t_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             anchor: int = BLK_K,
                             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of ``_packed_t_kernel``: q, k, v [B, H, S, D] -> [B, H*D,
    Sq] in q's dtype, or in ``out_dtype`` (float32: the output before its
    final rounding); the bounded forward of ``ops/flash_attention.py``
    (q * scale, p and the output rounded to the input dtype, the shift from
    the first ``anchor`` keys, the denominator floored at 1.2e-38)."""
    return _bounded_probe_reference(q, k, v, anchor, "packed_t", out_dtype)


def flash_packed_t_sminor_reference(qt: torch.Tensor, kt: torch.Tensor, v: torch.Tensor,
                                    anchor: int = BLK_K,
                                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of ``_packed_t_kernel_sminor``: qt, kt [B, H, D, S], v
    [B, H, S, D] -> [B, H*D, Sq] in q's dtype, or in ``out_dtype`` (float32:
    the output before its final rounding)."""
    return _bounded_probe_reference(qt, kt, v, anchor, "packed_t_sminor", out_dtype)


def flash_packed_t_all_sminor_reference(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                                        anchor: int = BLK_K,
                                        out_dtype: Optional[torch.dtype] = None
                                        ) -> torch.Tensor:
    """Plain version of ``_packed_t_kernel_all_sminor``: qt, kt, vt
    [B, H, D, S] -> [B, H*D, Sq] in q's dtype, or in ``out_dtype``."""
    return _bounded_probe_reference(qt, kt, vt, anchor, "packed_t_all_sminor", out_dtype)


def flash_exp2_t_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           blk_k: int = TILE,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of ``kern_exp2``: q, k, v [B, H, S, D] -> [B*H, D, Sq] in
    q's dtype, or in ``out_dtype`` (float32: the output before its final
    rounding).  q * sm_scale * log2(e) rounded to the input dtype, float32
    scores; over key blocks of ``blk_k`` a running max m, p = exp2(s - m_new)
    rounded to the input dtype, alpha = exp2(m_old - m_new), the sum from the
    rounded p; out = acc / sum, no floor.  The key block decides only the
    point p is rounded against: the CUDA kernels take ``exp2_key_tile`` (64
    keys, 32 at d = 80 in float32), the TPU wrapper's default is ``BLK_K``
    (512)."""
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
    return _packed_t((acc / denom).to(out_dtype or q.dtype)).reshape(b * h, d, sq)


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


def _tc_or_core(dtype: torch.dtype, entry: str, what: str, tc: bool = True) -> str:
    """``entry``'s tensor-core twin (``csrc/flash_probes_tc.cu``) for
    bfloat16 where ``tc``, ``entry`` itself (a CUDA-core kernel's)
    otherwise; raises for a dtype other than float32 and bfloat16."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} take float32 or bfloat16, got {dtype}")
    return f"{entry}_tc" if tc and dtype == torch.bfloat16 else entry


def probe_entry(dtype: torch.dtype, layout: str) -> str:
    """The CUDA entry point of the bounded probe ``layout`` for an input of
    ``dtype``: bfloat16 the tensor-core kernel (``csrc/flash_probes_tc.cu``),
    float32 the query-major kernel (``csrc/flash_variants.cu``).  Raises for
    any other dtype or layout."""
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {tuple(_LAYOUTS)}, not {layout!r}")
    return _tc_or_core(dtype, "hedit_flash_packed_t", "the bounded probes")


def exp2_entry(dtype: torch.dtype) -> str:
    """The CUDA entry point of the exact exp2 probe for an input of
    ``dtype``: bfloat16 the tensor-core kernel (``csrc/flash_probes_tc.cu``),
    float32 the query-major kernel (``csrc/flash_variants.cu``)."""
    return _tc_or_core(dtype, "hedit_flash_exp2_t", "the exact exp2 probe")


def exp2_key_tile(dtype: torch.dtype, d: int) -> int:
    """The key tile over which the exact exp2 probe's kernel moves its
    running max, and so the ``blk_k`` of its plain version: the query-major
    kernel's 32 keys at d = 80 in float32, 64 otherwise."""
    return 32 if dtype == torch.float32 and d == 80 else TILE


def ablate_entry(dtype: torch.dtype, mode: str) -> str:
    """The CUDA entry point of the ablation ``mode`` for an input of
    ``dtype``: bfloat16 the tensor-core kernel, float32 the query-major
    kernel (``csrc/flash_variants.cu``).  Raises for any other dtype or
    mode."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"mode must be one of {ABLATE_MODES}, not {mode!r}")
    return _tc_or_core(dtype, "hedit_flash_ablate_t", "the ablations")


def variant_entry(dtype: torch.dtype, name: str) -> str:
    """The CUDA entry point of variant ``name`` (``a``-``d``) for an input
    of ``dtype``: ``c`` its own kernel in both dtypes
    (``hedit_flash_variant_c``), bfloat16 ``d`` the tensor-core kernel
    (``csrc/flash_probes_tc.cu``), the rest the query-major kernel
    (``hedit_flash_variant``, ``csrc/flash_variants.cu``).  Raises for any
    other dtype or name."""
    if name not in _VARIANTS:
        raise ValueError(f"variant must be one of {tuple(_VARIANTS)}, not {name!r}")
    entry = _tc_or_core(dtype, "hedit_flash_variant", "the variants", tc=name == "d")
    return "hedit_flash_variant_c" if name == "c" else entry


# the float32 entry points of the query-major kernel (``csrc/flash_variants.cu``)
_QM_F32_ENTRIES = ("hedit_flash_packed_t", "hedit_flash_exp2_t", "hedit_flash_ablate_t")


def _launch_probe(entry: str, counter: str, q: torch.Tensor, pointers, ints, d: int,
                  strides) -> None:
    """Launch probe entry point ``entry`` on ``pointers`` (q, k, v, out) and
    count it in ``counter``, or in ``counter + "_tc"`` for a tensor-core
    entry.  The operands of a tensor-core entry must first pass
    ``check_tc_operands``, those of the query-major kernel's float32 entries
    ``check_f32_operands`` (dense images: the element ``strides`` are
    multiples of S, itself of TILE)."""
    tc = entry.endswith("_tc")
    if tc:
        check_tc_operands(d, [t.data_ptr() for t in pointers], strides)
    elif entry in _QM_F32_ENTRIES:
        check_f32_operands(d, [t.data_ptr() for t in pointers], strides, None)
    _launch(entry, q, pointers, ints)
    globals()[counter + "_tc" if tc else counter] += 1


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
    _launch_probe(probe_entry(q.dtype, layout), f"launches_{layout}", q, (q, k, v, out),
                  (b * h, sq, sk, d, anchor, code), d, [sq, sk])
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
    the software-pipelined key loop (the same bits).  The kernel moves its
    running max once a key tile, ``exp2_key_tile`` (64 keys; 32 at d = 80 in
    float32), as ``kern_exp2`` does with that ``blk_k`` (its wrapper's
    default block is 512 keys, which rounds p against other points): its
    plain version is ``flash_exp2_t_reference`` with that block.  bf16 runs
    on the tensor cores, float32 on the query-major kernel (``exp2_entry``)."""
    b, h, sq, sk, d = _dims(q, k, v, (False, False, False), "flash_exp2_t_cuda")
    if _on_cpu(q, k, v):
        return flash_exp2_t_reference(q, k, v, blk_k=exp2_key_tile(q.dtype, d))
    _check_cuda(q, k, v, b, h, d, "flash_exp2_t_cuda")
    out = torch.empty((b * h, d, sq), dtype=q.dtype, device=q.device)
    _launch_probe(exp2_entry(q.dtype), "launches_exp2_t", q, (q, k, v, out),
                  (b * h, sq, sk, d, int(bool(pipe))), d, [sq, sk])
    return out


def _chunks(bh: int, sq: int, sk: int):
    """Slices of the B*H rows whose float32 scores fit in ``_CHUNK_SCORES``."""
    step = max(1, _CHUNK_SCORES // (sq * sk))
    return [slice(i, min(i + step, bh)) for i in range(0, bh, step)]


def _ablate_weights(s: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "dots":
        return s
    if mode == "exp":
        return torch.exp2(s)
    return torch.exp2(torch.clamp(s - _ABLATE_SHIFT, max=100.0))


def _scores_in_order(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [n, Sq, D] k^T in float32, summed over D in order, one rounding a
    term: the float32 kernels' FMA chain over d (their float32 products
    may round once more here)."""
    qf, kf = q.float(), k.float()
    s = torch.zeros((q.shape[0], q.shape[1], k.shape[1]), device=q.device)
    for c in range(q.shape[-1]):
        s.addcmul_(qf[:, :, c, None], kf[:, None, :, c])
    return s


def _ablate_rows(q, k, v, mode: str):
    """Per chunk of B*H rows: (rows, scores, p in float32 after its rounding
    to the input dtype, v in float32) of the ablation ``mode``."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"mode must be one of {ABLATE_MODES}, not {mode!r}")
    b, h, sq, d = q.shape
    qf, kf, vf = (t.reshape(b * h, -1, d) for t in (q, k, v))
    for rows in _chunks(b * h, sq, kf.shape[1]):
        s = _scores_in_order(qf[rows], kf[rows])
        yield rows, s, _ablate_weights(s, mode).to(q.dtype).float(), vf[rows].float()


def flash_ablate_t_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             mode: str, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of ``make_kernel(mode)``: q, k, v [B, H, S, D] -> [B*H,
    D, Sq] in q's dtype, or in ``out_dtype`` (float32: the output before its
    final rounding).  Scores of the unscaled q in float32 (summed over D in
    the float32 kernel's order), p of ``mode`` rounded to the input dtype,
    out = (p v) / max(sum(p), 1e-30)."""
    b, h, sq, d = q.shape
    out = torch.empty((b * h, d, sq), dtype=out_dtype or q.dtype, device=q.device)
    for rows, _, p, vf in _ablate_rows(q, k, v, mode):
        den = torch.clamp(p.sum(dim=-1, keepdim=True), min=ABLATE_FLOOR)
        out[rows] = (torch.matmul(p, vf) / den).to(out.dtype).transpose(-1, -2)
    return out


def _ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One unit in the last place of each element of x in ``dtype``."""
    bits = 8 if dtype == torch.bfloat16 else 24
    exponent = torch.frexp(x.float()).exponent
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - bits)


def ablate_dots_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          want: torch.Tensor):
    """(tol [B*H, D, Sq], excused [B*H, Sq]) for the ``dots`` ablation, whose
    sum of p (the denominator) is as often negative as positive.

    Two computations of the same function differ in float32 summation order
    (the float32 kernel and the plain version, or JAX's kernel).
    Each Sk-term sum moves by at most gamma = 4 sqrt(Sk) 2^-24 times the sum
    of its terms' magnitudes.  Each score moves too, by up to ds = 4 sqrt(D)
    2^-24 sum_c |q_c k_c|, and p, rounded to the input dtype, can land on either
    neighbour: u_k = p(s + ds) - p(s - ds); those moves are independent, so
    their sum is taken as 4 sqrt(sum u^2).  The denominator may so move by
    e_den = gamma sum|p| + 4 sqrt(sum u^2), the numerator by gamma sum|p v| +
    4 sqrt(sum u^2 v^2).  An element of ``want`` (the plain version's output)
    is held within ulp(want) + (the numerator's move + |want| e_den) /
    (den - e_den) where the denominator is positive; where it is negative
    both sides divide by the floor (1e-30), and the |want| term drops.  Rows
    whose denominator lies within e_den of zero can fall on either side of
    the floor: they are excused, and counted by the caller."""
    b, h, sq, d = q.shape
    gamma = 4.0 * math.sqrt(k.shape[2]) * 2.0 ** -24
    gamma_d = 4.0 * math.sqrt(d) * 2.0 ** -24
    tol = torch.empty((b * h, d, sq), device=q.device)
    excused = torch.empty((b * h, sq), dtype=torch.bool, device=q.device)
    w = want.float()
    qf, kf = (t.reshape(b * h, -1, d) for t in (q, k))
    for rows, s, p, vf in _ablate_rows(q, k, v, "dots"):
        e_den = gamma * p.abs().sum(dim=-1)[:, None, :]                    # [n, 1, Sq]
        e_num = gamma * torch.matmul(p.abs(), vf.abs()).transpose(-1, -2)  # [n, D, Sq]
        ds = gamma_d * torch.matmul(qf[rows].float().abs(),
                                    kf[rows].float().abs().transpose(-1, -2))
        u2 = ((s + ds).to(q.dtype).float() - (s - ds).to(q.dtype).float()).square()
        del ds
        e_den = e_den + 4.0 * u2.sum(dim=-1).sqrt()[:, None, :]
        e_num = e_num + 4.0 * torch.matmul(u2, vf.square()).sqrt().transpose(-1, -2)
        del u2, s
        den = p.sum(dim=-1)[:, None, :]
        positive = den > e_den
        divisor = torch.clamp(torch.where(positive, den - e_den, torch.zeros_like(den)),
                              min=ABLATE_FLOOR)
        slack = e_num + torch.where(positive, w[rows].abs() * e_den, torch.zeros_like(e_num))
        tol[rows] = _ulp(w[rows], want.dtype) + slack / divisor
        excused[rows] = (den.abs() <= e_den)[:, 0]
    return tol, excused


# A model of one mma.sync m16n8k16 step with float32 accumulation, d = c +
# sum of 16 products of bf16 values: the products are exact in float32, and
# the hardware's sum (not specified as a chain of IEEE adds; measurements of
# earlier tensor cores found the addends aligned to the largest exponent and
# truncated) is taken to lie within MMA_STEP_ULPS units of 2^-23 of the
# largest magnitude among c and the 16 products: one unit for each of the 17
# addends' alignment and one more for the result's normalisation, doubled
# for margin.
MMA_STEP_ULPS = 2 * 17
_U23 = 2.0 ** -23


def mma_sum_bound(magnitude: torch.Tensor, steps: int) -> torch.Tensor:
    """How far a sum taken in ``steps`` mma.sync steps may lie from the exact
    one, given ``magnitude`` = sum over the steps of (|exact partial sum
    before the step| + the step's largest |product|), or any upper bound of
    it.  Step k errs by at most g M_k (g = ``MMA_STEP_ULPS`` 2^-23), M_k <=
    |C_{k-1}| + E_{k-1} + max |x_k|, so E <= g (magnitude + steps E): E <=
    g magnitude / (1 - g steps)."""
    g = MMA_STEP_ULPS * _U23
    return magnitude * (g / (1.0 - g * steps))


def ablate_dots_score_tolerance(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """How far the tensor-core kernel's float32 score q . k (bf16 q [n, Sq,
    D], k [n, Sk, D]) may lie from the exact one: the contraction is D
    zero-padded to ceil(D / 16) k16 steps (three at D = 40) of exact
    products, and each step's partial sums and largest product are bounded
    by sum_c |q_c k_c|, so ``mma_sum_bound(steps * sum_c |q_c k_c|,
    steps)``; [n, Sq, Sk] in float64."""
    steps = -(-q.shape[-1] // 16)
    magnitude = torch.matmul(q.double().abs(), k.double().abs().transpose(-1, -2))
    return mma_sum_bound(steps * magnitude, steps)


def ablate_dots_row_sums(scores: torch.Tensor) -> torch.Tensor:
    """The tensor-core ``dots`` kernel's row sums from its float32 scores
    [n, Sq, Sk], in its order, bit for bit: p = bf16(score); lane t of a row
    adds, n-tile by n-tile (8 keys) from 0, the pair p[8j + 2t] + p[8j + 2t +
    1]; then lanes t and t ^ 1, then t and t ^ 2 (all float32 adds rounded
    to nearest, as the CUDA cores add).  [n, Sq] float32."""
    n, sq, sk = scores.shape
    p = scores.to(torch.bfloat16).float().reshape(n, sq, sk // 8, 4, 2)
    pairs = p[..., 0] + p[..., 1]
    lanes = torch.zeros_like(pairs[:, :, 0])
    for j in range(sk // 8):
        lanes += pairs[:, :, j]
    return (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])


def ablate_dots_output_tolerance(v: torch.Tensor, scores: torch.Tensor, sums: torch.Tensor,
                                 dtype: torch.dtype = torch.bfloat16):
    """(want, tol), both [n, D, Sq] float64, for the ``dots`` kernel's output
    from its own float32 scores [n, Sq, Sk] and row sums [n, Sq], v [n, Sk,
    D].  want = the exact numerator sum_k bf16(score_k) v_k over the kernel's
    own denominator max(sum, 1e-30).  The kernel's numerator is a tensor-core
    sum of those exact products in 16-key steps, key order: it lies within
    ``mma_sum_bound`` of the exact one, its magnitude the sum over the steps
    of |the exact partial sum before the step| plus the step's sum of
    |products|.  Its quotient is rounded to float32 (2^-23 |want|) and to
    ``dtype`` (one ulp of want): tol = ulp(want) + 2^-23 |want| + bound /
    max(sum, 1e-30).  Dividing both sides by the kernel's own sum leaves no
    row ill-conditioned, whatever the sign of its sum."""
    n, sq, sk = scores.shape
    d = v.shape[-1]
    steps = sk // 16
    p = scores.to(torch.bfloat16).double()
    vd = v.double()
    blocks = torch.matmul(p.reshape(n, sq, steps, 16).transpose(1, 2),
                          vd.reshape(n, steps, 16, d))                 # [n, steps, Sq, D]
    partial = blocks.cumsum(dim=1)
    num = partial[:, -1]
    magnitude = partial[:, :-1].abs().sum(dim=1) + torch.matmul(p.abs(), vd.abs())
    del blocks, partial
    den = torch.clamp(sums.float(), min=ABLATE_FLOOR).double()[..., None]  # [n, Sq, 1]
    want = (num / den).transpose(-1, -2)
    bound = (mma_sum_bound(magnitude, steps) / den).transpose(-1, -2)
    tol = _ulp(want, dtype).double() + _U23 * want.abs() + bound
    return want, tol


def ablate_dots_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                      scores: torch.Tensor, sums: torch.Tensor) -> dict:
    """The ``dots`` kernel held on its own numbers, q, k, v [n, S, D] bf16,
    its output [n, D, Sq], float32 scores [n, Sq, Sk] and row sums [n, Sq]:
    (ii) every score within ``ablate_dots_score_tolerance`` of the exact
    (float64) q . k; (iii) every row sum the kernel's order of its own
    rounded scores, bit for bit (``ablate_dots_row_sums``); (iv) every
    output element within ``ablate_dots_output_tolerance`` of the exact
    numerator over the kernel's sum.  Returns the largest error over
    tolerance of (ii) and (iv), the error and tolerance at (iv)'s largest
    ratio, the rows whose sum differs and the rows whose sum the floor
    replaced (sum <= 1e-30)."""
    exact = torch.matmul(q.double(), k.double().transpose(-1, -2))
    score_ratio = ((scores.double() - exact).abs()
                   / ablate_dots_score_tolerance(q, k)).max().item()
    del exact
    plain_sums = ablate_dots_row_sums(scores)
    differing = int((plain_sums != sums).sum())
    want, tol = ablate_dots_output_tolerance(v, scores, sums, out.dtype)
    err = (out.double() - want).abs()
    ratio = err / tol
    worst = int(ratio.argmax())
    return {"score_err_over_tol": score_ratio, "sums_differing_rows": differing,
            "out_err_over_tol": ratio.flatten()[worst].item(),
            "err_at_worst": err.flatten()[worst].item(), "tol_at_worst": tol.flatten()[worst].item(),
            "floored_rows": int((sums <= ABLATE_FLOOR).sum())}


def flash_ablate_dots_check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The ``dots`` kernel's check-only instance on bf16 q, k, v [B, H, S,
    D]: (out [B*H, D, Sq], its float32 scores [B*H, Sq, Sk] before their
    rounding, its row sums [B*H, Sq] before the floor); the output is the
    timed kernel's bit for bit.  CPU tensors: the plain version with the
    kernel's order of the row sums (the scores summed over D in order,
    ``ablate_dots_row_sums``, out = p v / max(sum, 1e-30)).  Not a kernel of
    the probe's path: its launches count in ``launches_ablate_dots_check_tc``."""
    b, h, sq, sk, d = _dims(q, k, v, (False, False, False), "flash_ablate_dots_check_cuda")
    if _on_cpu(q, k, v):
        parts = []
        for _, s, p, vf in _ablate_rows(q, k, v, "dots"):
            sums = ablate_dots_row_sums(s)
            den = torch.clamp(sums, min=ABLATE_FLOOR)[..., None]
            parts.append(((torch.matmul(p, vf) / den).to(q.dtype).transpose(-1, -2), s, sums))
        return tuple(torch.cat(part) for part in zip(*parts))
    _check_cuda(q, k, v, b, h, d, "flash_ablate_dots_check_cuda")
    if q.dtype != torch.bfloat16:
        raise ValueError("flash_ablate_dots_check_cuda: the check instance is the tensor-core "
                         f"kernel's, bf16 only, got {q.dtype}")
    out = torch.empty((b * h, d, sq), dtype=q.dtype, device=q.device)
    scores = torch.empty((b * h, sq, sk), dtype=torch.float32, device=q.device)
    sums = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    check_tc_operands(d, [t.data_ptr() for t in (q, k, v, out)], [sq, sk])
    _launch("hedit_flash_ablate_dots_check_tc", q, (q, k, v, out, scores, sums),
            (b * h, sq, sk, d))
    global launches_ablate_dots_check_tc
    launches_ablate_dots_check_tc += 1
    return out, scores, sums


def check_ablate_dots_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, images: int = 8) -> dict:
    """Hold the bf16 ``dots`` output ``out`` [B*H, D, Sq] of q, k, v [B, H,
    S, D] on the kernel's own numbers, ``images`` B*H images a pass (the
    scores of the probe's shape take 8 GiB): (i) ``out`` is the check
    instance's output bit for bit, then ``ablate_dots_check`` on each pass.
    Returns the worst of each over all passes (the error and tolerance of
    the pass with the largest output ratio), the sums over them of the row
    counts, the row count and the rows excused (none: no row is)."""
    b, h, sq, d = q.shape
    qf, kf, vf = (t.reshape(b * h, -1, d) for t in (q, k, v))
    worst = {"bit_identical": True, "score_err_over_tol": 0.0, "sums_differing_rows": 0,
             "out_err_over_tol": -1.0, "err_at_worst": 0.0, "tol_at_worst": 0.0,
             "floored_rows": 0, "row_count": b * h * sq, "excused_rows": 0}
    bits = torch.int16 if out.element_size() == 2 else torch.int32
    for i in range(0, b * h, images):
        rows = slice(i, min(i + images, b * h))
        got, scores, sums = flash_ablate_dots_check_cuda(qf[None, rows], kf[None, rows],
                                                         vf[None, rows])
        worst["bit_identical"] &= torch.equal(got.view(bits), out[rows].view(bits))
        one = ablate_dots_check(qf[rows], kf[rows], vf[rows], out[rows], scores, sums)
        del got, scores, sums
        if one["out_err_over_tol"] > worst["out_err_over_tol"]:
            worst.update({key: one[key] for key in ("out_err_over_tol", "err_at_worst",
                                                    "tol_at_worst")})
        worst["score_err_over_tol"] = max(worst["score_err_over_tol"], one["score_err_over_tol"])
        for key in ("sums_differing_rows", "floored_rows"):
            worst[key] += one[key]
    return worst


def flash_ablate_t_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mode: str) -> torch.Tensor:
    """``make_kernel(mode)``: q, k, v [B, H, S, D] -> [B*H, D, Sq]; ``mode``
    one of ``ABLATE_MODES``.  bf16 runs on the tensor cores, float32 on the
    query-major kernel (``ablate_entry``)."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"mode must be one of {ABLATE_MODES}, not {mode!r}")
    b, h, sq, sk, d = _dims(q, k, v, (False, False, False), "flash_ablate_t_cuda")
    if _on_cpu(q, k, v):
        return flash_ablate_t_reference(q, k, v, mode)
    _check_cuda(q, k, v, b, h, d, "flash_ablate_t_cuda")
    out = torch.empty((b * h, d, sq), dtype=q.dtype, device=q.device)
    _launch_probe(ablate_entry(q.dtype, mode), f"launches_ablate_{mode}", q, (q, k, v, out),
                  (b * h, sq, sk, d, ABLATE_MODES.index(mode)), d, [sq, sk])
    return out


def _exact_f32(q, k, v, pv_bf16: bool, blk_k: int, out_dtype=None) -> torch.Tensor:
    """q, k, v [BH, S, D] -> [BH, Sq, D] in q's dtype (or ``out_dtype``):
    ``kern_a``'s exact softmax in float32 (q upcast and times sm_scale, not
    rounded).  Without ``pv_bf16`` one softmax over all keys (the key blocks
    move it by rounding only); with it the loop over ``blk_k``-key blocks of
    the running max, p rounded to bf16 for the PV product and unrounded in
    the sum."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32)
    out = torch.empty((bh, sq, d), dtype=out_dtype or q.dtype, device=q.device)
    for rows in _chunks(bh, sq, sk):
        qs = q[rows].float() * scale
        if not pv_bf16:
            s = torch.matmul(qs, k[rows].float().transpose(-1, -2))
            p = torch.exp(s - torch.clamp(s.amax(dim=-1, keepdim=True), min=_NEG_INF))
            out[rows] = (torch.matmul(p, v[rows].float()) / p.sum(dim=-1, keepdim=True)
                         ).to(out.dtype)
            continue
        m = torch.full((qs.shape[0], sq, 1), _NEG_INF, device=q.device)
        denom = torch.zeros_like(m)
        acc = torch.zeros_like(qs)
        for k0 in range(0, sk, blk_k):
            s = torch.matmul(qs, k[rows, k0:k0 + blk_k].float().transpose(-1, -2))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            denom = denom * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(),
                                             v[rows, k0:k0 + blk_k].float())
            m = m_new
        out[rows] = (acc / denom).to(out.dtype)
    return out


def flash_variant_a_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              pv_bf16: bool = False, blk_k: int = TILE,
                              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of ``kern_a``: q, k, v [BH, S, D] -> [BH, Sq, D] in q's
    dtype, or in ``out_dtype`` (float32: the output before its final
    rounding).  ``blk_k`` is the key block of the running max, which decides
    the point p is rounded against with ``pv_bf16``: the CUDA kernels' 64-key
    tile by default, the TPU kernel's ``BLK_K`` is 512."""
    return _exact_f32(q, k, v, pv_bf16, blk_k, out_dtype)


def flash_variant_b_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                              ) -> torch.Tensor:
    """Plain version of ``kern_b`` (and of ``kern_c``, the same function):
    q, k, v [BH, S, D] -> the transposed [BH, D, Sq] in q's dtype."""
    return _exact_f32(q, k, v, False, TILE).transpose(-1, -2).contiguous()


flash_variant_c_reference = flash_variant_b_reference


# each variant's entry-point code and whether its output is transposed
_VARIANTS = {"a": (0, False), "d": (1, False), "b": (2, True), "c": (3, True)}


def _variant(q, k, v, name: str) -> torch.Tensor:
    what = f"flash_variant_{'a' if name == 'd' else name}_cuda"
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{what}: q, k, v must be [B*H, S, D]")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(f"{what}: shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if sq % TILE or sk % TILE or sq < TILE or sk < TILE:
        raise ValueError(f"{what}: Sq = {sq} and Sk = {sk} must be multiples of {TILE}: "
                         f"the probe covers whole blocks and masks nothing")
    code, transposed = _VARIANTS[name]
    if _on_cpu(q, k, v):
        return (flash_variant_b_reference(q, k, v) if transposed
                else flash_variant_a_reference(q, k, v, pv_bf16=name == "d"))
    _check_device_dtype(q, k, v, what)
    if d != VARIANT_HEAD_DIM or bh > 65535:
        raise ValueError(f"{what} does not take q{tuple(q.shape)}: head dim must be "
                         f"{VARIANT_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k, v must be contiguous")
    out = torch.empty((bh, d, sq) if transposed else (bh, sq, d), dtype=q.dtype,
                      device=q.device)
    bf16 = q.dtype == torch.bfloat16
    if name == "d" and bf16:
        _launch_probe(variant_entry(q.dtype, name), "launches_variant_d", q, (q, k, v, out),
                      (bh, sq, sk, d, code), d, [sq, sk])
        return out
    # the query-major kernel and row 9 c's copy 16 bytes at a time in either dtype
    addresses = [t.data_ptr() for t in (q, k, v, out)]
    if bf16:
        check_tc_operands(d, addresses, [sq, sk])
    else:
        check_f32_operands(d, addresses, [sq, sk], None)
    _launch(variant_entry(q.dtype, name), q, (q, k, v, out),
            (bh, sq, sk, d) if name == "c" else (bh, sq, sk, d, code))
    counter = "d" if name == "d" else f"{name}_{'tc' if bf16 else 'f32'}"
    globals()[f"launches_variant_{counter}"] += 1
    return out


def flash_variant_a_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pv_bf16: bool = False) -> torch.Tensor:
    """``kern_a``: q, k, v [BH, S, D] -> [BH, Sq, D].  The kernels move their
    running max once a 64-key tile: the plain version is
    ``flash_variant_a_reference`` with its default block.  bf16 with
    ``pv_bf16`` runs on the tensor cores, the rest on the query-major kernel
    (``variant_entry``)."""
    return _variant(q, k, v, "d" if pv_bf16 else "a")


def flash_variant_b_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``kern_b``: q, k, v [BH, S, D] -> [BH, D, Sq], a transposed output
    (the query-major kernel: a's arithmetic, b's stores)."""
    return _variant(q, k, v, "b")


def flash_variant_c_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``kern_c``: q, k, v [BH, S, D] -> [BH, D, Sq], key-major scores
    (``hedit_flash_variant_c``: the scores' product on the tensor cores in
    bf16, by FMAs in float32; the scale after it; PV on the CUDA cores)."""
    return _variant(q, k, v, "c")
