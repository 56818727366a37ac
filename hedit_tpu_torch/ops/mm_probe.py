"""The matmul cost probe: hand-written CUDA kernels that accumulate ``reps``
nudged matmuls in float32, and their plain version.

Port of the TPU kernel of ``scripts/mm_probe.py`` (``_loop_kernel``; the
probe's harness has its own port, ``hedit_tpu_torch/probes/mm_probe.py``)::

    o = sum_{i < reps} dot(nudge_i(a), b),   nudge_i(a) = a + i in a's dtype

in float32, with the product in one of the script's four dimension numbers
(``LAYOUTS``): ``nn`` a [M, K] b [K, N]; ``tl`` a [K, M] b [K, N]; ``tr``
a [M, K] b [N, K]; ``tm`` a [K, M] b [N, K]; the output is [M, N] float32.
The nudge is rounded to a's dtype each rep (bf16 on the probe), so it does
not factor out of the sum.

A CPU tensor takes the plain version (``mm_loop_reference``).  A CUDA tensor
launches a kernel or raises: bf16 (the script's dtype) the tensor-core kernel
of ``csrc/mm_probe_tc.cu`` (K split over blocks by ``split_k_plan``), float32
the CUDA-core kernel of ``csrc/mm_probe.cu`` (the contraction split over
blocks by ``core_plan``; ``ENTRIES``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from hedit_tpu_torch.ops.flash_attention import _DTYPE_CODES, _launch, _on_cpu

# launches of each layout's kernel since the last reset (read by chip_smoke.py):
# the tensor-core kernel (bf16), and the CUDA-core one (float32, ``_core``)
launches_nn = 0
launches_tl = 0
launches_tr = 0
launches_tm = 0
launches_nn_core = 0
launches_tl_core = 0
launches_tr_core = 0
launches_tm_core = 0

REPS = 64   # the script's matmuls a call
# layout: (entry-point code, a stored [K, M], b stored [N, K])
LAYOUTS = {"nn": (0, False, False), "tl": (1, True, False), "tr": (2, False, True),
           "tm": (3, True, True)}
# the entry point of each dtype, and the suffix of its launch counters
ENTRIES = {torch.bfloat16: ("hedit_mm_loop_tc", ""), torch.float32: ("hedit_mm_loop", "_core")}
# the card's SMs: both kernels split the contraction where their output
# tiles are fewer, aiming at two blocks an SM
SMS = 132
MMA_K = 16   # mma.sync's K step: every split but K's ragged end is a multiple
# the CUDA-core kernel: K rows of its shared tiles at a time, and the
# shortest K chunk it splits K into
CORE_KT = 32
CORE_MIN_CHUNK = 16


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def tc_tile(m: int, n: int) -> Tuple[int, int]:
    """(rows, columns) of an output tile of the tensor-core kernel, which
    takes them as its ``bm`` and ``bn``: 16 rows a warp, min(4, ceil(M / 16))
    warps; 40 columns (five n8 tiles) where N <= 40, else 64."""
    return 16 * min(4, _cdiv(m, 16)), 40 if n <= 40 else 64


def split_k_plan(m: int, n: int, k: int) -> Tuple[int, int]:
    """(chunk, splits) of the tensor-core kernel: split s covers K rows
    [s chunk, min((s + 1) chunk, K)), chunk a multiple of ``MMA_K``, splits =
    ceil(K / chunk).  One split where the output tiles (``tc_tile``) are at
    least ``SMS``; else as many as bring tiles x splits to about 2 ``SMS``
    (the pv cases: 16 chunks of 128 or 32 of 64, 256 blocks)."""
    bm, bn = tc_tile(m, n)
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    want = 1 if tiles >= SMS else _cdiv(2 * SMS, tiles)
    chunk = MMA_K * _cdiv(_cdiv(k, want), MMA_K)
    return chunk, _cdiv(k, chunk)


class CorePlan(NamedTuple):
    """The CUDA-core kernel's plan, the entry point's arguments in order: a
    thread owns ``rm`` x ``rn`` outputs, a block ``tx`` x ``ty`` threads (a
    tile of ``tile``), its shared tiles ``kt`` rows of K deep; the
    contraction, reps x K terms an output, is cut into ``slices``: K chunks
    of ``chunk`` rows (``ksplits`` of them) times rep ranges of ``rchunk``
    (``rsplits``); slice s is chunk s // rsplits and rep range s % rsplits,
    one block a tile and a slice."""
    rm: int
    rn: int
    tx: int
    ty: int
    kt: int
    chunk: int
    ksplits: int
    rchunk: int
    rsplits: int

    @property
    def tile(self) -> Tuple[int, int]:
        return self.ty * self.rm, self.tx * self.rn

    @property
    def slices(self) -> int:
        return self.ksplits * self.rsplits

    @property
    def shared_bytes(self) -> int:
        """The block's shared tiles (``csrc/mm_probe.cu``): ``kt`` rows of A
        and of B, a thread's rows (columns) in slots rounded up to a
        multiple of 4, each row padded by 4 floats."""
        slots = lambda r: 4 * _cdiv(r, 4)  # noqa: E731
        return 4 * self.kt * (self.ty * slots(self.rm) + 4 + self.tx * slots(self.rn) + 4)


def core_tile(m: int, n: int) -> Tuple[int, int, int, int]:
    """(rm, rn, tx, ty) of the CUDA-core kernel.  A rep costs a thread one
    FADD a row (the nudge) beside rm x rn FMAs, so a thread takes few rows
    and many columns: 128 x 128 tiles of 2 x 32 (4 x 64 threads); 256 x 40
    where N <= 40 (2 x 20, 2 x 128 threads); 40 x 256 where M <= 40 (5 x 8,
    32 x 8 threads: a 40-row tile covered whole); 40 x 40 where both are
    (5 x 8, 5 x 8 threads)."""
    if m <= 40:
        return 5, 8, (5 if n <= 40 else 32), 8
    if n <= 40:
        return 2, 20, 2, 128
    return 2, 32, 4, 64


def _fill(blocks: int) -> float:
    """The share of the card's SMs that ``blocks`` equal blocks keep busy
    over the waves they take."""
    return blocks / (SMS * _cdiv(blocks, SMS))


def core_plan(m: int, n: int, k: int, reps: int = REPS) -> CorePlan:
    """The CUDA-core kernel's plan: ``core_tile``'s tiles; K chunks of at
    least ``CORE_MIN_CHUNK`` rows, at most two blocks an SM (2 ``SMS``
    blocks): of the chunk counts that fill the SMs' waves within 5% of the
    best, the most.  Where the K chunks leave the card below 90% full (K
    short beside few tiles), the reps are cut into ranges too.  The pv
    cases: 64 K chunks of 32 at 4 tiles, 128 of 16 at 2; the qk cases at 64
    tiles: 4 chunks of 32 where K = 128, 2 of 20 or 24 where K = 40 or 48."""
    rm, rn, tx, ty = core_tile(m, n)
    tiles = _cdiv(m, ty * rm) * _cdiv(n, tx * rn)
    want = max(1, 2 * SMS // tiles)
    counts = {_cdiv(k, _cdiv(k, s)) for s in range(1, min(want, _cdiv(k, CORE_MIN_CHUNK)) + 1)}
    best = max(_fill(tiles * s) for s in counts)
    ksplits = max(s for s in counts if _fill(tiles * s) >= best - 0.05)
    chunk = _cdiv(k, ksplits)
    rsplits = 1
    if reps and _fill(tiles * ksplits) < 0.9:
        rsplits = _cdiv(reps, _cdiv(reps, max(1, min(reps, want // ksplits))))
    rchunk = _cdiv(reps, rsplits) if reps else 1
    return CorePlan(rm, rn, tx, ty, min(CORE_KT, chunk), chunk, ksplits, rchunk, rsplits)


def core_partials(a: torch.Tensor, b: torch.Tensor, layout: str, plan: CorePlan,
                  reps: int = REPS) -> torch.Tensor:
    """The CUDA-core kernel's workspace [slices, M, N] in plain tensor code:
    slice s is the float32 sum over its rep range of the nudged A's K chunk
    times B's.  Summed in slice order, it is the function."""
    am, bk = _canonical(a, b, layout)
    bf = bk.float()
    parts = torch.zeros((plan.slices, am.shape[0], bk.shape[1]), device=a.device)
    for s in range(plan.slices):
        k0 = (s // plan.rsplits) * plan.chunk
        r0 = (s % plan.rsplits) * plan.rchunk
        for i in range(r0, min(reps, r0 + plan.rchunk)):
            parts[s] += torch.matmul(nudged(am[:, k0:k0 + plan.chunk], i), bf[k0:k0 + plan.chunk])
    return parts


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


def mm_library_operands(a: torch.Tensor, b: torch.Tensor, layout: str,
                        reps: int = REPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a_cat [M, reps K], b_rep [reps K, N]) in a's dtype: the nudged a's
    side by side along K, and b stacked reps times, so that the one product
    a_cat @ b_rep summed in float32 is the function.  The operands of the
    library yardstick (``torch.mm(a_cat, b_rep, out_dtype=torch.float32)`` on
    the card), made outside its timing; no path calls this."""
    am, bk = _canonical(a, b, layout)
    a_cat = torch.cat([nudged(am, i).to(a.dtype) for i in range(reps)], dim=1)
    return a_cat, bk.repeat(reps, 1)


def mm_loop_cuda(a: torch.Tensor, b: torch.Tensor, layout: str,
                 reps: int = REPS) -> torch.Tensor:
    """``_loop_kernel`` under the dimension numbers of ``layout``: [M, N]
    float32.  Raises on any CUDA input the kernels do not take."""
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
    entry, suffix = ENTRIES[a.dtype]
    code = LAYOUTS[layout][0]
    if a.dtype == torch.bfloat16:
        chunk, splits = split_k_plan(m, n, k)
        ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
              if splits > 1 else out)
        _launch(entry, a, (a, b, out, ws), (m, n, k, reps, code, *tc_tile(m, n), chunk, splits))
    else:
        plan = core_plan(m, n, k, reps)
        ws = (torch.empty((plan.slices, m, n), dtype=torch.float32, device=a.device)
              if plan.slices > 1 else out)
        _launch(entry, a, (a, b, out, ws), (m, n, k, reps, code, *plan))
    globals()[f"launches_{layout}{suffix}"] += 1
    return out
