"""The float32 forward at d = 40 / 80 (``csrc/flash_attention_f32.cu``), bounded
and exact.

This file imports no JAX, so it also runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_f32.py -q

On the CPU: the route (``bounded_entry``, ``lse_entry``, ``exact_entry``:
float32 at d = 40 / 80 to the float32 kernel, at d = 512 to the float32
d = 512 kernel, ``csrc/flash_attention_f32_512.cu``, bf16 to the tensor
cores), the operand check (``check_f32_operands``), the C entry points
against their ``ctypes`` argument types, and the kernel's order of work
rendered in plain torch against the plain versions: the bounded mode's
anchor window scored once and kept, their max over keys below min(anchor,
Sk), then p and PV of every tile, against ``flash_attention_lse_reference``;
the exact mode's running max over 64-key tiles, the two key halves' maxima
combined, at d = 40 two partial outputs, against
``flash_attention_exact_reference``.  Tests marked ``gpu`` hold the kernel
to its plain versions on the card and skip without one.
"""

import math
import re

import pytest
import torch

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_attention as flash_mod

F32_ENTRIES = ("hedit_flash_attention_fwd_f32", "hedit_flash_attention_fwd_packed_bounded_f32",
               "hedit_flash_attention_fwd_lse_f32")
TEMPLATE_ENTRIES = ("hedit_flash_attention_fwd", "hedit_flash_attention_fwd_packed_bounded",
                    "hedit_flash_attention_fwd_lse")
TC_ENTRIES = ("hedit_flash_attention_fwd_tc", "hedit_flash_attention_fwd_packed_bounded_tc",
              "hedit_flash_attention_fwd_lse_tc")
F32_512_ENTRIES = tuple(e + "_512" for e in F32_ENTRIES)
# the exact entries (head-split, packed) of each route, and the template's
F32_EXACT = ("hedit_flash_attention_fwd_exact_f32", "hedit_flash_attention_fwd_packed_exact_f32")
TEMPLATE_EXACT = ("hedit_flash_attention_fwd_exact", "hedit_flash_attention_fwd_packed")
TC_EXACT = ("hedit_flash_attention_fwd_exact_tc", "hedit_flash_attention_fwd_packed_exact_tc")
F32_512_EXACT = ("hedit_flash_attention_fwd_exact_f32_512",
                 "hedit_flash_attention_fwd_packed_exact_f32_512")
SOURCE = _build.CSRC / "flash_attention_f32.cu"
KEY_TILE = 64   # the kernel's key tile (kKeys)


@pytest.mark.parametrize("dtype,d,entries,exact", [
    (torch.float32, 40, F32_ENTRIES, F32_EXACT), (torch.float32, 80, F32_ENTRIES, F32_EXACT),
    (torch.float32, 512, F32_512_ENTRIES, F32_512_EXACT),
    (torch.bfloat16, 80, TC_ENTRIES, TC_EXACT),
])
def test_bounded_route_by_dtype_and_head_dim(dtype, d, entries, exact):
    """``bounded_entry`` (head-split, packed), ``lse_entry`` and
    ``exact_entry`` (head-split, packed) name the float32 kernel for float32
    at d = 40 / 80, the float32 d = 512 kernel at d = 512 and the
    tensor-core kernel for bf16, never the template; each entry is bound
    with the template's argument types and defined once in ``csrc`` (the
    float32 ones at d = 40 / 80 in ``csrc/flash_attention_f32.cu``).  The
    float32 operand check takes the paths' operands and raises on an address
    off 16 bytes, a stride that is not a multiple of 4, a head dim without a
    tile and an anchor window beyond the head dim's (512 keys at 40 / 80,
    1024 at 512)."""
    got = (flash_mod.bounded_entry(dtype, False, d), flash_mod.bounded_entry(dtype, True, d),
           flash_mod.lse_entry(dtype, d))
    assert got == entries
    assert (flash_mod.exact_entry(dtype, False, d), flash_mod.exact_entry(dtype, True, d)) == exact
    sources = " ".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for entry, template in zip(entries + exact, TEMPLATE_ENTRIES + TEMPLATE_EXACT):
        assert _build.ARGTYPES[entry] == _build.ARGTYPES[template]
        assert len(re.findall(rf'extern "C" int {entry}\(', sources)) == 1, entry
        if exact is F32_EXACT:
            assert re.search(rf'extern "C" int {entry}\(', SOURCE.read_text()), entry
    if entries is TC_ENTRIES:
        return
    window = 1024 if d == 512 else 512
    good = [0x7F0000000000 + 16 * i for i in range(4)]
    strides = [4096 * d, 1000 * d, d, 8 * d, 3 * 4096 * 8 * d]
    flash_mod.check_f32_operands(d, good, strides, window)
    for args, match in (((d, good[:3] + [good[3] + 4], strides, window), "aligned"),
                        ((d, good, strides + [1024 * 320 + 2], window), "multiples of 4"),
                        ((d, good, [d + 1], window), "multiples of 4"),
                        ((64, good, strides, window), "head dims"),
                        ((d, good, strides, window + 1), "anchor keys")):
        with pytest.raises(ValueError, match=match):
            flash_mod.check_f32_operands(*args)


def _kernel_order(q, k, v, anchor):
    """The kernel's order of work in plain float32 torch, [BH, S, D] inputs:
    the first ceil(a_end / 64) key tiles (a_end = min(anchor, Sk)) scored
    once and kept; shift = their max over keys below a_end, + 16; then every
    tile's p = exp2(min(s - shift, 100)), 0 for keys at or past Sk, its row
    sum and its PV product, tile by tile (the window's tiles the kernel
    keeps in shared memory, 7 down to 6 at d = 80 or 3 at d = 40, first),
    the window's tiles from the kept scores.  Returns (out, lse2 [BH, Sq])."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qs = q * torch.tensor(1.0 / d ** 0.5 * math.log2(math.e), dtype=torch.float32)
    a_end, nt = min(anchor, sk), -(-sk // KEY_TILE)
    wt = -(-a_end // KEY_TILE)
    pad = nt * KEY_TILE - sk
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    tile = lambda t, i: t[:, i * KEY_TILE:(i + 1) * KEY_TILE]  # noqa: E731
    window = [qs @ tile(kp, i).transpose(1, 2) for i in range(wt)]
    shift = torch.cat(window, dim=2)[..., :a_end].amax(dim=-1, keepdim=True) + 16.0
    lsum = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    # the window's tiles held in shared memory (7, 6, ..) first, then the rest
    reg_tiles = 6 if d == 80 else 3
    order = ([i for i in range(7, reg_tiles - 1, -1) if i < wt]
             + [i for i in range(nt) if i < min(wt, reg_tiles) or i >= wt])
    for i in order:
        s = window[i] if i < wt else qs @ tile(kp, i).transpose(1, 2)
        p = torch.exp2(torch.clamp(s - shift, max=100.0))
        p[..., torch.arange(i * KEY_TILE, (i + 1) * KEY_TILE) >= sk] = 0.0
        lsum = lsum + p.sum(dim=-1, keepdim=True)
        acc = acc + p @ tile(vp, i)
    lsum = torch.clamp(lsum, min=flash_mod.DENOM_FLOOR)
    return acc / lsum, (shift + torch.log2(lsum))[..., 0]


def _kernel_order_exact(q, k, v):
    """The exact mode's order of work in plain float32 torch, [BH, S, D]
    inputs: 64-key tiles in order; a tile's scores, -inf for keys at or past
    Sk; each row's max over the tile's two key halves (keys 0-31 and 32-63,
    the two warps of a row), combined; m_new = max(m, that), alpha =
    exp2(m - m_new) rescaling the two halves' partial row sums and the
    accumulators; p = exp2(s - m_new) summed into its half's row sum and,
    at d = 80, multiplied into one accumulator over all 64 keys, at d = 40
    into one partial output a key half, the two added at the end; out = acc
    / (sum of half 0 + sum of half 1), no floor."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qs = q * torch.tensor(1.0 / d ** 0.5 * math.log2(math.e), dtype=torch.float32)
    nt = -(-sk // KEY_TILE)
    pad = nt * KEY_TILE - sk
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    halves = (slice(0, KEY_TILE // 2), slice(KEY_TILE // 2, KEY_TILE))
    m = torch.full((bh, sq, 1), -math.inf)
    lsum = [torch.zeros(bh, sq, 1) for _ in halves]
    acc = [torch.zeros(bh, sq, d) for _ in halves[:2 if d == 40 else 1]]
    for i in range(nt):
        s = qs @ kp[:, i * KEY_TILE:(i + 1) * KEY_TILE].transpose(1, 2)
        s[..., torch.arange(i * KEY_TILE, (i + 1) * KEY_TILE) >= sk] = -math.inf
        m_new = torch.maximum(m, torch.maximum(*(s[..., h].amax(dim=-1, keepdim=True)
                                                 for h in halves)))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        lsum = [ls * alpha + p[..., h].sum(dim=-1, keepdim=True) for ls, h in zip(lsum, halves)]
        vt = vp[:, i * KEY_TILE:(i + 1) * KEY_TILE]
        if d == 40:
            acc = [a * alpha + p[..., h] @ vt[:, h] for a, h in zip(acc, halves)]
        else:
            acc = [acc[0] * alpha + p @ vt]
        m = m_new
    return sum(acc[1:], acc[0]) / (lsum[0] + lsum[1])


@pytest.mark.parametrize("mode", ["bounded", "exact"])
def test_kernel_order_of_work_matches_the_plain_version(mode):
    """The rendering of the kernel's order of work in each mode against its
    plain version.  Bounded: ``flash_attention_lse_reference`` with the same
    anchor: the default anchor at 1024 keys, an anchor that ends inside a key
    tile (the keys after it in that tile take the kept scores' p but not the
    max), Sk below the anchor, below one key tile and ragged, and the
    saturating input (keys far above the anchor window clamp to 2^100).
    Exact: ``flash_attention_exact_reference`` at the kernel's key tile of
    64 on the same inputs (the anchor unused; on the saturating input one key
    takes all the weight).  Both sides are float32 and differ only in
    summation order: 1e-5 of the largest output and of lse2."""
    g = torch.Generator().manual_seed(7)
    cases = [(4, 256, 1024, 40, 512), (2, 100, 1024, 80, 100), (2, 70, 300, 40, 300),
             (2, 33, 40, 80, 128), (1, 65, 1064, 80, 512), (2, 64, 200, 40, 130)]
    for bh, sq, sk, d, anchor in cases:
        q, k, v = (torch.randn(bh, s, d, generator=g) for s in (sq, sk, sk))
        if anchor == 130:  # saturating: key 150 scores far above the window's max
            q, k = q * 0.1, k * 0.5
            q[..., 0] = 8.0
            k[:, 150, 0] = 80.0
        if mode == "exact":
            assert flash_mod.exact_key_tile(d, torch.float32) == KEY_TILE
            want = flash_mod.flash_attention_exact_reference(q[None], k[None], v[None], KEY_TILE)
            torch.testing.assert_close(_kernel_order_exact(q, k, v), want[0], rtol=0,
                                       atol=1e-5 * want.abs().max().item())
            continue
        out, lse2 = _kernel_order(q, k, v, anchor)
        want, want_lse = flash_mod.flash_attention_lse_reference(q[None], k[None], v[None],
                                                                  anchor)
        torch.testing.assert_close(out, want[0], rtol=0, atol=1e-5 * want.abs().max().item())
        torch.testing.assert_close(lse2, want_lse.reshape(bh, sq), rtol=1e-5, atol=0)


# ---------------------------------------------------------------- on the card

F32_TOL = 1e-4   # float32, summation order; the outputs of these inputs are O(0.1-1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    """The float32 kernel's counters (bounded 0-2, exact 6-7) and the
    template's (3-5, 8-9)."""
    return (flash_mod.launches_f32, flash_mod.launches_packed_bounded_f32,
            flash_mod.launches_lse_f32, flash_mod.launches, flash_mod.launches_packed_bounded,
            flash_mod.launches_lse, flash_mod.launches_exact_f32, flash_mod.launches_packed_f32,
            flash_mod.launches_exact, flash_mod.launches_packed)


def _saturating(device, bh=8, s=1024, d=40):
    """Every query's score with a key set by the key's first component: key
    600 scores more than 116 log2 units above the 512-key anchor window's
    max (clamped to 2^100), keys 700-763 below the clamp."""
    g = torch.Generator(device=device).manual_seed(5)
    q = torch.randn(1, bh, s, d, generator=g, device=device) * 0.1
    q[..., 0] = 8.0
    k = torch.randn(1, bh, s, d, generator=g, device=device) * 0.5
    v = torch.randn(1, bh, s, d, generator=g, device=device)
    k[:, :, 600, 0] = 80.0
    k[:, :, 700:764, 0] = 60.0
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80])
def test_f32_kernel_matches_plain_on_card(cuda, d):
    """Head-split (bounded and LSE) against ``flash_attention_lse_reference``
    and packed against ``flash_attention_packed_bounded_reference``: out
    within 1e-4, lse2 within 1e-5 relative, one launch of the float32
    kernel's counter each and none of the template's.  Cases: the UNet's
    [1, 8, 1024, 80] and packed [4, 1024, 8 x 80] (d = 80; [2, 8, 4096, 40]
    and [2, 4096, 8 x 40] at d = 40), ragged Sq != Sk (1000 / 1064), Sk
    below the anchor (300), below 256 (140) and below one key tile (40),
    B H = 1, the saturating input, and a packed row slice of a larger batch
    (a batch stride, no copy)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    s = 1024 if d == 80 else 4096
    split = [((1 if d == 80 else 2, 8, s), s), ((1, 8, 1000), 1064), ((2, 3, 300), 300),
             ((1, 2, 140), 140), ((2, 2, 77), 40), ((1, 1, 1024), 1024)]
    for (b, h, sq), sk in split:
        q = torch.randn(b, h, sq, d, generator=g, device=cuda)
        k, v = (torch.randn(b, h, sk, d, generator=g, device=cuda) for _ in range(2))
        _check_split(q, k, v)
    if d == 40:
        _check_split(*_saturating(cuda))
    batch = 4 if d == 80 else 2
    for rows, (sq, sk), sliced in ((batch, (s, s), False), (2, (1000, 1064), False),
                                   (2, (1024, 1024), True)):
        qkv = [torch.randn(rows, 3, n, 8 * d, generator=g, device=cuda)
               for n in (sq, sk, sk)]
        _check_packed(*((t[:, 1] if sliced else t[:, 0].contiguous()) for t in qkv))
    if d == 40:
        q, k, v = (t.transpose(1, 2).reshape(1, 1024, 8 * d).contiguous()
                   for t in _saturating(cuda))
        _check_packed(q, k, v)


def _check_split(q, k, v):
    before = _counts()
    out, lse2 = flash_mod.flash_attention_lse_cuda(q, k, v)
    plain_out = flash_mod.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + (i in (0, 2)) for i, c in enumerate(before))
    want, want_lse = flash_mod.flash_attention_lse_reference(q, k, v)
    for got in (out, plain_out):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)
    torch.testing.assert_close(lse2, want_lse, rtol=1e-5, atol=0)


def _check_packed(q, k, v):
    before = _counts()
    got = flash_mod.flash_attention_packed_bounded_cuda(q, k, v, 8)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + (i == 1) for i, c in enumerate(before))
    assert got.shape == q.shape and got.is_contiguous() and torch.isfinite(got).all()
    want = flash_mod.flash_attention_packed_bounded_reference(q, k, v, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80])
def test_f32_exact_kernel_matches_plain_on_card(cuda, d):
    """The exact mode, head-split against ``flash_attention_exact_reference``
    and packed against ``flash_attention_packed_exact_reference``, both at
    the kernel's key tile of 64: within 1e-4, a second launch bit-identical,
    one launch of ``launches_exact_f32`` / ``launches_packed_f32`` each and
    none of the template's counters.  Cases: the UNet's shapes ([4, 8, 1024,
    80] and packed [4, 1024, 8 x 80]; [2, 8, 4096, 40] and [2, 4096, 8 x 40]
    at d = 40), ragged Sq != Sk (1000 / 1064), Sq above Sk (300 / 140), Sk
    below one key tile (77 / 40), the saturating input at d = 40, and a
    packed row slice of a larger batch."""
    g = torch.Generator(device=cuda).manual_seed(13)
    s = 1024 if d == 80 else 4096
    for (b, h, sq), sk in (((4 if d == 80 else 2, 8, s), s), ((1, 8, 1000), 1064),
                           ((2, 3, 300), 140), ((2, 2, 77), 40)):
        q = torch.randn(b, h, sq, d, generator=g, device=cuda)
        k, v = (torch.randn(b, h, sk, d, generator=g, device=cuda) for _ in range(2))
        _check_exact(lambda: flash_mod.flash_attention_exact_cuda(q, k, v),
                     flash_mod.flash_attention_exact_reference(q, k, v), 6)
    if d == 40:
        q, k, v = _saturating(cuda)
        _check_exact(lambda: flash_mod.flash_attention_exact_cuda(q, k, v),
                     flash_mod.flash_attention_exact_reference(q, k, v), 6)
    for rows, (sq, sk), sliced in ((4 if d == 80 else 2, (s, s), False),
                                   (2, (1000, 1064), False), (2, (1024, 1024), True)):
        qkv = [torch.randn(rows, 3, n, 8 * d, generator=g, device=cuda) for n in (sq, sk, sk)]
        qp, kp, vp = ((t[:, 1] if sliced else t[:, 0].contiguous()) for t in qkv)
        _check_exact(lambda: flash_mod.flash_attention_packed_cuda(qp, kp, vp, 8),
                     flash_mod.flash_attention_packed_exact_reference(qp, kp, vp, 8), 7)


def _check_exact(call, want, counter):
    """One launch of ``call`` moves only counter ``counter`` of ``_counts``;
    its output is within 1e-4 of ``want`` and a second launch gives the same
    bits."""
    before = _counts()
    got = call()
    torch.cuda.synchronize()
    assert _counts() == tuple(c + (i == counter) for i, c in enumerate(before))
    assert got.shape == want.shape and got.is_contiguous() and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)
    assert torch.equal(call(), got)


@pytest.mark.gpu
def test_f32_kernel_is_deterministic_on_card(cuda):
    """Two launches give the same bits: sums run in a fixed order, no
    atomics (head-split with lse2, packed)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn(1, 8, 1024, 80, generator=g, device=cuda) for _ in range(3))
    a, b = flash_mod.flash_attention_lse_cuda(q, k, v), flash_mod.flash_attention_lse_cuda(q, k, v)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    qp = torch.randn(2, 4096, 320, generator=g, device=cuda)
    assert torch.equal(flash_mod.flash_attention_packed_bounded_cuda(qp, qp, qp, 8),
                       flash_mod.flash_attention_packed_bounded_cuda(qp, qp, qp, 8))


@pytest.mark.gpu
def test_f32_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    """A pointer off 16 bytes, a batch stride that is not a multiple of 4 and
    an anchor window beyond 512 keys are refused before any launch, with no
    fallback to the template or the plain version, by the bounded and the
    exact wrappers; the entry points refuse the same."""
    buf = torch.randn(2 * 1024 * 320 + 8, device=cuda)
    misaligned = buf[1:1 + 1024 * 320].view(1, 1024, 320)           # 4 bytes off
    odd = buf.as_strided((2, 1024, 320), (1024 * 320 + 2, 320, 1))   # batch stride 327,682
    head = buf[1:1 + 1024 * 40].view(1, 1, 1024, 40)
    dense = torch.randn(1, 1024, 320, device=cuda)
    before = _counts()
    for call, match in ((lambda: flash_mod.flash_attention_packed_bounded_cuda(
                            misaligned, misaligned, misaligned, 8), "aligned"),
                        (lambda: flash_mod.flash_attention_cuda(head, head, head), "aligned"),
                        (lambda: flash_mod.flash_attention_lse_cuda(head, head, head),
                         "aligned"),
                        (lambda: flash_mod.flash_attention_packed_bounded_cuda(odd, odd, odd, 8),
                         "multiples of 4"),
                        (lambda: flash_mod.flash_attention_packed_bounded_cuda(
                            dense, dense, dense, 8, anchor=600), "anchor keys"),
                        (lambda: flash_mod.flash_attention_exact_cuda(head, head, head),
                         "aligned"),
                        (lambda: flash_mod.flash_attention_packed_cuda(
                            misaligned, misaligned, misaligned, 8), "aligned"),
                        (lambda: flash_mod.flash_attention_packed_cuda(odd, odd, odd, 8),
                         "multiples of 4")):
        with pytest.raises(ValueError, match=match):
            call()
    torch.cuda.synchronize()
    assert _counts() == before
    out = torch.empty_like(dense)
    for entry, ints in (
            ("hedit_flash_attention_fwd_packed_bounded_f32",
             (1, 8, 1024, 1024, 40, 600, *(1024 * 320,) * 3)),                 # window 600
            ("hedit_flash_attention_fwd_packed_bounded_f32",
             (2, 8, 1024, 1024, 40, 512, 1024 * 320 + 2, *(1024 * 320,) * 2)),
            ("hedit_flash_attention_fwd_packed_exact_f32",
             (2, 8, 1024, 1024, 40, 1024 * 320 + 2, *(1024 * 320,) * 2))):
        with pytest.raises(RuntimeError, match="code -1"):
            flash_mod._launch(entry, dense, (dense, dense, dense, out), ints)
    with pytest.raises(RuntimeError, match="code -1"):
        flash_mod._launch("hedit_flash_attention_fwd_exact_f32", dense,
                          (head, dense, dense, out), (1, 1024, 1024, 40))
