"""The float32 bounded forward at d = 40 / 80 (``csrc/flash_attention_f32.cu``).

This file imports no JAX, so it also runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_f32.py -q

On the CPU: the route (``bounded_entry``, ``lse_entry``: float32 at d = 40 /
80 to the float32 kernel, at d = 512 to the CUDA-core template, bf16 to the
tensor cores), the operand check (``check_f32_operands``), the C entry
points against their ``ctypes`` argument types, and the kernel's order of
work rendered in plain torch (the anchor window's key tiles scored once and
kept, their max over keys below min(anchor, Sk), then p and PV of every
tile) against ``flash_attention_lse_reference``.  Tests marked ``gpu`` hold
the kernel to its plain versions on the card and skip without one.
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
KEY_TILE = 64   # the kernel's key tile (kKeys)


@pytest.mark.parametrize("dtype,d,entries", [
    (torch.float32, 40, F32_ENTRIES), (torch.float32, 80, F32_ENTRIES),
    (torch.float32, 512, TEMPLATE_ENTRIES), (torch.bfloat16, 80, TC_ENTRIES),
])
def test_bounded_route_by_dtype_and_head_dim(dtype, d, entries):
    """``bounded_entry`` (head-split, packed) and ``lse_entry`` name the
    float32 kernel for float32 at d = 40 / 80, the CUDA-core template at
    d = 512 and the tensor-core kernel for bf16; each entry is bound with the
    template's argument types and defined in ``csrc``.  The float32 operand
    check takes the paths' operands and raises on an address off 16 bytes, a
    stride that is not a multiple of 4, a head dim without a tile and an
    anchor window beyond 512 keys."""
    got = (flash_mod.bounded_entry(dtype, False, d), flash_mod.bounded_entry(dtype, True, d),
           flash_mod.lse_entry(dtype, d))
    assert got == entries
    sources = " ".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for entry, template in zip(entries, TEMPLATE_ENTRIES):
        assert _build.ARGTYPES[entry] == _build.ARGTYPES[template]
        assert re.search(rf'extern "C" int {entry}\(', sources), entry
    if entries is not F32_ENTRIES:
        return
    good = [0x7F0000000000 + 16 * i for i in range(4)]
    strides = [4096 * d, 1000 * d, d, 8 * d, 3 * 4096 * 8 * d]
    flash_mod.check_f32_operands(d, good, strides, 512)
    for args, match in (((d, good[:3] + [good[3] + 4], strides, 512), "aligned"),
                        ((d, good, strides + [1024 * 320 + 2], 512), "multiples of 4"),
                        ((d, good, [d + 1], 512), "multiples of 4"),
                        ((64, good, strides, 512), "head dims"),
                        ((d, good, strides, 513), "anchor keys")):
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


def test_kernel_order_of_work_matches_the_plain_version():
    """The rendering of the kernel's order of work against
    ``flash_attention_lse_reference`` with the same anchor: the default
    anchor at 1024 keys, an anchor that ends inside a key tile (the keys
    after it in that tile take the kept scores' p but not the max), Sk below
    the anchor, below one key tile and ragged, and the saturating input
    (keys far above the anchor window clamp to 2^100).  Both sides are
    float32 and differ only in summation order: 1e-5 of the largest output
    and of lse2."""
    g = torch.Generator().manual_seed(7)
    cases = [(4, 256, 1024, 40, 512), (2, 100, 1024, 80, 100), (2, 70, 300, 40, 300),
             (2, 33, 40, 80, 128), (1, 65, 1064, 80, 512), (2, 64, 200, 40, 130)]
    for bh, sq, sk, d, anchor in cases:
        q, k, v = (torch.randn(bh, s, d, generator=g) for s in (sq, sk, sk))
        if anchor == 130:  # saturating: key 150 scores far above the window's max
            q, k = q * 0.1, k * 0.5
            q[..., 0] = 8.0
            k[:, 150, 0] = 80.0
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
    return (flash_mod.launches_f32, flash_mod.launches_packed_bounded_f32,
            flash_mod.launches_lse_f32, flash_mod.launches, flash_mod.launches_packed_bounded,
            flash_mod.launches_lse)


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
    fallback to the template or the plain version; the entry points refuse
    the same."""
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
                            dense, dense, dense, 8, anchor=600), "anchor keys")):
        with pytest.raises(ValueError, match=match):
            call()
    torch.cuda.synchronize()
    assert _counts() == before
    out = torch.empty_like(dense)
    for ints in ((1, 8, 1024, 1024, 40, 600, *(1024 * 320,) * 3),      # window 600
                 (2, 8, 1024, 1024, 40, 512, 1024 * 320 + 2, *(1024 * 320,) * 2)):
        with pytest.raises(RuntimeError, match="code -1"):
            flash_mod._launch("hedit_flash_attention_fwd_packed_bounded_f32", dense,
                              (dense, dense, dense, out), ints)
