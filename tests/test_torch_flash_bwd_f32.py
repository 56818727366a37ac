"""The fused float32 flash backward at d = 40 / 80 (``csrc/flash_attention_bwd_f32.cu``).

This file imports no JAX, so it also runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_bwd_f32.py -q

On the CPU: the kernel's order of work rendered in plain torch (key blocks
that own dk and dv, streamed query tiles, dq summed over key blocks in a
shuffled order) against ``flash_attention_backward_reference``; the entry
point against its ``ctypes`` argument types, the route (``bwd_entry``) and
the operand check (``check_f32_bwd_operands``).  Tests marked ``gpu`` hold
the kernel to its plain version on the card and skip without one.  (The
plain version itself is held to JAX's backward kernels by
``tests/test_torch_flash_bwd.py``.)
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_attention as flash_mod

KEY_TILE = 64                       # keys a block owns (kKeys)
QUERY_TILE = {40: 64, 80: 32}       # query rows a streamed tile (BWD_F32_BQ_40 / _80)


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _inputs(bh, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(1, bh, s, d).astype(np.float32)) for s in (sq, sk, sk, sq)]


def _kernel_order(q, k, v, do, lse2, delta, rng):
    """The kernel's order of work in plain float32 torch, [BH, S, D] inputs:
    the keys in blocks of 64, each owning its dk and dv (all blocks at once
    as a batch dimension); the queries streamed in tiles (64 rows at d = 40,
    32 at d = 80); per tile and block s^T = K Q^T and dp^T = V dO^T, p^T =
    exp2(s^T * scale * log2(e) - lse2), 0 for padded keys and queries, ds^T =
    p^T (dp^T - delta); dV += p^T dO, dK += ds^T Q; the block's dq partial
    ds K * scale, the partials of all blocks summed in an order drawn from
    ``rng`` (the kernel's atomic adds run in launch order).  Returns
    (dq, dk, dv)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    c2 = scale * math.log2(math.e)
    nb, bq = -(-sk // KEY_TILE), QUERY_TILE[d]
    pad = nb * KEY_TILE - sk
    kb, vb = (torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(bh, nb, KEY_TILE, d)
              for t in (k, v))
    key_ok = (torch.arange(nb * KEY_TILE) < sk).reshape(1, nb, KEY_TILE, 1)
    dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
    dq = torch.zeros_like(q)
    for q0 in range(0, sq, bq):
        qt, ot = q[:, None, q0:q0 + bq], do[:, None, q0:q0 + bq]
        lt, dt = lse2[:, None, None, q0:q0 + bq], delta[:, None, None, q0:q0 + bq]
        st = kb @ qt.transpose(-1, -2)                      # [BH, blocks, keys, queries]
        dpt = vb @ ot.transpose(-1, -2)
        pt = torch.where(key_ok, torch.exp2(st * c2 - lt), torch.zeros(()))
        dst = pt * (dpt - dt)
        dv += pt @ ot
        dk += dst @ qt
        partial = dst.transpose(-1, -2) @ kb * scale        # [BH, blocks, queries, D]
        for b in rng.permutation(nb):
            dq[:, q0:q0 + bq] += partial[:, b]
    return dq, (dk * scale).reshape(bh, -1, d)[:, :sk], dv.reshape(bh, -1, d)[:, :sk]


def test_kernel_order_of_work_matches_the_plain_version():
    """The rendering of the fused kernel's order of work against
    ``flash_attention_backward_reference`` on the same inputs, fed the plain
    forward's out and lse2: Sq = Sk = 4096 at d = 40 (the NMG gradient
    call's head), ragged Sq != Sk (1000 / 1064) at d = 80, Sk below one key
    tile, B H = 1 at d = 80 with Sq below one query tile.  Both sides are
    float32 and differ only in summation order: 1e-5 of each output's largest
    value."""
    rng = np.random.RandomState(17)
    for bh, sq, sk, d in ((1, 4096, 4096, 40), (2, 1000, 1064, 80), (2, 77, 40, 40),
                          (1, 20, 200, 80)):
        q, k, v, do = _inputs(bh, sq, sk, d, seed=sq + sk + d)
        out, lse2 = flash_mod.flash_attention_lse_reference(q, k, v)
        wants = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do)
        delta = (do * out).sum(dim=-1)
        got = _kernel_order(q[0], k[0], v[0], do[0], lse2.reshape(bh, sq), delta[0], rng)
        for a, w in zip(got, wants):
            torch.testing.assert_close(a, w[0], rtol=0, atol=1e-5 * w.abs().max().item())


def test_fused_entry_point_route_and_operand_check():
    """``hedit_flash_attention_bwd_f32`` exists in its source with as many
    parameters as the ``ctypes`` argument types the loader gives it (q, k,
    v, dO, lse2, delta, dq, dk, dv; bh, sq, sk, d, dtype; the stream: the
    template's two entries in one); ``bwd_entry`` names it alone for float32
    at d = 40 / 80; the operand check takes contiguous operands at 16-byte
    aligned addresses and raises on an address off 16 bytes, a stride that
    is not a multiple of 4 and a head dim without a tile; CPU tensors take
    the plain backward and launch nothing."""
    entry = flash_mod.F32_BWD_ENTRY
    text = (_build.CSRC / "flash_attention_bwd_f32.cu").read_text()
    params, = re.findall(rf'extern "C" int {entry}\(([^)]*)\)', text)
    argtypes = _build.ARGTYPES[entry]
    assert len(params.split(",")) == len(argtypes) == 9 + 5 + 1
    assert argtypes == [argtypes[0]] * 9 + [argtypes[9]] * 5 + [argtypes[0]]
    assert _build.ARGTYPES["hedit_flash_attention_bwd_dkv"][:8] == argtypes[:8]
    for d in flash_mod.F32_HEAD_DIMS:
        assert flash_mod.bwd_entry(torch.float32, d) == (entry,)
        good = [0x7F0000000000 + 16 * i for i in range(7)]
        flash_mod.check_f32_bwd_operands(d, good, [4096 * d, 1064 * d, d])
        for args, match in (((d, good[:6] + [good[6] + 4], [d]), "aligned"),
                            ((d, good, [4096 * d + 2, d]), "multiples of 4"),
                            ((64, good, [64]), "head dims")):
            with pytest.raises(ValueError, match=match):
                flash_mod.check_f32_bwd_operands(*args)
    q, k, v, do = _inputs(2, 64, 72, 40, seed=3)
    before = flash_mod.launches_bwd_f32
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_mod.flash_attention_diff(*leaves), leaves, do)
    out, lse2 = flash_mod.flash_attention_lse_reference(q, k, v)
    for a, b in zip(got, flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_bwd_f32_cuda(q, k, v, do, lse2, (do * out).sum(dim=-1))
    assert flash_mod.launches_bwd_f32 == before


# ---------------------------------------------------------------- on the card

F32_TOL = 1e-4   # float32, summation order: relative to each output's largest value


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return (flash_mod.launches_bwd_f32, flash_mod.launches_bwd_dq, flash_mod.launches_bwd_dkv,
            flash_mod.launches_bwd_dq_tc, flash_mod.launches_bwd_dkv_tc)


def _card_inputs(device, b, h, sq, sk, d, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device=device) for s in (sq, sk, sk, sq))
    out, lse2 = flash_mod.flash_attention_lse_cuda(q, k, v)
    return q, k, v, do, out, lse2


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80])
def test_fused_kernel_matches_plain_on_card(cuda, d):
    """dq, dk and dv of one launch (``flash_attention_backward_cuda``)
    against the plain backward on the same inputs, fed the kernel forward's
    out and lse2, within 1e-4 of each output's largest value; one launch of
    the fused kernel's counter and none of the other backward kernels'.
    Cases: [1, 8, 4096, 40] (d = 40) or [1, 8, 1024, 80], ragged Sq != Sk
    (1000 / 1064), Sk below one key tile (40), B H = 1 (300 / 140)."""
    s = 4096 if d == 40 else 1024
    for b, h, sq, sk in ((1, 8, s, s), (1, 8, 1000, 1064), (2, 2, 77, 40), (1, 1, 300, 140)):
        q, k, v, do, out, lse2 = _card_inputs(cuda, b, h, sq, sk, d, seed=sq + sk)
        before = _counts()
        got = flash_mod.flash_attention_backward_cuda(q, k, v, out, lse2, do)
        torch.cuda.synchronize()
        assert _counts() == (before[0] + 1,) + before[1:]
        wants = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do)
        for a, w in zip(got, wants):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, w, rtol=0, atol=F32_TOL * w.abs().max().item())


@pytest.mark.gpu
def test_fused_kernel_run_to_run_on_card(cuda):
    """Two launches on the same inputs: dk and dv bit-identical (one writer
    each, a fixed order); dq, summed over the key blocks by atomic adds in
    launch order, within 1e-6 of its largest value."""
    q, k, v, do, out, lse2 = _card_inputs(cuda, 1, 8, 4096, 4096, 40, seed=5)
    delta = (do * out).sum(dim=-1)
    a = flash_mod.flash_bwd_f32_cuda(q, k, v, do, lse2, delta)
    b = flash_mod.flash_bwd_f32_cuda(q, k, v, do, lse2, delta)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=1e-6 * a[0].abs().max().item())


@pytest.mark.gpu
def test_flash_attention_diff_gradient_through_the_fused_kernel_on_card(cuda):
    """``flash_attention_diff`` in float32 at 2048 tokens (the kernels'
    route, ``bwd_takes_kernels``) and d = 40 / 80: one launch of the float32
    LSE forward and one of the fused backward, and the gradient of the plain
    backward fed the same forward's out and lse2, within 1e-4 of each
    output's largest value."""
    for d in (40, 80):
        q, k, v, do, out, lse2 = _card_inputs(cuda, 1, 2, 2048, 2048, d, seed=d)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (flash_mod.launches_lse_f32,) + _counts()
        got = torch.autograd.grad(flash_mod.flash_attention_diff(*leaves), leaves, do)
        torch.cuda.synchronize()
        assert (flash_mod.launches_lse_f32,) + _counts() == (before[0] + 1, before[1] + 1,
                                                             *before[2:])
        wants = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do)
        for a, w in zip(got, wants):
            torch.testing.assert_close(a, w, rtol=0, atol=F32_TOL * w.abs().max().item())


@pytest.mark.gpu
def test_fused_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """A pointer off 16 bytes and an element stride that is not a multiple
    of 4 (a one-head view whose head stride is odd) are refused before any
    launch, with no fallback to the template or the plain version, as are
    bf16 and float32 at d = 40 through the two-kernel wrappers; the entry
    point refuses a misaligned pointer too."""
    buf = torch.randn(2 * 1024 * 40 + 16, device=cuda)
    misaligned = buf[1:1 + 1024 * 40].view(1, 1, 1024, 40)               # 4 bytes off
    aligned = buf[4:4 + 1024 * 40].view(1, 1, 1024, 40)
    odd = buf.as_strided((1, 1, 1024, 40), (1024 * 40 + 2, 1024 * 40 + 2, 40, 1))
    lse2 = torch.zeros(1, 1, 1024, device=cuda)
    delta = torch.zeros(1, 1024, device=cuda)
    bf16 = aligned.to(torch.bfloat16)
    before = _counts()
    for call, match in (
            (lambda: flash_mod.flash_bwd_f32_cuda(misaligned, aligned, aligned, aligned, lse2,
                                                  delta), "aligned"),
            (lambda: flash_mod.flash_bwd_f32_cuda(aligned, aligned, aligned, misaligned, lse2,
                                                  delta), "aligned"),
            (lambda: flash_mod.flash_bwd_f32_cuda(odd, aligned, aligned, aligned, lse2, delta),
             "multiples of 4"),
            (lambda: flash_mod.flash_bwd_f32_cuda(bf16, bf16, bf16, bf16, lse2, delta),
             "float32"),
            (lambda: flash_mod.flash_bwd_dq_cuda(aligned, aligned, aligned, aligned, lse2, delta),
             "flash_bwd_f32_cuda"),
            (lambda: flash_mod.flash_bwd_dkv_cuda(aligned, aligned, aligned, aligned, lse2,
                                                  delta), "flash_bwd_f32_cuda")):
        with pytest.raises(ValueError, match=match):
            call()
    torch.cuda.synchronize()
    assert _counts() == before
    outs = [torch.empty_like(aligned) for _ in range(3)]
    with pytest.raises(RuntimeError, match="code -1"):
        flash_mod._launch(flash_mod.F32_BWD_ENTRY, misaligned,
                          (misaligned, aligned, aligned, aligned, lse2, delta, *outs),
                          (1, 1024, 1024, 40))
