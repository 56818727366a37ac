"""The float32 flash backward at d = 512 (``csrc/flash_attention_bwd_f32_512.cu``).

This file imports no JAX, so it also runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_bwd_f32_512.py -q

On the CPU: the kernels' order of work rendered in plain torch (blocks of 16
keys that own dk and dv, streamed tiles of 16 queries, the score products'
8 partial contractions added in order, the stored ds, then dq summed over the
keys in order) against ``flash_attention_backward_reference``; the entry
points against their ``ctypes`` argument types, the route (``bwd_entry``),
the workspace's shape and the operand check (``check_f32_bwd_operands``).
Tests marked ``gpu`` hold the kernels to their plain version on the card and
skip without one.  (The plain version itself is held to JAX's backward
kernels at d = 512 by ``tests/test_torch_flash_bwd.py``.)
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_attention as flash_mod

KEYS = 16          # keys a dk / dv block owns (kKeys)
QUERY_TILE = 16    # queries a streamed tile (kBQ)
SPLIT = 8          # partial contractions of the score products (kSplit: 64 dims each)
DQ_KEYS = 16       # keys a stage of the dq product (BWD512_DQ_BK)
D = 512


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _inputs(bh, sq, sk, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(1, bh, s, D).astype(np.float32)) for s in (sq, sk, sk, sq)]


def _kernel_order(q, k, v, do, lse2, delta):
    """The two kernels' order of work in plain float32 torch, [BH, S, D]
    inputs.  dk / dv: the keys in blocks of 16 (all blocks at once as a batch
    dimension), each owning its dk and dv; the queries streamed in tiles of
    16; per tile and block s^T = K Q^T and dp^T = V dO^T, each the sum of 8
    partial products over 64 dims added in order; p^T = exp2(s^T * scale *
    log2(e) - lse2), 0 for padded keys and queries, ds^T = p^T (dp^T -
    delta); dV += p^T dO, dK += ds^T Q, tile after tile; ds^T stored into
    the workspace [BH, Sk, ldq].  dq: ds k * scale, summed over stages of 16
    keys in ascending order.  Returns (dq, dk, dv, the workspace)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    c2 = scale * math.log2(math.e)
    nb = -(-sk // KEYS)
    pad = nb * KEYS - sk
    kb, vb = (torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(bh, nb, KEYS, d) for t in (k, v))
    key_ok = (torch.arange(nb * KEYS) < sk).reshape(1, nb, KEYS, 1)
    _, _, ldq = flash_mod.bwd_f32_512_workspace(bh, sq, sk)
    ws = torch.zeros(bh, nb * KEYS, ldq)
    dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
    dims = d // SPLIT
    for q0 in range(0, sq, QUERY_TILE):
        n = min(QUERY_TILE, sq - q0)
        qt, ot = q[:, None, q0:q0 + n], do[:, None, q0:q0 + n]
        lt, dt = lse2[:, None, None, q0:q0 + n], delta[:, None, None, q0:q0 + n]
        st = torch.zeros(bh, nb, KEYS, n)
        dpt = torch.zeros(bh, nb, KEYS, n)
        for w in range(SPLIT):
            cut = slice(w * dims, (w + 1) * dims)
            st = st + kb[..., cut] @ qt[..., cut].transpose(-1, -2)
            dpt = dpt + vb[..., cut] @ ot[..., cut].transpose(-1, -2)
        pt = torch.where(key_ok, torch.exp2(st * c2 - lt), torch.zeros(()))
        dst = pt * (dpt - dt)
        dv += pt @ ot
        dk += dst @ qt
        ws[:, :, q0:q0 + n] = dst.reshape(bh, nb * KEYS, n)
    ws = ws[:, :sk]
    dq = torch.zeros_like(q)
    for k0 in range(0, sk, DQ_KEYS):
        dq += ws[:, k0:k0 + DQ_KEYS, :sq].transpose(-1, -2) @ k[:, k0:k0 + DQ_KEYS]
    return (dq * scale, (dk * scale).reshape(bh, -1, d)[:, :sk], dv.reshape(bh, -1, d)[:, :sk],
            ws)


def test_kernel_order_of_work_matches_the_plain_version():
    """The rendering of the kernels' order of work against
    ``flash_attention_backward_reference`` on the same inputs, fed the plain
    forward's out and lse2: ragged Sq != Sk (300 / 260: a last query tile
    and a last key block of 12), Sk below one key block (77 / 40, B H = 2),
    Sq below one query tile (20 / 300), Sq not a multiple of 4 (130 / 129,
    B H = 3: the workspace's rows padded to 132 queries, the padding left
    zero).  Both sides are float32 and differ only in summation order: 1e-5
    of each output's largest value."""
    for bh, sq, sk in ((1, 300, 260), (2, 77, 40), (1, 20, 300), (3, 130, 129)):
        q, k, v, do = _inputs(bh, sq, sk, seed=sq + sk)
        out, lse2 = flash_mod.flash_attention_lse_reference(q, k, v)
        wants = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do)
        delta = (do * out).sum(dim=-1)
        *got, ws = _kernel_order(q[0], k[0], v[0], do[0], lse2.reshape(bh, sq), delta[0])
        for a, w in zip(got, wants):
            torch.testing.assert_close(a, w[0], rtol=0, atol=1e-5 * w.abs().max().item())
        assert ws.shape == flash_mod.bwd_f32_512_workspace(bh, sq, sk)
        assert not ws[..., sq:].any(), "padded queries store ds = 0"


def test_entry_points_route_workspace_and_operand_check():
    """``hedit_flash_attention_bwd_dkv_f32_512`` (q, k, v, dO, lse2, delta,
    ds, dk, dv; bh, sq, sk, d, dtype; the stream) and
    ``hedit_flash_attention_bwd_dq_f32_512`` (k, ds, dq; the same ints and
    the stream) exist in their source with as many parameters as the
    ``ctypes`` argument types the loader gives them; ``bwd_entry`` names
    them (dq first, as for every two-kernel route) for float32 at d = 512
    and for nothing else; the template's entries stay bound for the probes.
    The workspace is [BH, Sk, Sq rounded up to 4].  The operand check takes
    16-byte aligned operands with strides of multiples of 4 at d = 512 and
    raises on an address off 16 bytes, a stride that is not a multiple of 4
    and a head dim without a kernel.  CPU tensors take the plain backward
    and launch nothing; the wrappers refuse them.  No wrapper names the
    CUDA-core template."""
    text = (_build.CSRC / "flash_attention_bwd_f32_512.cu").read_text()
    entry_dq, entry_dkv = flash_mod.F32_512_BWD_ENTRIES
    for entry, pointers in ((entry_dkv, 9), (entry_dq, 3)):
        params, = re.findall(rf'extern "C" int {entry}\(([^)]*)\)', text)
        argtypes = _build.ARGTYPES[entry]
        assert len(params.split(",")) == len(argtypes) == pointers + 5 + 1
        assert argtypes == [argtypes[0]] * pointers + [argtypes[pointers]] * 5 + [argtypes[0]]
    assert _build.ARGTYPES[entry_dkv] == _build.ARGTYPES[flash_mod.F32_BWD_ENTRY]
    assert flash_mod.bwd_entry(torch.float32, 512) == flash_mod.F32_512_BWD_ENTRIES
    for dtype, d in ((torch.float32, 40), (torch.float32, 80), (torch.bfloat16, 512)):
        assert flash_mod.bwd_entry(dtype, d) != flash_mod.F32_512_BWD_ENTRIES
    template = {"hedit_flash_attention_bwd_dq", "hedit_flash_attention_bwd_dkv"}
    assert template <= set(_build.ARGTYPES)
    for dtype in (torch.float32, torch.bfloat16):
        for d in flash_mod.BWD_HEAD_DIMS:
            assert not template & set(flash_mod.bwd_entry(dtype, d)), (dtype, d)
    assert flash_mod.bwd_f32_512_workspace(2, 1001, 1100) == (2, 1100, 1004)
    assert flash_mod.bwd_f32_512_workspace(1, 2048, 2048) == (1, 2048, 2048)
    good = [0x7F0000000000 + 16 * i for i in range(8)]
    flash_mod.check_f32_bwd_operands(512, good, [2048 * 512, 1100 * 1004, 1004, 512])
    for args, match in (((512, good[:7] + [good[7] + 4], [512]), "aligned"),
                        ((512, good, [1100 * 1001, 1001]), "multiples of 4"),
                        ((256, good, [256]), "head dims")):
        with pytest.raises(ValueError, match=match):
            flash_mod.check_f32_bwd_operands(*args)
    q, k, v, do = _inputs(1, 64, 72, seed=3)
    before = flash_mod.launches_bwd_f32_512
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_mod.flash_attention_diff(*leaves), leaves, do)
    out, lse2 = flash_mod.flash_attention_lse_reference(q, k, v)
    for a, b in zip(got, flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do)):
        assert torch.equal(a, b)
    delta = (do * out).sum(dim=-1)
    for wrapper in (flash_mod.flash_bwd_f32_512_cuda, flash_mod.flash_bwd_dq_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(q, k, v, do, lse2, delta)
    assert flash_mod.launches_bwd_f32_512 == before


# ---------------------------------------------------------------- on the card

F32_TOL = 1e-4   # float32, summation order: relative to each output's largest value


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return (flash_mod.launches_bwd_f32_512, flash_mod.launches_bwd_f32,
            flash_mod.launches_bwd_dq_tc, flash_mod.launches_bwd_dkv_tc)


def _card_inputs(device, b, h, sq, sk, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, D, generator=g, device=device) for s in (sq, sk, sk, sq))
    out, lse2 = flash_mod.flash_attention_lse_cuda(q, k, v)
    return q, k, v, do, out, lse2


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    """dq, dk and dv of one call (``flash_attention_backward_cuda``) against
    the plain backward on the same inputs, fed the kernel forward's out and
    lse2, within 1e-4 of each output's largest value; one count of the
    float32 d = 512 wrapper and none of the other backward kernels'.  Cases:
    [1, 1, 2048, 512] (the routed shape), ragged 1000 / 1100, Sk below one
    key block (77 / 40, B H = 4), Sq below one query tile (20 / 300), Sq not
    a multiple of 4 (130 / 129, three heads)."""
    for b, h, sq, sk in ((1, 1, 2048, 2048), (1, 1, 1000, 1100), (2, 2, 77, 40),
                         (1, 1, 20, 300), (1, 3, 130, 129)):
        q, k, v, do, out, lse2 = _card_inputs(cuda, b, h, sq, sk, seed=sq + sk)
        before = _counts()
        got = flash_mod.flash_attention_backward_cuda(q, k, v, out, lse2, do)
        torch.cuda.synchronize()
        assert _counts() == (before[0] + 1,) + before[1:]
        wants = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do)
        for a, w in zip(got, wants):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, w, rtol=0, atol=F32_TOL * w.abs().max().item())


@pytest.mark.gpu
def test_kernels_run_to_run_on_card(cuda):
    """Two calls on the same inputs at [1, 1, 4096, 512] and ragged 1000 /
    1100: dq, dk and dv bit-identical (one writer an element, every sum in
    a fixed order, no atomics)."""
    for sq, sk in ((4096, 4096), (1000, 1100)):
        q, k, v, do, out, lse2 = _card_inputs(cuda, 1, 1, sq, sk, seed=5)
        delta = (do * out).sum(dim=-1)
        a = flash_mod.flash_bwd_f32_512_cuda(q, k, v, do, lse2, delta)
        b = flash_mod.flash_bwd_f32_512_cuda(q, k, v, do, lse2, delta)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_flash_attention_diff_at_2048_routes_through_the_kernels_on_card(cuda):
    """``flash_attention_diff`` in float32 at [1, 1, 2048, 512]: K/V of 8 MiB
    fit JAX's budget exactly and 2048 tokens reach ``_BWD_MIN_SEQ``, so one
    launch of the float32 d = 512 LSE forward and one call of the float32
    d = 512 backward, none of the other backward kernels'; the gradient of the plain
    backward fed the same forward's out and lse2, within 1e-4 of each
    output's largest value."""
    q, k, v, do, out, lse2 = _card_inputs(cuda, 1, 1, 2048, 2048, seed=2048)
    assert flash_mod.bwd_takes_kernels(2048, 2048, D, 4, interpret=False)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_mod.launches_lse_f32_512,) + _counts()
    got = torch.autograd.grad(flash_mod.flash_attention_diff(*leaves), leaves, do)
    torch.cuda.synchronize()
    assert (flash_mod.launches_lse_f32_512,) + _counts() == (before[0] + 1, before[1] + 1,
                                                             *before[2:])
    wants = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do)
    for a, w in zip(got, wants):
        torch.testing.assert_close(a, w, rtol=0, atol=F32_TOL * w.abs().max().item())


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    """A pointer off 16 bytes (q or dO), bf16 and d = 40 are refused before
    any launch, with no fallback to the template or the plain version, as
    is float32 at d = 512 through the tensor-core wrappers and the fused
    float32 one; the entry points refuse a misaligned pointer too."""
    buf = torch.randn(2 * 1024 * D + 16, device=cuda)
    misaligned = buf[1:1 + 1024 * D].view(1, 1, 1024, D)                # 4 bytes off
    aligned = buf[4:4 + 1024 * D].view(1, 1, 1024, D)
    lse2 = torch.zeros(1, 1, 1024, device=cuda)
    delta = torch.zeros(1, 1024, device=cuda)
    small = torch.zeros(1, 1, 1024, 40, device=cuda)
    bf16 = aligned.to(torch.bfloat16)
    before = _counts()
    for call, match in (
            (lambda: flash_mod.flash_bwd_f32_512_cuda(misaligned, aligned, aligned, aligned, lse2,
                                                      delta), "aligned"),
            (lambda: flash_mod.flash_bwd_f32_512_cuda(aligned, aligned, aligned, misaligned, lse2,
                                                      delta), "aligned"),
            (lambda: flash_mod.flash_bwd_f32_512_cuda(bf16, bf16, bf16, bf16, lse2, delta),
             "float32 at d = 512"),
            (lambda: flash_mod.flash_bwd_f32_512_cuda(small, small, small, small, lse2, delta),
             "float32 at d = 512"),
            (lambda: flash_mod.flash_bwd_dq_cuda(aligned, aligned, aligned, aligned, lse2, delta),
             "flash_bwd_f32_512_cuda"),
            (lambda: flash_mod.flash_bwd_dkv_cuda(aligned, aligned, aligned, aligned, lse2,
                                                  delta), "flash_bwd_f32_512_cuda"),
            (lambda: flash_mod.flash_bwd_f32_cuda(aligned, aligned, aligned, aligned, lse2,
                                                  delta), "float32 at head dims")):
        with pytest.raises(ValueError, match=match):
            call()
    torch.cuda.synchronize()
    assert _counts() == before
    entry_dq, entry_dkv = flash_mod.F32_512_BWD_ENTRIES
    ds = torch.empty(flash_mod.bwd_f32_512_workspace(1, 1024, 1024), device=cuda)
    outs = [torch.empty_like(aligned) for _ in range(3)]
    with pytest.raises(RuntimeError, match="code -1"):
        flash_mod._launch(entry_dkv, misaligned,
                          (misaligned, aligned, aligned, aligned, lse2, delta, ds, *outs[:2]),
                          (1, 1024, 1024, D))
    with pytest.raises(RuntimeError, match="code -1"):
        flash_mod._launch(entry_dq, misaligned, (aligned, ds, misaligned), (1, 1024, 1024, D))
