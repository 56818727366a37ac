"""The port's hand-written kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the machine with the card,
where the JAX package is not installed and ``tests/conftest.py`` (which
imports JAX) must be skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py -q

Tests marked ``gpu`` need a CUDA device and skip without one; the others
check that a CPU tensor takes the plain version and launches nothing.
"""

import math

import pytest
import torch

from hedit_tpu_torch.ops import flash_attention as flash_mod
from hedit_tpu_torch.ops import groupnorm as gn_mod
from hedit_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ, fused_attention, fused_attention_packed, merge_heads, split_heads,
)
from hedit_tpu_torch.ops.flash_attention import (
    bounded_anchor, flash_attention_bounded_reference, flash_attention_exact_reference,
    flash_attention_packed_exact_reference, flash_attention_packed_reference, reference_attention,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_flash_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor takes the plain version even at kernel-sized sequences
    and launches nothing: the routing takes the exact plain version, as the
    JAX package's routing off the TPU does, and the bounded forward's wrapper
    its own bounded plain version."""
    q = torch.randn(1, 1, FLASH_MIN_SEQ, 8)
    before = flash_mod.launches
    torch.testing.assert_close(fused_attention(q, q, q), reference_attention(q, q, q),
                               rtol=0, atol=0)
    torch.testing.assert_close(flash_mod.flash_attention_cuda(q, q, q),
                               flash_attention_bounded_reference(q, q, q), rtol=0, atol=0)
    assert flash_mod.launches == before


def _plain_on_card(fn, *ts):
    """A plain version on the card with its output before the final rounding:
    float32 inputs run in float32; bfloat16 inputs round q * scale and p to
    bf16 at the kernel's steps, the bounded and the exact plain versions
    alike (the exact one at the kernel's key tile), and leave the output
    unrounded (a kernel sums in another order than cuBLAS, so the two float32
    outputs may round to neighbouring bf16 values)."""
    return fn(*ts, out_dtype=torch.float32)


def _route_suffix(dtype, d):
    """The counter suffix of the bounded and the exact forward's route
    (``bounded_entry``, ``exact_entry``): bf16 the tensor cores, float32 at
    d = 40 / 80 the float32 kernel, float32 at d = 512 the float32 d = 512
    kernel."""
    if dtype == torch.bfloat16:
        return "_tc"
    return "_f32" if d in flash_mod.F32_HEAD_DIMS else flash_mod.F32_512_SUFFIX


def _tol(dtype, want):
    """float32: 1e-4 (summation order); bfloat16: one output ulp at the
    largest output, 2^-8 * max|out|: the kernel rounds its output once (half
    an ulp) and q * scale and p at the plain version's steps, where a
    rounding may fall the other way."""
    return 1e-4 if dtype == torch.float32 else 2.0 ** -8 * want.float().abs().max().item()


def _saturating(device, dtype):
    """q [1, 8, 1024, 40], k / v [1, 8, 1024, 40]: every query's score with
    a key is set by the key's first component.  The anchor window (512 keys)
    scores a few log2 units; key 600 scores ~146, more than 116 above the
    window's max (clamped to 2^100 by the bounded form), keys 700-763 ~109
    (below the clamp): exact attention is key 600's value row, the bounded
    form mixes in the 64 keys."""
    g = torch.Generator(device=device).manual_seed(5)
    q = torch.randn(1, 8, 1024, 40, generator=g, device=device) * 0.1
    q[..., 0] = 8.0
    k = torch.randn(1, 8, 1024, 40, generator=g, device=device) * 0.5
    v = torch.randn(1, 8, 1024, 40, generator=g, device=device)
    k[:, :, 600, 0] = 80.0
    k[:, :, 700:764, 0] = 60.0
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 1024, 40), (1, 8, 1000, 80), (1, 1, 1024, 512)])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, shape):
    """The bounded kernel (kernel 1) against its plain version with the same
    anchor, and the exact kernel (kernel 6) against
    ``flash_attention_exact_reference`` at the kernel's key tile (tolerances
    of ``_tol``); each bf16 on the tensor cores, float32 on the CUDA cores
    (both at d = 40 / 80 on the float32 kernel, at d = 512 on the float32
    d = 512 kernel; the counters say which ran)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    for wrapper, plain, counter in (
            (flash_mod.flash_attention_cuda, flash_attention_bounded_reference,
             "launches" + _route_suffix(dtype, shape[3])),
            (flash_mod.flash_attention_exact_cuda, flash_attention_exact_reference,
             "launches_exact" + _route_suffix(dtype, shape[3]))):
        before = getattr(flash_mod, counter)
        got = wrapper(q, k, v)
        torch.cuda.synchronize()
        assert getattr(flash_mod, counter) == before + 1
        want = _plain_on_card(plain, q, k, v).float()
        torch.testing.assert_close(got.float(), want, rtol=0, atol=_tol(dtype, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bounded_kernels_saturate_as_their_plain_versions_on_card(cuda, dtype):
    """Keys beyond the anchor window far above its max: the bounded kernels
    (forward and LSE forward) match the bounded plain versions, the exact
    kernel matches its plain version (exact attention with the kernel's
    roundings), and the two forms differ by far more than the tolerance.
    bf16 runs every one on the tensor cores, float32 on the CUDA cores (all
    three on the float32 kernel)."""
    q, k, v = _saturating(cuda, dtype)
    assert bounded_anchor(1024, 40) == 512
    suffix = _route_suffix(dtype, 40)
    names = ("launches" + suffix, "launches_lse" + suffix, "launches_exact" + suffix)
    before = [getattr(flash_mod, n) for n in names]
    bounded = flash_mod.flash_attention_cuda(q, k, v).float()
    out, lse2 = flash_mod.flash_attention_lse_cuda(q, k, v)
    exact = flash_mod.flash_attention_exact_cuda(q, k, v).float()
    assert [getattr(flash_mod, n) for n in names] == [c + 1 for c in before]
    want_out, want_lse = flash_mod.flash_attention_lse_reference(q, k, v,
                                                                 out_dtype=torch.float32)
    want_exact = _plain_on_card(flash_attention_exact_reference, q, k, v)
    torch.cuda.synchronize()
    tol = _tol(dtype, want_out)
    torch.testing.assert_close(bounded, _plain_on_card(flash_attention_bounded_reference, q, k, v),
                               rtol=0, atol=tol)
    torch.testing.assert_close(out.float(), want_out, rtol=0, atol=tol)
    torch.testing.assert_close(lse2, want_lse, rtol=1e-5, atol=1e-4)   # ~120: float32 ulps
    torch.testing.assert_close(exact, want_exact, rtol=0, atol=_tol(dtype, want_exact))
    assert (bounded - exact).abs().max().item() > 20 * tol
    assert lse2.min().item() > 100.0


@pytest.mark.gpu
def test_flash_kernel_refuses_other_head_dims(cuda):
    q = torch.randn(1, 1, 1024, 64, device=cuda)
    with pytest.raises(ValueError):
        flash_mod.flash_attention_cuda(q, q, q)


def test_groupnorm_module_on_cpu_takes_plain_version():
    m = gn_mod.FusedGroupNorm(32, 64, eps=1e-6, act="silu")
    x = torch.randn(2, 64, 4, 4)
    before = gn_mod.launches
    torch.testing.assert_close(
        m(x), gn_mod.group_norm_reference(x, m.weight, m.bias, groups=32, eps=1e-6, act="silu"),
        rtol=0, atol=0)
    assert gn_mod.launches == before
    with pytest.raises(ValueError):
        gn_mod.group_norm_cuda(x.contiguous(memory_format=torch.channels_last), m.weight, m.bias,
                               groups=32)


# every GroupNorm shape of the paths' table (PERF.md section 6, row 2); the
# last two take the streamed regime
GN_PATH_SHAPES = [(8, 320, 64, 64), (2, 320, 64, 64), (8, 960, 64, 64), (8, 640, 64, 64),
                  (8, 1920, 32, 32), (8, 1280, 8, 8), (8, 2560, 8, 8), (2, 512, 64, 64),
                  (2, 128, 512, 512), (2, 256, 256, 256)]


def _gn_inputs(device, shape, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(dtype)
    w = torch.randn(shape[1], generator=g, device=device).to(dtype)
    b = torch.randn(shape[1], generator=g, device=device).to(dtype)
    return x.contiguous(memory_format=torch.channels_last), w, b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GN_PATH_SHAPES)
def test_groupnorm_kernel_matches_plain_on_card(cuda, dtype, shape):
    """The CUDA kernel against the plain version on the card, channels-last:
    float32 1e-4 absolute (summation order); bfloat16 one output ulp,
    2^-7 * max|y|, since both normalise in float32 and round once.  Two
    launches give the same bits, and y is channels-last."""
    x, w, b = _gn_inputs(cuda, shape, dtype)
    before = gn_mod.launches
    got = gn_mod.group_norm(x, w, b, groups=32, eps=1e-5, act="silu")
    again = gn_mod.group_norm(x, w, b, groups=32, eps=1e-5, act="silu")
    torch.cuda.synchronize()
    assert gn_mod.launches == before + 2
    assert torch.equal(got, again) and got.is_contiguous(memory_format=torch.channels_last)
    want = gn_mod.group_norm_reference(x, w, b, groups=32, eps=1e-5, act="silu").float()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


@pytest.mark.gpu
def test_groupnorm_kernel_refuses_what_it_does_not_take(cuda):
    """NCHW-contiguous x, float16, C % G != 0, a misaligned view: ValueError,
    nothing launched, no copy into the layout."""
    x, w, b = _gn_inputs(cuda, (2, 64, 8, 8), torch.float32)
    flat = torch.empty(x.numel() + 1, device=cuda)
    before = gn_mod.launches
    for args, groups in (((x.contiguous(), w, b), 32), ((x.half(), w.half(), b.half()), 32),
                         ((x, w, b), 48),
                         ((flat[1:].view(2, 8, 8, 64).permute(0, 3, 1, 2), w, b), 32)):
        with pytest.raises(ValueError):
            gn_mod.group_norm_cuda(*args, groups=groups)
    assert gn_mod.launches == before


def _bounded_vs_exact_tol(q, k, v):
    """How far the bounded forward and ``reference_attention`` may differ in
    float32 on the same inputs ([B, H, S, D], no key above the anchor
    window's max + 116, so the two are the same function), from float32
    rounding and the output's scale; eps = 2^-24, the unit roundoff.

    * A score: each form sums D products (the bounded one of q rounded after
      its scale, the exact one divided by sqrt(D) after), so each side's
      score is off by at most (D + 2) eps sum_c |q_c k_c| / sqrt(D) in
      natural log units (the bounded form's base-2 scores times ln 2), and a
      weight exp(s - shift) by that relatively, plus the exponential's own
      error (at most 2 eps each side).  With both sides:
      w_rel = 2 (D + 2) eps max sum_c |q_c k_c| / sqrt(D) + 4 eps.
    * The output is sum_j w_j v_j / sum_j w_j: weights off by at most w_rel
      relatively move it by at most 2 w_rel max|v| (to first order), and
      each side's two sums over Sk keys and its division add at most
      (Sk + 1) eps max|v|.
    """
    d, sk = q.shape[-1], k.shape[-2]
    eps = 2.0 ** -24
    dots = torch.matmul(q.detach().abs(), k.detach().abs().transpose(-1, -2)).max().item()
    w_rel = 2 * (d + 2) * eps * dots / d ** 0.5 + 4 * eps
    return (2 * w_rel + 2 * (sk + 1) * eps) * v.detach().abs().max().item()


def test_flash_diff_on_cpu_takes_plain_versions():
    """``flash_attention_diff`` on CPU tensors: forward and backward are the
    plain versions (the bounded forward's wrapper gives its plain version,
    bit for bit, which pins the function), nothing is launched, and the
    backward kernels' entry points refuse CPU tensors.  Against exact
    ``reference_attention`` the bounded output differs by float32 rounding
    only, held to the bound ``_bounded_vs_exact_tol`` derives from the
    inputs."""
    q, k, v = (torch.randn(1, 2, 48, 8, requires_grad=True) for _ in range(3))
    before = _bwd_counts()
    out = flash_mod.flash_attention_diff(q, k, v)
    out.sum().backward()
    assert before == _bwd_counts()
    torch.testing.assert_close(out, reference_attention(q, k, v), rtol=0,
                               atol=_bounded_vs_exact_tol(q, k, v))
    want_out, want_lse = flash_mod.flash_attention_lse_reference(q, k, v)
    got_out, got_lse = flash_mod.flash_attention_lse_cuda(q, k, v)
    torch.testing.assert_close(got_out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=0)
    with pytest.raises(ValueError):
        flash_mod.flash_attention_backward_cuda(q, k, v, out, torch.zeros(2, 1, 48), out)


def _bwd_tols(dtype, wants):
    """float32: 1e-4 of each output's largest value (summation order, exp2
    rounding).  bfloat16: the kernels round qs, ks, ds and p (for dv) to bf16
    as the TPU kernels do, and so does the plain version; each output is held
    to the plain version before its final rounding (``out_dtype=float32``)
    within 2^-8 of its largest value.  That is half an ulp for the kernel's
    own rounding of the output, and room for the few ds (or p) values whose
    float32 inputs, summed in another order on the tensor cores, round to
    the other bf16 neighbour: one such flip moves an output by one bf16 ulp
    of that term (<= 2^-7 |ds| |k|, or |q|), and one term is a small part of
    a sum over hundreds of keys or queries."""
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -8
    return [rel * w.abs().max().item() for w in wants]


def _bwd_counts():
    return (flash_mod.launches_lse, flash_mod.launches_lse_tc, flash_mod.launches_bwd_dq,
            flash_mod.launches_bwd_dkv, flash_mod.launches_bwd_dq_tc,
            flash_mod.launches_bwd_dkv_tc, flash_mod.launches_lse_f32,
            flash_mod.launches_bwd_f32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sk", [((1, 8, 1024, 40), 1024), ((2, 4, 1024, 80), 1024),
                                      ((1, 8, 1000, 80), 1064), ((1, 2, 300, 40), 140)])
def test_flash_lse_and_backward_kernels_match_plain_on_card(cuda, dtype, shape, sk):
    """The LSE forward (out, lse2) against its bounded plain version, out
    before its final rounding, and dq, dk, dv of the backward kernels
    (``flash_attention_backward_cuda``, called directly: the routing sends
    these lengths to autograd of ``reference_attention``) against the plain
    backward on the same inputs, fed the kernel forward's out and lse2,
    before its final rounding; ragged Sq != Sk included: padded keys must
    not leak into dq, padded queries not into dk / dv.  bf16 runs the
    tensor-core LSE forward and backward, float32 the float32 LSE kernel and
    the fused float32 backward (``lse_entry``, ``bwd_entry``)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    kshape = shape[:2] + (sk, shape[3])
    q = torch.randn(shape, generator=g, device=cuda).to(dtype)
    k = torch.randn(kshape, generator=g, device=cuda).to(dtype)
    v = torch.randn(kshape, generator=g, device=cuda).to(dtype)
    do = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = _bwd_counts()
    out, lse2 = flash_mod.flash_attention_lse_cuda(q, k, v)
    got = flash_mod.flash_attention_backward_cuda(q, k, v, out, lse2, do)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert _bwd_counts() == tuple(c + m for c, m in zip(before, (0, tc, 0, 0, tc, tc, not tc,
                                                                  not tc)))
    # the bounded plain version in the inputs' dtype rounds at the kernel's steps
    want_out, want_lse = flash_mod.flash_attention_lse_reference(q, k, v,
                                                                 out_dtype=torch.float32)
    wants = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do,
                                                         out_dtype=torch.float32)
    tol_out, = _bwd_tols(dtype, [want_out])
    torch.testing.assert_close(out.float(), want_out, rtol=0, atol=tol_out)
    # lse2 is float32 for either dtype: 1e-4 absolute on values of ~10; in
    # bf16 a rounding of one p that falls the other way moves it by at most
    # log2(1 + 2^-8)
    lse_tol = 1e-4 if dtype == torch.float32 else math.log2(1 + 2.0 ** -8)
    torch.testing.assert_close(lse2, want_lse, rtol=0, atol=lse_tol)
    for a, b, tol in zip(got, wants, _bwd_tols(dtype, wants)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b, rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,sk,saturate", [
    ((1, 8, 4096, 40), 4096, False), ((1, 8, 1024, 80), 1024, False),
    ((1, 1, 4096, 512), 4096, False), ((1, 8, 1000, 80), 1064, False),
    ((1, 1, 1000, 512), 1100, False), ((1, 2, 77, 40), 300, False),
    ((1, 8, 1024, 40), 1024, True)])
def test_tc_lse_kernel_matches_bf16_plain_on_card(cuda, shape, sk, saturate):
    """The tensor-core LSE forward (row 3 in bf16) at d = 40, 80 and 512,
    the NMG gradient call's and the VAE's shapes, ragged Sq and Sk, and the
    saturating input: out against the bounded plain version before its final
    rounding within one output ulp (``_tol``), lse2 against the plain lse2
    within log2(1 + 2^-8) (a rounding of one p that falls the other way moves
    a row's sum by at most one ulp of its largest term) and 1e-5 relative
    (the saturating rows' ~120); one launch of its counter, none of the
    CUDA-core template's."""
    if saturate:
        q, k, v = _saturating(cuda, torch.bfloat16)
    else:
        g = torch.Generator(device=cuda).manual_seed(4)
        q = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
        k, v = (torch.randn(shape[:2] + (sk, shape[3]), generator=g, device=cuda)
                .to(torch.bfloat16) for _ in range(2))
    before = _bwd_counts()
    out, lse2 = flash_mod.flash_attention_lse_cuda(q, k, v)
    torch.cuda.synchronize()
    assert _bwd_counts() == tuple(c + (i == 1) for i, c in enumerate(before))
    want_out, want_lse = flash_mod.flash_attention_lse_reference(q, k, v,
                                                                 out_dtype=torch.float32)
    assert torch.isfinite(out).all() and torch.isfinite(lse2).all()
    torch.testing.assert_close(out.float(), want_out, rtol=0, atol=_tol(torch.bfloat16, want_out))
    torch.testing.assert_close(lse2, want_lse, rtol=1e-5, atol=math.log2(1 + 2.0 ** -8))


@pytest.mark.gpu
def test_differentiated_attention_routes_by_length_on_card(cuda):
    """``fused_attention`` under a recorded gradient routes as JAX on the
    TPU: from ``FLASH_MIN_SEQ`` tokens the LSE forward, and the backward
    kernel (float32 here: the fused dq / dk / dv one) only from
    ``_BWD_MIN_SEQ`` (2048) on, the gradient of
    ``reference_attention`` by autograd below; below ``FLASH_MIN_SEQ`` no
    launch; the forward kernel alone when nothing requires a gradient.
    Every route gives the plain version's gradient (float32, 1e-4 of its
    largest value)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    assert flash_mod._BWD_MIN_SEQ == 2 * FLASH_MIN_SEQ
    for s, fwd, bwd in ((2 * FLASH_MIN_SEQ, 1, 1), (FLASH_MIN_SEQ, 1, 0),
                        (FLASH_MIN_SEQ // 2, 0, 0)):
        q, k, v = (torch.randn(1, 2, s, 40, generator=g, device=cuda).requires_grad_()
                   for _ in range(3))
        before = (flash_mod.launches_f32, flash_mod.launches_lse_f32,
                  flash_mod.launches_bwd_f32, flash_mod.launches_bwd_dq)
        got = torch.autograd.grad(fused_attention(q, k, v).square().sum(), (q, k, v))
        assert (flash_mod.launches_f32, flash_mod.launches_lse_f32, flash_mod.launches_bwd_f32,
                flash_mod.launches_bwd_dq) == (before[0], before[1] + fwd,
                                               before[2] + bwd, before[3]), s
        want = torch.autograd.grad(reference_attention(q, k, v).square().sum(), (q, k, v))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item())
        with torch.no_grad():
            fused_attention(q, k, v)
        assert flash_mod.launches_f32 == before[0] + fwd


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_refuses_the_vae_head_dim(cuda, dtype):
    """The VAE's mid-block attention [1, 1, 4096, 512] through
    ``fused_attention`` (the style reward's route), routed as JAX on the
    TPU by ``flash_kv_fits``: in bf16 (8 MiB of K/V, the budget) under a
    recorded gradient the tensor-core LSE forward and both tensor-core
    backward kernels (which take 40, 80 and 512; the CUDA-core template's
    none), matching the plain backward on the same inputs before its final
    rounding, fed the bounded plain forward's out and lse2 (tolerances of
    ``_bwd_tols``); in float32 (16 MiB) no kernel at all, with or without a
    gradient: ``reference_attention`` and its autograd.  A head dim the
    kernels have no tile for is still refused."""
    g = torch.Generator(device=cuda).manual_seed(3)
    shape = (1, 1, 4096, 512)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype).requires_grad_()
               for _ in range(3))
    do = torch.randn(shape, generator=g, device=cuda).to(dtype)
    assert 512 in flash_mod.BWD_HEAD_DIMS
    tc = dtype == torch.bfloat16
    before, forward = _bwd_counts(), _launch_counts()
    got = torch.autograd.grad(fused_attention(q, k, v), (q, k, v), do)
    with torch.no_grad():
        fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert _bwd_counts() == tuple(c + m for c, m in zip(before, (0, tc, 0, 0, tc, tc, 0, 0)))
    assert _launch_counts()[0] == forward[0] and _launch_counts()[6] == forward[6] + tc
    if tc:
        want_out, want_lse = flash_mod.flash_attention_lse_reference(q.detach(), k.detach(),
                                                                     v.detach())
        wants = flash_mod.flash_attention_backward_reference(
            q.detach(), k.detach(), v.detach(), want_out, want_lse, do, out_dtype=torch.float32)
    else:
        wants = torch.autograd.grad(reference_attention(q, k, v), (q, k, v), do)
    for a, b, tol in zip(got, wants, _bwd_tols(dtype, wants)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)
    x = torch.randn(1, 1, 1024, 64, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_mod.flash_attention_backward_cuda(x, x, x, x, torch.zeros(1, 1, 1024, device=cuda),
                                                x)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,sk", [((1, 1, 4096, 512), 4096), ((1, 1, 1000, 512), 1100)])
def test_flash_backward_tensor_cores_at_the_vae_head_dim(cuda, shape, sk):
    """bf16 at d = 512 (``csrc/flash_attention_bwd_tc.cu``): dq and dk / dv of
    ``flash_bwd_dq_cuda`` / ``flash_bwd_dkv_cuda`` against the plain backward
    before its final rounding, fed the kernel forward's out and lse2, at the
    decoder's mid-block attention and a ragged 1000 / 1100 (padded keys must
    not leak into dq, padded queries not into dk / dv); the tensor-core
    counters move, the template's do not; launched again, every output
    bit-identical (one writer an element, no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    kshape = shape[:2] + (sk, shape[3])
    q, do = (torch.randn(shape, generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(kshape, generator=g, device=cuda).bfloat16() for _ in range(2))
    out, lse2 = flash_mod.flash_attention_lse_cuda(q, k, v)
    delta = (do.float() * out.float()).sum(dim=-1)
    before = _bwd_counts()
    got = [flash_mod.flash_bwd_dq_cuda(q, k, v, do, lse2, delta),
           *flash_mod.flash_bwd_dkv_cuda(q, k, v, do, lse2, delta)]
    again = [flash_mod.flash_bwd_dq_cuda(q, k, v, do, lse2, delta),
             *flash_mod.flash_bwd_dkv_cuda(q, k, v, do, lse2, delta)]
    torch.cuda.synchronize()
    assert _bwd_counts() == tuple(c + m for c, m in zip(before, (0, 0, 0, 0, 2, 2, 0, 0)))
    wants = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do,
                                                         out_dtype=torch.float32)
    for a, b, w, tol in zip(got, again, wants, _bwd_tols(torch.bfloat16, wants)):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), w, rtol=0, atol=tol)
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_backward_tensor_cores_refuse_a_misaligned_vae_operand(cuda):
    """At d = 512 too the tensor-core backward's wrappers raise on a bf16
    operand that is not 16-byte aligned, and launch nothing: no fall back to
    the CUDA-core template or a plain version."""
    buf = torch.zeros(2 * 1024 * 512 + 16, device=cuda, dtype=torch.bfloat16)
    misaligned = buf[1:1 + 1024 * 512].view(1, 1, 1024, 512)    # 2 bytes off
    aligned = buf[8:8 + 1024 * 512].view(1, 1, 1024, 512)       # 16 bytes on
    lse2, delta = torch.zeros(1, 1, 1024, device=cuda), torch.zeros(1, 1024, device=cuda)
    before = _bwd_counts()
    for operands in ((misaligned, aligned, aligned, aligned), (aligned, aligned, misaligned,
                                                               aligned)):
        for wrapper in (flash_mod.flash_bwd_dq_cuda, flash_mod.flash_bwd_dkv_cuda):
            with pytest.raises(ValueError, match="aligned"):
                wrapper(*operands, lse2, delta)
    assert _bwd_counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,act", [((1, 320, 64, 64), "silu"), ((2, 1280, 8, 8), "silu"),
                                       ((1, 640, 32, 32), None)])
def test_groupnorm_gradient_matches_autograd_of_plain_on_card(cuda, dtype, shape, act):
    """The autograd wrapper around the CUDA kernel (forward the kernel,
    backward plain tensor code from the saved input), channels-last,
    against ``torch.autograd`` of ``group_norm_reference`` in float32 on the
    same input values: dx, dweight, dbias within 1e-4 (float32) or one bf16
    ulp (2^-8, bfloat16) of each gradient's largest value; dx channels-last."""
    x, w, b = (t.requires_grad_() for t in _gn_inputs(cuda, shape, dtype))
    dy = _gn_inputs(cuda, shape, dtype, seed=1)[0]
    before = gn_mod.launches
    got = torch.autograd.grad(gn_mod.group_norm(x, w, b, groups=32, eps=1e-5, act=act),
                              (x, w, b), dy)
    assert gn_mod.launches == before + 1
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    xf, wf, bf = (t.detach().float().requires_grad_() for t in (x, w, b))
    want = torch.autograd.grad(
        gn_mod.group_norm_reference(xf, wf, bf, groups=32, eps=1e-5, act=act), (xf, wf, bf),
        dy.float())
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -8
    for a, c in zip(got, want):
        torch.testing.assert_close(a.float(), c, rtol=0, atol=rel * c.abs().max().item())


def _launch_counts():
    return (flash_mod.launches, flash_mod.launches_packed, flash_mod.launches_lse,
            flash_mod.launches_bwd_dq, flash_mod.launches_bwd_dkv,
            flash_mod.launches_packed_bounded, flash_mod.launches_tc,
            flash_mod.launches_packed_bounded_tc, flash_mod.launches_exact_tc,
            flash_mod.launches_packed_tc, flash_mod.launches_f32,
            flash_mod.launches_packed_bounded_f32, flash_mod.launches_lse_f32,
            flash_mod.launches_f32_512, flash_mod.launches_packed_bounded_f32_512,
            flash_mod.launches_lse_f32_512, flash_mod.launches_exact_f32_512,
            flash_mod.launches_packed_f32_512, flash_mod.launches_exact_f32,
            flash_mod.launches_packed_f32)


def test_packed_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor of packed heads takes the plain versions even at
    kernel-sized sequences and launches nothing; the CUDA entry point refuses
    CPU tensors instead of falling back."""
    q = torch.randn(1, FLASH_MIN_SEQ, 2 * 8)
    before = _launch_counts()
    torch.testing.assert_close(fused_attention_packed(q, q, q, 2),
                               flash_attention_packed_reference(q, q, q, 2), rtol=0, atol=0)
    torch.testing.assert_close(flash_mod.flash_attention_packed_bounded_cuda(q, q, q, 2),
                               flash_mod.flash_attention_packed_bounded_reference(q, q, q, 2),
                               rtol=0, atol=0)
    assert _launch_counts() == before
    with pytest.raises(ValueError):
        flash_mod.flash_attention_packed_cuda(q, q, q, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,sq,sk,d", [(2, 8, 1024, 1024, 40), (2, 8, 1024, 1024, 80),
                                             (2, 3, 300, 300, 40), (2, 2, 128, 400, 80),
                                             (1, 1, 1000, 1100, 512)])
def test_packed_kernel_matches_plain_on_card(cuda, dtype, b, heads, sq, sk, d):
    """The exact packed-head kernel (bf16 on the tensor cores, float32 on
    the CUDA cores, at d = 40 / 80 on the float32 kernel and at d = 512 on
    the float32 d = 512 kernel: the counters say which ran) against its
    plain version (``flash_attention_packed_exact_reference`` at the
    kernel's key tile, output before its final rounding), ragged and Sq !=
    Sk included, the VAE's width, contiguous and as a row slice of a larger
    batch (a batch stride, no copy).  Tolerances as the head-split forward's: float32 1e-4,
    bfloat16 one output ulp at the largest output."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, 3, sq, heads * d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, 3, sk, heads * d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, 2, sk, heads * d, generator=g, device=cuda).to(dtype)
    for qs, ks, vs in ((q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous()),
                       (q[:, 1], k[:, 2], v[:, 1])):
        before = _launch_counts()
        got = flash_mod.flash_attention_packed_cuda(qs, ks, vs, heads)
        torch.cuda.synchronize()
        moved = 9 if dtype == torch.bfloat16 else 17 if d == 512 else 19
        assert _launch_counts() == tuple(c + (i == moved) for i, c in enumerate(before))
        assert got.shape == qs.shape and got.is_contiguous()
        want = flash_attention_packed_exact_reference(qs, ks, vs, heads,
                                                      out_dtype=torch.float32)
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -8 * want.abs().max().item()
        torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


@pytest.mark.gpu
def test_packed_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn(2, 1024, 8 * 40, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_mod.flash_attention_packed_cuda(q, q, q, 5)            # d = 64
    with pytest.raises(ValueError, match="dense"):
        flash_mod.flash_attention_packed_cuda(q[:, ::2], q[:, ::2], q[:, ::2], 8)
    with pytest.raises(ValueError, match="shape"):
        flash_mod.flash_attention_packed_cuda(q, q[:1], q[:1], 8)
    with pytest.raises(ValueError, match="dtypes"):
        flash_mod.flash_attention_packed_cuda(q, q.double(), q, 8)
    # bf16 takes the tensor cores, which refuse a batch stride that is not a
    # multiple of 8 and a pointer off 16 bytes, and never fall back
    buf = torch.randn(2 * 1024 * 320 + 8, device=cuda).to(torch.bfloat16)
    odd = buf.as_strided((2, 1024, 320), (1024 * 320 + 3, 320, 1))
    misaligned = buf[1:1 + 1024 * 320].view(1, 1024, 320)
    before = _launch_counts()
    for t in (odd, misaligned):
        with pytest.raises(ValueError, match="multiples of 8|aligned"):
            flash_mod.flash_attention_packed_cuda(t, t, t, 8)
    head = buf[1:1 + 1024 * 40].view(1, 1, 1024, 40)
    with pytest.raises(ValueError, match="aligned"):
        flash_mod.flash_attention_exact_cuda(head, head, head)
    assert _launch_counts() == before
    # the CUDA-core template's exact entries take float32 only
    qb = q.to(torch.bfloat16)
    for entry, ints in (("hedit_flash_attention_fwd_packed", (2, 8, 1024, 1024, 40,
                                                              *(1024 * 320,) * 3)),
                        ("hedit_flash_attention_fwd_exact", (16, 1024, 1024, 40))):
        with pytest.raises(RuntimeError, match="code -1"):
            flash_mod._launch(entry, qb, (qb, qb, qb, torch.empty_like(qb)), ints)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,heads,sq,sk,d", [(2, 8, 1024, 1024, 40), (2, 8, 1024, 1024, 80),
                                             (2, 3, 300, 300, 40), (2, 2, 128, 400, 80)])
def test_packed_bounded_kernel_matches_plain_on_card(cuda, dtype, b, heads, sq, sk, d):
    """The bounded packed-head kernel (bf16 on the tensor cores, float32 on
    the CUDA cores) against its plain version (``_plain_on_card``), with
    JAX's anchor and with a short one that leaves keys beyond the window,
    contiguous and as a row slice of a larger batch.  Tolerances of
    ``_tol``."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, 3, sq, heads * d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, 3, sk, heads * d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, 2, sk, heads * d, generator=g, device=cuda).to(dtype)
    for (qs, ks, vs), anchor in (((q[:, 0].contiguous(), k[:, 0].contiguous(),
                                   v[:, 0].contiguous()), None),
                                  ((q[:, 1], k[:, 2], v[:, 1]), 100)):
        before = _launch_counts()
        got = flash_mod.flash_attention_packed_bounded_cuda(qs, ks, vs, heads, anchor)
        torch.cuda.synchronize()
        moved = 7 if dtype == torch.bfloat16 else 11
        assert _launch_counts() == tuple(c + (i == moved) for i, c in enumerate(before))
        assert got.shape == qs.shape and got.is_contiguous()
        want = flash_mod.flash_attention_packed_bounded_reference(qs, ks, vs, heads, anchor,
                                                                  out_dtype=torch.float32)
        torch.testing.assert_close(got.float(), want, rtol=0, atol=_tol(dtype, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_bounded_kernel_saturates_as_its_plain_version_on_card(cuda, dtype):
    """The saturating input laid out packed ([1, 1024, 8 * 40]): the routed
    attention (the bounded packed kernel of the dtype: bf16 on the tensor
    cores, which moves their counter and not the CUDA-core one) matches the
    bounded plain version within one output ulp and differs from exact
    attention by far more."""
    q, k, v = (merge_heads(t).contiguous() for t in _saturating(cuda, dtype))
    before = _launch_counts()
    with torch.no_grad():
        got = fused_attention_packed(q, k, v, 8).float()
    torch.cuda.synchronize()
    moved = 7 if dtype == torch.bfloat16 else 11
    assert _launch_counts() == tuple(c + (i == moved) for i, c in enumerate(before))
    want = flash_mod.flash_attention_packed_bounded_reference(q, k, v, 8,
                                                              out_dtype=torch.float32)
    exact = flash_attention_packed_reference(q.float(), k.float(), v.float(), 8)
    tol = _tol(dtype, want)
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert (got - exact).abs().max().item() > 20 * tol


@pytest.mark.gpu
def test_packed_attention_routes_by_heads_length_and_gradient_on_card(cuda):
    """``fused_attention_packed``: the bounded packed kernel at
    ``FLASH_MIN_SEQ`` tokens with 8 heads and no recorded gradient, and never
    the exact packed kernel; kernels 3-5 (head-split) under a recorded
    gradient; the head-split bounded forward for one head; the plain version
    below the threshold.  Every route gives the plain version's output."""
    g = torch.Generator(device=cuda).manual_seed(0)
    S = FLASH_MIN_SEQ
    q8 = torch.randn(2, S, 8 * 40, generator=g, device=cuda)
    q1 = torch.randn(1, S, 512, generator=g, device=cuda)
    short = torch.randn(2, S // 2, 8 * 40, generator=g, device=cuda)
    # (inputs, heads, recorded gradient) -> how far each of launches_f32_512,
    # launches_packed, launches_lse_f32, launches_packed_bounded_f32 moves
    # (float32: d = 40 on the float32 kernel, d = 512 on its own)
    for x, heads, grad, moved in ((q8, 8, False, (0, 0, 0, 1)), (q8, 8, True, (0, 0, 1, 0)),
                                  (q1, 1, False, (1, 0, 0, 0)), (short, 8, False, (0, 0, 0, 0))):
        x = x.clone().requires_grad_(grad)
        before = _launch_counts()
        with torch.set_grad_enabled(grad):
            got = fused_attention_packed(x, x, x, heads)
        torch.cuda.synchronize()
        after = _launch_counts()
        assert tuple(after[i] - before[i] for i in (13, 1, 12, 11, 0, 6, 7)) == moved + (0,) * 3
        want = flash_attention_packed_reference(x.detach(), x.detach(), x.detach(), heads)
        torch.testing.assert_close(got.detach(), want, rtol=0, atol=1e-4)
    # a tensor that requires a gradient, with recording off: the packed kernel
    x = q8.clone().requires_grad_(True)
    before = _launch_counts()
    with torch.no_grad():
        fused_attention_packed(x, x, x, 8)
    assert _launch_counts()[11] == before[11] + 1
    # head split and merge around the head-split bounded kernel (the same
    # arithmetic) give the same values
    with torch.no_grad():
        a = fused_attention_packed(q8, q8, q8, 8)
        b = merge_heads(flash_mod.flash_attention_cuda(*(split_heads(q8, 8),) * 3))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,sk", [((2, 8, 1024, 40), 1024), ((2, 4, 1024, 80), 1024),
                                      ((1, 1, 2048, 512), 2048), ((1, 8, 1000, 80), 1064),
                                      ((1, 8, 1024, 40), 1000), ((1, 1, 1000, 512), 1100),
                                      ((1, 2, 77, 40), 300)])
def test_tc_kernel_matches_bf16_plain_on_card(cuda, shape, sk):
    """The tensor-core forward, head-split, at d = 40, 80 and 512, ragged Sq
    and Sk included, against the bounded plain version (``_plain_on_card``)
    within one output ulp; one launch of its counter and none of the
    CUDA-core template's."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(shape[:2] + (sk, shape[3]), generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    before = _launch_counts()
    got = flash_mod.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert _launch_counts() == tuple(c + (i == 6) for i, c in enumerate(before))
    want = _plain_on_card(flash_attention_bounded_reference, q, k, v)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=_tol(torch.bfloat16, want))


@pytest.mark.gpu
@pytest.mark.parametrize("b,heads,sq,sk,d", [(2, 8, 1024, 1024, 40), (2, 8, 1024, 1024, 80),
                                             (1, 8, 1000, 1064, 40), (2, 3, 300, 300, 80)])
def test_tc_packed_kernel_matches_bf16_plain_on_card(cuda, b, heads, sq, sk, d):
    """The tensor-core forward on packed heads, contiguous and as a
    batch-strided row slice of a larger batch, against the bounded plain
    version within one output ulp."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(b, 3, sq, heads * d, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(b, 3, sk, heads * d, generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn(b, 2, sk, heads * d, generator=g, device=cuda).to(torch.bfloat16)
    for qs, ks, vs in ((q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous()),
                       (q[:, 1], k[:, 2], v[:, 1])):
        before = _launch_counts()
        got = flash_mod.flash_attention_packed_bounded_cuda(qs, ks, vs, heads)
        torch.cuda.synchronize()
        assert _launch_counts() == tuple(c + (i == 7) for i, c in enumerate(before))
        want = flash_mod.flash_attention_packed_bounded_reference(qs, ks, vs, heads,
                                                                  out_dtype=torch.float32)
        torch.testing.assert_close(got.float(), want, rtol=0, atol=_tol(torch.bfloat16, want))


@pytest.mark.gpu
def test_tc_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    """A pointer that is not 16-byte aligned, a batch stride that is not a
    multiple of 8 and float16 are refused before any launch: no fallback to
    the CUDA-core template."""
    buf = torch.randn(2 * 1024 * 320 + 8, device=cuda).to(torch.bfloat16)
    misaligned = buf[1:1 + 1024 * 320].view(1, 1024, 320)
    odd = buf.as_strided((2, 1024, 320), (1024 * 320 + 3, 320, 1))
    head = buf[1:1 + 1024 * 40].view(1, 1, 1024, 40)
    before, lse_before = _launch_counts(), flash_mod.launches_lse_tc
    with pytest.raises(ValueError, match="aligned"):
        flash_mod.flash_attention_packed_bounded_cuda(misaligned, misaligned, misaligned, 8)
    with pytest.raises(ValueError, match="aligned"):
        flash_mod.flash_attention_cuda(head, head, head)
    with pytest.raises(ValueError, match="aligned"):
        flash_mod.flash_attention_lse_cuda(head, head, head)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_mod.flash_attention_packed_bounded_cuda(odd, odd, odd, 8)
    with pytest.raises(ValueError, match="dtypes"):
        flash_mod.flash_attention_cuda(*(head.contiguous().half(),) * 3)
    torch.cuda.synchronize()
    assert _launch_counts() == before and flash_mod.launches_lse_tc == lse_before


def _probe_inputs(dtype, shape=(2, 3, 256, 40), seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]


def _sminor(t):
    return t.transpose(-1, -2).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["packed_t", "packed_t_sminor", "packed_t_all_sminor"])
@pytest.mark.parametrize("shape,anchor", [((2, 3, 256, 40), 128), ((1, 2, 512, 80), 512),
                                          ((1, 2, 1024, 40), 512), ((1, 2, 576, 80), 192),
                                          ((1, 2, 320, 40), 64)])
def test_probe_bounded_kernels_match_plain_on_card(cuda, dtype, layout, shape, anchor):
    """TPU kernel 11's three layouts against their plain versions (tolerances
    of ``_tol``), one launch each: bf16 on the tensor cores (its own
    counter, held before the final rounding), float32 on the query-major
    kernel (``csrc/flash_variants.cu``).  The saturating input (a
    512-key anchor, keys beyond it far above) included, and an Sq of 64
    more than a multiple of 128 at d = 80 and at d = 40 with a 64-key
    anchor (a last block half past Sq).  A second launch gives the same
    bits."""
    from hedit_tpu_torch.ops import flash_probes as fp

    q, k, v = _probe_inputs(dtype, shape)
    if shape[2] == 1024:
        q, k, v = _saturating(cuda, dtype)
    args = {"packed_t": (q, k, v), "packed_t_sminor": (_sminor(q), _sminor(k), v),
            "packed_t_all_sminor": (_sminor(q), _sminor(k), _sminor(v))}[layout]
    wrapper = getattr(fp, f"flash_{layout}_cuda")
    plain = getattr(fp, f"flash_{layout}_reference")
    tc = dtype == torch.bfloat16
    counter = f"launches_{layout}_tc" if tc else f"launches_{layout}"
    names = [n for n in dir(fp) if n.startswith("launches_packed_t")]
    before = {n: getattr(fp, n) for n in names}
    got = wrapper(*args, anchor)
    torch.cuda.synchronize()
    assert {n: getattr(fp, n) - before[n] for n in names} == {n: int(n == counter) for n in names}
    b, h, s, d = q.shape
    assert got.shape == (b, h * d, s)
    want = (plain(*args, anchor, out_dtype=torch.float32) if tc else plain(*args, anchor).float())
    torch.testing.assert_close(got.float(), want, rtol=0, atol=_tol(dtype, want))
    assert torch.equal(wrapper(*args, anchor), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pipe", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 256, 40), (1, 2, 576, 80), (1, 1, 64, 40),
                                   (1, 2, 320, 40)])
def test_probe_exp2_kernel_matches_plain_on_card(cuda, dtype, pipe, shape):
    """TPU kernel 10, both key loops, against its plain version (with the
    kernel's key tile as the block of the running max, ``exp2_key_tile``:
    64 keys, 32 at d = 80 in float32; tolerances of ``_tol``): bf16 on the
    tensor cores (its own counter, held before the final rounding), float32
    on the query-major kernel (a last block past Sq at 64 and 320 queries).
    The two loops give the same bits."""
    from hedit_tpu_torch.ops import flash_probes as fp

    q, k, v = _probe_inputs(dtype, shape)
    counter = "launches_exp2_t_tc" if dtype == torch.bfloat16 else "launches_exp2_t"
    names = ("launches_exp2_t", "launches_exp2_t_tc")
    before = {n: getattr(fp, n) for n in names}
    got = fp.flash_exp2_t_cuda(q, k, v, pipe)
    other = fp.flash_exp2_t_cuda(q, k, v, not pipe)
    torch.cuda.synchronize()
    assert {n: getattr(fp, n) - before[n] for n in names} == {n: 2 * (n == counter) for n in names}
    assert got.shape == (shape[0] * shape[1], shape[3], shape[2])
    blk_k = fp.exp2_key_tile(dtype, shape[3])
    want = (fp.flash_exp2_t_reference(q, k, v, blk_k=blk_k, out_dtype=torch.float32)
            if dtype == torch.bfloat16 else fp.flash_exp2_t_reference(q, k, v, blk_k=blk_k).float())
    torch.testing.assert_close(got.float(), want, rtol=0, atol=_tol(dtype, want))
    assert torch.equal(got, other)


@pytest.mark.gpu
def test_probe_kernels_refuse_what_they_do_not_take(cuda):
    from hedit_tpu_torch.ops import flash_probes as fp

    q = torch.randn(1, 2, 256, 40, device=cuda)
    with pytest.raises(ValueError, match="multiples"):
        fp.flash_packed_t_cuda(q[:, :, :200], q[:, :, :200], q[:, :, :200], 128)
    with pytest.raises(ValueError, match="anchor"):
        fp.flash_packed_t_cuda(q, q, q, 192)
    with pytest.raises(ValueError, match="head dim"):
        fp.flash_exp2_t_cuda(*(torch.randn(1, 2, 256, 64, device=cuda),) * 3)
    with pytest.raises(ValueError, match="shape"):
        fp.flash_packed_t_sminor_cuda(q, q, q, 128)
    # the tensor-core entries take bf16 in every layout (layout 0 is row 11a)
    # and pipe 0 or 1; float32, layout 3, d = 64, pipe 2 and a misaligned
    # pointer are refused; the wrappers raise on the last first (rows 8 and
    # 9 d below)
    from hedit_tpu_torch._build import cuda_library

    lib = cuda_library()
    bounded, exp2 = lib.hedit_flash_packed_t_tc, lib.hedit_flash_exp2_t_tc
    stream = torch.cuda.current_stream().cuda_stream
    qb = q.to(torch.bfloat16)
    out = torch.empty(1, 80, 256, dtype=torch.bfloat16, device=cuda)
    ptrs = [t.data_ptr() for t in (qb, qb, qb, out)]
    for layout in (0, 1, 2):
        assert bounded(*ptrs, 2, 256, 256, 40, 128, layout, 1, stream) == 0
    for layout, dtype, d, shift in ((3, 1, 40, 0), (0, 0, 40, 0), (0, 1, 64, 0), (0, 1, 40, 2)):
        assert bounded(ptrs[0] + shift, *ptrs[1:], 2, 256, 256, d, 128, layout, dtype,
                       stream) == -1
    for pipe in (0, 1):
        assert exp2(*ptrs, 2, 256, 256, 40, pipe, 1, stream) == 0
    for pipe, dtype, d, shift in ((2, 1, 40, 0), (-1, 1, 40, 0), (0, 0, 40, 0), (1, 1, 64, 0),
                                  (0, 1, 40, 2)):
        assert exp2(ptrs[0] + shift, *ptrs[1:], 2, 256, 256, d, pipe, dtype, stream) == -1
    # row 8: modes 0 (dots), 1 (exp) and 2 (noprolog) in bf16, not mode 3,
    # float32, d = 64 or a misaligned pointer, nor dots' check instance on
    # those or a scores pointer off 8 bytes; row 9: variant 1 (d) in bf16 at
    # d = 40 into [BH, Sq, D], not variants 0, 2, 3, float32, d = 80 or a
    # misaligned pointer.  The float32 entries (the query-major kernel's)
    # refuse bf16 dots, exp, noprolog and d; hedit_flash_variant refuses
    # kern_c (3) in either dtype; kern_c's
    # own entry takes both dtypes at d = 40, aligned
    ablate, variant = lib.hedit_flash_ablate_t_tc, lib.hedit_flash_variant_tc
    check = lib.hedit_flash_ablate_dots_check_tc
    for mode in (0, 1, 2):
        assert ablate(*ptrs, 2, 256, 256, 40, mode, 1, stream) == 0
        assert lib.hedit_flash_ablate_t(*ptrs, 2, 256, 256, 40, mode, 1, stream) == -1
    for mode, dtype, d, shift in ((3, 1, 40, 0), (1, 0, 40, 0), (2, 1, 64, 0), (1, 1, 40, 2)):
        assert ablate(ptrs[0] + shift, *ptrs[1:], 2, 256, 256, d, mode, dtype, stream) == -1
    scores = torch.empty(2, 256, 256, device=cuda)
    sums = torch.empty(2, 256, device=cuda)
    assert check(*ptrs, scores.data_ptr(), sums.data_ptr(), 2, 256, 256, 40, 1, stream) == 0
    for dtype, d, shift, s_shift in ((0, 40, 0, 0), (1, 64, 0, 0), (1, 40, 2, 0), (1, 40, 0, 4)):
        assert check(ptrs[0] + shift, *ptrs[1:], scores.data_ptr() + s_shift, sums.data_ptr(),
                     2, 256, 256, d, dtype, stream) == -1
    assert variant(*ptrs, 2, 256, 256, 40, 1, 1, stream) == 0
    assert lib.hedit_flash_variant(*ptrs, 2, 256, 256, 40, 1, 1, stream) == -1
    for code, dtype, d, shift in ((0, 1, 40, 0), (2, 1, 40, 0), (3, 1, 40, 0), (1, 0, 40, 0),
                                  (1, 1, 80, 0), (1, 1, 40, 2)):
        assert variant(ptrs[0] + shift, *ptrs[1:], 2, 256, 256, d, code, dtype, stream) == -1
    out32 = torch.empty(2, 40, 256, device=cuda)
    ptrs32 = [t.data_ptr() for t in (q, q, q, out32)]
    for dtype, pointers in ((0, ptrs32), (1, ptrs)):
        assert lib.hedit_flash_variant(*pointers, 2, 256, 256, 40, 3, dtype, stream) == -1
        assert lib.hedit_flash_variant_c(*pointers, 2, 256, 256, 40, dtype, stream) == 0
    for dtype, d, sq, shift in ((2, 40, 256, 0), (1, 80, 256, 0), (1, 40, 200, 0), (1, 40, 256, 2),
                                (0, 40, 256, 4)):
        assert lib.hedit_flash_variant_c(ptrs[0] + shift, *ptrs[1:], 2, sq, 256, d, dtype,
                                         stream) == -1
    # rows 11 (layouts 0-2, anchor a multiple of 64 that divides Sk) and 8
    # (modes 0-2) in float32 on the query-major kernel at d = 40 and 80,
    # aligned; not bf16, d = 64, anchor 96, layout or mode 3, Sq = 200 or a
    # pointer off 16 bytes (q, v or out)
    q80 = torch.randn(1, 2, 256, 80, device=cuda)
    out80 = torch.empty(2, 80, 256, device=cuda)
    for d, pointers in ((40, ptrs32), (80, [t.data_ptr() for t in (q80, q80, q80, out80)])):
        for code in (0, 1, 2):
            assert lib.hedit_flash_packed_t(*pointers, 2, 256, 256, d, 128, code, 0, stream) == 0
            assert lib.hedit_flash_ablate_t(*pointers, 2, 256, 256, d, code, 0, stream) == 0
    for d, sq, anchor, code, dtype, shift, which in (
            (40, 256, 128, 0, 1, 0, 0), (64, 256, 128, 0, 0, 0, 0), (40, 256, 96, 1, 0, 0, 0),
            (40, 256, 128, 3, 0, 0, 0), (40, 200, 128, 2, 0, 0, 0), (40, 256, 128, 0, 0, 4, 0),
            (40, 256, 128, 2, 0, 8, 2), (40, 256, 128, 1, 0, 4, 3)):
        moved = list(ptrs32)
        moved[which] += shift
        assert lib.hedit_flash_packed_t(*moved, 2, sq, 256, d, anchor, code, dtype, stream) == -1
        if anchor == 128:  # row 8 takes no anchor
            assert lib.hedit_flash_ablate_t(*moved, 2, sq, 256, d, code, dtype, stream) == -1
    # row 10 (pipe 0, 1) in float32 on the query-major kernel at d = 40 and
    # 80, aligned; not bf16, d = 64, pipe 2, Sq = 200 or a pointer off 16
    # bytes (q, k or out)
    for d, pointers in ((40, ptrs32), (80, [t.data_ptr() for t in (q80, q80, q80, out80)])):
        for pipe in (0, 1):
            assert lib.hedit_flash_exp2_t(*pointers, 2, 256, 256, d, pipe, 0, stream) == 0
    for d, sq, pipe, dtype, shift, which in ((40, 256, 0, 1, 0, 0), (64, 256, 0, 0, 0, 0),
                                             (40, 256, 2, 0, 0, 0), (40, 200, 1, 0, 0, 0),
                                             (40, 256, 0, 0, 4, 0), (40, 256, 1, 0, 8, 1),
                                             (40, 256, 1, 0, 4, 3)):
        moved = list(ptrs32)
        moved[which] += shift
        assert lib.hedit_flash_exp2_t(*moved, 2, sq, 256, d, pipe, dtype, stream) == -1
    # rows 9 a, b (codes 0, 2, both dtypes) and float32 d (1) on the
    # query-major kernel, aligned; not code -1, d = 80, Sq = 200, dtype 2 or
    # a pointer off 16 bytes (q, k or out)
    for dtype, pointers in ((0, ptrs32), (1, ptrs)):
        for code in (0, 2) + ((1,) if dtype == 0 else ()):
            assert lib.hedit_flash_variant(*pointers, 2, 256, 256, 40, code, dtype, stream) == 0
        for code, d, sq, shift, which in ((-1, 40, 256, 0, 0), (0, 80, 256, 0, 0),
                                          (2, 40, 200, 0, 0), (0, 40, 256, 4, 0),
                                          (2, 40, 256, 8, 1), (0, 40, 256, 4, 3)):
            moved = list(pointers)
            moved[which] += shift
            assert lib.hedit_flash_variant(*moved, 2, sq, 256, d, code, dtype, stream) == -1
    assert lib.hedit_flash_variant(*ptrs, 2, 256, 256, 40, 0, 2, stream) == -1

    def misaligned(t):  # a dense copy of t two bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        return buf[1:].view(t.shape).copy_(t)

    qt = _sminor(qb)
    names = [n for n in dir(fp) if n.startswith("launches_")]
    before = {n: getattr(fp, n) for n in names}
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_packed_t_all_sminor_cuda(misaligned(qt), qt, qt, 128)
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_packed_t_sminor_cuda(qt, qt, misaligned(qb), 128)
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_packed_t_cuda(qb, misaligned(qb), qb, 128)
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_exp2_t_cuda(qb, qb, misaligned(qb), True)
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_ablate_t_cuda(qb, qb, misaligned(qb), "noprolog")
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_variant_a_cuda(misaligned(qb[0]), qb[0], qb[0], pv_bf16=True)
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_ablate_dots_check_cuda(qb, misaligned(qb), qb)
    for t in (qb[0], q[0]):
        with pytest.raises(ValueError, match="aligned"):
            fp.flash_variant_c_cuda(t, t, misaligned(t))
        with pytest.raises(ValueError, match="aligned"):
            fp.flash_variant_a_cuda(misaligned(t), t, t)
        with pytest.raises(ValueError, match="aligned"):
            fp.flash_variant_b_cuda(t, misaligned(t), t)
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_variant_a_cuda(q[0], q[0], misaligned(q[0]), pv_bf16=True)
    qt32 = _sminor(q)
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_packed_t_cuda(misaligned(q), q, q, 128)
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_packed_t_sminor_cuda(qt32, qt32, misaligned(q), 128)
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_packed_t_all_sminor_cuda(qt32, misaligned(qt32), qt32, 128)
    with pytest.raises(ValueError, match="aligned"):
        fp.flash_ablate_t_cuda(q, q, misaligned(q), "dots")
    for pipe in (False, True):
        with pytest.raises(ValueError, match="aligned"):
            fp.flash_exp2_t_cuda(q, misaligned(q), q, pipe)
    with pytest.raises(ValueError, match="bf16 only"):
        fp.flash_ablate_dots_check_cuda(q, q, q)
    torch.cuda.synchronize()
    assert {n: getattr(fp, n) for n in names} == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dots", "exp", "noprolog"])
@pytest.mark.parametrize("shape", [(1, 4, 1024, 40), (1, 2, 256, 80), (1, 2, 320, 40)])
def test_probe_ablate_kernel_matches_plain_on_card(cuda, dtype, mode, shape):
    """TPU kernel 8, each mode, against its plain version (q and k scaled by
    0.05 as the probe draws them); bf16 on the tensor cores (its own
    counter), float32 on the query-major kernel (``csrc/flash_variants.cu``),
    an Sq of 320 included (a last block half past Sq at d = 40).  A second
    launch gives the same bits.  ``exp`` and ``noprolog``:
    tolerances of ``_tol``, bf16 held before the final rounding.  ``dots``
    in bf16: on the kernel's own scores and row sums
    (``check_ablate_dots_kernel``: the check instance's output bit for bit,
    every score within the tensor cores' bound of the exact one, every row
    sum the kernel's order bit for bit, every output within its tolerance of
    the exact numerator over the kernel's sum; no row excused).  ``dots`` in
    float32: each element within ``ablate_dots_tolerance``, rows whose sum
    of p lies within its reach of zero excused (under 1% here)."""
    from hedit_tpu_torch.ops import flash_probes as fp

    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(shape, generator=g, device=cuda) * s for s in (0.05, 0.05, 1.0))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    tc = dtype == torch.bfloat16
    counter = f"launches_ablate_{mode}{'_tc' if tc else ''}"
    names = [n for n in dir(fp) if n.startswith("launches_ablate_")]
    before = {n: getattr(fp, n) for n in names}
    got = fp.flash_ablate_t_cuda(q, k, v, mode)
    torch.cuda.synchronize()
    assert {n: getattr(fp, n) - before[n] for n in names} == {n: int(n == counter) for n in names}
    b, h, s, d = shape
    assert got.shape == (b * h, d, s) and got.dtype == dtype
    assert torch.equal(fp.flash_ablate_t_cuda(q, k, v, mode), got)
    if tc and mode == "dots":
        worst = fp.check_ablate_dots_kernel(q, k, v, got, images=3)
        assert worst["bit_identical"] and worst["sums_differing_rows"] == 0, worst
        assert worst["score_err_over_tol"] <= 1.0 and worst["out_err_over_tol"] <= 1.0, worst
        passes = -(-b * h // 3)
        assert fp.launches_ablate_dots_check_tc - before["launches_ablate_dots_check_tc"] == passes
        return
    if tc:
        want = fp.flash_ablate_t_reference(q, k, v, mode, out_dtype=torch.float32)
        torch.testing.assert_close(got.float(), want, rtol=0, atol=_tol(dtype, want))
        return
    want = fp.flash_ablate_t_reference(q, k, v, mode)
    err = (got.float() - want.float()).abs()
    if mode != "dots":
        assert err.max().item() <= _tol(dtype, want)
        return
    tol, excused = fp.ablate_dots_tolerance(q, k, v, want)
    assert excused.float().mean().item() < 1e-2
    assert bool(((err <= tol) | excused[:, None, :]).all()), (err / tol).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["a", "b", "c", "d"])
@pytest.mark.parametrize("bh,s,same", [(2, 256, False), (3, 1024, True), (1, 64, False)])
def test_probe_variant_kernels_match_plain_on_card(cuda, dtype, variant, bh, s, same):
    """TPU kernel 9's three layouts and ``pv_bf16`` (d) against their plain
    versions (d with the kernels' 64-key blocks of the running max;
    tolerances of ``_tol``); ``same``: q = k = v, as the probe feeds them;
    (1, 64): Sq half of a 128-query block.  bf16 d runs on the tensor cores
    (its own counter, held before the final rounding), c on its own kernel,
    a, b and float32 d on the query-major kernel (a, b, c: a counter a
    dtype).  The kernels of ``csrc/flash_variants.cu`` give the same bits
    when relaunched, and b's output is a's transposed, bit for bit."""
    from hedit_tpu_torch.ops import flash_probes as fp

    q, k, v = _probe_inputs(dtype, (bh, s, 40), seed=bh)
    if same:
        k = v = q
    tc = dtype == torch.bfloat16 and variant == "d"
    counter = f"launches_variant_{variant}{'_tc' if tc else ''}"
    if variant != "d":
        counter += "_tc" if dtype == torch.bfloat16 else "_f32"
    names = [n for n in dir(fp) if n.startswith("launches_variant_")]
    before = {n: getattr(fp, n) for n in names}
    if variant in "ad":
        got = fp.flash_variant_a_cuda(q, k, v, pv_bf16=variant == "d")
        want = fp.flash_variant_a_reference(q, k, v, pv_bf16=variant == "d",
                                            out_dtype=torch.float32 if tc else None)
    else:
        got = getattr(fp, f"flash_variant_{variant}_cuda")(q, k, v)
        want = fp.flash_variant_b_reference(q, k, v)
    torch.cuda.synchronize()
    assert {n: getattr(fp, n) - before[n] for n in names} == {n: int(n == counter) for n in names}
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=_tol(dtype, want))
    if not tc:
        again = (fp.flash_variant_a_cuda(q, k, v, pv_bf16=variant == "d") if variant in "ad"
                 else getattr(fp, f"flash_variant_{variant}_cuda")(q, k, v))
        assert torch.equal(again, got)
    if variant == "b":
        assert torch.equal(got, fp.flash_variant_a_cuda(q, k, v).transpose(-1, -2))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nn", "tl", "tr", "tm"])
@pytest.mark.parametrize("m,n,k", [(100, 70, 40), (64, 64, 300), (3, 130, 128)])
def test_mm_loop_kernel_matches_plain_on_card(cuda, dtype, layout, m, n, k):
    """TPU kernel 12 under each dimension numbers, ragged M and N, the
    contraction split over blocks (float32, the CUDA-core kernel: K chunks
    and rep ranges) or split K (bf16, the tensor-core kernel): all-ones
    inputs give exactly K * (1 + ... + reps); seeded inputs agree with the
    plain version within 4 sqrt(reps K) 2^-24 times the sum of each
    output's term magnitudes."""
    from hedit_tpu_torch.ops import mm_probe as mp

    reps = 5
    _, a_t, b_t = mp.LAYOUTS[layout]
    a_shape, b_shape = ((k, m) if a_t else (m, k)), ((n, k) if b_t else (k, n))
    counter = f"launches_{layout}{mp.ENTRIES[dtype][1]}"
    before = getattr(mp, counter)
    ones = mp.mm_loop_cuda(torch.ones(a_shape, dtype=dtype, device=cuda),
                           torch.ones(b_shape, dtype=dtype, device=cuda), layout, reps)
    g = torch.Generator(device="cuda").manual_seed(m + n + k)
    a = torch.randn(a_shape, generator=g, device=cuda).to(dtype)
    b = torch.randn(b_shape, generator=g, device=cuda).to(dtype)
    got = mp.mm_loop_cuda(a, b, layout, reps)
    torch.cuda.synchronize()
    assert getattr(mp, counter) == before + 2
    assert ones.shape == (m, n) and ones.dtype == torch.float32
    assert bool((ones == k * reps * (reps + 1) // 2).all())
    want = mp.mm_loop_reference(a, b, layout, reps)
    tol = 4 * math.sqrt(reps * k) * 2.0 ** -24 * mp.mm_loop_magnitude(a, b, layout, reps)
    assert bool(((got - want).abs() <= tol).all()), ((got - want).abs() / tol).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nn", "tl", "tr", "tm"])
def test_mm_loop_tc_kernel_past_256_reps_and_relaunched(cuda, layout):
    """The tensor-core kernel of TPU kernel 12 at 300 reps (past rep 256 its
    nudge adds in float32 and rounds, as the plain version does) and at the
    probe's 64 on a split K against the plain version, each relaunched bit
    for bit."""
    from hedit_tpu_torch.ops import mm_probe as mp

    _, a_t, b_t = mp.LAYOUTS[layout]
    g = torch.Generator(device="cuda").manual_seed(7)
    for (m, n, k), reps in (((40, 48, 96), 300), ((48, 40, 1000), 64)):
        a = torch.randn((k, m) if a_t else (m, k), generator=g, device=cuda).to(torch.bfloat16)
        b = torch.randn((n, k) if b_t else (k, n), generator=g, device=cuda).to(torch.bfloat16)
        got, again = mp.mm_loop_cuda(a, b, layout, reps), mp.mm_loop_cuda(a, b, layout, reps)
        want = mp.mm_loop_reference(a, b, layout, reps)
        tol = 4 * math.sqrt(reps * k) * 2.0 ** -24 * mp.mm_loop_magnitude(a, b, layout, reps)
        assert torch.equal(got, again)
        assert bool(((got - want).abs() <= tol).all()), ((got - want).abs() / tol).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nn", "tl", "tr", "tm"])
def test_mm_loop_core_kernel_each_plan_kind_relaunched(cuda, layout):
    """The float32 CUDA-core kernel of TPU kernel 12 at the probe's 64 reps
    in each kind of ``core_plan``: one slice (the tiles fill the card), K
    chunks alone, rep ranges alone, both on a ragged shape; all-ones exactly
    K * 2080, seeded within 4 sqrt(64 K) 2^-24 sum |terms| of the plain
    version, relaunched bit for bit."""
    from hedit_tpu_torch.ops import mm_probe as mp

    _, a_t, b_t = mp.LAYOUTS[layout]
    g = torch.Generator(device="cuda").manual_seed(9)
    kinds = {(2100, 2050, 24): (1, 1), (512, 128, 2048): (64, 1), (256, 256, 16): (1, 64),
             (100, 70, 37): (3, 64)}
    for (m, n, k), splits in kinds.items():
        plan = mp.core_plan(m, n, k)
        assert (plan.ksplits, plan.rsplits) == splits, plan
        a_shape, b_shape = ((k, m) if a_t else (m, k)), ((n, k) if b_t else (k, n))
        ones = mp.mm_loop_cuda(torch.ones(a_shape, device=cuda), torch.ones(b_shape, device=cuda),
                               layout)
        a = torch.randn(a_shape, generator=g, device=cuda)
        b = torch.randn(b_shape, generator=g, device=cuda)
        got, again = mp.mm_loop_cuda(a, b, layout), mp.mm_loop_cuda(a, b, layout)
        want = mp.mm_loop_reference(a, b, layout)
        tol = 4 * math.sqrt(mp.REPS * k) * 2.0 ** -24 * mp.mm_loop_magnitude(a, b, layout)
        assert bool((ones == k * mp.REPS * (mp.REPS + 1) // 2).all()), (m, n, k)
        assert torch.equal(got, again), (m, n, k)
        assert bool(((got - want).abs() <= tol).all()), ((got - want).abs() / tol).max().item()


@pytest.mark.gpu
def test_cost_probe_kernels_refuse_what_they_do_not_take(cuda):
    from hedit_tpu_torch.ops import flash_probes as fp
    from hedit_tpu_torch.ops import mm_probe as mp

    q = torch.randn(1, 2, 256, 40, device=cuda)
    with pytest.raises(ValueError, match="mode"):
        fp.flash_ablate_t_cuda(q, q, q, "softmax")
    with pytest.raises(ValueError, match="head dim"):
        fp.flash_ablate_t_cuda(*(torch.randn(1, 2, 256, 64, device=cuda),) * 3, "exp")
    with pytest.raises(ValueError, match="head dim"):
        fp.flash_variant_b_cuda(*(torch.randn(2, 256, 80, device=cuda),) * 3)
    with pytest.raises(ValueError, match="multiples"):
        fp.flash_variant_a_cuda(*(torch.randn(2, 200, 40, device=cuda),) * 3)
    with pytest.raises(ValueError, match="dtypes"):
        mp.mm_loop_cuda(torch.ones(8, 40, device=cuda), torch.ones(40, 8, device=cuda,
                                                                   dtype=torch.bfloat16), "nn")
    with pytest.raises(ValueError, match="contiguous"):
        mp.mm_loop_cuda(torch.ones(40, 8, device=cuda).t(), torch.ones(40, 8, device=cuda), "nn")


# the float32 d = 512 kernel's counters (``csrc/flash_attention_f32_512.cu``)
# and the template's float32 forward counters it replaced at d = 512
F32_512_COUNTERS = ("launches_f32_512", "launches_lse_f32_512", "launches_exact_f32_512",
                    "launches_packed_bounded_f32_512", "launches_packed_f32_512")
TEMPLATE_COUNTERS = ("launches", "launches_lse", "launches_exact", "launches_packed_bounded",
                     "launches_packed")


def _f32_512_counts():
    return {n: getattr(flash_mod, n) for n in F32_512_COUNTERS + TEMPLATE_COUNTERS}


def _saturating_512(device):
    """q, k, v [1, 1, 4096, 512]: every query's score with a key is set by
    the key's first component; key 1500 scores ~146 log2 units, more than
    116 above the 1024-key anchor window's max (clamped to 2^100 by the
    bounded form), keys 1510-1573 ~109: exact attention is key 1500's value
    row, the bounded form mixes in the 64 keys."""
    g = torch.Generator(device=device).manual_seed(6)
    q = torch.randn(1, 1, 4096, 512, generator=g, device=device) * 0.1
    q[..., 0] = 8.0 * (512 / 40) ** 0.5
    k = torch.randn(1, 1, 4096, 512, generator=g, device=device) * 0.5
    v = torch.randn(1, 1, 4096, 512, generator=g, device=device)
    k[:, :, 1500, 0] = 80.0
    k[:, :, 1510:1574, 0] = 60.0
    return q, k, v


@pytest.mark.gpu
def test_f32_512_kernel_matches_plain_on_card(cuda):
    """The float32 d = 512 kernel in its three modes, through
    ``flash_attention_cuda``, ``flash_attention_lse_cuda`` and
    ``flash_attention_exact_cuda``, at [1, 1, 1024, 512] (the 256 px
    decode), [1, 1, 4096, 512], a ragged [1, 1, 1000, 512] against 1100 keys
    and the saturating input, against the plain versions: out within 1e-4,
    lse2 within 1e-5 relative; one launch of each mode's counter, none of
    the template's; on the saturating input the two forms far apart.  Then
    packed heads (one head [1, 1024, 512], and two heads [2, 600, 1024]
    against 1100 keys as a batch-strided row slice), bounded and exact."""
    g = torch.Generator(device=cuda).manual_seed(19)
    cases = [[torch.randn(1, 1, s, 512, generator=g, device=cuda) for s in (sq, sk, sk)]
             for sq, sk in ((1024, 1024), (4096, 4096), (1000, 1100))]
    for q, k, v in cases + [list(_saturating_512(cuda))]:
        before = _f32_512_counts()
        out = flash_mod.flash_attention_cuda(q, k, v)
        lse_out, lse2 = flash_mod.flash_attention_lse_cuda(q, k, v)
        exact = flash_mod.flash_attention_exact_cuda(q, k, v)
        torch.cuda.synchronize()
        moved = {n: c - before[n] for n, c in _f32_512_counts().items()}
        assert moved == {**dict.fromkeys(before, 0), "launches_f32_512": 1,
                         "launches_lse_f32_512": 1, "launches_exact_f32_512": 1}
        want, want_lse = flash_mod.flash_attention_lse_reference(q, k, v)
        for got in (out, lse_out, exact):
            assert torch.isfinite(got).all()
        torch.testing.assert_close(out, want, rtol=0, atol=1e-4)
        torch.testing.assert_close(lse_out, want, rtol=0, atol=1e-4)
        torch.testing.assert_close(lse2, want_lse, rtol=1e-5, atol=0)
        torch.testing.assert_close(exact, flash_attention_exact_reference(q, k, v), rtol=0,
                                   atol=1e-4)
    assert (out - exact).abs().max().item() > 20 * 1e-4   # the saturating input
    for b, heads, sq, sk, sliced in ((1, 1, 1024, 1024, False), (2, 2, 600, 1100, True)):
        q, k, v = (torch.randn(b, 3, s, heads * 512, generator=g, device=cuda)
                   for s in (sq, sk, sk))
        q, k, v = (t[:, 1] if sliced else t[:, 0].contiguous() for t in (q, k, v))
        before = _f32_512_counts()
        got = flash_mod.flash_attention_packed_bounded_cuda(q, k, v, heads)
        got_e = flash_mod.flash_attention_packed_cuda(q, k, v, heads)
        torch.cuda.synchronize()
        moved = {n: c - before[n] for n, c in _f32_512_counts().items()}
        assert moved == {**dict.fromkeys(before, 0), "launches_packed_bounded_f32_512": 1,
                         "launches_packed_f32_512": 1}
        torch.testing.assert_close(
            got, flash_mod.flash_attention_packed_bounded_reference(q, k, v, heads), rtol=0,
            atol=1e-4)
        torch.testing.assert_close(
            got_e, flash_attention_packed_exact_reference(q, k, v, heads), rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_f32_512_kernel_is_deterministic_on_card(cuda):
    """Two launches give the same bits in every mode: each CTA sums in a
    fixed order and the cluster combines its CTAs in rank order, no
    atomics."""
    g = torch.Generator(device=cuda).manual_seed(20)
    q, k, v = (torch.randn(1, 1, s, 512, generator=g, device=cuda) for s in (1000, 1100, 1100))
    for call in (lambda: (flash_mod.flash_attention_cuda(q, k, v),),
                 lambda: flash_mod.flash_attention_lse_cuda(q, k, v),
                 lambda: (flash_mod.flash_attention_exact_cuda(q, k, v),)):
        a, b = call(), call()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_f32_512_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    """A pointer off 16 bytes (bounded, LSE, exact), a batch stride that is
    not a multiple of 4 and an anchor window beyond 1024 keys are refused
    before any launch, with no fallback to the template or a plain version;
    the entry points refuse the same, bf16 and a head dim other than 512."""
    buf = torch.randn(2 * 1200 * 512 + 8, device=cuda)
    head = buf[1:1 + 1024 * 512].view(1, 1, 1024, 512)                 # 4 bytes off
    odd = buf.as_strided((2, 1024, 512), (1024 * 512 + 2, 512, 1))      # batch stride 524,290
    dense = buf[:1200 * 512].view(1, 1200, 512)
    before = _f32_512_counts()
    for call, match in ((lambda: flash_mod.flash_attention_cuda(head, head, head), "aligned"),
                        (lambda: flash_mod.flash_attention_lse_cuda(head, head, head), "aligned"),
                        (lambda: flash_mod.flash_attention_exact_cuda(head, head, head),
                         "aligned"),
                        (lambda: flash_mod.flash_attention_packed_cuda(odd, odd, odd, 1),
                         "multiples of 4"),
                        (lambda: flash_mod.flash_attention_packed_bounded_cuda(
                            dense, dense, dense, 1, anchor=1100), "anchor keys")):
        with pytest.raises(ValueError, match=match):
            call()
    torch.cuda.synchronize()
    assert _f32_512_counts() == before
    q = torch.randn(1, 1, 1200, 512, device=cuda)
    for entry, t, ints in (("hedit_flash_attention_fwd_f32_512", q, (1, 1200, 1200, 512, 1100)),
                           ("hedit_flash_attention_fwd_f32_512", q.to(torch.bfloat16),
                            (1, 1200, 1200, 512, 1024)),
                           ("hedit_flash_attention_fwd_exact_f32_512", q[..., :256].contiguous(),
                            (1, 1200, 1200, 256))):
        with pytest.raises(RuntimeError, match="code -1"):
            flash_mod._launch(entry, t, (t, t, t, torch.empty_like(t)), ints)
