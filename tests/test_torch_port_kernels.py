"""The port's hand-written kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the machine with the card,
where the JAX package is not installed and ``tests/conftest.py`` (which
imports JAX) must be skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py -q

Tests marked ``gpu`` need a CUDA device and skip without one; the others
check that a CPU tensor takes the plain version and launches nothing.
"""

import pytest
import torch

from hedit_tpu_torch.ops import flash_attention as flash_mod
from hedit_tpu_torch.ops import groupnorm as gn_mod
from hedit_tpu_torch.ops.attention import FLASH_MIN_SEQ, fused_attention
from hedit_tpu_torch.ops.flash_attention import reference_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_flash_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor takes the plain version even at kernel-sized sequences
    and launches nothing; the CUDA entry point refuses CPU tensors instead
    of falling back."""
    q = torch.randn(1, 1, FLASH_MIN_SEQ, 8)
    before = flash_mod.launches
    torch.testing.assert_close(fused_attention(q, q, q), reference_attention(q, q, q),
                               rtol=0, atol=0)
    assert flash_mod.launches == before
    with pytest.raises(ValueError):
        flash_mod.flash_attention_cuda(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 1024, 40), (1, 8, 1000, 80), (1, 1, 1024, 512)])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, shape):
    """CUDA kernel against the plain version in float32 on the same input
    values.  float32: 1e-4 (summation order); bfloat16: one output ulp at the
    largest output, 2^-8 * max|out|, since the kernel computes in float32 and
    rounds once to bf16 (half an ulp)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    before = flash_mod.launches
    got = flash_mod.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert flash_mod.launches == before + 1
    want = reference_attention(q.float(), k.float(), v.float())
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -8 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


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
        gn_mod.group_norm_triton(x, m.weight, m.bias, groups=32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 320, 64, 64), (4, 640, 32, 32), (4, 1280, 8, 8)])
def test_groupnorm_kernel_matches_plain_on_card(cuda, dtype, shape):
    """Triton kernel against the plain version on the card: float32 1e-4
    absolute (summation order); bfloat16 one output ulp, 2^-7 * max|y|, since
    both normalise in float32 and round once."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    w = torch.randn(shape[1], generator=g, device=cuda).to(dtype)
    b = torch.randn(shape[1], generator=g, device=cuda).to(dtype)
    before = gn_mod.launches
    got = gn_mod.group_norm(x, w, b, groups=32, eps=1e-5, act="silu")
    torch.cuda.synchronize()
    assert gn_mod.launches == before + 1
    want = gn_mod.group_norm_reference(x, w, b, groups=32, eps=1e-5, act="silu").float()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


def test_flash_diff_on_cpu_takes_plain_versions():
    """``flash_attention_diff`` on CPU tensors: forward and backward are the
    plain versions, nothing is launched, and the backward kernels' entry
    points refuse CPU tensors."""
    q, k, v = (torch.randn(1, 2, 48, 8, requires_grad=True) for _ in range(3))
    before = (flash_mod.launches_lse, flash_mod.launches_bwd_dq, flash_mod.launches_bwd_dkv)
    out = flash_mod.flash_attention_diff(q, k, v)
    out.sum().backward()
    assert before == (flash_mod.launches_lse, flash_mod.launches_bwd_dq,
                      flash_mod.launches_bwd_dkv)
    torch.testing.assert_close(out, reference_attention(q, k, v), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        flash_mod.flash_attention_lse_cuda(q, k, v)
    with pytest.raises(ValueError):
        flash_mod.flash_attention_backward_cuda(q, k, v, out, torch.zeros(2, 1, 48), out)


def _bwd_tols(dtype, wants):
    """float32: 1e-4 of each output's largest value (summation order, exp2
    rounding).  bfloat16: the kernels compute in float32 from the bf16 inputs
    and round once, so each is held to the plain version in float32 on the
    same input values within one bf16 ulp of its largest value, 2^-8 * max."""
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -8
    return [rel * w.abs().max().item() for w in wants]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sk", [((1, 8, 1024, 40), 1024), ((2, 4, 1024, 80), 1024),
                                      ((1, 8, 1000, 80), 1064), ((1, 2, 300, 40), 140)])
def test_flash_lse_and_backward_kernels_match_plain_on_card(cuda, dtype, shape, sk):
    """The LSE forward (out, lse2) and dq, dk, dv through
    ``flash_attention_diff`` against the plain versions in float32 on the same
    input values, ragged Sq != Sk included: padded keys must not leak into
    dq, padded queries not into dk / dv."""
    g = torch.Generator(device=cuda).manual_seed(0)
    kshape = shape[:2] + (sk, shape[3])
    q = torch.randn(shape, generator=g, device=cuda).to(dtype).requires_grad_()
    k = torch.randn(kshape, generator=g, device=cuda).to(dtype).requires_grad_()
    v = torch.randn(kshape, generator=g, device=cuda).to(dtype).requires_grad_()
    do = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = (flash_mod.launches_lse, flash_mod.launches_bwd_dq, flash_mod.launches_bwd_dkv)
    out, lse2 = flash_mod.flash_attention_lse_cuda(q.detach(), k.detach(), v.detach())
    got = torch.autograd.grad(flash_mod.flash_attention_diff(q, k, v), (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_mod.launches_lse, flash_mod.launches_bwd_dq, flash_mod.launches_bwd_dkv) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    want_out, want_lse = flash_mod.flash_attention_lse_reference(qf, kf, vf)
    wants = flash_mod.flash_attention_backward_reference(qf, kf, vf, want_out, want_lse,
                                                         do.float())
    tol_out, = _bwd_tols(dtype, [want_out])
    torch.testing.assert_close(out.float(), want_out, rtol=0, atol=tol_out)
    # lse2 is float32 for either dtype: 1e-4 absolute on values of ~10
    torch.testing.assert_close(lse2, want_lse, rtol=0, atol=1e-4)
    for a, b, tol in zip(got, wants, _bwd_tols(dtype, wants)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b, rtol=0, atol=tol)


@pytest.mark.gpu
def test_differentiated_attention_routes_by_length_on_card(cuda):
    """``fused_attention`` under a recorded gradient: the flash kernels (LSE
    forward, dq, dk / dv) from ``FLASH_MIN_SEQ`` tokens on, autograd of the
    plain version below it (no launch), and the forward kernel alone when
    nothing requires a gradient.  Both routes give the plain version's
    gradient (float32, 1e-4 of its largest value)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for s, launches in ((FLASH_MIN_SEQ, 1), (FLASH_MIN_SEQ // 2, 0)):
        q, k, v = (torch.randn(1, 2, s, 40, generator=g, device=cuda).requires_grad_()
                   for _ in range(3))
        before = (flash_mod.launches, flash_mod.launches_lse, flash_mod.launches_bwd_dq,
                  flash_mod.launches_bwd_dkv)
        got = torch.autograd.grad(fused_attention(q, k, v).square().sum(), (q, k, v))
        assert (flash_mod.launches, flash_mod.launches_lse, flash_mod.launches_bwd_dq,
                flash_mod.launches_bwd_dkv) == (before[0], before[1] + launches,
                                                before[2] + launches, before[3] + launches)
        want = torch.autograd.grad(reference_attention(q, k, v).square().sum(), (q, k, v))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item())
        with torch.no_grad():
            fused_attention(q, k, v)
        assert flash_mod.launches == before[0] + launches


@pytest.mark.gpu
def test_flash_backward_refuses_the_vae_head_dim(cuda):
    q = torch.randn(1, 1, 1024, 512, device=cuda, requires_grad=True)
    out = flash_mod.flash_attention_diff(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        out.sum().backward()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,act", [((1, 320, 64, 64), "silu"), ((2, 1280, 8, 8), "silu"),
                                       ((1, 640, 32, 32), None)])
def test_groupnorm_gradient_matches_autograd_of_plain_on_card(cuda, dtype, shape, act):
    """The autograd wrapper around the Triton kernel (forward the kernel,
    backward plain tensor code from the saved input) against
    ``torch.autograd`` of ``group_norm_reference`` in float32 on the same
    input values: dx, dweight, dbias within 1e-4 (float32) or one bf16 ulp
    (2^-8, bfloat16) of each gradient's largest value."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype).requires_grad_()
    w = torch.randn(shape[1], generator=g, device=cuda).to(dtype).requires_grad_()
    b = torch.randn(shape[1], generator=g, device=cuda).to(dtype).requires_grad_()
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = gn_mod.launches
    got = torch.autograd.grad(gn_mod.group_norm(x, w, b, groups=32, eps=1e-5, act=act),
                              (x, w, b), dy)
    assert gn_mod.launches == before + 1
    xf, wf, bf = (t.detach().float().requires_grad_() for t in (x, w, b))
    want = torch.autograd.grad(
        gn_mod.group_norm_reference(xf, wf, bf, groups=32, eps=1e-5, act=act), (xf, wf, bf),
        dy.float())
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -8
    for a, c in zip(got, want):
        torch.testing.assert_close(a.float(), c, rtol=0, atol=rel * c.abs().max().item())
