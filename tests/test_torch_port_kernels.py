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
