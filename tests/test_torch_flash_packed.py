"""The plain version of the port's packed-head flash attention on the CPU,
against the JAX package's packed Pallas kernel in interpret mode and against
the port's head-split plain version.  The CUDA kernel itself is held to this
plain version on the card (``tests/test_torch_port_kernels.py``,
``chip_smoke.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.ops.flash_attention import flash_attention_packed
from hedit_tpu_torch.control.base import LayerTag
from hedit_tpu_torch.ops.attention import (
    controlled_attention, fused_attention_packed, merge_heads, split_heads,
)
from hedit_tpu_torch.ops.flash_attention import (
    flash_attention_packed_reference, reference_attention,
)

# the JAX package's own cases (tests/test_models.py: test_flash_attention_packed_oracle)
SHAPES = [(2, 3, 300, 300, 40),   # unaligned sequence, packed head slicing
          (1, 8, 256, 256, 40),   # the SD head layout
          (2, 2, 128, 400, 80)]   # several key blocks with a masked tail


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _qkv(b, h, sq, sk, d):
    rng = np.random.RandomState(0)
    return (rng.randn(b, sq, h * d).astype(np.float32), rng.randn(b, sk, h * d).astype(np.float32),
            rng.randn(b, sk, h * d).astype(np.float32))


@pytest.mark.parametrize("b,h,sq,sk,d", SHAPES)
def test_packed_plain_version_matches_jax_packed_kernel(b, h, sq, sk, d):
    """float32, the tolerance of the JAX package's own oracle test (rtol 2e-4,
    atol 2e-5: the kernel's online softmax in base 2 against a plain softmax)."""
    q, k, v = _qkv(b, h, sq, sk, d)
    want = flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=h,
                                  blk_q=128, blk_k=128, interpret=True)
    got = flash_attention_packed_reference(*(torch.from_numpy(t) for t in (q, k, v)), h)
    assert got.shape == (b, sq, h * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("b,h,sq,sk,d", SHAPES)
def test_packed_plain_version_is_the_head_split_one(b, h, sq, sk, d):
    """Packed in, packed out equals split_heads -> plain attention ->
    merge_heads bit for bit, on contiguous inputs and on a row slice of a
    larger batch; head h is columns h*D .. (h+1)*D."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(b, h, sq, sk, d))
    want = merge_heads(reference_attention(split_heads(q, h), split_heads(k, h),
                                           split_heads(v, h)))
    torch.testing.assert_close(flash_attention_packed_reference(q, k, v, h), want,
                               rtol=0, atol=0)
    wide = torch.stack([q, q + 1.0], dim=1)       # [b, 2, sq, h*d]: batch-strided slices
    torch.testing.assert_close(fused_attention_packed(wide[:, 0], k, v, h), want, rtol=0, atol=0)
    one = reference_attention(q[:, None, :, :d], k[:, None, :, :d], v[:, None, :, :d])[:, 0]
    torch.testing.assert_close(want[..., :d], one, rtol=0, atol=1e-6)


def test_controlled_attention_without_control_is_packed_attention():
    """The UNet's entry point with no control: the packed fused path."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, 2, 64, 64, 8))
    out, maps = controlled_attention(q, k, v, heads=2,
                                     layer=LayerTag("down", False, 64, 0))
    torch.testing.assert_close(out, flash_attention_packed_reference(q, k, v, 2), rtol=0, atol=0)
    assert maps == {}
