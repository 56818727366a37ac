"""The port routes attention as the JAX package does on the TPU, and its exact
forward's plain versions compute JAX's exact kernels in their bf16 steps.

* JAX's routing predicates, copied into the port (``flash_kv_fits``,
  ``FLASH_KV_BUDGET_BYTES``, ``_BWD_MIN_SEQ``), and the port's forward and
  backward routes built on them, against the JAX package's own functions
  over a grid of lengths, head dims and dtypes;
* the card's backward routing below 2048 tokens, asked for on the CPU
  (``flash_diff_backward(..., interpret=False)``, the plain versions standing
  in for the kernels), against JAX's ``_flash_diff_bwd(False, res, do)``;
* ``flash_attention_exact_reference`` and its packed twin against JAX's
  exact ``flash_attention`` / ``flash_attention_packed`` in Pallas interpret
  mode at equal key blocks.

The cases run as loops inside three items: pytest-xdist's loadfile scheduler
queues test files by their number of items.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.ops import attention as j_attention
from hedit_tpu.ops import flash_attention as j_flash
from hedit_tpu_torch.ops import attention as attention_mod
from hedit_tpu_torch.ops import flash_attention as flash_mod

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def test_routing_predicates_are_jax_tpu_routing():
    """The copies equal their originals, and the port's routes are JAX's TPU
    routes (``hedit_tpu/ops/attention.py:fused_attention`` for the forward,
    ``_flash_diff_bwd(False, ...)`` for the backward) over the UNet's and the
    VAE's lengths and head dims, the budget's edges and ragged lengths, in
    both dtypes.  The VAE's mid block [*, 1, 4096, 512] takes the kernels in
    bf16 (8 MiB of K/V, exactly the budget) and ``reference_attention`` in
    float32 (16 MiB); the UNet's 1024-token gradient takes autograd of
    ``reference_attention``, its 4096-token one the kernels."""
    assert flash_mod.FLASH_KV_BUDGET_BYTES == j_flash.FLASH_KV_BUDGET_BYTES
    assert flash_mod._BWD_MIN_SEQ == j_flash._BWD_MIN_SEQ
    assert attention_mod.FLASH_MIN_SEQ == j_attention.FLASH_MIN_SEQ
    lengths = (77, 256, 1000, 1023, 1024, 1025, 2047, 2048, 3000, 4096, 4097, 8192, 16384)
    for d in (40, 64, 80, 160, 512, 1024):
        for itemsize in (2, 4):
            for sq in lengths:
                for sk in lengths:
                    fits = j_flash.flash_kv_fits(sk, d, itemsize)
                    assert flash_mod.flash_kv_fits(sk, d, itemsize) == fits, (sk, d, itemsize)
                    forward = (sq >= j_attention.FLASH_MIN_SEQ
                               and sk >= j_attention.FLASH_MIN_SEQ and fits)
                    assert attention_mod.flash_route(sq, sk, d, itemsize) == forward
                    bwd_fits = j_flash.flash_kv_fits(sq, d, itemsize) and fits
                    for interpret in (False, True):
                        kernels = bwd_fits and (min(sq, sk) >= j_flash._BWD_MIN_SEQ or interpret)
                        assert flash_mod.bwd_takes_kernels(sq, sk, d, itemsize,
                                                           interpret) == kernels
    assert attention_mod.flash_route(4096, 4096, 512, 2)
    assert not attention_mod.flash_route(4096, 4096, 512, 4)
    assert not flash_mod.bwd_takes_kernels(1024, 1024, 80, 2, False)
    assert flash_mod.bwd_takes_kernels(4096, 4096, 40, 2, False)


def test_card_backward_below_2048_tokens_is_jax_routing():
    """``flash_diff_backward`` with the card's routing (``interpret=False``)
    on CPU tensors below ``_BWD_MIN_SEQ`` against JAX's
    ``_flash_diff_bwd(False, res, do)``, residuals from
    ``_flash_bounded_fwd_lse(interpret=True)``: both take the gradient of
    ``reference_attention``.  float32: 1e-5 of each gradient's largest value
    (summation order).  bfloat16: both round at the same steps (p before the
    PV product, dO v^T, dv, the outputs), so they agree but where float32
    sums in another order straddle a rounding boundary: within 2^-8 of each
    gradient's largest value, at most 2% of the elements differing.  The
    dq / dk / dv kernels' plain version, the card's route here before the
    routing followed JAX's, misses the bf16 bound on most elements."""
    for dtype in DTYPES:
        tdt, jdt = DTYPES[dtype]
        for sq, sk, d in ((256, 256, 40), (140, 260, 40), (256, 256, 80), (1024, 77, 40)):
            rng = np.random.RandomState(sq + sk + d)
            arrays = [rng.randn(1, 2, s, d).astype(np.float32) for s in (sq, sk, sk, sq)]
            q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrays)
            out, lse2 = flash_mod.flash_attention_lse_reference(q, k, v)
            got = flash_mod.flash_diff_backward(q, k, v, out, lse2, do, interpret=False)
            jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in arrays)
            jout, jlse = j_flash._flash_bounded_fwd_lse(jq, jk, jv, interpret=True)
            want = j_flash._flash_diff_bwd(False, (jq, jk, jv, jout, jlse), jdo)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                assert a.dtype == tdt and tuple(a.shape) == b.shape
                a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
                largest = np.abs(b).max()
                where = f"{name} {dtype} {(sq, sk, d)}"
                if dtype == "float32":
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * largest, err_msg=where)
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=2.0 ** -8 * largest,
                                               err_msg=where)
                    assert np.mean(a != b) <= 0.02, where


def test_exact_plain_versions_match_jax_exact_kernels():
    """``flash_attention_exact_reference`` (head-split) and
    ``flash_attention_packed_exact_reference`` (packed heads) with 128-key
    blocks against JAX's ``flash_attention`` and ``flash_attention_packed``
    with ``blk_q = blk_k = 128`` in interpret mode: aligned, ragged and
    Sq != Sk, both dtypes.  float32: 2e-5 (exp2 and summation order).
    bfloat16: both round q * scale and p to bf16 at the same steps and sum
    the rounded p; their float32 scores differ in the last bits, so a
    rounding may fall the other way: one bf16 ulp at the largest output,
    2^-8 of it, and at most 2% of the elements differing at all.
    ``reference_attention`` (float32 q * scale and p) misses both in bf16:
    more than half its elements differ."""
    for dtype in DTYPES:
        tdt, jdt = DTYPES[dtype]
        for sq, sk, d in ((128, 128, 40), (300, 300, 40), (256, 77, 80)):
            rng = np.random.RandomState(sq + sk + d)
            arrays = [rng.randn(1, 2, s, d).astype(np.float32) for s in (sq, sk, sk)]
            q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
            got = flash_mod.flash_attention_exact_reference(q, k, v, 128)
            want = np.asarray(j_flash.flash_attention(
                *(jnp.asarray(a).astype(jdt) for a in arrays), blk_q=128, blk_k=128,
                interpret=True).astype(jnp.float32))
            tol = 2e-5 if dtype == "float32" else 2.0 ** -8 * np.abs(want).max()
            assert got.dtype == tdt
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol,
                                       err_msg=f"{dtype} {(sq, sk, d)}")
            if dtype == "bfloat16":
                assert np.mean(got.float().numpy() != want) <= 0.02, (sq, sk, d)
        for b, heads, sq, sk, d in ((1, 2, 300, 300, 40), (2, 3, 128, 400, 80)):
            rng = np.random.RandomState(b + heads + sq + sk + d)
            arrays = [rng.randn(b, s, heads * d).astype(np.float32) for s in (sq, sk, sk)]
            q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
            got = flash_mod.flash_attention_packed_exact_reference(q, k, v, heads, 128)
            want = np.asarray(j_flash.flash_attention_packed(
                *(jnp.asarray(a).astype(jdt) for a in arrays), heads=heads, blk_q=128,
                blk_k=128, interpret=True).astype(jnp.float32))
            tol = 2e-5 if dtype == "float32" else 2.0 ** -8 * np.abs(want).max()
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol,
                                       err_msg=f"packed {dtype} {(b, heads, sq, sk, d)}")
            if dtype == "bfloat16":
                assert np.mean(got.float().numpy() != want) <= 0.02, (b, heads, sq, sk, d)
