"""The bf16 tensor-core route of the port's flash backward, on the CPU.

The kernels (``hedit_tpu_torch/csrc/flash_attention_bwd_tc.cu``) run only on
the card (``tests/test_torch_port_kernels.py``, ``chip_smoke.py``).  Here,
without JAX:

* the dispatch (``bwd_entry``): bf16 at the UNet's head dims and at the
  VAE's 512 to the tensor-core entry points, float32 at the UNet's to the
  fused float32 entry point (``csrc/flash_attention_bwd_f32.cu``), float32
  at 512 to the float32 d = 512 pair (``csrc/flash_attention_bwd_f32_512.cu``),
  anything else refused;
* the operand check of the tensor-core route (``check_tc_operands``):
  16-byte alignment, strides that are multiples of 8;
* the C entry points' parameter counts against the ``ctypes`` argument types
  the loader gives them (the sources cannot be compiled here);
* CPU tensors take the plain versions and launch nothing;
* the plain backward: in bf16 its output before the final rounding
  (``out_dtype=float32``) rounds to its own bf16 result, its roundings are
  the TPU kernels' (qs and ks, ds, p for dv), and float32 inputs keep the
  float32 formulas bit for bit;
* the d = 512 kernels' order of work (32-row tiles, each score contraction
  summed as two halves) rendered in plain torch against the plain backward.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_attention as flash_mod

TC_ENTRIES = ("hedit_flash_attention_bwd_dq_tc", "hedit_flash_attention_bwd_dkv_tc")
CORE_ENTRIES = ("hedit_flash_attention_bwd_dq", "hedit_flash_attention_bwd_dkv")
F32_ENTRIES = ("hedit_flash_attention_bwd_f32",)
F32_512_ENTRIES = ("hedit_flash_attention_bwd_dq_f32_512", "hedit_flash_attention_bwd_dkv_f32_512")


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


# The small dispatch and operand cases run as loops inside a few tests:
# pytest-xdist's loadfile scheduler queues test files by their number of
# items, and a file of few items queues behind the suite's long JAX files.
ROUTES = ((torch.bfloat16, 40, TC_ENTRIES), (torch.bfloat16, 80, TC_ENTRIES),
          (torch.bfloat16, 512, TC_ENTRIES), (torch.float32, 40, F32_ENTRIES),
          (torch.float32, 80, F32_ENTRIES), (torch.float32, 512, F32_512_ENTRIES))


def test_bwd_entry_sends_bf16_unet_widths_to_the_tensor_cores():
    """Every bf16 head dim (the UNet's 40 and 80, the VAE's 512) to the
    tensor-core entry points; float32 by head dim to the fused kernel or the
    float32 d = 512 pair."""
    assert flash_mod.TC_BWD_HEAD_DIMS == flash_mod.BWD_HEAD_DIMS
    for dtype, d, entries in ROUTES:
        assert flash_mod.bwd_entry(dtype, d) == entries, (dtype, d)
        assert set(entries) <= set(_build.ARGTYPES)


def test_bwd_entry_refuses_other_dtypes_and_head_dims():
    for dtype, d, match in ((torch.float16, 40, "float32 or bfloat16"),
                            (torch.float64, 80, "float32 or bfloat16"),
                            (torch.bfloat16, 64, "head dims"),
                            (torch.float32, 64, "head dims"),
                            (torch.bfloat16, 32, "head dims")):
        with pytest.raises(ValueError, match=match):
            flash_mod.bwd_entry(dtype, d)


def test_check_tc_operands_for_the_backward():
    """Contiguous [BH, S, D] operands at 16-byte aligned addresses pass (row
    stride d, image strides S * d for the paths' lengths and a ragged one);
    an address off 16 bytes or a stride off a multiple of 8 is refused."""
    for d in flash_mod.TC_BWD_HEAD_DIMS:
        addresses = [0x7F0000000000 + 16 * i for i in range(8)]
        flash_mod.check_tc_operands(d, addresses, [4096 * d, 1000 * d, 1064 * d, d])
    for d, addresses, strides, match in (
            (40, [0, 16, 34, 48], [40], "aligned"),            # a view one element in
            (80, [0, 16, 32, 56], [80], "aligned"),            # dO 8 bytes off
            (40, [0, 16, 32, 48], [40, 1000 * 40 + 4], "multiples of 8")):
        with pytest.raises(ValueError, match=match):
            flash_mod.check_tc_operands(d, addresses, strides)


def test_tc_backward_entry_points_match_their_argument_counts():
    """The two tensor-core entry points exist in
    ``csrc/flash_attention_bwd_tc.cu`` with as many parameters as the
    ``ctypes`` argument types the loader gives them, the template's list: q,
    k, v, dO, lse2, delta, then dq or dk and dv; bh, sq, sk, d, dtype; the
    stream.  (``tests/test_torch_flash_tc.py`` checks every entry point's
    parameter types.)"""
    text = (_build.CSRC / "flash_attention_bwd_tc.cu").read_text()
    for tc, core, outs in zip(TC_ENTRIES, CORE_ENTRIES, (1, 2)):
        params, = re.findall(rf'extern "C" int {tc}\(([^)]*)\)', text)
        assert len(params.split(",")) == len(_build.ARGTYPES[tc]) == 6 + outs + 5 + 1
        assert _build.ARGTYPES[tc] == _build.ARGTYPES[core]


def _counts():
    return (flash_mod.launches_lse, flash_mod.launches_lse_tc, flash_mod.launches_bwd_dq,
            flash_mod.launches_bwd_dkv, flash_mod.launches_bwd_dq_tc,
            flash_mod.launches_bwd_dkv_tc)


def _inputs(sq, sk, d, dtype, seed=0):
    rng = np.random.RandomState(seed + sq + sk + d)
    arrays = [rng.randn(1, 2, s, d).astype(np.float32) for s in (sq, sk, sk, sq)]
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def test_cpu_tensors_launch_nothing():
    """bf16 CPU tensors at a tensor-core head dim: ``flash_attention_diff``
    runs the plain forward and backward, no counter of either route moves,
    and the kernels' wrappers refuse CPU tensors before any launch."""
    q, k, v, do = _inputs(64, 72, 40, torch.bfloat16)
    before = _counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_mod.flash_attention_diff(*leaves), leaves, do)
    out, lse2 = flash_mod.flash_attention_lse_reference(q, k, v)
    want = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    delta = (do.float() * out.float()).sum(dim=-1)
    for wrapper in (flash_mod.flash_bwd_dq_cuda, flash_mod.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(q, k, v, do, lse2, delta)
    assert _counts() == before


@pytest.mark.parametrize("sq,sk,d", [(64, 64, 40), (40, 72, 80), (32, 48, 512)])
def test_plain_bf16_output_before_rounding_rounds_to_its_result(sq, sk, d):
    """``out_dtype=float32`` gives the plain backward's outputs before their
    final rounding: rounded to bf16 they are its bf16 outputs, bit for bit."""
    q, k, v, do = _inputs(sq, sk, d, torch.bfloat16)
    out, lse2 = flash_mod.flash_attention_lse_reference(q, k, v)
    rounded = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do)
    before = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do,
                                                          out_dtype=torch.float32)
    for r, b in zip(rounded, before):
        assert b.dtype == torch.float32 and r.dtype == torch.bfloat16
        assert torch.equal(b.to(torch.bfloat16), r)


def _bf16(x):
    return x.to(torch.bfloat16).float()


@pytest.mark.parametrize("sq,sk,d", [(48, 64, 40), (64, 40, 80), (32, 48, 512)])
def test_plain_bf16_takes_the_tpu_kernels_roundings(sq, sk, d):
    """The plain backward in bf16, before its final rounding, against the
    TPU kernels' steps written out once more in float64 with each bf16
    rounding explicit: qs = q * c and ks = k * c rounded (c rounded first),
    ds rounded on each side, p rounded for dv only.  The float64 and float32
    sums round a ds (or p) to the other bf16 neighbour where it lies within
    float32 error of a rounding boundary, which moves an output by one bf16
    ulp of that term: at most 2% of the elements further apart than 1e-5 of
    the largest value, none further than 2^-10 of it.  The same steps
    without the roundings miss on most elements."""
    q, k, v, do = _inputs(sq, sk, d, torch.bfloat16, seed=1)
    out, lse2 = flash_mod.flash_attention_lse_reference(q, k, v)
    got = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do,
                                                       out_dtype=torch.float32)
    scale = 1.0 / math.sqrt(d)
    c = _bf16(torch.tensor(scale * math.log2(math.e))).double()
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    lse = lse2.reshape(1, 2, sq, 1).double()
    delta = (dod * out.double()).sum(-1, keepdim=True)
    dp = dod @ vd.mT
    p_q = torch.exp2(_bf16(qd * c).double() @ kd.mT - lse)
    p_k = torch.exp2(qd @ _bf16(kd * c).double().mT - lse)
    ds_q, ds_k = _bf16(p_q * (dp - delta)).double(), _bf16(p_k * (dp - delta)).double()
    rounded = (ds_q @ kd * scale, ds_k.mT @ qd * scale, _bf16(p_k).double().mT @ dod)
    p = torch.exp2(qd @ kd.mT * (scale * math.log2(math.e)) - lse)
    ds = p * (dp - delta)
    once = (ds @ kd * scale, ds.mT @ qd * scale, p.mT @ dod)
    for a, b, o in zip(got, rounded, once):
        largest = b.abs().max().item()
        gap = (a.double() - b).abs()
        assert gap.max().item() <= 2.0 ** -10 * largest
        assert (gap > 1e-5 * largest).double().mean().item() <= 0.02
        assert ((a.double() - o).abs() > 1e-5 * largest).double().mean().item() > 0.5
    # the two sides' scores are rounded differently: their probabilities differ
    assert not torch.equal(p_q, p_k)


def test_plain_float32_keeps_its_formulas_bit_for_bit():
    """float32 inputs: p = exp2(q k^T * scale * log2(e) - lse2), no rounding
    anywhere, as before the bf16 roundings were added."""
    q, k, v, do = _inputs(40, 56, 40, torch.float32)
    out, lse2 = flash_mod.flash_attention_lse_reference(q, k, v)
    got = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do)
    scale = 1.0 / 40 ** 0.5
    p = torch.exp2(torch.matmul(q, k.transpose(-1, -2)) * (scale * math.log2(math.e))
                   - lse2.reshape(1, 2, 40, 1))
    delta = (do * out).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta)
    want = (torch.matmul(ds, k) * scale, torch.matmul(ds.transpose(-1, -2), q) * scale,
            torch.matmul(p.transpose(-1, -2), do))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _kernel_order_512(q, k, v, do, lse2, delta, tile=32):
    """The d = 512 kernels' order of work in plain float32 torch, [S, D] bf16
    inputs of one head: streamed tiles of 32 rows; each score product
    contracted as two halves of 256 columns, the first half's sum plus the
    second's; p = exp2(s - lse2) and ds rounded to bf16 per tile (p too, for
    dv); the outputs summed over the tiles in order.  Rows past the end are
    left out (the kernels zero-fill and mask them).  Returns (dq, dk, dv)
    before their final rounding."""
    d = q.shape[1]
    scale = 1.0 / math.sqrt(d)
    c = _bf16(torch.tensor(scale * math.log2(math.e)))
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    qs, ks = _bf16(qf * c), _bf16(kf * c)
    h = d // 2

    def halves(a, b):
        return a[:, :h] @ b[:, :h].T + a[:, h:] @ b[:, h:].T

    dq = torch.zeros_like(qf)
    for k0 in range(0, k.shape[0], tile):
        kt, vt = kf[k0:k0 + tile], vf[k0:k0 + tile]
        p = torch.exp2(halves(qs, kt) - lse2[:, None])
        dq += _bf16(p * (halves(dof, vt) - delta[:, None])) @ kt
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, q.shape[0], tile):
        qt, ot = qf[q0:q0 + tile], dof[q0:q0 + tile]
        pt = torch.exp2(halves(ks, qt) - lse2[None, q0:q0 + tile])
        dv += _bf16(pt) @ ot
        dk += _bf16(pt * (halves(vf, ot) - delta[None, q0:q0 + tile])) @ qt
    return dq * scale, dk * scale, dv


def test_kernel_order_at_d512_matches_the_plain_backward():
    """The d = 512 tensor-core kernels' order of work (``_kernel_order_512``:
    32-row tiles, each score contraction summed as two halves) against the
    plain backward before its final rounding, ragged on both sides (100
    queries, 70 keys): the orders differ only in float32 summation, which
    may move a ds (or p) to the other bf16 neighbour; each output within
    2^-10 of its largest value, at most 2% of its elements further apart
    than 1e-5 of it."""
    q, k, v, do = _inputs(100, 70, 512, torch.bfloat16, seed=2)
    out, lse2 = flash_mod.flash_attention_lse_reference(q, k, v)
    wants = flash_mod.flash_attention_backward_reference(q, k, v, out, lse2, do,
                                                         out_dtype=torch.float32)
    delta = (do.float() * out.float()).sum(dim=-1)
    for h in range(q.shape[1]):
        got = _kernel_order_512(q[0, h], k[0, h], v[0, h], do[0, h], lse2[h, 0], delta[0, h])
        for a, w in zip(got, wants):
            w = w[0, h]
            largest = w.abs().max().item()
            gap = (a - w).abs()
            assert gap.max().item() <= 2.0 ** -10 * largest
            assert (gap > 1e-5 * largest).double().mean().item() <= 0.02
