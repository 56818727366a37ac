"""The port's GroupNorm layer in channels-last, on the CPU.

The plain versions keep x's memory format and give the same bits for a
channels-last x as for its NCHW-contiguous copy; the CUDA kernel's wrapper
refuses CPU tensors; the tile plan of ``csrc/group_norm.cu`` meets the
kernel's constraints at every GroupNorm shape of the SD-1.5 paths; and a
model of the streamed regime's partition and combination order (two-pass
spans, Chan's formula in span order, chunked as the apply kernel folds
them) matches the two-pass plain version where cancellation would show, at
x = 1e3 + N(0, 1) in float32.  No JAX: these check the port's own layout.
"""

import os

import numpy as np
import pytest
import torch

from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import groupnorm as gn_mod
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

CL = torch.channels_last
# every GroupNorm shape of the paths' table (PERF.md section 6, row 2)
PATH_SHAPES = ((8, 320, 64, 64), (2, 320, 64, 64), (8, 960, 64, 64), (8, 640, 64, 64),
               (8, 1920, 32, 32), (8, 1280, 8, 8), (8, 2560, 8, 8), (2, 512, 64, 64),
               (2, 128, 512, 512), (2, 256, 256, 256))
STREAMED = {(2, 128, 512, 512), (2, 256, 256, 256)}


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """Give torch this worker's share of the host's cores (see
    test_torch_port_models.py)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _inputs(dtype, shape=(2, 64, 6, 5), seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(shape[1]).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.randn(shape[1]).astype(np.float32)).to(dtype)
    return x.contiguous(memory_format=CL), w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_forward_keeps_channels_last_and_its_bits(dtype):
    x, w, b = _inputs(dtype)
    assert not x.is_contiguous()
    for act, eps in ((None, 1e-5), ("silu", 1e-6)):
        got = gn_mod.group_norm_reference(x, w, b, groups=32, eps=eps, act=act)
        want = gn_mod.group_norm_reference(x.contiguous(), w, b, groups=32, eps=eps, act=act)
        assert got.is_contiguous(memory_format=CL) and got.dtype == dtype
        assert want.is_contiguous()
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_keeps_channels_last_and_its_bits(dtype):
    x, w, b = _inputs(dtype, seed=1)
    dy = _inputs(dtype, seed=2)[0]
    got = gn_mod.group_norm_backward_reference(x, w, b, dy, groups=32, eps=1e-5, act="silu")
    want = gn_mod.group_norm_backward_reference(x.contiguous(), w, b, dy.contiguous(),
                                                groups=32, eps=1e-5, act="silu")
    assert got[0].is_contiguous(memory_format=CL) and not got[0].is_contiguous()
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_cuda_wrapper_refuses_cpu_tensors():
    x, w, b = _inputs(torch.float32)
    before = gn_mod.launches
    for t in (x, x.contiguous()):
        with pytest.raises(ValueError, match="CUDA"):
            gn_mod.group_norm_cuda(t, w, b, groups=32)
    assert gn_mod.launches == before


def test_build_declares_the_kernel_entry_points():
    args = _build.ARGTYPES["hedit_group_norm_nhwc"]
    assert len(args) == 19 and args[15] is _build.ctypes.c_float
    assert "hedit_group_norm_active_clusters" in _build.ARGTYPES
    source = (_build.CSRC / "group_norm.cu").read_text()
    assert 'extern "C" int hedit_group_norm_nhwc(' in source
    assert "_gn_kernel" in source  # the note names the TPU kernel it replaces


@pytest.mark.parametrize("elt", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", PATH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_meets_the_kernel_constraints(shape, elt):
    """What ``csrc/group_norm.cu:check_tile`` and ``launch`` require of a
    tile, and the regime each shape takes (streamed: the VAE's two largest)."""
    b, c, h, w = shape
    hw, cpg = h * w, c // 32
    tile = gn_mod.plan(b, hw, c, 32, elt)
    vc = tile.cb * elt // 16
    assert c % tile.cb == 0 and tile.cb % cpg == 0 and tile.cb * elt % 16 == 0
    assert tile.threads <= gn_mod.MAX_THREADS and tile.threads % vc == 0
    assert 1 <= tile.cluster <= gn_mod.MAX_CLUSTER
    lanes = tile.threads // vc
    assert lanes <= tile.pixels
    assert gn_mod.slice_smem(tile.pixels, tile.cb, elt, lanes, cpg) <= gn_mod.SMEM_PER_CTA
    assert tile.cb * elt >= min(gn_mod.MIN_ROW_BYTES, c * elt)
    assert tile.regime == ("streamed" if shape in STREAMED else "resident")
    if tile.regime == "resident":
        assert tile.cluster * tile.pixels >= hw
    else:
        assert tile.cb == c and tile.apply_threads % vc == 0
        assert 32 <= tile.apply_threads <= gn_mod.MAX_THREADS
        assert tile.apply_pixels % (tile.apply_threads // vc) == 0


def _fold(parts):
    """Chan's combination, in order, of (n, mean, M2) with [B, G] tensors."""
    n, m, m2 = 0.0, None, None
    for nb, mb, m2b in parts:
        if nb == 0:
            continue
        if n == 0:
            n, m, m2 = nb, mb, m2b
            continue
        nn = n + nb
        d = mb - m
        m = m + d * (nb / nn)
        m2 = m2 + m2b + d * d * (n * nb / nn)
        n = nn
    return n, m, m2


def streamed_statistics(x, groups, tile):
    """Mean and variance of each (image, group) of a float32 x as the
    streamed regime computes them: spans of ``cluster * pixels`` pixels,
    each two-pass about the group's pilot (its element at pixel 0, first
    channel), folded by Chan's formula in chunks of consecutive spans (one
    chunk a group for each ``groups`` apply threads), then the chunks."""
    b, c = x.shape[:2]
    t = x.permute(0, 2, 3, 1).reshape(b, -1, groups, c // groups)
    hw, span = t.shape[1], tile.cluster * tile.pixels
    pilot = t[:, 0, :, 0]
    full = hw // span * span
    spans = []
    for part in (t[:, :full].reshape(b, -1, span, *t.shape[2:]), t[:, None, full:]):
        # part [B, spans, pixels, G, C / G]: each span two-pass about the pilot
        n = float(part.shape[2] * part.shape[4])
        ms = (part - pilot[:, None, None, :, None]).sum(dim=(2, 4)) / n
        d = part - (pilot[:, None] + ms)[:, :, None, :, None]
        m2 = (d * d).sum(dim=(2, 4))
        spans += [(n, ms[:, i], m2[:, i]) for i in range(part.shape[1]) if n]
    k = tile.apply_threads // groups
    chunks = [_fold(spans[i * len(spans) // k:(i + 1) * len(spans) // k]) for i in range(k)]
    n, m, m2 = _fold(chunks)
    return pilot + m, m2 / n


@pytest.mark.parametrize("shape,tile", [
    ((1, 512, 128, 128), None),  # the plan's own tile: 47 spans of 8 x 44 pixels
    ((2, 64, 37, 29), gn_mod.Plan(cb=64, cluster=8, pixels=5, threads=16, apply_pixels=64,
                                  apply_threads=512)),  # 27 spans, the last one ragged
], ids=["vae-128x128-f32", "ragged"])
def test_streamed_combination_matches_two_pass(shape, tile):
    b, c, h, w = shape
    tile = tile or gn_mod.plan(b, h * w, c, 32, 4)
    assert tile.regime == "streamed"
    rng = np.random.RandomState(7)
    x = torch.from_numpy((rng.randn(*shape) + 1e3).astype(np.float32))
    mean, var = streamed_statistics(x, 32, tile)
    x32 = x.reshape(b, 32, -1)
    want_mean = x32.mean(dim=2)
    d = x32 - want_mean[..., None]
    want_var = (d * d).mean(dim=2)
    torch.testing.assert_close(mean, want_mean, rtol=1e-6, atol=0)
    torch.testing.assert_close(var, want_var, rtol=1e-6, atol=0)


def test_pipeline_towers_are_channels_last():
    pipe = create_sd_pipeline(tiny=True, device="cpu")
    convs = [p for m in (pipe.unet, pipe.vae) for p in m.parameters() if p.dim() == 4]
    assert convs and all(p.is_contiguous(memory_format=CL) for p in convs)
