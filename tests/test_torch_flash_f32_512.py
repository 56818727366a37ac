"""The float32 forward at the VAE's d = 512 (``csrc/flash_attention_f32_512.cu``),
on the CPU.

The kernel runs only on the card (``tests/test_torch_port_kernels.py``,
``chip_smoke.py``).  Here, in three items (pytest-xdist's loadfile scheduler
queues test files by their number of items):

* the routes: ``bounded_entry``, ``lse_entry`` and ``exact_entry`` at
  (float32, 512) name the new entry points, bound with the template's
  argument types and defined in ``csrc``; ``bwd_entry(float32, 512)``
  names the float32 d = 512 backward (``csrc/flash_attention_bwd_f32_512.cu``,
  ``tests/test_torch_flash_bwd_f32_512.py``); ``check_f32_operands`` at d = 512 takes a
  1024-key window and refuses 1025, while d = 40 / 80 keep 512;
* the kernel's order of work rendered in plain torch (the anchor window's
  key tiles scored once and kept, the key tiles split over the cluster's
  CTAs in contiguous shares, each CTA's row sums and accumulator, the
  exact mode's running max and rescale per CTA, the CTAs combined in rank
  order) against ``flash_attention_lse_reference`` and
  ``flash_attention_exact_reference``;
* the plain versions against the JAX package's ``_flash_bounded_kernel``,
  ``_flash_bounded_lse_kernel`` and ``_flash_kernel`` in Pallas interpret
  mode at d = 512 with Sk > 1024 (the anchor window shorter than the keys)
  and a ragged Sq.
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.ops.flash_attention import (
    _flash_bounded_fwd_lse, flash_attention, flash_attention_bounded,
)
from hedit_tpu_torch import _build
from hedit_tpu_torch.ops import flash_attention as flash_mod

SOURCE = _build.CSRC / "flash_attention_f32_512.cu"
ENTRIES = ("hedit_flash_attention_fwd_f32_512", "hedit_flash_attention_fwd_packed_bounded_f32_512",
           "hedit_flash_attention_fwd_lse_f32_512", "hedit_flash_attention_fwd_exact_f32_512",
           "hedit_flash_attention_fwd_packed_exact_f32_512")
TEMPLATE = ("hedit_flash_attention_fwd", "hedit_flash_attention_fwd_packed_bounded",
            "hedit_flash_attention_fwd_lse", "hedit_flash_attention_fwd_exact",
            "hedit_flash_attention_fwd_packed")


def _define(name):
    """The default of a ``-D`` knob of the kernel's source."""
    return int(re.search(rf"#define {name} (\d+)", SOURCE.read_text()).group(1))


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


# the cluster sizes the launch chooses between (2 where that grid fills the
# card, else 8); each CTA of a cluster takes a share of the keys
CLUSTERS = (2, 8)
SPLIT = _define("F512_QK_SPLIT")    # warp groups splitting each K item's dims
KEYS = _constant("kKeys")           # keys a tile
ITEM_DIMS = 64                      # dims of a K item (kKDims)


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def test_f32_512_routes_entries_and_operand_check():
    """float32 at d = 512 names the new kernel's entry points in all three
    modes, head-split and packed, each with the template's argument types
    and defined in the sources; bf16 at 512 stays on the tensor cores and
    float32 at 40 / 80 on their kernels; the backward at (float32, 512)
    has its own kernels.  The key tile of the exact plain version follows
    the kernel's (``kKeys``) in float32 and stays 32 in bf16.  The operand
    check takes a 1024-key window at d = 512 (512 at 40 / 80), the exact
    mode's None, and refuses an address off 16 bytes, a stride that is not
    a multiple of 4 and a longer window."""
    f32 = torch.float32
    got = (flash_mod.bounded_entry(f32, False, 512), flash_mod.bounded_entry(f32, True, 512),
           flash_mod.lse_entry(f32, 512), flash_mod.exact_entry(f32, False, 512),
           flash_mod.exact_entry(f32, True, 512))
    assert got == ENTRIES
    sources = " ".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for entry, template in zip(ENTRIES, TEMPLATE):
        assert _build.ARGTYPES[entry] == _build.ARGTYPES[template], entry
        assert len(re.findall(rf'extern "C" int {entry}\(', sources)) == 1, entry
        assert re.search(rf'extern "C" int {entry}\(', SOURCE.read_text()), entry
    assert flash_mod.bwd_entry(f32, 512) == ("hedit_flash_attention_bwd_dq_f32_512",
                                             "hedit_flash_attention_bwd_dkv_f32_512")
    assert flash_mod.bounded_entry(torch.bfloat16, False, 512) == "hedit_flash_attention_fwd_tc"
    assert flash_mod.exact_entry(torch.bfloat16, True, 512) == (
        "hedit_flash_attention_fwd_packed_exact_tc")
    assert flash_mod.lse_entry(f32, 80) == "hedit_flash_attention_fwd_lse_f32"
    assert flash_mod.exact_entry(f32, False, 80) == "hedit_flash_attention_fwd_exact"
    assert flash_mod.F32_512_KEY_TILE == KEYS
    assert flash_mod.exact_key_tile(512, f32) == KEYS
    assert flash_mod.exact_key_tile(512, torch.bfloat16) == 32
    assert flash_mod.bounded_anchor(4096, 512) == flash_mod.F32_WINDOWS[512] == 1024
    assert "? 2 : 8;" in SOURCE.read_text() and _define("F512_CLUSTER") == 0   # CLUSTERS
    good = [0x7F0000000000 + 16 * i for i in range(4)]
    strides = [4096 * 512, 1100 * 512, 512, 3 * 1024 * 512]
    flash_mod.check_f32_operands(512, good, strides, 1024)
    flash_mod.check_f32_operands(512, good, strides, None)
    flash_mod.check_f32_operands(80, good, [80], 512)
    for args, match in (((512, good[:3] + [good[3] + 4], strides, 1024), "aligned"),
                        ((512, good, strides + [1024 * 512 + 2], 1024), "multiples of 4"),
                        ((512, good, strides, 1025), "anchor keys"),
                        ((80, good, [80], 513), "anchor keys"),
                        ((64, good, strides, 512), "head dims")):
        with pytest.raises(ValueError, match=match):
            flash_mod.check_f32_operands(*args)


def _shares(lo, hi, c, cluster):
    """CTA c's contiguous share of the tiles lo .. hi - 1, as the kernel splits them."""
    n = hi - lo
    return range(lo + c * n // cluster, lo + (c + 1) * n // cluster)


def _kernel_order(q, k, v, anchor, exact, cluster):
    """The kernel's order of work in plain float32 torch, [BH, Sq, 512]
    inputs.  Query rows are independent, so every row block is rendered at
    once.  A tile's scores are the ``SPLIT`` warp groups' partial products,
    each over its 64 / SPLIT dims of every 64-dim K item, added in group
    order.  Key tiles of ``KEYS``; bounded: the first ceil(a_end / KEYS)
    tiles (a_end = min(anchor, Sk)) are the window, split over the
    ``cluster`` CTAs in contiguous shares and scored once (the kept scores
    give each CTA's max over keys below a_end, then p and PV), the later
    tiles split likewise; the shift = the CTAs' maxima's max + 16.  Exact:
    every tile split over the CTAs, each CTA a running max over its tiles
    with the rescale.  Each CTA's row sums and accumulator run tile by tile;
    the CTAs combine in rank order, weighted by exp2(m_c - max m) (exact) or
    1 (bounded), the bounded sum floored.  Returns (out, lse2 [BH, Sq])."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qs = q * torch.tensor(1.0 / d ** 0.5 * math.log2(math.e), dtype=torch.float32)
    nt = -(-sk // KEYS)
    pad = nt * KEYS - sk
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    keys = lambda t: torch.arange(t * KEYS, (t + 1) * KEYS)  # noqa: E731
    # group g's dims: its 64 / SPLIT of every K item; the groups' partial
    # products added in group order
    part = ITEM_DIMS // SPLIT
    dims = [torch.cat([torch.arange(c + g * part, c + (g + 1) * part)
                       for c in range(0, d, ITEM_DIMS)]) for g in range(SPLIT)]

    def scores(t):
        kt = kp[:, t * KEYS:(t + 1) * KEYS]
        s = torch.zeros(bh, sq, KEYS)
        for idx in dims:
            s = s + qs[..., idx] @ kt[..., idx].transpose(1, 2)
        return s
    neg = torch.full((bh, sq, 1), -math.inf)
    ms, ls, accs = [], [], []
    if exact:
        for c in range(cluster):
            m, lsum, acc = neg.clone(), torch.zeros(bh, sq, 1), torch.zeros(bh, sq, d)
            for t in _shares(0, nt, c, cluster):
                s = scores(t).masked_fill(keys(t) >= sk, -math.inf)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new)
                lsum = lsum * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + p @ vp[:, t * KEYS:(t + 1) * KEYS]
                m = m_new
            ms.append(m), ls.append(lsum), accs.append(acc)
        big = torch.stack(ms).amax(dim=0)
        weights = [torch.exp2(m - big) for m in ms]
    else:
        a_end = min(anchor, sk)
        wt = -(-a_end // KEYS)
        window = {t: scores(t) for t in range(wt)}           # scored once, kept
        for c in range(cluster):
            m = neg.clone()
            for t in _shares(0, wt, c, cluster):
                m = torch.maximum(m, window[t].masked_fill(keys(t) >= a_end, -math.inf)
                                  .amax(dim=-1, keepdim=True))
            ms.append(m)
        big = ms[0]
        for m in ms[1:]:
            big = torch.maximum(big, m)
        shift = big + 16.0
        for c in range(cluster):
            lsum, acc = torch.zeros(bh, sq, 1), torch.zeros(bh, sq, d)
            for t in [*_shares(0, wt, c, cluster), *_shares(wt, nt, c, cluster)]:
                s = window[t] if t < wt else scores(t)
                p = torch.exp2(torch.clamp(s - shift, max=100.0)).masked_fill(keys(t) >= sk, 0.0)
                lsum = lsum + p.sum(dim=-1, keepdim=True)
                acc = acc + p @ vp[:, t * KEYS:(t + 1) * KEYS]
            ls.append(lsum), accs.append(acc)
        weights = [torch.ones_like(big)] * cluster
    lsum, out = torch.zeros(bh, sq, 1), torch.zeros(bh, sq, d)
    for a, l_c, acc in zip(weights, ls, accs):   # rank order
        lsum = lsum + a * l_c
        out = out + a * acc
    if not exact:
        lsum = torch.clamp(lsum, min=flash_mod.DENOM_FLOOR)
    lse2 = None if exact else (shift + torch.log2(lsum))[..., 0]
    return out / lsum, lse2


def _saturate(q, k, key):
    """Every query's score with a key set by the key's first component: key
    ``key`` scores more than 116 log2 units above the others (the bounded
    form clamps it to 2^100 where it lies past the anchor window)."""
    q, k = q * 0.1, k * 0.5
    q[..., 0] = 8.0 * (512 / 40) ** 0.5
    k[:, key, 0] = 80.0
    k[:, key + 10:key + 74, 0] = 60.0
    return q, k


def test_f32_512_kernel_order_of_work_matches_the_plain_versions():
    """The rendering, in clusters of 2 and of 8, against
    ``flash_attention_lse_reference`` (bounded, with the same anchor) and
    ``flash_attention_exact_reference`` (exact, at ``exact_key_tile(512,
    float32)``): every key in the window (Sk = 1024),
    a window shorter than the keys (1100, 2000: some CTAs hold no window
    tile, some no later tile), fewer tiles than CTAs (Sk 77, 300), an anchor
    that ends inside a key tile (300 of 1100), ragged Sq, and the saturating
    input (a key past the window clamped to 2^100; the exact form far
    off).  float32 on both sides, differing in summation order only: 1e-5
    of the largest output, lse2 1e-5 relative."""
    g = torch.Generator().manual_seed(19)
    for bh, sq, sk, anchor, saturate in ((1, 40, 1024, 1024, False), (2, 33, 1100, 1024, False),
                                         (1, 20, 2000, 1024, False), (1, 9, 77, 128, False),
                                         (1, 17, 1100, 300, False), (2, 12, 300, 300, False),
                                         (1, 24, 1300, 1024, True)):
        q, k, v = (torch.randn(bh, s, 512, generator=g) for s in (sq, sk, sk))
        if saturate:
            q, k = _saturate(q, k, 1100)
        want, want_lse = flash_mod.flash_attention_lse_reference(q[None], k[None], v[None],
                                                                  anchor)
        want_e = flash_mod.flash_attention_exact_reference(q[None], k[None], v[None])[0]
        for cluster in CLUSTERS:
            where = (bh, sq, sk, anchor, saturate, cluster)
            out, lse2 = _kernel_order(q, k, v, anchor, False, cluster)
            torch.testing.assert_close(out, want[0], rtol=0, atol=1e-5 * want.abs().max().item(),
                                       msg=lambda m: f"{where} {m}")
            torch.testing.assert_close(lse2, want_lse.reshape(bh, sq), rtol=1e-5, atol=0)
            exact, _ = _kernel_order(q, k, v, anchor, True, cluster)
            torch.testing.assert_close(exact, want_e, rtol=0,
                                       atol=1e-5 * want_e.abs().max().item(),
                                       msg=lambda m: f"exact {where} {m}")
            if saturate:
                assert (out - exact).abs().max().item() > 1e-2


def test_f32_512_plain_versions_match_jax_kernels():
    """The plain versions at q [1, 1, 40, 512] against Sk = 1100 keys (the
    JAX wrappers' default blocks: 128 query rows, 1024-key blocks, so a
    1024-key anchor window shorter than the keys, and Sq padded from 40)
    against ``flash_attention_bounded`` (``_flash_bounded_kernel``),
    ``_flash_bounded_fwd_lse`` (``_flash_bounded_lse_kernel``) and
    ``flash_attention`` (``_flash_kernel``) in Pallas interpret mode, as the
    JAX package's CPU tests run them; the exact plain version at JAX's
    1024-key block.  Random inputs, then the saturating ones (key 1060,
    past the window, clamped to 2^100 in the bounded form).  float32: 2e-5
    absolute (exp2 and summation order), lse2 1e-5 relative."""
    rng = np.random.RandomState(512)
    q, k, v = (rng.randn(1, 1, s, 512).astype(np.float32) for s in (40, 1100, 1100))
    sat_q, sat_k = _saturate(torch.from_numpy(q[0]), torch.from_numpy(k[0]), 1060)
    for arrays in ((q, k, v), (sat_q[None].numpy(), sat_k[None].numpy(), v)):
        tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
        jq, jk, jv = (jnp.asarray(a) for a in arrays)
        assert flash_mod.bounded_anchor(1100, 512) == 1024
        want_out, want_lse = _flash_bounded_fwd_lse(jq, jk, jv, interpret=True)
        out, lse2 = flash_mod.flash_attention_lse_reference(tq, tk, tv)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=2e-5)
        np.testing.assert_allclose(lse2.numpy(), np.asarray(want_lse), rtol=1e-5, atol=0)
        bounded = flash_mod.flash_attention_bounded_reference(tq, tk, tv).numpy()
        np.testing.assert_allclose(
            bounded, np.asarray(flash_attention_bounded(jq, jk, jv, interpret=True)),
            rtol=0, atol=2e-5)
        exact = flash_mod.flash_attention_exact_reference(tq, tk, tv, 1024).numpy()
        np.testing.assert_allclose(exact, np.asarray(flash_attention(jq, jk, jv, interpret=True)),
                                   rtol=0, atol=2e-5)
