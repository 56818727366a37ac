"""Parity of the PyTorch port's schedule, kernels' plain versions and
attention control against the JAX package, on the CPU at small shapes.

The same numpy-seeded inputs go through the JAX function and its port.  JAX
Pallas kernels run in interpret mode with 128 blocks, as the JAX package's
own tests run them; tolerances are stated at each comparison.  The kernels
themselves are tested in ``test_torch_port_kernels.py``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.control.base import LayerTag as JLayerTag
from hedit_tpu.control.p2p import P2PControl as JP2PControl
from hedit_tpu.core.schedule import Schedule as JSchedule
from hedit_tpu.invert.ddpm import sample_xts_from_x0 as j_sample_xts_from_x0
from hedit_tpu.ops import attention as jattn
from hedit_tpu.ops.flash_attention import flash_attention_bounded
from hedit_tpu.ops.flash_attention import reference_attention as j_reference_attention
from hedit_tpu.ops.groupnorm import group_norm_pallas
from hedit_tpu.ops.groupnorm import group_norm_reference as j_group_norm_reference
from hedit_tpu_torch.control.base import LayerTag
from hedit_tpu_torch.control.p2p import P2PControl, stack_controls
from hedit_tpu_torch.core.schedule import Schedule
from hedit_tpu_torch.invert.ddpm import sample_xts_from_x0
from hedit_tpu_torch.ops import groupnorm as gn_mod
from hedit_tpu_torch.ops.attention import controlled_attention
from hedit_tpu_torch.ops.flash_attention import reference_attention


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its
    share.  Oversubscribed intra-op threads spin and stall each other (on an
    8-core host with 6 workers one flagship test took 250 s instead of 1.5 s)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ schedule #

@pytest.mark.parametrize("steps,offset", [(50, 1), (7, 0)])
def test_schedule_matches_jax(steps, offset):
    """Tables equal exactly (both built by numpy in float32); the step math
    agrees to 1e-6 (float32 in both, same formulas)."""
    js, ts = JSchedule.create(steps, steps_offset=offset), Schedule.create(steps, steps_offset=offset)
    np.testing.assert_array_equal(_np(ts.alphas_cumprod), np.asarray(js.alphas_cumprod))
    np.testing.assert_array_equal(_np(ts.timesteps), np.asarray(js.timesteps))
    np.testing.assert_allclose(_np(ts.variance(ts.timesteps)),
                               np.asarray(js.variance(js.timesteps)), rtol=1e-6, atol=1e-7)
    rng = np.random.RandomState(0)
    eps, x, z = (rng.randn(2, 4, 4, 3).astype(np.float32) for _ in range(3))
    tl = [int(t) for t in np.asarray(js.timesteps)] + [0]
    for i, t in enumerate(tl[:-1]):
        want = js.reverse_step(jnp.asarray(eps), t, jnp.asarray(x), eta=1.0,
                               variance_noise=jnp.asarray(z))
        got = ts.reverse_step(torch.from_numpy(eps), t, torch.from_numpy(x), eta=1.0,
                              variance_noise=torch.from_numpy(z))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            _np(ts.reverse_step(torch.from_numpy(eps), t, torch.from_numpy(x), eta=1.0)),
            np.asarray(js.reverse_step(jnp.asarray(eps), t, jnp.asarray(x), eta=1.0)),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(ts.h_edit_coeff(t, tl[i + 1], 1.0)),
                                   np.asarray(js.h_edit_coeff(t, tl[i + 1], 1.0)),
                                   rtol=1e-6, atol=1e-6)


def test_sample_xts_from_x0_matches_jax_grid():
    """xts[idx] = sqrt(abar_t) x0 + sqrt(1 - abar_t) n at t = timesteps[S - idx]
    in both packages.  The two draw different noise, so each is checked
    against that formula with its own noise: the JAX function returns it,
    and the port's is redrawn from the same seed.  float32: 1e-6."""
    S = 7
    js = JSchedule.create(S)
    abar = np.asarray(js.alphas_cumprod)[np.asarray(js.timesteps)][::-1, None, None, None]
    x0 = np.random.RandomState(3).randn(1, 4, 4, 3).astype(np.float32)

    def q_sample(noise):  # noise [S, 4, 4, 3] for idx 1..S
        return np.concatenate([x0, np.sqrt(abar) * x0 + np.sqrt(1 - abar) * noise])

    jxts, jnoise = j_sample_xts_from_x0(js, jnp.asarray(x0), jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(jxts), q_sample(np.asarray(jnoise)[1:]),
                               rtol=1e-6, atol=1e-6)
    xts = sample_xts_from_x0(Schedule.create(S), torch.from_numpy(x0),
                             torch.Generator().manual_seed(5))
    noise = torch.randn((S, 4, 4, 3), generator=torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_allclose(_np(xts), q_sample(noise), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- flash attention #

@pytest.mark.parametrize("sq,sk,d", [(256, 256, 40), (256, 200, 80), (200, 328, 16)])
def test_flash_plain_matches_jax(sq, sk, d):
    """The plain version against the JAX bounded Pallas kernel (interpret,
    128 blocks, ragged lengths padded and masked) and the JAX oracle.
    float32 throughout: 2e-5 covers the kernel's exp2 / summation order."""
    rng = np.random.RandomState(sq + sk + d)
    q = rng.randn(1, 2, sq, d).astype(np.float32)
    k = rng.randn(1, 2, sk, d).astype(np.float32)
    v = rng.randn(1, 2, sk, d).astype(np.float32)
    got = _np(reference_attention(*(torch.from_numpy(a) for a in (q, k, v))))
    oracle = np.asarray(j_reference_attention(*(jnp.asarray(a) for a in (q, k, v))))
    kernel = np.asarray(flash_attention_bounded(*(jnp.asarray(a) for a in (q, k, v)),
                                                blk_q=128, blk_k=128, interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------- groupnorm #

@pytest.mark.parametrize("c,layout", [(128, "nchw"), (320, "nchw"), (128, "channels_last")],
                         ids=["128", "320", "128-channels_last"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_groupnorm_plain_matches_jax(c, layout, act, eps):
    """The plain two-pass version (NCHW-contiguous, or channels-last as the
    models carry it) against ``group_norm_reference`` (NHWC), and at C=128
    the Pallas kernel in interpret mode; float32, with the JAX package's own
    kernel-vs-oracle tolerance (rtol 2e-4, atol 2e-5)."""
    rng = np.random.RandomState(c)
    x = (rng.randn(2, 8, 8, c) * 3 + 1).astype(np.float32)
    scale, bias = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)  # a channels-last view
    tx = tx.contiguous() if layout == "nchw" else tx
    y = gn_mod.group_norm_reference(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                                    groups=32, eps=eps, act=act)
    assert y.is_contiguous(memory_format=(torch.contiguous_format if layout == "nchw"
                                          else torch.channels_last))
    got = _np(y.permute(0, 2, 3, 1))
    jargs = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = np.asarray(j_group_norm_reference(*jargs, groups=32, eps=eps, act=act))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    if c == 128:
        kern = np.asarray(group_norm_pallas(*jargs, groups=32, eps=eps, act=act,
                                            interpret=True))
        np.testing.assert_allclose(got, kern, rtol=2e-4, atol=2e-5)


# --------------------------------------------------------- controlled attention #

def _controls(rng, mode, reweight, step, n_img=1):
    """A non-neutral JAX P2PControl per image and the port's stacked control."""
    jctrls, tctrls = [], []
    for _ in range(n_img):
        arrs = dict(
            cross_alpha=rng.uniform(0, 1, (11, 77)).astype(np.float32),
            refine_mapper=rng.randint(0, 77, 77).astype(np.int64),
            refine_alphas=rng.uniform(0, 1, 77).astype(np.float32),
            replace_mapper=rng.uniform(0, 1, (77, 77)).astype(np.float32),
            equalizer=rng.uniform(0.5, 2.0, 77).astype(np.float32))
        arrs["cross_alpha"][8:] = 0.0   # cross window closed from step 8 on
        static = dict(mode=mode, use_reweight=reweight, self_replace_until=5, cond_start=2,
                      blend_px=16)
        jctrls.append(JP2PControl(step=jnp.asarray(step, jnp.int32),
                                  **{k: jnp.asarray(a) for k, a in arrs.items()}, **static))
        tctrls.append(P2PControl(step=step, **{k: torch.from_numpy(a)[None]
                                               for k, a in arrs.items()}, **static))
    return jctrls, stack_controls(tctrls)


@pytest.mark.parametrize("mode,reweight", [("replace", False), ("refine", True)])
@pytest.mark.parametrize("step", [3, 9])
@pytest.mark.parametrize("kind", ["self", "cross", "store"])
def test_controlled_attention_matches_jax(mode, reweight, step, kind):
    """Two images of four rows each (cond_start=2) through the port in one
    call against each image through the JAX function: the self row-select,
    the cross linear edit and the store layers' probability path with their
    stored maps, at a step inside (3) and outside (9) the self and cross
    windows.  float32; 1e-5 covers the reordered softmax sums."""
    heads, g, sq, hd = 2, 4, 16, 16
    sk = sq if kind == "self" else 77
    place = "up" if kind == "store" else "down"
    px = 16 if kind == "store" else 64
    rng = np.random.RandomState(["self", "cross", "store"].index(kind) * 100 + step
                                + (mode == "refine"))
    jctrls, tctrl = _controls(rng, mode, reweight, step, n_img=2)
    q = rng.randn(2 * g, sq, hd).astype(np.float32)
    k = rng.randn(2 * g, sk, hd).astype(np.float32)
    v = rng.randn(2 * g, sk, hd).astype(np.float32)
    tag = dict(place=place, is_cross=kind != "self", num_pixels=px, index=0, store_index=1)
    got, store = controlled_attention(*(torch.from_numpy(a) for a in (q, k, v)), heads=heads,
                                      layer=LayerTag(**tag), control=tctrl)
    for i, jc in enumerate(jctrls):
        rows = slice(g * i, g * (i + 1))
        want, jstore = jattn.controlled_attention(
            jnp.asarray(q[rows]), jnp.asarray(k[rows]), jnp.asarray(v[rows]), heads=heads,
            layer=JLayerTag(**tag), control=jc)
        np.testing.assert_allclose(_np(got[rows]), np.asarray(want), rtol=1e-5, atol=1e-5)
        assert set(store) == set(jstore)
        for name in jstore:
            np.testing.assert_allclose(_np(store[name][i]), np.asarray(jstore[name]),
                                       rtol=1e-5, atol=1e-6)
    assert bool(store) == (kind == "store")


def test_controlled_attention_rejects_short_groups():
    _, tctrl = _controls(np.random.RandomState(0), "replace", False, 0)
    x = torch.randn(3, 16, 8)
    tag = LayerTag(place="down", is_cross=True, num_pixels=64, index=0)
    with pytest.raises(ValueError):
        controlled_attention(x, x, x, heads=2, layer=tag,
                             control=dataclasses.replace(tctrl, cond_start=2))


@pytest.mark.parametrize("is_replace", [True, False])
def test_build_p2p_control_and_local_blend_match_jax(is_replace):
    """The factories reuse the numpy preprocessing of ``hedit_tpu``: the
    port's arrays equal the JAX ones exactly (with a leading image axis)."""
    from hedit_tpu.control.p2p import build_p2p_control as j_build
    from hedit_tpu.control.p2p import init_local_blend as j_blend
    from hedit_tpu.models.tokenizer import CLIPTokenizer
    from hedit_tpu_torch.control.p2p import build_p2p_control, init_local_blend

    tok = CLIPTokenizer()
    prompts = (["a green lizard on a branch", "a brown lizard on a branch"] if is_replace
               else ["a lizard on a branch", "a small brown lizard on a branch"])
    kw = dict(num_steps=10, cross_replace_steps=0.4, self_replace_steps=0.35, prompts=prompts,
              tokenizer=tok, is_replace=is_replace, cond_start=2, blend_px=16,
              eq_params={"words": ("brown",), "values": (2.0,)} if is_replace else None)
    got, want = build_p2p_control(**kw), j_build(**kw)
    for f in ("cross_alpha", "refine_mapper", "refine_alphas", "replace_mapper", "equalizer"):
        np.testing.assert_array_equal(_np(getattr(got, f))[0], np.asarray(getattr(want, f)))
    for f in ("mode", "use_reweight", "self_replace_until", "cond_start", "blend_px"):
        assert getattr(got, f) == getattr(want, f)
    words = (("lizard",), ("brown",))
    lb = init_local_blend(prompts, words, tok, num_steps=10, heads=2, res=4)
    jlb = j_blend(prompts, words, tok, num_steps=10, heads=2, res=4)
    np.testing.assert_array_equal(_np(lb.alpha_layers)[0], np.asarray(jlb.alpha_layers))
    assert _np(lb.store_sum).shape[1:] == jlb.store_sum.shape
    assert int(lb.start_blend[0]) == jlb.start_blend and lb.res == jlb.res
