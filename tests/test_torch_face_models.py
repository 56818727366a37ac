"""The face-swap models of the port against the JAX package's on the same
weights, carried over by the ``io_utils/weights.py`` inverses of the JAX
converters: the CelebA-HQ DDPM UNet (tiny config, NHWC in and out, and the
full config's keys), IR-SE-50, LPIPS-VGG, the face parser, the critics'
gradients with respect to a 256x256 image, and the face mask.  Each inverse
is held to its converter bit for bit (``convert_X(X_state_dict(params)) ==
params``, the parser's spatial flip included).

Tolerances (float32 on both sides): the DDPM's eps within 2e-5 of its
largest value (the port's GroupNorm statistics are two-pass, Flax's
``nn.GroupNorm`` takes E[x^2] - E[x]^2); the critics' outputs within 1e-5
to 1e-4 of their largest value (another summation order in the convolutions
of 17 to 50 layers); their gradients in relative L2 and for 98% of the
elements (see ``test_critic_gradients_match_jax``); the parser's argmax
where its top-2 logit gap exceeds the logits' tolerance; the mask within
1e-5, pixels within 1e-5 of the 0.9 threshold excused and counted.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.io_utils.weights import _flatten_tree
from hedit_tpu.models import arcface as j_arcface
from hedit_tpu.models import ddpm_unet as j_ddpm
from hedit_tpu.models import face_parser as j_parser
from hedit_tpu.models import lpips_vgg as j_lpips
from hedit_tpu.rewards import face_mask as j_mask
from hedit_tpu_torch.io_utils import weights
from hedit_tpu_torch.models import arcface, ddpm_unet, face_parser, lpips_vgg
from hedit_tpu_torch.models.frozen_layers import FrozenBatchNorm
from hedit_tpu_torch.ops.groupnorm import FusedGroupNorm
from hedit_tpu_torch.pipelines.sd import seeded_init_
from hedit_tpu_torch.rewards import face_mask


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _np_state(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same_tree(got, want):
    """Bit for bit: the same leaves, the same shapes, the same values."""
    got, want = _flatten_tree(got["params"]), _flatten_tree(want["params"])
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(want[path]),
                                      err_msg="/".join(path))


def _seeded(model, seed):
    """The port's seeded init, then seeded BatchNorm statistics and affine
    terms and PReLU slopes (the init leaves BatchNorm the identity), so that
    every key carries values."""
    seeded_init_(model, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(rs.uniform(lo, hi, t.shape).astype(np.float32)))
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.from_numpy(rs.randn(*t.shape).astype(np.float32) * 0.1))
            elif isinstance(m, torch.nn.PReLU):
                m.weight.copy_(torch.from_numpy(rs.uniform(0.05, 0.5, m.weight.shape)
                                                .astype(np.float32)))
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def critics():
    """(port model, JAX module, JAX params) for IR-SE-50, LPIPS-VGG and the
    parser: the port's seeded weights, carried to JAX by the JAX package's
    converters; each inverse gives the port's state_dict back bit for bit."""
    out = {}
    for name, make, jmodule, convert, inverse in (
            ("arcface", arcface.IRSE50, j_arcface.IRSE50(), j_arcface.convert_irse50,
             weights.irse50_state_dict),
            ("lpips", lpips_vgg.LPIPSVgg, j_lpips.LPIPSVgg(), j_lpips.convert_lpips_vgg,
             weights.lpips_vgg_state_dict),
            ("parser", face_parser.FaceParsing, j_parser.FaceParsing(),
             j_parser.convert_face_parser, weights.face_parser_state_dict)):
        model = _seeded(make(), len(out) + 11)
        sd = model.state_dict()
        params = jax.tree_util.tree_map(jnp.asarray, convert(_np_state(sd)))
        back = inverse(params, model)
        assert back.keys() == sd.keys()
        for k in sd:
            assert torch.equal(back[k], sd[k]), (name, k)
        _assert_same_tree(convert(_np_state(back)), params)
        out[name] = (model, jmodule, params)
    return out


def _gn_inputs_channels_last(model):
    """Forward pre-hooks: (GroupNorm calls, channels-last inputs)."""
    seen = [0, 0]

    def hook(_, args):
        seen[0] += 1
        seen[1] += args[0].is_contiguous(memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, FusedGroupNorm):
            m.register_forward_pre_hook(hook)
    return seen


def test_ddpm_unet_matches_jax_and_round_trips():
    """The tiny DDPM (ch 32, ch_mult (1, 2), attention at 8x8) at the port's
    seeded weights, carried to JAX by ``convert_ddpm_ckpt`` (with a
    ``module.`` prefix and a ``logvar`` key, as the reference checkpoint may
    have them) and back by ``ddpm_state_dict``, bit for bit both ways; on
    16x16 NHWC images, batch 2, at t = (1, 501) and at a scalar t = 999: eps
    within 2e-5 of its largest value, every GroupNorm input channels-last
    (31 calls a forward).  The CelebA-HQ config: 113,673,219 parameters,
    every port key at its Flax path with its shape."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    model = ddpm_unet.DDPMUNet(ddpm_unet.DDPMConfig.tiny())
    seeded_init_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():  # seeded GroupNorm affine terms, so the keys carry values
        for m in model.modules():
            if isinstance(m, FusedGroupNorm):
                m.weight.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, m.weight.shape)
                                                .astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rs.randn(*m.bias.shape).astype(np.float32) * 0.1))
    model.eval().requires_grad_(False)
    sd = model.state_dict()
    # the reference checkpoint's quirks: a DataParallel prefix, a logvar key
    state = {"module." + k: v for k, v in _np_state(sd).items()}
    state["logvar"] = np.zeros(3, np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, j_ddpm.convert_ddpm_ckpt(state))
    back = weights.ddpm_state_dict(params, model)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    _assert_same_tree(j_ddpm.convert_ddpm_ckpt(_np_state(back)), params)

    jmodel = j_ddpm.DDPMUNet(j_ddpm.DDPMConfig.tiny())
    apply = jax.jit(jmodel.apply)
    seen = _gn_inputs_channels_last(model)
    for t in (np.array([1, 501]), np.array(999)):
        want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t)))
        with torch.no_grad():
            got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        assert got.shape == want.shape == (2, 16, 16, 3)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 2e-5 * scale, (t, np.abs(got - want).max(), scale)
    assert seen == [2 * 31, 2 * 31]

    with torch.device("meta"):
        full = ddpm_unet.DDPMUNet(ddpm_unet.DDPMConfig.celeba_hq())
    assert sum(p.numel() for p in full.parameters()) == 113_673_219
    tmpl = _flatten_tree(jax.eval_shape(j_ddpm.DDPMUNet(j_ddpm.DDPMConfig.celeba_hq()).init,
                                        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)),
                                        jnp.array(1))["params"])
    paths = set()
    for key, ref in full.state_dict().items():
        probe = np.broadcast_to(np.zeros((), np.float32), tuple(ref.shape))
        path, arr = weights.torch_key_to_flax(key, probe, weights.DDPM_FIXUPS)
        assert path in tmpl and tuple(tmpl[path].shape) == arr.shape, key
        paths.add(path)
    assert paths == set(tmpl)


def test_critics_match_jax_and_round_trip(critics):
    """IR-SE-50 at 112x112, batch 1: the embedding within 1e-5; LPIPS-VGG at
    32x32, batch 2: the distances within 1e-5 of the largest (and
    ``lpips_state`` reads the torchvision / ``lins.N`` layouts); the parser's
    logits at 32x32, batch 2, within 1e-4 of the largest, its argmax equal
    wherever the top-2 gap exceeds that.  The converters' round trips are the
    fixture's (the parser's spatial flip of its transposed convs included)."""
    rs = np.random.RandomState(1)
    arc, jarc, p_arc = critics["arcface"]
    x112 = rs.uniform(-1, 1, (1, 112, 112, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jarc.apply)(p_arc, jnp.asarray(x112)))
    with torch.no_grad():
        got = arc(torch.from_numpy(x112)).numpy()
    assert got.shape == (1, 512)
    assert np.abs(got - want).max() <= 1e-5, np.abs(got - want).max()

    lp, jlp, p_lp = critics["lpips"]
    sd = _np_state(lp.state_dict())
    renamed = {(k.replace("lin", "lins.") if k.startswith("lin")
                else k.replace(k.split(".")[1], "features")): v for k, v in sd.items()}
    assert lpips_vgg.lpips_state(dict(renamed, **{"scaling_layer.shift": 0})).keys() == sd.keys()
    a, b = (rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(jlp.apply)(p_lp, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = lp(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    par, jpar, p_par = critics["parser"]
    img = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jpar.apply(p, x, method=jpar.logits))(
        p_par, jnp.asarray(img)))
    with torch.no_grad():
        got = par.logits(torch.from_numpy(img)).numpy()
        seg = par(torch.from_numpy(img)).numpy()
    tol = 1e-4 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(seg[clear], want.argmax(-1)[clear])


def test_critic_gradients_match_jax(critics):
    """d cosine_loss / d image and d LPIPS / d image at a 256x256 image
    (ArcFace's crop and pools, VGG at full size), against ``jax.grad`` of
    the JAX package's losses on the same weights: the losses within 1e-5;
    each gradient's relative L2 distance within 2e-3, and 98% of its
    elements within 1e-4 of its largest.  Both gradients are ill-conditioned
    in float32 at seeded weights: an element whose path crosses a PReLU or
    ReLU kink, or a VGG max-pool window whose two top values tie within
    float32 rounding, takes another branch in either framework (measured:
    the port's float32 gradients lie as far from its float64 ones, ArcFace's
    2.3e-3 of the largest at worst, 0.7% of the elements beyond 1e-4, L2
    4.7e-4; LPIPS' 0.9% of the elements, L2 5e-4)."""
    rs = np.random.RandomState(2)
    img, ref, src = (rs.uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32) for _ in range(3))
    arc, jarc, p_arc = critics["arcface"]
    lp, jlp, p_lp = critics["lpips"]
    ref_embed = jax.jit(lambda p, x: j_arcface.extract_feats(p, jarc, x))(p_arc, jnp.asarray(ref))
    # weights and targets as arguments: closed over, XLA folds them as constants
    # (the source's whole VGG forward), which takes ~45 s of compile
    j_losses = ((lambda x, p, r: j_arcface.cosine_loss(p, jarc, x, r), p_arc, ref_embed),
                (lambda x, p, y: jnp.mean(jlp.apply(p, x, y)), p_lp, jnp.asarray(src)))
    with torch.no_grad():
        t_ref = arcface.extract_feats(arc, torch.from_numpy(ref))
    losses = (lambda x: arcface.cosine_loss(arc, x, t_ref),
              lambda x: lp(x, torch.from_numpy(src)).mean())
    for k, ((j_loss, p, target), loss) in enumerate(zip(j_losses, losses)):
        want_l, want_g = jax.jit(jax.value_and_grad(j_loss))(jnp.asarray(img), p, target)
        x = torch.from_numpy(img).requires_grad_()
        got_l = loss(x)
        got_g, = torch.autograd.grad(got_l, x)
        want_g, got_g = np.asarray(want_g), got_g.numpy()
        assert abs(got_l.item() - float(want_l)) <= 1e-5 * max(1.0, abs(float(want_l)))
        close = np.abs(got_g - want_g) <= 1e-4 * np.abs(want_g).max()
        assert close.mean() >= 0.98, (k, close.mean())
        assert np.linalg.norm(got_g - want_g) <= 2e-3 * np.linalg.norm(want_g), k


def test_face_mask_matches_jax():
    """``encode_segmentation`` exactly, the erosion kernel bit for bit, and
    ``build_face_mask`` (kernel 13, threshold 0.9, 7 iterations) on a seeded
    batch of two 64x64 class maps of blobs within 1e-5, pixels within 1e-5 of
    the threshold excused and counted; its renormalisation is over the whole
    batch in both packages."""
    rs = np.random.RandomState(3)
    seg = np.zeros((2, 64, 64), np.int64)
    yy, xx = np.mgrid[:64, :64]
    for b in range(2):
        for cls in (1, 5, 10, 13, 8):
            cy, cx, r = rs.randint(8, 56), rs.randint(8, 56), rs.randint(6, 20)
            seg[b][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = cls
    np.testing.assert_array_equal(face_mask._erosion_kernel(13), j_mask._erosion_kernel(13))
    for no_neck in (True, False):
        np.testing.assert_array_equal(
            face_mask.encode_segmentation(torch.from_numpy(seg), no_neck).numpy(),
            np.asarray(j_mask.encode_segmentation(jnp.asarray(seg), no_neck)))
    want = np.asarray(j_mask.build_face_mask(jnp.asarray(seg)))
    got = face_mask.build_face_mask(torch.from_numpy(seg)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 1)
    near = np.abs(_pre_threshold(seg) - 0.9) <= 1e-5
    ok = np.abs(got - want) <= 1e-5
    assert (ok | near).all()
    assert 0.05 < (want == 1.0).mean() < 0.95 and (~ok).sum() <= near.sum()
    print(f"face mask: {near.sum()} pixels within 1e-5 of the threshold excused")


def _pre_threshold(seg):
    """The eroded face + mouth map before its threshold (numpy, float64)."""
    enc = face_mask.encode_segmentation(torch.from_numpy(seg))
    x = (enc[..., 0] + enc[..., 1])[:, None].double()
    k = torch.from_numpy(face_mask._erosion_kernel(13)).double()[None, None]
    for _ in range(6):
        x = torch.minimum(x, torch.nn.functional.conv2d(x, k, padding=6))
    return torch.nn.functional.conv2d(x, k, padding=6).permute(0, 2, 3, 1).numpy()
