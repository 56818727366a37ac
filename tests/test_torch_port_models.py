"""Parity of the PyTorch port's SD towers with the JAX package.

One set of seeded JAX parameters drives both packages: the port's
``state_dict`` comes from ``hedit_tpu_torch.io_utils.weights``, whose
converters are the exact inverses of ``hedit_tpu.io_utils.weights``.  The
tiny towers are compared in float32 at the tolerance of
``tests/test_torch_parity_sd.py`` (rtol 1e-4, atol 1e-5); at SD-1.5 widths
only the parameter keys and shapes are compared, against ``jax.eval_shape``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hedit_tpu.io_utils.weights import (
    _flatten_tree, convert_clip_text, convert_unet, convert_vae, validate_against,
)
from hedit_tpu.models import unet_sd as j_unet_sd
from hedit_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from hedit_tpu.models.clip_text import CLIPTextModel as JCLIPText
from hedit_tpu.models.vae import AutoencoderKL as JVAE
from hedit_tpu.models.vae import VAEConfig as JVAEConfig
from hedit_tpu_torch.io_utils.weights import clip_text_state_dict, unet_state_dict, vae_state_dict
from hedit_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from hedit_tpu_torch.models.unet_sd import UNet2DCondition, UNetConfig, _build_tags
from hedit_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from hedit_tpu_torch.ops.groupnorm import FusedGroupNorm

RTOL, ATOL = 1e-4, 1e-5


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


def seeded_flax_params(template, seed: int):
    """A Flax parameter tree of the template's structure, filled from numpy:
    kernels N(0, 1/fan_in), biases N(0, 0.1), norm scales 1 + N(0, 0.1),
    embeddings N(0, 1).  (Flax's own init of the tiny UNet takes ~30 s on
    the CPU; the values only have to be seeded and well scaled.)"""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        z = rng.randn(*leaf.shape)
        if name == "kernel":
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            z = 1.0 + 0.1 * z
        elif "embedding" not in name:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


@pytest.fixture(scope="module")
def jax_tiny():
    """(model, params) of the three tiny JAX towers."""
    rng = jax.random.PRNGKey(0)
    unet = j_unet_sd.UNet2DCondition(j_unet_sd.UNetConfig.tiny())
    vae = JVAE(JVAEConfig.tiny())
    text = JCLIPText(JCLIPConfig.tiny())
    templates = (
        jax.eval_shape(unet.init, rng, jnp.zeros((1, 16, 16, 4)), jnp.array(1),
                       jnp.zeros((1, 77, 32))),
        jax.eval_shape(vae.init, rng, jnp.zeros((1, 64, 64, 3))),
        jax.eval_shape(text.init, rng, jnp.zeros((1, 77), jnp.int32)))
    return {name: (model, seeded_flax_params(t, seed))
            for seed, (name, model, t) in enumerate(zip(("unet", "vae", "clip"),
                                                         (unet, vae, text), templates))}


def _port(model, state):
    model.load_state_dict(state, strict=True)
    return model.eval()


def _require_contiguous_groupnorm_inputs(model):
    """The Triton GroupNorm takes contiguous NCHW only: check every call site."""
    def hook(_, args):
        assert args[0].is_contiguous(), "GroupNorm input is not contiguous NCHW"
    return [m.register_forward_pre_hook(hook) for m in model.modules()
            if isinstance(m, FusedGroupNorm)]


def _flat_tags(tags):
    out = []
    for place in ("down", "mid", "up"):
        for item in tags[place]:
            for pair in ([item] if isinstance(item, tuple) else item):
                out += [dataclasses.asdict(t) for t in pair]
    return out


def test_layer_tags_match_jax():
    for cfg, jcfg in ((UNetConfig.tiny(), j_unet_sd.UNetConfig.tiny()),
                      (UNetConfig.sd15(), j_unet_sd.UNetConfig.sd15())):
        assert _flat_tags(_build_tags(cfg)) == _flat_tags(j_unet_sd._build_tags(jcfg))


@pytest.mark.parametrize("tower", ["unet", "vae", "clip"])
def test_weight_bridge_round_trip(jax_tiny, tower):
    """JAX tiny params -> port state_dict -> hedit_tpu converter gives the
    original tree back, leaf for leaf, exactly."""
    params = jax_tiny[tower][1]
    model, to_sd, back = {
        "unet": (UNet2DCondition(UNetConfig.tiny()), unet_state_dict, convert_unet),
        "vae": (AutoencoderKL(VAEConfig.tiny()), vae_state_dict, convert_vae),
        "clip": (CLIPTextModel(CLIPTextConfig.tiny()), clip_text_state_dict, convert_clip_text),
    }[tower]
    state = to_sd(params, model)
    assert set(state) == set(model.state_dict())
    want = _flatten_tree(params["params"])
    got = _flatten_tree(back({k: v.numpy() for k, v in state.items()})["params"])
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg="/".join(path))


def test_sd15_keys_and_shapes_match_jax():
    """At SD-1.5 widths the port's keys, through the JAX converters, give
    exactly the JAX towers' parameter paths and shapes (no weights are
    materialised: the port is built on the meta device)."""
    rng = jax.random.PRNGKey(0)
    ucfg, vcfg, tcfg = (j_unet_sd.UNetConfig.sd15(), JVAEConfig.sd(), JCLIPConfig.sd15())
    templates = {
        "unet": jax.eval_shape(j_unet_sd.UNet2DCondition(ucfg).init, rng,
                               jnp.zeros((1, 64, 64, 4)), jnp.array(1),
                               jnp.zeros((1, 77, 768))),
        "vae": jax.eval_shape(JVAE(vcfg).init, rng, jnp.zeros((1, 64, 64, 3))),
        "clip": jax.eval_shape(JCLIPText(tcfg).init, rng, jnp.zeros((1, 77), jnp.int32)),
    }
    with torch.device("meta"):
        ports = {"unet": UNet2DCondition(UNetConfig.sd15()), "vae": AutoencoderKL(VAEConfig.sd()),
                 "clip": CLIPTextModel(CLIPTextConfig.sd15())}
    convert = {"unet": convert_unet, "vae": convert_vae, "clip": convert_clip_text}
    for name, model in ports.items():
        shapes = {k: np.broadcast_to(np.zeros((), np.float32), tuple(v.shape))
                  for k, v in model.state_dict().items()}
        validate_against(templates[name], convert[name](shapes), name)


def test_unet_tiny_parity(jax_tiny):
    junet, params = jax_tiny["unet"]
    model = _port(UNet2DCondition(UNetConfig.tiny()),
                  unet_state_dict(params, UNet2DCondition(UNetConfig.tiny())))
    hooks = _require_contiguous_groupnorm_inputs(model)
    rng = np.random.RandomState(21)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    t = np.array([3, 7], np.int64)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    want = np.asarray(jax.jit(junet.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(ctx)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_vae_tiny_parity(jax_tiny):
    jvae, params = jax_tiny["vae"]
    model = _port(AutoencoderKL(VAEConfig.tiny()),
                  vae_state_dict(params, AutoencoderKL(VAEConfig.tiny())))
    hooks = _require_contiguous_groupnorm_inputs(model)
    rng = np.random.RandomState(23)
    x = (rng.rand(1, 32, 32, 3) * 2 - 1).astype(np.float32)
    z = (rng.rand(1, 4, 4, 4) * 2 - 1).astype(np.float32)
    want_z = np.asarray(jvae.apply(params, jnp.asarray(x), method=JVAE.encode_mode))
    want_img = np.asarray(jvae.apply(params, jnp.asarray(z), method=JVAE.decode))
    with torch.no_grad():
        got_z = model.encode_mode(torch.from_numpy(x)).numpy()
        got_img = model.decode(torch.from_numpy(z)).numpy()
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(got_z, want_z, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_img, want_img, rtol=RTOL, atol=ATOL)


def test_clip_text_tiny_parity(jax_tiny):
    jtext, params = jax_tiny["clip"]
    model = _port(CLIPTextModel(CLIPTextConfig.tiny()),
                  clip_text_state_dict(params, CLIPTextModel(CLIPTextConfig.tiny())))
    ids = np.random.RandomState(5).randint(0, 1000, size=(3, 77))
    want = np.asarray(jtext.apply(params, jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _write_safetensors(path, tensors):
    """Minimal safetensors writer: 8-byte header length, JSON header, data."""
    import json
    import struct

    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        data = np.ascontiguousarray(arr).tobytes()
        dtype = {np.dtype(np.float32): "F32", np.dtype(np.int64): "I64"}[arr.dtype]
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header).encode()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + b"".join(blobs))


def test_pipeline_loads_a_local_diffusers_directory(tmp_path):
    """``create_sd_pipeline(weights_dir)`` loads unet/, vae/ and text_encoder/
    safetensors whose keys are the diffusers ones (the text encoder's
    ``position_ids`` buffer is skipped)."""
    from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

    src = create_sd_pipeline(tiny=True, seed=3)
    for sub, name, model in (("unet", "diffusion_pytorch_model", src.unet),
                             ("vae", "diffusion_pytorch_model", src.vae),
                             ("text_encoder", "model", src.text_model)):
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        if sub == "text_encoder":
            state["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
        _write_safetensors(tmp_path / sub / f"{name}.safetensors", state)
    got = create_sd_pipeline(str(tmp_path), tiny=True, seed=4)
    for a, b in ((src.unet, got.unet), (src.vae, got.vae), (src.text_model, got.text_model)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb
            torch.testing.assert_close(va, vb, rtol=0, atol=0)
