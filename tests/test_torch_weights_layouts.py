"""``create_sd_pipeline(weights_dir)`` on the checkpoint layouts the JAX
package reads: ``*.safetensors`` and ``*.bin`` files (in its order), and the
legacy VAE attention names (diffusers' ``query`` / ``key`` / ``value`` /
``proj_attn`` and the LDM ``q`` / ``k`` / ``v`` / ``proj_out`` as 1x1
convs).  Each directory is written here from one seeded tiny pipeline and
must load into the same weights and give the same UNet and VAE outputs as
the safetensors directory; the port's legacy renames are held to the JAX
package's ``convert_vae`` on the same keys.
"""

import os

import numpy as np
import pytest
import torch

from hedit_tpu.io_utils import weights as j_weights
from hedit_tpu.io_utils.safetensors_io import save_safetensors
from hedit_tpu_torch.io_utils import weights
from hedit_tpu_torch.pipelines.sd import create_sd_pipeline

TOWERS = {"unet": "diffusion_pytorch_model", "vae": "diffusion_pytorch_model",
          "text_encoder": "model"}
# the legacy names of each renamed key's leaf: diffusers < 0.14, LDM
LEGACY = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}
LDM = {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0"}


@pytest.fixture(scope="module", autouse=True)
def _share_cores():
    """pytest-xdist runs several workers on the host's cores: give torch its share."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def source():
    """The seeded tiny pipeline whose weights every directory holds."""
    return create_sd_pipeline(tiny=True, seed=3, device="cpu")


def _states(pipe):
    return {"unet": pipe.unet.state_dict(), "vae": pipe.vae.state_dict(),
            "text_encoder": pipe.text_model.state_dict()}


def _legacy(state, names):
    """The VAE state with its mid-block attention keys renamed to ``names``'
    legacy leaves; for the LDM names the weights become [C, C, 1, 1] convs."""
    out = {}
    for key, t in state.items():
        for old, new in names.items():
            marker = f"mid_block.attentions.0.{new}."
            if marker in key:
                key = key.replace(marker, f"mid_block.attentions.0.{old}.")
                if names is LDM and t.dim() == 2:
                    t = t[:, :, None, None]
        out[key] = t
    return out


def _write(root, states, fmt):
    """One diffusers-layout directory: each tower's state as safetensors or
    as a torch ``.bin`` (``pytorch_model.bin`` for the text encoder)."""
    for sub, state in states.items():
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        if fmt == "safetensors":
            save_safetensors(os.path.join(root, sub, f"{TOWERS[sub]}.safetensors"),
                             {k: v.numpy() for k, v in state.items()})
        else:
            name = "pytorch_model" if sub == "text_encoder" else TOWERS[sub]
            torch.save(dict(state), os.path.join(root, sub, f"{name}.bin"))
    return str(root)


def _outputs(pipe):
    """A UNet call and a VAE round trip on fixed seeded inputs."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 16, 4, generator=g)
    ctx = pipe.encode_token_ids(torch.randint(0, 1000, (2, 77), generator=g))
    img = torch.rand(1, 64, 64, 3, generator=g) * 2 - 1
    with torch.no_grad():
        return [pipe.unet(x, 500, ctx), pipe.vae_decode(pipe.vae_encode(img))]


@pytest.mark.parametrize("layout", ["bin", "legacy_vae_names", "ldm_vae_convs", "mixed"])
def test_layout_loads_as_the_safetensors_directory(tmp_path, source, layout):
    """Every layout loads (strict keys) into the weights of the safetensors
    directory, bit for bit, and gives the same UNet and VAE outputs."""
    states = _states(source)
    ref = create_sd_pipeline(_write(tmp_path / "ref", states, "safetensors"), tiny=True,
                             device="cpu")
    if layout == "bin":
        root = _write(tmp_path / layout, states, "bin")
    elif layout == "legacy_vae_names":
        root = _write(tmp_path / layout, {**states, "vae": _legacy(states["vae"], LEGACY)},
                      "safetensors")
    elif layout == "ldm_vae_convs":
        root = _write(tmp_path / layout, {**states, "vae": _legacy(states["vae"], LDM)}, "bin")
    else:  # a .bin text encoder beside safetensors towers, LDM names in safetensors
        root = _write(tmp_path / layout, {"unet": states["unet"],
                                          "vae": _legacy(states["vae"], LDM)}, "safetensors")
        _write(tmp_path / layout, {"text_encoder": states["text_encoder"]}, "bin")
    got = create_sd_pipeline(root, tiny=True, device="cpu")
    for sub, want in _states(ref).items():
        have = _states(got)[sub]
        assert have.keys() == want.keys()
        for key in want:
            torch.testing.assert_close(have[key], want[key], rtol=0, atol=0, msg=key)
    for a, b in zip(_outputs(got), _outputs(ref)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_files_are_taken_in_the_jax_order(tmp_path, source):
    """safetensors before .bin in one tower directory, as the JAX package
    looks for them; a directory with neither raises."""
    states = _states(source)
    root = _write(tmp_path / "both", states, "safetensors")
    zeros = {sub: {k: torch.zeros_like(v) for k, v in st.items()} for sub, st in states.items()}
    _write(tmp_path / "both", zeros, "bin")
    got = create_sd_pipeline(root, tiny=True, device="cpu")
    torch.testing.assert_close(got.unet.state_dict(), states["unet"], rtol=0, atol=0)
    os.makedirs(tmp_path / "empty" / "unet")
    with pytest.raises(FileNotFoundError):
        create_sd_pipeline(str(tmp_path / "empty"), tiny=True, device="cpu")


@pytest.mark.parametrize("names", ["legacy", "ldm"])
def test_legacy_vae_renames_match_the_jax_converter(source, names):
    """The port's renames and squeeze, then its key rule, give the Flax tree
    that the JAX package's ``convert_vae`` makes of the same legacy state."""
    state = _legacy(_states(source)["vae"], LEGACY if names == "legacy" else LDM)
    assert any(".query." in k or ".q." in k for k in state)
    flat = {}
    for key, t in weights.legacy_vae_state(state).items():
        path, arr = weights.torch_key_to_flax(key, t.numpy(), weights.VAE_FIXUPS)
        flat[path] = arr
    want = j_weights._flatten_tree(
        j_weights.convert_vae({k: v.numpy() for k, v in state.items()})["params"])
    assert flat.keys() == want.keys()
    for path, arr in want.items():
        np.testing.assert_array_equal(flat[path], arr, err_msg="/".join(path))
