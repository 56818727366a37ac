"""The port imports nothing of the JAX package: a source scan of every file of
the port, and the port's own copies of the JAX package's framework-free
modules (tokenizer, P2P preprocessing and the demo's blend-word heuristic,
weight-key mapping, safetensors reader, image I/O and the demo YAML reader)
held to the originals on the same inputs.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from hedit_tpu.control import p2p_prep as j_prep
from hedit_tpu.io_utils import images as j_images
from hedit_tpu.io_utils import weights as j_weights
from hedit_tpu.io_utils.safetensors_io import load_safetensors as j_load_safetensors
from hedit_tpu.io_utils.safetensors_io import save_safetensors
from hedit_tpu.models.tokenizer import CLIPTokenizer as JCLIPTokenizer
from hedit_tpu_torch.control import p2p_prep
from hedit_tpu_torch.io_utils import images, weights
from hedit_tpu_torch.io_utils.safetensors_io import load_safetensors
from hedit_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from hedit_tpu_torch.models.tokenizer import CLIPTokenizer
from hedit_tpu_torch.models.unet_sd import UNet2DCondition, UNetConfig
from hedit_tpu_torch.models.vae import AutoencoderKL, VAEConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|hedit_tpu|scripts)\b(?!_)",
                     re.M)

PROMPTS = ["a photo of a green lizard on a rock", "a photo of a brown lizard on a rock",
           "A cat's whiskers, 3 dogs & an über-long   sentence!", ""]


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, dirs, names in os.walk(os.path.join(ROOT, "hedit_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, git-ignored
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_port_file_imports_jax_flax_or_the_jax_package():
    """Every ``*.py`` under ``hedit_tpu_torch/`` and ``chip_smoke.py``: no
    import statement, at any indentation, names jax, flax, a module of
    ``hedit_tpu`` or the JAX package's ``scripts/`` (``hedit_tpu_torch``
    itself passes: the match is word-bounded).  The probes' ports are among
    the files scanned."""
    files = _port_files()
    assert len(files) > 20
    assert {"masactrl.py", "masactrl_mask.py", "masactrl_auto.py", "h_edit_ctrl.py",
            "main_masactrl.py", "common.py", "flash_probes.py"} <= {
                os.path.basename(f) for f in files}
    assert {os.path.join(ROOT, "hedit_tpu_torch", "probes", f"{n}.py")
            for n in ("flash_nhd_variants", "flash_v4_variants", "flash_ablate",
                      "flash_variants", "mm_probe")} <= set(files)
    assert os.path.join(ROOT, "hedit_tpu_torch", "ops", "mm_probe.py") in files
    hits = [f"{os.path.relpath(f, ROOT)}: {m.group(0).strip()}"
            for f in files for m in _IMPORT.finditer(open(f).read())]
    assert not hits, hits
    assert _IMPORT.search("    from hedit_tpu.io_utils import x") and \
        _IMPORT.search("import scripts.flash_nhd_variants") and \
        not _IMPORT.search("from hedit_tpu_torch.ops import y")


@pytest.fixture(scope="module")
def toks():
    return CLIPTokenizer(), JCLIPTokenizer()


def test_tokenizer_matches(toks):
    tok, jtok = toks
    np.testing.assert_array_equal(tok(PROMPTS), jtok(PROMPTS))
    for p in PROMPTS:
        ids = tok.encode(p)
        assert ids == jtok.encode(p) and tok.decode(ids) == jtok.decode(ids)


@pytest.mark.parametrize("src,tar", [
    ("a photo of a green lizard on a rock", "a photo of a brown lizard on a rock"),
    ("a cat sitting on a bench", "a fluffy orange cat sitting on a wooden bench"),
    ("a fluffy orange cat sitting on a wooden bench", "a cat sitting on a bench"),
    ("a photo of a green lizard on a rock", "a photo of a green lizard on a rock"),
])
def test_p2p_prep_matches(toks, src, tar, monkeypatch):
    """Mappers, alphas, equalizer and word indices of the own copy against
    the JAX package's (whose aligner may be the native one: same tie-break),
    and the demo's blend-word heuristic on a replace, an insert, a delete and
    no difference, with nltk as it is installed and with no nltk at all
    (where the JAX copy raises; this one takes the regex that JAX's takes
    without punkt's data)."""
    tok, jtok = toks
    for kw in ({}, {"eq_value": 1.25}, {"is_global_edit": False}):
        want = j_prep.preprocess_blend_and_eq(src, tar, **kw)
        assert p2p_prep.preprocess_blend_and_eq(src, tar, **kw) == want
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "nltk.tokenize", None)
            assert p2p_prep.preprocess_blend_and_eq(src, tar, **kw) == want
    blend, _ = p2p_prep.preprocess_blend_and_eq(src, tar)
    assert (blend is None) == (src == tar or "fluffy" in src or "fluffy" in tar)
    prompts = [src, tar]
    for a, b in zip(p2p_prep.get_refinement_mapper(prompts, tok),
                    j_prep.get_refinement_mapper(prompts, jtok)):
        np.testing.assert_array_equal(a, b)
    if len(src.split(" ")) == len(tar.split(" ")):
        np.testing.assert_array_equal(p2p_prep.get_replacement_mapper(prompts, tok),
                                      j_prep.get_replacement_mapper(prompts, jtok))
    for steps in (0.4, {"default_": 0.8, tar.split(" ")[-1]: (0.1, 0.5)}):
        np.testing.assert_array_equal(
            p2p_prep.get_time_words_attention_alpha(prompts, 10, dict(steps) if isinstance(
                steps, dict) else steps, tok),
            j_prep.get_time_words_attention_alpha(prompts, 10, dict(steps) if isinstance(
                steps, dict) else steps, jtok))
    word = tar.split(" ")[4]
    np.testing.assert_array_equal(p2p_prep.get_word_inds(tar, word, tok),
                                  j_prep.get_word_inds(tar, word, jtok))
    np.testing.assert_array_equal(p2p_prep.get_equalizer(tar, (word,), (2.0,), tok),
                                  j_prep.get_equalizer(tar, (word,), (2.0,), jtok))


@pytest.mark.parametrize("tower", ["unet", "vae", "clip"])
def test_weight_key_mapping_matches(tower):
    """``torch_key_to_flax`` with each tower's fix-ups, on every key of the
    SD-1.5 tower (meta tensors: shapes only): same Flax path and the same
    transposition as the JAX package's rule."""
    with torch.device("meta"):
        model, fix, jfix = {
            "unet": (lambda: UNet2DCondition(UNetConfig.sd15()), weights.UNET_FIXUPS,
                     j_weights.UNET_FIXUPS),
            "vae": (lambda: AutoencoderKL(VAEConfig.sd()), weights.VAE_FIXUPS,
                    j_weights.VAE_FIXUPS),
            "clip": (lambda: CLIPTextModel(CLIPTextConfig.sd15()), weights.CLIP_TEXT_FIXUPS,
                     j_weights.CLIP_TEXT_FIXUPS)}[tower]
        model = model()
    keys = list(model.state_dict().items())
    assert len(keys) > 100
    for key, ref in keys:
        probe = np.broadcast_to(np.zeros((), np.float32), tuple(ref.shape))
        path, arr = weights.torch_key_to_flax(key, probe, fix)
        jpath, jarr = j_weights.torch_key_to_flax(key, probe, jfix)
        assert path == jpath and arr.shape == jarr.shape, key
    tree = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert weights._flatten_tree(tree) == j_weights._flatten_tree(tree)


def test_safetensors_reader_matches(tmp_path):
    rs = np.random.RandomState(0)
    tensors = {"w": rs.randn(3, 4).astype(np.float32), "h": rs.randn(5).astype(np.float16),
               "i": np.arange(6, dtype=np.int64).reshape(2, 3),
               "b": rs.randn(2, 2).astype(np.float32)}
    path = str(tmp_path / "t.safetensors")
    save_safetensors(path, tensors, bf16_keys=("b",))
    got, want = load_safetensors(path), j_load_safetensors(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_image_io_matches(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(0)
    path = str(tmp_path / "im.png")
    Image.fromarray(rs.randint(0, 255, (48, 80, 3), dtype=np.uint8)).save(path)
    got, want = images.load_image(path, size=32), j_images.load_image(path, size=32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(images.to_pil(got)), np.asarray(j_images.to_pil(want)))


def test_dataset_from_yaml_matches(tmp_path):
    """The demo YAML reader on a YAML written here: entries with and without a
    blend word, an image path with a leading slash, the reference's keys."""
    path = tmp_path / "demo.yaml"
    path.write_text("- image: /lizard.jpg\n"
                    "  source_prompt: a photo of a green lizard on a rock\n"
                    "  target_prompt: a photo of a brown lizard on a rock\n"
                    "  blended_word: lizard lizard\n"
                    "  editing_instruction: make the lizard brown\n"
                    "- image: /cat.png\n"
                    "  source_prompt: a cat sitting on a bench\n"
                    "  target_prompt: a dog sitting on a bench\n"
                    "  blended_word: ''\n")
    got = images.dataset_from_yaml(str(path))
    assert got == j_images.dataset_from_yaml(str(path))
    assert [item["image"] for item in got] == ["/lizard.jpg", "/cat.png"]
