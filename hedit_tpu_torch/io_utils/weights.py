"""JAX parameter trees -> the port's ``state_dict``s.

The port's parameter names are the diffusers / transformers ``state_dict``
keys, which ``hedit_tpu/io_utils/weights.py`` (numpy only) maps to Flax
trees: ``convert_unet``, ``convert_vae`` and ``convert_clip_text``, and the
face models' ``convert_ddpm_ckpt``, ``convert_irse50``,
``convert_lpips_vgg`` and ``convert_face_parser``.  The converters here are
their exact inverses.  Each walks the port module's own
keys, finds each key's Flax path with the same ``torch_key_to_flax`` rule
(kept here as an own copy, with the ``*_FIXUPS`` tables; a test holds
it to the JAX package's on every key of the three towers),
and undoes its transposition (Dense kernel [in, out] -> weight [out, in];
conv kernel HWIO -> OIHW).  So ``convert_unet(unet_state_dict(params,
model))`` gives ``params`` back, and both packages compute the same thing
from one set of weights.  A local diffusers directory loads directly, since
its keys are already the port's, once ``legacy_vae_state`` has renamed the
legacy VAE attention keys the JAX package also reads.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

# Key mapping rules (diffusers / HF torch -> the JAX package's Flax trees):
# ``.N`` list indices -> ``_N`` module-name suffixes; Dense ``weight``
# [out, in] -> ``kernel`` [in, out]; conv ``weight`` OIHW -> ``kernel`` HWIO;
# norm ``weight`` (1-D) -> ``scale``; embedding ``weight`` -> ``embedding``.

UNET_FIXUPS: List[Tuple[str, str]] = []  # the UNet's keys need only the general rules

VAE_FIXUPS: List[Tuple[str, str]] = [
    # encoder / decoder block flattening: down_blocks_0.resnets_0 -> down_blocks_0_resnets_0
    (r"(down_blocks_\d+)\.(resnets_\d+)", r"\1_\2"),
    (r"(down_blocks_\d+)\.(downsamplers_\d+)", r"\1_\2"),
    (r"(up_blocks_\d+)\.(resnets_\d+)", r"\1_\2"),
    (r"(up_blocks_\d+)\.(upsamplers_\d+)", r"\1_\2"),
    # legacy diffusers VAE attention names -> to_q / to_k / to_v / to_out_0
    (r"mid_block\.attentions_0\.query", "mid_block.attentions_0.to_q"),
    (r"mid_block\.attentions_0\.key", "mid_block.attentions_0.to_k"),
    (r"mid_block\.attentions_0\.value", "mid_block.attentions_0.to_v"),
    (r"mid_block\.attentions_0\.proj_attn", "mid_block.attentions_0.to_out_0"),
    (r"mid_block\.attentions_0\.q\.", "mid_block.attentions_0.to_q."),
    (r"mid_block\.attentions_0\.k\.", "mid_block.attentions_0.to_k."),
    (r"mid_block\.attentions_0\.v\.", "mid_block.attentions_0.to_v."),
    (r"mid_block\.attentions_0\.proj_out", "mid_block.attentions_0.to_out_0"),
]

CLIP_TEXT_FIXUPS: List[Tuple[str, str]] = [
    (r"^text_model\.", ""),
    (r"^encoder\.", ""),
    (r"embeddings\.token_embedding", "token_embedding"),
    (r"embeddings\.position_embedding\.weight", "position_embedding"),
    (r"\.mlp\.fc1", ".mlp_fc1"),
    (r"\.mlp\.fc2", ".mlp_fc2"),
]

# the CelebA-HQ DDPM's checkpoint keys (``hedit_tpu/models/ddpm_unet.py:convert_ddpm_ckpt``)
DDPM_FIXUPS: List[Tuple[str, str]] = [
    (r"^temb\.dense_0", "temb_dense_0"),
    (r"^temb\.dense_1", "temb_dense_1"),
    (r"^down_(\d+)\.block_(\d+)", r"down_\1_block_\2"),
    (r"^down_(\d+)\.attn_(\d+)", r"down_\1_attn_\2"),
    (r"^down_(\d+)\.downsample", r"down_\1_downsample"),
    (r"^up_(\d+)\.block_(\d+)", r"up_\1_block_\2"),
    (r"^up_(\d+)\.attn_(\d+)", r"up_\1_attn_\2"),
    (r"^up_(\d+)\.upsample", r"up_\1_upsample"),
    (r"^mid\.block_1", "mid_block_1"),
    (r"^mid\.attn_1", "mid_attn_1"),
    (r"^mid\.block_2", "mid_block_2"),
]


def torch_key_to_flax(key: str, arr: np.ndarray,
                      fixups: Optional[List[Tuple[str, str]]] = None
                      ) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Map one flat torch key / tensor to a Flax path / tensor."""
    k = re.sub(r"\.(\d+)", r"_\1", key)  # 'down_blocks.0.x' -> 'down_blocks_0.x'
    for pat, rep in fixups or []:
        k = re.sub(pat, rep, k)
    parts = k.split(".")
    leaf = parts[-1]
    if leaf == "weight":
        if "token_embedding" in k or k.endswith("embedding.weight"):
            leaf = "embedding"
        elif arr.ndim == 4:
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        elif arr.ndim == 1:
            leaf = "scale"
        else:
            leaf = "kernel"
    return tuple(parts[:-1] + [leaf]), np.asarray(arr)


def _flatten_tree(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# Legacy VAE attention names -> the port's keys: the torch-key form of the
# legacy rules of ``VAE_FIXUPS`` (diffusers' query / key / value / proj_attn
# and the LDM names q / k / v / proj_out of the mid-block attention).
VAE_LEGACY_KEYS: List[Tuple[str, str]] = [
    (r"(mid_block\.attentions\.0)\.(?:query|q)\.", r"\1.to_q."),
    (r"(mid_block\.attentions\.0)\.(?:key|k)\.", r"\1.to_k."),
    (r"(mid_block\.attentions\.0)\.(?:value|v)\.", r"\1.to_v."),
    (r"(mid_block\.attentions\.0)\.(?:proj_attn|proj_out)\.", r"\1.to_out.0."),
]


def legacy_vae_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A VAE ``state_dict`` with legacy attention keys renamed to the port's
    (``VAE_LEGACY_KEYS``), and the mid-block attention's 1x1-conv weights
    ``[C, C, 1, 1]`` squeezed to the linear ``[C, C]``, as the JAX package's
    ``convert_vae`` squeezes them; other keys pass unchanged."""
    out = {}
    for key, t in state.items():
        for pat, rep in VAE_LEGACY_KEYS:
            key = re.sub(pat, rep, key)
        if "mid_block.attentions.0." in key and t.dim() == 4 and tuple(t.shape[2:]) == (1, 1):
            t = t.reshape(t.shape[0], t.shape[1])
        out[key] = t
    return out


def _to_torch(path: Tuple[str, ...], arr: np.ndarray, ndim: int) -> np.ndarray:
    if path[-1] == "kernel" and ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if path[-1] == "kernel" and ndim == 2:
        return arr.T
    return arr


def flax_to_state_dict(params: Dict[str, Any], model: nn.Module,
                       fixups: List[Tuple[str, str]]) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_state_dict`` for the keys of ``model``; raises on
    a missing, unexpected or mis-shaped leaf."""
    flat = _flatten_tree(params["params"] if "params" in params else params)
    out, used, errors = {}, set(), []
    for key, ref in model.state_dict().items():
        probe = np.broadcast_to(np.zeros((), np.float32), tuple(ref.shape))
        path, _ = torch_key_to_flax(key, probe, fixups)
        if path not in flat:
            errors.append(f"MISSING {key} ({'/'.join(path)})")
            continue
        arr = _to_torch(path, np.asarray(flat[path]), ref.dim())
        if tuple(arr.shape) != tuple(ref.shape):
            errors.append(f"SHAPE {key}: got {arr.shape} want {tuple(ref.shape)}")
            continue
        used.add(path)
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))  # a copy
    errors += [f"UNEXPECTED {'/'.join(p)}" for p in flat if p not in used]
    if errors:
        raise ValueError(f"{len(errors)} weight problems:\n" + "\n".join(errors[:50]))
    return out


def unet_state_dict(params, model: nn.Module) -> Dict[str, torch.Tensor]:
    return flax_to_state_dict(params, model, UNET_FIXUPS)


def vae_state_dict(params, model: nn.Module) -> Dict[str, torch.Tensor]:
    return flax_to_state_dict(params, model, VAE_FIXUPS)


def clip_text_state_dict(params, model: nn.Module) -> Dict[str, torch.Tensor]:
    return flax_to_state_dict(params, model, CLIP_TEXT_FIXUPS)


def ddpm_state_dict(params, model: nn.Module) -> Dict[str, torch.Tensor]:
    return flax_to_state_dict(params, model, DDPM_FIXUPS)


# The face critics' converters name each tensor by hand; their inverses walk
# the same (torch key, Flax path, layout) table.  Layouts: "plain" as is,
# "conv" OIHW <-> HWIO, "dense" [out, in] <-> [in, out], "convT" a transposed
# conv [in, out, H, W] <-> HWIO-like [H, W, in, out] flipped in H and W.
_TO_TORCH = {
    "plain": lambda a: a,
    "conv": lambda a: a.transpose(3, 2, 0, 1),
    "dense": lambda a: a.T,
    "convT": lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
}


def _bn_pairs(t: str, f: str):
    return [(f"{t}.{a}", f"{f}/{b}", "plain") for a, b in (
        ("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var"))]


def _conv_pairs(t: str, f: str, bias: bool, layout: str = "conv"):
    return [(f"{t}.weight", f"{f}/kernel", layout)] + (
        [(f"{t}.bias", f"{f}/bias", "plain")] if bias else [])


def irse50_pairs():
    """``convert_irse50``'s table (``hedit_tpu/models/arcface.py:118-165``)."""
    from hedit_tpu_torch.models.arcface import IR_SE_50_BLOCKS

    pairs = (_conv_pairs("input_layer.0", "input_conv", False)
             + _bn_pairs("input_layer.1", "input_bn")
             + [("input_layer.2.weight", "input_prelu/alpha", "plain")])
    for i, (cin, depth, _) in enumerate(IR_SE_50_BLOCKS):
        t, f = f"body.{i}", f"body_{i}"
        if cin != depth:
            pairs += (_conv_pairs(f"{t}.shortcut_layer.0", f"{f}/shortcut_conv", False)
                      + _bn_pairs(f"{t}.shortcut_layer.1", f"{f}/shortcut_bn"))
        pairs += (_bn_pairs(f"{t}.res_layer.0", f"{f}/res_bn1")
                  + _conv_pairs(f"{t}.res_layer.1", f"{f}/res_conv1", False)
                  + [(f"{t}.res_layer.2.weight", f"{f}/res_prelu/alpha", "plain")]
                  + _conv_pairs(f"{t}.res_layer.3", f"{f}/res_conv2", False)
                  + _bn_pairs(f"{t}.res_layer.4", f"{f}/res_bn2")
                  + _conv_pairs(f"{t}.res_layer.5.fc1", f"{f}/res_se/fc1", False)
                  + _conv_pairs(f"{t}.res_layer.5.fc2", f"{f}/res_se/fc2", False))
    return (pairs + _bn_pairs("output_layer.0", "output_bn2d")
            + [("output_layer.3.weight", "output_linear/kernel", "dense"),
               ("output_layer.3.bias", "output_linear/bias", "plain")]
            + _bn_pairs("output_layer.4", "output_bn1d"))


def lpips_vgg_pairs():
    """``convert_lpips_vgg``'s table in the lpips slice layout
    (``hedit_tpu/models/lpips_vgg.py:64-101``)."""
    from hedit_tpu_torch.models.lpips_vgg import TV_CONV_IDX, slice_key

    pairs = []
    for my_idx, tv_idx in enumerate(TV_CONV_IDX):
        pairs += _conv_pairs(slice_key(tv_idx), f"net/conv_{my_idx}", True)
    return pairs + [(f"lin{i}.model.1.weight", f"lin_{i}/kernel", "conv") for i in range(5)]


def face_parser_pairs():
    """``convert_face_parser``'s table (``hedit_tpu/models/face_parser.py:73-114``),
    its transposed convs flipped in H and W."""
    def unetconv(t, f):
        return [p for i in (1, 2) for p in _conv_pairs(f"{t}.conv{i}.0", f"{f}/conv{i}_conv", True)
                + _bn_pairs(f"{t}.conv{i}.1", f"{f}/conv{i}_bn")]

    pairs = [p for name in ("conv1", "conv2", "conv3", "conv4", "center")
             for p in unetconv(name, name)]
    for name in ("up_concat4", "up_concat3", "up_concat2", "up_concat1"):
        pairs += unetconv(f"{name}.conv", f"{name}/conv")
        pairs += _conv_pairs(f"{name}.up", f"{name}/up", True, "convT")
    return pairs + _conv_pairs("final", "final", True)


def pairs_to_state_dict(params, pairs, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse of a hand-named converter: each torch key of ``pairs`` from
    its Flax path; raises unless the keys are exactly ``model``'s, shapes
    included, and every leaf of ``params`` is used."""
    flat = _flatten_tree(params["params"] if "params" in params else params)
    want = model.state_dict()
    out, errors = {}, []
    for key, path, layout in pairs:
        path = tuple(path.split("/"))
        if path not in flat:
            errors.append(f"MISSING {key} ({'/'.join(path)})")
            continue
        arr = _TO_TORCH[layout](np.asarray(flat[path]))
        if key not in want or tuple(arr.shape) != tuple(want[key].shape):
            errors.append(f"SHAPE {key}: got {arr.shape} want "
                          f"{tuple(want[key].shape) if key in want else 'no such key'}")
            continue
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))  # a copy
    used = {tuple(p.split("/")) for _, p, _ in pairs}
    errors += [f"UNEXPECTED {'/'.join(p)}" for p in flat if p not in used]
    errors += [f"NOT SET {k}" for k in want if k not in out]
    if errors:
        raise ValueError(f"{len(errors)} weight problems:\n" + "\n".join(errors[:50]))
    return out


def irse50_state_dict(params, model: nn.Module) -> Dict[str, torch.Tensor]:
    return pairs_to_state_dict(params, irse50_pairs(), model)


def lpips_vgg_state_dict(params, model: nn.Module) -> Dict[str, torch.Tensor]:
    return pairs_to_state_dict(params, lpips_vgg_pairs(), model)


def face_parser_state_dict(params, model: nn.Module) -> Dict[str, torch.Tensor]:
    return pairs_to_state_dict(params, face_parser_pairs(), model)


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A .pt / .pth / .ckpt (torch) or .safetensors file as numpy arrays (own
    copy of ``hedit_tpu/io_utils/weights.py:load_torch_state``): a
    ``state_dict`` entry unwrapped, a list's first element taken (the
    reference CelebA checkpoint's quirk)."""
    if path.endswith(".safetensors"):
        from hedit_tpu_torch.io_utils.safetensors_io import load_safetensors

        return load_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, (list, tuple)):  # reference celeba ckpt quirk
        obj = obj[0]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def load_known(model: nn.Module, state: Dict[str, np.ndarray], name: str) -> None:
    """Load ``model``'s own keys from ``state`` (numpy), as the JAX package's
    converters read only the keys they know; raises on a missing or
    mis-shaped one."""
    want = model.state_dict()
    errors = [f"MISSING {k}" for k in want if k not in state]
    errors += [f"SHAPE {k}: got {tuple(np.shape(state[k]))} want {tuple(v.shape)}"
               for k, v in want.items() if k in state and tuple(np.shape(state[k])) != tuple(v.shape)]
    if errors:
        raise ValueError(f"{name}: {len(errors)} weight problems:\n" + "\n".join(errors[:50]))
    model.load_state_dict({k: torch.from_numpy(np.array(state[k], dtype=np.float32))
                           for k in want})
