"""JAX parameter trees -> the port's ``state_dict``s.

The port's parameter names are the diffusers / transformers ``state_dict``
keys, which ``hedit_tpu/io_utils/weights.py`` (numpy only) maps to Flax
trees: ``convert_unet``, ``convert_vae`` and ``convert_clip_text``.  The
converters here are their exact inverses.  Each walks the port module's own
keys, finds each key's Flax path with the same ``torch_key_to_flax`` rule
(kept here as an own copy, with the three ``*_FIXUPS`` tables; a test holds
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
