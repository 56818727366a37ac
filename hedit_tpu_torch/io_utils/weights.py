"""JAX parameter trees -> the port's ``state_dict``s.

The port's parameter names are the diffusers / transformers ``state_dict``
keys, which ``hedit_tpu/io_utils/weights.py`` (numpy only) maps to Flax
trees: ``convert_unet``, ``convert_vae`` and ``convert_clip_text``.  The
converters here are their exact inverses.  Each walks the port module's own
keys, finds each key's Flax path with the same ``torch_key_to_flax`` rule,
and undoes its transposition (Dense kernel [in, out] -> weight [out, in];
conv kernel HWIO -> OIHW).  So ``convert_unet(unet_state_dict(params,
model))`` gives ``params`` back, and both packages compute the same thing
from one set of weights.  A local diffusers directory loads directly, since
its keys are already the port's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from hedit_tpu.io_utils.weights import (
    CLIP_TEXT_FIXUPS, UNET_FIXUPS, VAE_FIXUPS, _flatten_tree, torch_key_to_flax,
)


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
