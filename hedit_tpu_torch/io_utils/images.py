"""Image and dataset I/O in NHWC, [-1, 1] floats (own copy of what the port
needs from ``hedit_tpu/io_utils/images.py``).

Parity: ``*/utils/utils.py`` of the reference and ``p2p/ptp_classes.py:351-372``
(load_512: centre-crop to a square, resize to 512, scale to [-1, 1]).  Needs
PIL, so only the CLI imports this module; ``dataset_from_yaml`` imports PyYAML
when it is called.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
from PIL import Image


def load_image(path: str, *, size: int = 512, left: int = 0, right: int = 0,
               top: int = 0, bottom: int = 0) -> np.ndarray:
    """-> [1, size, size, 3] float32 in [-1, 1] (load_512 semantics, with the
    reference's offset clamping quirks, ``ptp_classes.py:351-372``)."""
    image = np.array(Image.open(path).convert("RGB"))[:, :, :3]
    h, w, _ = image.shape
    left = min(left, w - 1)
    right = min(right, w - left - 1)
    top = min(top, h - left - 1)   # reference quirk: clamps top against left
    bottom = min(bottom, h - top - 1)
    image = image[top : h - bottom, left : w - right]
    h, w, _ = image.shape
    if h < w:
        off = (w - h) // 2
        image = image[:, off : off + h]
    elif w < h:
        off = (h - w) // 2
        image = image[off : off + w]
    image = np.array(Image.fromarray(image).resize((size, size)))
    return (image.astype(np.float32) / 127.5 - 1.0)[None]


def to_pil(x: np.ndarray) -> Image.Image:
    """[H, W, 3] or [1, H, W, 3] in [-1, 1] -> PIL (x / 2 + 0.5, clamped;
    ``utils/utils.py:19-25``)."""
    x = np.asarray(x)
    if x.ndim == 4:
        x = x[0]
    x = np.clip(x / 2 + 0.5, 0.0, 1.0)
    return Image.fromarray((x * 255).astype(np.uint8))


def dataset_from_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def dataset_from_yaml(path: str) -> List[Dict]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
