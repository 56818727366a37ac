"""Minimal pure-numpy safetensors reader (own copy of the reader in
``hedit_tpu/io_utils/safetensors_io.py``).

Format: 8-byte little-endian header length, a JSON header mapping tensor name
-> {dtype, shape, data_offsets}, then a flat byte buffer.  Enough to load the
checkpoint files of a local diffusers directory (SD UNet / VAE / CLIP).
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of the file as a numpy array; BF16 (no numpy dtype) is
    widened to float32."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        buf = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = buf[start:end]
        if meta["dtype"] == "BF16":
            u16 = np.frombuffer(raw, dtype=np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        elif meta["dtype"] in _DTYPES:
            arr = np.frombuffer(raw, dtype=_DTYPES[meta["dtype"]])
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {meta['dtype']!r}")
        out[name] = arr.reshape(meta["shape"])
    return out
