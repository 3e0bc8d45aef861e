"""The safetensors file format with numpy alone (no ``safetensors`` package).

A file is an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}`` and then one byte buffer; offsets count from the buffer's start.
F32, F16 and BF16 are read (BF16 as uint16, widened to float32) and F32 is
written.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import numpy as np

_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": np.dtype("<u2")}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: array}; F32 and F16 keep their dtype, BF16 becomes float32."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = np.fromfile(f, dtype=np.uint8)
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}, "
                             f"not one of {sorted(_DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        dt = _DTYPES[dtype]
        if end - begin != int(np.prod(shape, dtype=np.int64)) * dt.itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes "
                             f"for shape {shape} {dtype}")
        arr = buf[begin:end].view(dt).reshape(shape)
        if dtype == "BF16":  # the high half of a float32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray]) -> None:
    """Write tensors as F32 (any float input is converted) in the format
    above, names and data in sorted order."""
    header, offset = {}, 0
    arrays = {}
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name], dtype="<f4")
        arrays[name] = arr
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in sorted(arrays):
            f.write(arrays[name].tobytes())
