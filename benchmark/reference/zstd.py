"""ctypes binding of the zstd frame decoder beside this file
(``zstd_decode.cpp``, a frozen copy of the measured package's), which the
orbax reader needs for compressed nodes and chunks.

The library is compiled with ``g++`` at first use into ``benchmark/.build/``
inside the checkout, keyed by a hash of the source and the flags, so that
only the first run in a checkout builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "zstd_decode.cpp")
BUILD_DIR = os.path.join(os.path.dirname(HERE), ".build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libzstd_decode_{digest}.so")


def load() -> ctypes.CDLL:
    """The library, built on first use; raises where g++ fails."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}"
                proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
            lib.zstd_frames_content_size.restype = ctypes.c_int64
            lib.zstd_frames_content_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.zstd_decompress.restype = ctypes.c_int
            lib.zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                            ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
            lib.zstd_error_name.restype = ctypes.c_char_p
            lib.zstd_error_name.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


def decompress(data: bytes, expected_size: Optional[int] = None,
               limit: Optional[int] = None) -> np.ndarray:
    """Decode the zstd frames in `data` (skippable frames skipped) into a
    new uint8 array.  Its size is the sum of the sizes the frame headers
    state; where a frame states none, `expected_size` (for a zarr chunk,
    its bytes) gives it, and the output must fill it exactly; without one,
    the output may take up to `limit` bytes (for an OCDBT node, the
    store's largest decoded node).  Raises ValueError on corrupt, truncated
    or dictionary frames, and on output of another size."""
    lib = load()
    data = bytes(data)
    stated = lib.zstd_frames_content_size(data, len(data))
    if stated < -1:
        raise ValueError(f"zstd: {lib.zstd_error_name(-stated - 1).decode()}")
    exact = True
    if stated >= 0:
        if expected_size is not None and stated != expected_size:
            raise ValueError(f"zstd: the frames hold {stated} bytes, expected {expected_size}")
        size = stated
    elif expected_size is not None:
        size = int(expected_size)
    elif limit is not None:
        size, exact = int(limit), False
    else:
        raise ValueError("zstd: a frame states no content size and neither an expected "
                         "size nor a limit was given")
    out = np.empty(size, np.uint8)
    written = ctypes.c_size_t(0)
    code = lib.zstd_decompress(data, len(data), out.ctypes.data, size, ctypes.byref(written))
    if code != 0:
        raise ValueError(f"zstd: {lib.zstd_error_name(code).decode()} "
                         f"(error {code}, after {written.value} bytes)")
    if exact and written.value != size:
        raise ValueError(f"zstd: decoded {written.value} bytes, expected {size}")
    return out if exact else out[:written.value]
