"""ctypes binding of the native host op (``native/hostops.cpp``): connected
components of a thresholded OCR probability map, for the host candidate
path (``OcrConfig.device_components=False``).

The library is compiled with ``g++`` into this package's git-ignored
``build/`` directory at first use, keyed by a hash of the source and the
flags, under the build lock of ``ops/cuda_build.py``; ``native/``'s own
``libhostops.so`` is never written.  A failed build raises.  The OpenCV
form stays as the explicit ``impl="cv2"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from omniparser_tpu_torch.ops import cuda_build

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "hostops.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None

Component = Tuple[Tuple[int, int, int, int], float, int]


def _lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(cuda_build.BUILD_DIR, f"libhostops_{digest}.so")


def load() -> ctypes.CDLL:
    """The library, built on first use; raises where g++ fails."""
    global _lib
    if _lib is not None:
        return _lib
    with cuda_build._lock:
        if _lib is None:
            path = _lib_path()
            if not os.path.exists(path):
                os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
                tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
                proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
            lib.extract_components.restype = ctypes.c_int32
            lib.extract_components.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
                ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the native library builds and loads on this machine (where
    it does not, ``extract_components(impl='native')`` raises)."""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


def extract_components(prob: np.ndarray, threshold: float, min_area: int, min_score: float,
                       max_out: int = 1024, impl: str = "native") -> List[Component]:
    """4-connected components of (prob > threshold), in the raster order of
    each component's first pixel, with (bbox xyxy x2/y2 exclusive, mean
    prob, area); components under min_area or min_score are dropped before
    the max_out cap.  impl: 'native' (the C++ library) or 'cv2'."""
    prob = np.ascontiguousarray(prob, np.float32)
    if prob.ndim != 2:
        raise ValueError(f"prob: want [H, W], got {prob.shape}")
    h, w = prob.shape
    if impl == "native":
        lib = load()
        boxes = np.zeros((max_out, 4), np.int32)
        scores = np.zeros(max_out, np.float32)
        areas = np.zeros(max_out, np.int32)
        n = lib.extract_components(
            prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            h, w, threshold, min_area, min_score, max_out,
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            areas.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return [(tuple(int(v) for v in boxes[i]), float(scores[i]), int(areas[i]))
                for i in range(n)]
    if impl != "cv2":
        raise ValueError(f"impl must be 'native' or 'cv2', got {impl!r}")
    import cv2

    binary = (prob > threshold).astype(np.uint8)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(binary, connectivity=4)
    out: List[Component] = []
    for i in range(1, n):
        x, y, bw, bh, area = stats[i]
        if area < min_area:
            continue
        score = float(prob[labels == i].mean())
        if score < min_score:
            continue
        out.append(((int(x), int(y), int(x + bw), int(y + bh)), score, int(area)))
        if len(out) >= max_out:
            break
    return out
