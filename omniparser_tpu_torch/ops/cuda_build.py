"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` has a plain C interface and is compiled by ``nvcc`` for
sm_90a into its own shared library under ``omniparser_tpu_torch/build/``,
all sources in parallel, at first use; the libraries are keyed by a hash
of their source and the flags, so an unchanged source is not rebuilt.
They are loaded with ``ctypes``: pointers come from ``tensor.data_ptr()``
and the stream from ``torch.cuda.current_stream()``.

Nothing here runs at import: a machine without ``nvcc`` can import every
module of the package and use the plain versions on CPU tensors.

Building and loading hold one module lock: the server's batcher thread may
reach its first kernel while the main thread is still warming up, and
two builds at once would race on the same output files.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add: the keep masks and containment masks are held
    # bit for bit against PyTorch, and an fma in (a_i + a_j) - iw*ih moves
    # the union's last bit and flips a decision at a threshold
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

SOURCES = ("nms.cu", "overlap.cu", "crop.cu", "beam_attention.cu")

_libs: Dict[str, ctypes.CDLL] = {}
# re-entrant: load() holds it while it calls build_all()
_lock = threading.RLock()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(looked on PATH and under CUDA_HOME / /usr/local/cuda)")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{os.path.splitext(name)[0]}_{digest}.so")


def build_all(verbose: bool = False) -> Dict[str, object]:
    """Compile every source whose library is missing (one nvcc process per
    source, all started together) and load all of them.  Returns
    {'seconds', 'built': [...], 'cached': [...], 'log': str}."""
    with _lock:
        return _build_all_locked(verbose)


def _build_all_locked(verbose: bool) -> Dict[str, object]:
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List[tuple] = []
    cached: List[str] = []
    nvcc: Optional[str] = None
    extra = ["-Xptxas", "-v"] if verbose else []
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            cached.append(name)
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out + f".tmp{os.getpid()}.{threading.get_ident()}"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", tmp, os.path.join(CSRC_DIR, name)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {name} ==\n{text}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n" + "\n".join(log))
    for name in SOURCES:
        _libs[name] = ctypes.CDLL(_lib_path(name))
    return {"seconds": time.perf_counter() - t0, "built": [p[0] for p in procs],
            "cached": cached, "log": "\n".join(log)}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building all on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:  # a second caller waits for the first one's build
            if name not in _libs:
                build_all()
            lib = _libs[name]
    return lib


def current_stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream as the C entries take it.  Outputs and
    scratch come from torch's allocator on this same stream, so a buffer
    freed right after a launch is not handed out again before the kernel
    that uses it has run."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")
