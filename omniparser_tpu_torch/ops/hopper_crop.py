"""Crop-gather: K boxes -> K [out_h, out_w, 3] float32 patches.

The wrapper launches the hand-written CUDA kernel (``csrc/crop.cu``) for a
CUDA image and takes ``crop_resize_plain`` (ops/preprocess.py, re-exported
here) for a CPU image, and only for that: on a CUDA tensor it launches or
raises.  One kernel serves both grid rules: 'resize' (caption crops,
stretched) and 'line' (OCR line crops, aspect-preserving).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from omniparser_tpu_torch.ops import cuda_build
from omniparser_tpu_torch.ops.preprocess import _hw, _out_hw, crop_resize_plain

__all__ = ["crop_resize", "crop_resize_plain", "launch_counts"]

launch_counts: Dict[str, int] = {"crop_resize": 0}

_MODES = {"resize": 0, "line": 1}


def crop_resize(padded_u8: torch.Tensor, orig_hw, boxes_norm: torch.Tensor,
                out_size=64, grid: str = "resize") -> torch.Tensor:
    """padded_u8 [Hb,Wb,3] uint8, orig_hw (h, w) of the unpadded image,
    boxes_norm [K,4] float32 normalised xyxy -> [K,out_h,out_w,3] float32
    in [0,255]."""
    if grid not in _MODES:
        raise ValueError(f"grid must be 'resize' or 'line', got {grid!r}")
    if padded_u8.dtype != torch.uint8 or padded_u8.dim() != 3 or padded_u8.shape[2] != 3:
        raise ValueError(f"padded_u8: want uint8 [H,W,3], got "
                         f"{padded_u8.dtype} {tuple(padded_u8.shape)}")
    if boxes_norm.dtype != torch.float32 or boxes_norm.dim() != 2 or boxes_norm.shape[1] != 4:
        raise ValueError(f"boxes_norm: want float32 [K,4], got "
                         f"{boxes_norm.dtype} {tuple(boxes_norm.shape)}")
    if boxes_norm.device != padded_u8.device:
        raise ValueError("boxes_norm must be on the image's device")
    if not (padded_u8.is_contiguous() and boxes_norm.is_contiguous()):
        raise ValueError("crop_resize: inputs must be contiguous")
    out_h, out_w = _out_hw(out_size)
    if not padded_u8.is_cuda:
        return crop_resize_plain(padded_u8, orig_hw, boxes_norm, (out_h, out_w), grid)
    h, w = _hw(orig_hw)
    img_h, img_w = padded_u8.shape[0], padded_u8.shape[1]
    if not (0 < h <= img_h and 0 < w <= img_w):
        raise ValueError(f"orig_hw {(h, w)} does not fit the image {(img_h, img_w)}")
    if out_h * out_w > 65535 * 256:
        raise ValueError("crop_resize: patch too large for one launch")
    lib = cuda_build.load("crop.cu")
    fn = lib.crop_resize_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k = boxes_norm.shape[0]
    out = torch.empty((k, out_h, out_w, 3), dtype=torch.float32, device=padded_u8.device)
    if k == 0:
        return out
    with torch.cuda.device(padded_u8.device):
        err = fn(padded_u8.data_ptr(), boxes_norm.data_ptr(), out.data_ptr(), k, img_h,
                 img_w, h, w, out_h, out_w, _MODES[grid], cuda_build.current_stream())
    launch_counts["crop_resize"] += 1
    cuda_build.check(err, "crop_resize")
    return out
