"""Image preprocessing as fixed-shape tensor ops.

The raw screenshot is host-padded (memcpy only) into a uint8 bucket and
uploaded once; letterbox resize, normalisation and the N-box crop-gather
run on the tensor's device.  Image sizes are host integers here (eager
PyTorch needs no traced scalars); every float that decides a pixel is
computed in float32, in the JAX package's operation order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# ultralytics letterbox fill (YOLO convention)
LETTERBOX_FILL = 114.0


def pick_bucket(h: int, w: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket that fits the longer side; else the largest bucket."""
    longest = max(h, w)
    for b in sorted(buckets):
        if longest <= b:
            return b
    return max(buckets)


def pick_bucket_2d(h: int, w: int, step: int = 128, max_side: int = 8192) -> Tuple[int, int]:
    """Per-axis static bucket: round each dim up to a multiple of `step`."""
    hb = min(-(-h // step) * step, max_side)
    wb = min(-(-w // step) * step, max_side)
    if h > hb or w > wb:
        raise ValueError(f"image {h}x{w} exceeds max_side {max_side}")
    return hb, wb


def pad_to_bucket(image_u8, bucket_h: int, bucket_w: int):
    """Host-side: zero-pad a [H,W,3] uint8 array into the static bucket.
    Returns (padded [bucket_h,bucket_w,3], (h, w))."""
    h, w = image_u8.shape[:2]
    if h > bucket_h or w > bucket_w:
        raise ValueError(f"image {h}x{w} exceeds bucket {bucket_h}x{bucket_w}")
    out = np.zeros((bucket_h, bucket_w, 3), dtype=np.uint8)
    out[:h, :w] = image_u8
    return out, (h, w)


def _hw(orig_hw) -> Tuple[int, int]:
    """(h, w) as host ints from a tuple, array or tensor."""
    if isinstance(orig_hw, torch.Tensor):
        orig_hw = orig_hw.tolist()
    return int(orig_hw[0]), int(orig_hw[1])


def _linear_taps(in_size: int, out_size: int, scale, translation, device):
    """Two-tap linear resampling along one axis with a scale and a
    translation: output o samples the input at
    ``(o + 0.5) / scale - translation / scale - 0.5``.  Taps outside the
    input get weight 0 and the rest are renormalised (so the source's edge
    replicates); samples wholly outside the input give 0.
    Returns (i0, i1 int64 [out], w0, w1 float32 [out])."""
    f32 = np.float32
    inv = f32(1.0) / f32(scale)
    o = np.arange(out_size, dtype=f32)
    sample = (o + f32(0.5)) * inv - f32(translation) * inv - f32(0.5)
    i0 = np.floor(sample)
    i1 = i0 + f32(1.0)
    w0 = np.maximum(f32(1.0) - np.abs(sample - i0), f32(0.0))
    w1 = np.maximum(f32(1.0) - np.abs(sample - i1), f32(0.0))
    w0 = np.where((i0 >= 0) & (i0 <= in_size - 1), w0, f32(0.0))
    w1 = np.where((i1 >= 0) & (i1 <= in_size - 1), w1, f32(0.0))
    total = w0 + w1
    ok = np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps))
    safe = np.where(total != 0, total, f32(1.0))
    w0 = np.where(ok, w0 / safe, f32(0.0))
    w1 = np.where(ok, w1 / safe, f32(0.0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(in_size - 0.5))
    w0 = np.where(inside, w0, f32(0.0)).astype(f32)
    w1 = np.where(inside, w1, f32(0.0)).astype(f32)
    i0c = np.clip(i0, 0, in_size - 1).astype(np.int64)
    i1c = np.clip(i1, 0, in_size - 1).astype(np.int64)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return as_t(i0c), as_t(i1c), as_t(w0), as_t(w1)


def letterbox(padded_u8: torch.Tensor, orig_hw, target: int):
    """Letterbox a bucket-padded uint8 image to (target, target) float32 [0,1].

    YOLO convention: scale r = min(target/h, target/w), centred, gray(114)
    fill.  The resampling is linear without antialiasing over the WHOLE
    padded bucket (so the image's edge blends with the bucket's zero
    padding where there is any), then everything outside the
    floor/ceil-bounded letterbox window is replaced by the fill.

    Returns (image [target,target,3] float32 in [0,1], r, (pad_y, pad_x));
    r and the pads are numpy float32 scalars.
    """
    f32 = np.float32
    h_i, w_i = _hw(orig_hw)
    h, w = f32(h_i), f32(w_i)
    t = f32(target)
    r = np.minimum(t / h, t / w)
    new_h, new_w = h * r, w * r
    pad_y = (t - new_h) / f32(2.0)
    pad_x = (t - new_w) / f32(2.0)

    dev = padded_u8.device
    hb, wb = padded_u8.shape[0], padded_u8.shape[1]
    y0, y1, wy0, wy1 = _linear_taps(hb, target, r, pad_y, dev)
    x0, x1, wx0, wx1 = _linear_taps(wb, target, r, pad_x, dev)
    # rows first ([target, Wb, 3]), then columns
    rows = (padded_u8[y0].to(torch.float32) * wy0[:, None, None]
            + padded_u8[y1].to(torch.float32) * wy1[:, None, None])
    scaled = rows[:, x0] * wx0[None, :, None] + rows[:, x1] * wx1[None, :, None]

    ar = np.arange(target, dtype=f32)
    in_y = (ar >= np.floor(pad_y)) & (ar < np.ceil(pad_y + new_h))
    in_x = (ar >= np.floor(pad_x)) & (ar < np.ceil(pad_x + new_w))
    inside = (torch.from_numpy(in_y).to(dev)[:, None]
              & torch.from_numpy(in_x).to(dev)[None, :])
    fill = torch.full((), LETTERBOX_FILL, dtype=torch.float32, device=dev)
    out = torch.where(inside[..., None], scaled, fill)
    return out / 255.0, r, (pad_y, pad_x)


def boxes_letterboxed_to_image(boxes_xyxy: torch.Tensor, r, pad_yx, orig_hw):
    """Map detector boxes from letterboxed coords back to original pixels,
    clamped to the image (ultralytics scale_boxes semantics)."""
    pad_y, pad_x = pad_yx
    h, w = _hw(orig_hw)
    dev = boxes_xyxy.device
    shift = torch.tensor([pad_x, pad_y, pad_x, pad_y], dtype=torch.float32, device=dev)
    out = (boxes_xyxy - shift) / torch.tensor(float(r), dtype=torch.float32, device=dev)
    lim = torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
    return torch.minimum(torch.clamp(out, min=0.0), lim)


def _crop_bounds(boxes_norm: torch.Tensor, h: int, w: int):
    b = boxes_norm.to(torch.float32)
    x1 = torch.trunc(b[:, 0] * float(w))
    y1 = torch.trunc(b[:, 1] * float(h))
    x2 = torch.trunc(b[:, 2] * float(w))
    y2 = torch.trunc(b[:, 3] * float(h))
    cw = torch.clamp(x2 - x1, min=1.0)
    ch = torch.clamp(y2 - y1, min=1.0)
    return x1, y1, cw, ch


def _finish_grid(x1, y1, cw, ch, js, is_, h: int, w: int):
    # clamp relative coords to [0, c-1] BEFORE the shift (degenerate boxes
    # must not sample outside the box), then into the unpadded image
    hi_x = torch.clamp(cw - 1.0, min=0.0)[:, None]
    hi_y = torch.clamp(ch - 1.0, min=0.0)[:, None]
    xs = x1[:, None] + torch.minimum(torch.clamp(js, min=0.0), hi_x)
    ys = y1[:, None] + torch.minimum(torch.clamp(is_, min=0.0), hi_y)
    xs = torch.clamp(xs, min=0.0, max=float(w) - 1.0)
    ys = torch.clamp(ys, min=0.0, max=float(h) - 1.0)
    return xs, ys


def resize_grid(boxes_norm: torch.Tensor, orig_hw, out_hw):
    """Anisotropic-stretch sample grids for [K,4] normalised boxes:
    (xs [K,out_w], ys [K,out_h]) source pixel centres; cv2.resize's
    half-pixel rule ``src = (dst + 0.5) * (crop / out) - 0.5``."""
    out_h, out_w = out_hw
    h, w = _hw(orig_hw)
    x1, y1, cw, ch = _crop_bounds(boxes_norm, h, w)
    dev = boxes_norm.device
    aw = torch.arange(out_w, dtype=torch.float32, device=dev)
    ah = torch.arange(out_h, dtype=torch.float32, device=dev)
    js = (aw[None, :] + 0.5) * (cw / out_w)[:, None] - 0.5
    is_ = (ah[None, :] + 0.5) * (ch / out_h)[:, None] - 0.5
    return _finish_grid(x1, y1, cw, ch, js, is_, h, w)


def line_grid(boxes_norm: torch.Tensor, orig_hw, out_hw):
    """Isotropic line-crop sample grids: one scale s = max(ch/out_h,
    cw/out_w) so glyphs are never stretched; left-anchored, vertically
    centred, out-of-crop samples clamp to the crop's edge."""
    out_h, out_w = out_hw
    h, w = _hw(orig_hw)
    x1, y1, cw, ch = _crop_bounds(boxes_norm, h, w)
    dev = boxes_norm.device
    s = torch.maximum(ch / out_h, cw / out_w)
    off_y = (out_h - ch / s) / 2.0
    aw = torch.arange(out_w, dtype=torch.float32, device=dev)
    ah = torch.arange(out_h, dtype=torch.float32, device=dev)
    is_ = ((ah[None, :] - off_y[:, None]) + 0.5) * s[:, None] - 0.5
    js = (aw[None, :] + 0.5) * s[:, None] - 0.5
    return _finish_grid(x1, y1, cw, ch, js, is_, h, w)


def _bilinear_gather(img_u8: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Sample img [H,W,3] at the outer product ys[k] x xs[k] per box,
    bilinear: -> [K, out_h, out_w, 3] float32."""
    img_h, img_w = img_u8.shape[0], img_u8.shape[1]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[:, None, :, None]
    fy = (ys - y0)[:, :, None, None]
    x0i = torch.clamp(x0.to(torch.int64), 0, img_w - 1)
    x1i = torch.clamp(x0i + 1, 0, img_w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, img_h - 1)
    y1i = torch.clamp(y0i + 1, 0, img_h - 1)

    def tap(yi, xi):
        return img_u8[yi[:, :, None], xi[:, None, :]].to(torch.float32)

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x1i) * fx
    bot = tap(y1i, x0i) * (1 - fx) + tap(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def _out_hw(out_size) -> Tuple[int, int]:
    return (out_size, out_size) if isinstance(out_size, int) else tuple(out_size)


def crop_resize_plain(padded_u8, orig_hw, boxes_norm, out_size=64, grid: str = "resize"):
    """Plain PyTorch crop-gather: N normalised-xyxy boxes -> N
    [out_h,out_w,3] float32 patches in [0,255].  Integer crop bounds by
    truncation, half-pixel-centre bilinear sampling, edge clamp inside the
    crop.  grid='resize' stretches the box to the patch; grid='line'
    keeps the aspect ratio (see line_grid)."""
    make = resize_grid if grid == "resize" else line_grid
    xs, ys = make(boxes_norm, orig_hw, _out_hw(out_size))
    return _bilinear_gather(padded_u8, xs, ys)


def crop_resize_batch(padded_u8, orig_hw, boxes_norm, out_size=64):
    """Caption crops: boxes stretched to [out,out,3] patches.  On a CUDA
    tensor this is the hand-written gather kernel; on the CPU its plain
    version."""
    from omniparser_tpu_torch.ops.hopper_crop import crop_resize

    return crop_resize(padded_u8, orig_hw, boxes_norm, out_size, grid="resize")


def crop_lines_batch(padded_u8, orig_hw, boxes_norm, out_hw=(32, 320)):
    """OCR line crops: aspect-preserving [out_h,out_w,3] patches (same
    kernel, line grid rule)."""
    from omniparser_tpu_torch.ops.hopper_crop import crop_resize

    return crop_resize(padded_u8, orig_hw, boxes_norm, out_hw, grid="line")
