"""The plain geometry of the parse, as the measured package states it in its
plain PyTorch versions (frozen copies): letterbox resampling, the map back
to image pixels, the crop-gather grids (caption crops and OCR lines),
greedy NMS and the icon/OCR merge.  Every float that decides a pixel or a
keep decision is float32, in the same operation order, so that the
program's kernels are held to these bit for bit where the comparison is
exact."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

LETTERBOX_FILL = 114.0
_INSIDE_THRESHOLD = 0.80
_UNION_EPS = 1e-6


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


def bilinear_crops_plain(padded_u8, orig_hw, boxes_norm, out_size=64, grid: str = "resize"):
    """Plain PyTorch crop-gather: N normalised-xyxy boxes -> N
    [out_h,out_w,3] float32 patches in [0,255].  Integer crop bounds by
    truncation, half-pixel-centre bilinear sampling, edge clamp inside the
    crop.  grid='resize' stretches the box to the patch; grid='line'
    keeps the aspect ratio (see line_grid)."""
    make = resize_grid if grid == "resize" else line_grid
    xs, ys = make(boxes_norm, orig_hw, _out_hw(out_size))
    return _bilinear_gather(padded_u8, xs, ys)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; negative-extent boxes get their signed product."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection areas between all pairs: a [N,4], b [M,4] -> [N,M].
    Per-axis overlaps are clamped to 0 independently."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_max_overlap_ratio(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's asymmetric "IoU": max(iou, inter/area_a, inter/area_b);
    the containment ratios only apply when both areas are > 0.  [N,M]."""
    inter = pairwise_intersection(a, b)
    area_a = box_area(a)[:, None]
    area_b = box_area(b)[None, :]
    iou = inter / (area_a + area_b - inter + _UNION_EPS)
    both_pos = (area_a > 0) & (area_b > 0)
    zero = torch.zeros((), dtype=inter.dtype, device=inter.device)
    one = torch.ones((), dtype=inter.dtype, device=inter.device)
    ratio_a = torch.where(both_pos, inter / torch.where(area_a == 0, one, area_a), zero)
    ratio_b = torch.where(both_pos, inter / torch.where(area_b == 0, one, area_b), zero)
    return torch.maximum(iou, torch.maximum(ratio_a, ratio_b))


def containment_ratio(inner: torch.Tensor, outer: torch.Tensor) -> torch.Tensor:
    """inter(inner_i, outer_j) / area(inner_i) -> [N,M]; zero-area inner
    boxes get ratio 0."""
    inter = pairwise_intersection(inner, outer)
    area = box_area(inner)[:, None]
    zero = torch.zeros((), dtype=inter.dtype, device=inter.device)
    one = torch.ones((), dtype=inter.dtype, device=inter.device)
    return torch.where(area > 0, inter / torch.where(area == 0, one, area), zero)


def plain_pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """Symmetric IoU without the containment ratios (torchvision semantics):
    0 where the union is 0."""
    inter = pairwise_intersection(boxes, boxes)
    area = box_area(boxes)
    union = area[:, None] + area[None, :] - inter
    one = torch.ones((), dtype=union.dtype, device=union.device)
    zero = torch.zeros((), dtype=union.dtype, device=union.device)
    return torch.where(union > 0, inter / torch.where(union == 0, one, union), zero)


def greedy_nms_plain(sorted_boxes: torch.Tensor, sorted_valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch greedy NMS keep mask over score-sorted boxes: if box i
    survives, every later box j with IoU(i, j) > threshold is dropped.
    Returns the FULL keep mask [N] bool."""
    n = sorted_boxes.shape[0]
    over = plain_pairwise_iou(sorted_boxes) > iou_threshold
    over = torch.triu(over, diagonal=1)  # only later boxes
    keep = sorted_valid.clone()
    for i in range(n):
        # no host read of keep[i]: the row is applied under its condition
        keep = keep & ~(over[i] & keep[i])
    return keep


def overlap_matrices_plain(icon_boxes: torch.Tensor, ocr_boxes: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch (ratio [N,N] f32, a [N,M] bool, b [N,M] bool):
    ratio = max-overlap ratio between icons; a[i,k]: OCR k sits more than
    0.80 inside icon i; b[i,k]: icon i sits more than 0.80 inside OCR k."""
    ratio = pairwise_max_overlap_ratio(icon_boxes, icon_boxes)
    a = containment_ratio(ocr_boxes, icon_boxes).T > _INSIDE_THRESHOLD
    b = containment_ratio(icon_boxes, ocr_boxes) > _INSIDE_THRESHOLD
    return ratio, a, b


def merge_masks_plain(icon_boxes: torch.Tensor, icon_valid: torch.Tensor,
                      ocr_boxes: torch.Tensor, ocr_valid: torch.Tensor,
                      iou_threshold: float) :
    """Plain PyTorch merge decision -> (icon_keep [N], ocr_keep [M],
    absorb [N,M], icon_suppressed [N]), all bool.  See ops/overlap.py for
    the rules."""
    n = icon_boxes.shape[0]
    m = ocr_boxes.shape[0]
    dev = icon_boxes.device

    ratio, a_geom, b_geom = overlap_matrices_plain(icon_boxes, ocr_boxes)
    a = a_geom & ocr_valid[None, :]
    b = b_geom & ocr_valid[None, :]

    # --- icon-vs-icon suppression (keep the smaller box) ---
    area = box_area(icon_boxes)
    not_self = ~torch.eye(n, dtype=torch.bool, device=dev)
    bigger = area[:, None] > area[None, :]
    suppressed_by = not_self & icon_valid[None, :] & (ratio > iou_threshold) & bigger
    icon_suppressed = suppressed_by.any(dim=1) & icon_valid
    icon_pass = icon_valid & ~icon_suppressed

    # the reference's elif only fires when the `a` branch didn't
    b = b & ~a

    ks = torch.arange(m, device=dev)
    any_b = b.any(dim=1)
    first_b = torch.argmax(b.to(torch.int8), dim=1)  # first True (lowest index)
    k_stop = torch.where(any_b, first_b, torch.full_like(first_b, m))

    absorb = icon_pass[:, None] & a & (ks[None, :] < k_stop[:, None])
    ocr_removed = absorb.any(dim=0)

    icon_keep = icon_pass & ~any_b
    ocr_keep = ocr_valid & ~ocr_removed
    return icon_keep, ocr_keep, absorb, icon_suppressed
