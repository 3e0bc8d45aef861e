"""Set-of-Mark (SOM) overlay renderer.

Host-side drawing reproducing the reference's annotator behavior
(util/box_annotator.py:10-262 + util/utils.py:326-354): per-box palette
color, numeric labels, luminance-chosen text color, and the four-candidate
overlap-avoiding label placement (top-left -> outer-left -> outer-right ->
top-right, rejecting candidates with IoU > 0.3 against any detection or
out-of-image).

Drawing is cv2 (C++), deliberately host work as in the reference.  cv2 is
imported inside ``annotate_som``, the one function that draws, so that the
package imports and parses without it; label placement is numpy only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Distinct default palette (role equivalent to supervision's
# ColorPalette.DEFAULT — values are our own; pass `palette=` for custom).
DEFAULT_PALETTE: Tuple[str, ...] = (
    "#e6194b", "#3cb44b", "#ffe119", "#4363d8", "#f58231",
    "#911eb4", "#46f0f0", "#f032e6", "#bcf60c", "#fabebe",
    "#008080", "#e6beff", "#9a6324", "#fffac8", "#800000",
    "#aaffc3", "#808000", "#ffd8b1", "#000075", "#808080",
)

_LABEL_IOU_REJECT = 0.3  # util/box_annotator.py:199


def _hex_to_rgb(h: str) -> Tuple[int, int, int]:
    h = h.lstrip("#")
    return tuple(int(h[i : i + 2], 16) for i in (0, 2, 4))


def place_labels_batch(
    pad: int,
    tws: np.ndarray,
    ths: np.ndarray,
    boxes: np.ndarray,
    image_wh: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each box pick the first of the reference's four label candidates
    (top-left, outer-left, outer-right, top-right:
    util/box_annotator.py:207-262) that stays in-image and has
    max(iou, inter/area) <= 0.3 against EVERY detection; fall back to the
    last candidate.  One [N,4,N] broadcast for all boxes at once.

    tws/ths: [N] int text sizes.  boxes: [N,4] int xyxy (the detections are
    also the obstacle set, matching the reference — labels do not avoid
    other labels).  Returns (tx [N], ty [N], bg [N,4]) int arrays.
    """
    n = len(boxes)
    if n == 0:
        z = np.zeros((0,), int)
        return z, z, np.zeros((0, 4), int)
    W, H = image_wh
    x1, y1, x2 = boxes[:, 0], boxes[:, 1], boxes[:, 2]
    tw, th = tws, ths
    p = pad
    # candidate text anchors and bg boxes, [N, 4] each (c axis = priority)
    tx = np.stack([x1 + p, x1 - p - tw, x2 + p, x2 - p - tw], 1)
    ty = np.stack([y1 - p, y1 + p + th, y1 + p + th, y1 - p], 1)
    bg = np.stack([
        np.stack([x1, y1 - 2 * p - th, x1 + 2 * p + tw, y1], 1),      # top left
        np.stack([x1 - 2 * p - tw, y1, x1, y1 + 2 * p + th], 1),      # outer left
        np.stack([x2, y1, x2 + 2 * p + tw, y1 + 2 * p + th], 1),      # outer right
        np.stack([x2 - 2 * p - tw, y1 - 2 * p - th, x2, y1], 1),      # top right
    ], 1)  # [N, 4c, 4]
    in_img = (bg[:, :, 0] >= 0) & (bg[:, :, 1] >= 0) \
        & (bg[:, :, 2] <= W) & (bg[:, :, 3] <= H)
    # overlap score of every candidate bg against every detection, [N,4c,N]
    b = bg[:, :, None, :].astype(np.float64)
    d = boxes[None, None, :, :].astype(np.float64)
    iw = np.minimum(b[..., 2], d[..., 2]) - np.maximum(b[..., 0], d[..., 0])
    ih = np.minimum(b[..., 3], d[..., 3]) - np.maximum(b[..., 1], d[..., 1])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_bg = (bg[:, :, 2] - bg[:, :, 0]) * (bg[:, :, 3] - bg[:, :, 1])
    area_bg = area_bg[:, :, None].astype(np.float64)
    area_d = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
    area_d = area_d[None, None, :].astype(np.float64)
    union = area_bg + area_d - inter
    iou = np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)
    both = (area_bg > 0) & (area_d > 0)
    score = np.where(
        both,
        np.maximum(iou, np.maximum(
            inter / np.where(area_bg > 0, area_bg, 1.0),
            inter / np.where(area_d > 0, area_d, 1.0))),
        iou,
    )
    ok = in_img & ~(score > _LABEL_IOU_REJECT).any(-1)      # [N, 4c]
    # first accepted candidate, else the last one iterated (c=3)
    pick = np.where(ok.any(1), ok.argmax(1), 3)
    rows = np.arange(n)
    return tx[rows, pick], ty[rows, pick], bg[rows, pick]


def annotate_som(
    image_rgb: np.ndarray,
    boxes_xyxy_px: np.ndarray,
    labels: Optional[Sequence[str]] = None,
    text_scale: float = 0.4,
    text_thickness: int = 2,
    text_padding: int = 5,
    thickness: int = 3,
    palette: Sequence[str] = DEFAULT_PALETTE,
) -> np.ndarray:
    """Draw numbered boxes with overlap-avoiding labels; returns a copy.

    boxes_xyxy_px: [N, 4] pixel xyxy.  labels default to "0".."N-1"
    (the reference labels by index: util/utils.py:347).
    """
    import cv2

    scene = image_rgb.copy()
    H, W = scene.shape[:2]
    font = cv2.FONT_HERSHEY_SIMPLEX
    boxes = boxes_xyxy_px.astype(int)
    if labels is None:
        labels = [str(i) for i in range(len(boxes))]

    # text sizes, cached by string (labels are short index strings — a
    # handful of distinct getTextSize calls instead of N)
    size_cache: Dict[str, Tuple[int, int]] = {}
    for t in labels:
        if t not in size_cache:
            size_cache[t] = cv2.getTextSize(t, font, text_scale, text_thickness)[0]
    tws = np.array([size_cache[t][0] for t in labels], int)
    ths = np.array([size_cache[t][1] for t in labels], int)
    txs, tys, bgs = place_labels_batch(text_padding, tws, ths, boxes, (W, H))

    for i, (x1, y1, x2, y2) in enumerate(boxes):
        color = _hex_to_rgb(palette[i % len(palette)])
        cv2.rectangle(scene, (int(x1), int(y1)), (int(x2), int(y2)), color, thickness)
        bg = bgs[i]
        cv2.rectangle(scene, (int(bg[0]), int(bg[1])), (int(bg[2]), int(bg[3])),
                      color, cv2.FILLED)
        # text color by background luminance (util/box_annotator.py:148-150)
        lum = 0.299 * color[0] + 0.587 * color[1] + 0.114 * color[2]
        text_color = (0, 0, 0) if lum > 160 else (255, 255, 255)
        cv2.putText(scene, labels[i], (int(txs[i]), int(tys[i])), font, text_scale,
                    text_color, text_thickness, cv2.LINE_AA)
    return scene


def annotate(
    image_rgb: np.ndarray,
    boxes_cxcywh_norm: np.ndarray,
    *,
    text_scale: float = 0.4,
    text_thickness: int = 2,
    text_padding: int = 5,
    thickness: int = 3,
) -> Tuple[np.ndarray, Dict[str, List[float]]]:
    """The reference's annotate() wrapper (util/utils.py:326-354):
    normalized cxcywh -> pixel xyxy/xywh; returns (annotated image,
    label_coordinates {index_str: [x, y, w, h] pixels})."""
    h, w = image_rgb.shape[:2]
    scale = np.array([w, h, w, h], np.float32)
    b = boxes_cxcywh_norm.astype(np.float32) * scale
    xyxy = np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                     b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], axis=1)
    xywh = np.stack([xyxy[:, 0], xyxy[:, 1], b[:, 2], b[:, 3]], axis=1)
    scene = annotate_som(
        image_rgb, xyxy,
        text_scale=text_scale, text_thickness=text_thickness,
        text_padding=text_padding, thickness=thickness,
    )
    label_coordinates = {str(i): [float(v) for v in xywh[i]] for i in range(len(xywh))}
    return scene, label_coordinates
