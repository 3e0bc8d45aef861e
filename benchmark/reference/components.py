"""The OCR text detector's postprocess, plain: the probability map rounded
to the uint8 grid, 4-connected components of (map > 0.3), each with its box,
area and mean probability, the components in raster order of their first
pixel, then the line candidates: unclip, unmap from the letterbox and the
size gate, in the candidate slots the pipeline ships.

Labelling joins the masked runs of each row with the overlapping runs of
the row above (a union-find over runs), so it is independent of how the
measured program labels pixels.  Sums of map values are taken in float64:
the values are multiples of 1/255 in float32, and every such sum over a
frame is exact there, so the order of summation cannot matter."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

BIN_THRESHOLD = 0.3
MIN_SCORE = 0.3
MIN_AREA = 4
MAX_COMPONENTS = 1024   # raw components kept, and filtered components kept
SCALE = 2               # the text detector's output stride
UNCLIP = 2.0


def quantized_map(raw: torch.Tensor) -> np.ndarray:
    """The text detector's output [1, 1, H, W] -> [H, W] float32 on the
    uint8 grid (k / 255), as the thresholds see it."""
    p = torch.clamp(raw[0, 0].float(), 0.0, 1.0)
    return (torch.floor(p * 255.0 + 0.5) / 255.0).cpu().numpy()


def _row_runs(row: np.ndarray):
    """[(x0, x1)] of the masked runs of one row, x1 exclusive."""
    edges = np.diff(np.concatenate([[False], row, [False]]).astype(np.int8))
    return list(zip(np.nonzero(edges == 1)[0].tolist(), np.nonzero(edges == -1)[0].tolist()))


def components(prob: np.ndarray) -> Dict[str, np.ndarray]:
    """Filtered components of `prob` [H, W] float32: boxes [C, 4] int
    (xyxy, x2 and y2 exclusive) and scores [C] float32, in raster order of
    each component's first pixel; the first MAX_COMPONENTS raw components
    only, then at most MAX_COMPONENTS filtered ones."""
    h, w = prob.shape
    mask = prob > np.float32(BIN_THRESHOLD)
    csum = np.concatenate([np.zeros((h, 1)), np.cumsum(prob.astype(np.float64), axis=1)],
                          axis=1)
    runs = []          # (y, x0, x1)
    parent = []

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    prev = []          # (x0, x1, run id) of the row above
    for y in range(h):
        if not mask[y].any():
            prev = []
            continue
        cur = []
        j = 0
        for x0, x1 in _row_runs(mask[y]):
            rid = len(runs)
            runs.append((y, x0, x1))
            parent.append(rid)
            while j < len(prev) and prev[j][1] <= x0:
                j += 1
            k = j
            while k < len(prev) and prev[k][0] < x1:   # 4-connected: columns overlap
                a, b = find(rid), find(prev[k][2])
                if a != b:
                    parent[max(a, b)] = min(a, b)
                k += 1
            cur.append((x0, x1, rid))
        prev = cur
    stats: Dict[int, list] = {}    # root -> [first pixel, x1, y1, x2, y2, area, sum]
    for rid, (y, x0, x1) in enumerate(runs):
        r = find(rid)
        s = stats.get(r)
        part = csum[y, x1] - csum[y, x0]
        if s is None:
            stats[r] = [y * w + x0, x0, y, x1, y + 1, x1 - x0, part]
        else:
            s[0] = min(s[0], y * w + x0)
            s[1], s[2] = min(s[1], x0), min(s[2], y)
            s[3], s[4] = max(s[3], x1), max(s[4], y + 1)
            s[5] += x1 - x0
            s[6] += part
    ordered = sorted(stats.values(), key=lambda s: s[0])[:MAX_COMPONENTS]
    boxes, scores = [], []
    for _, x1, y1, x2, y2, area, psum in ordered:
        score = np.float32(psum) / np.float32(area)
        if area >= MIN_AREA and score >= np.float32(MIN_SCORE):
            boxes.append((x1, y1, x2, y2))
            scores.append(score)
    boxes, scores = boxes[:MAX_COMPONENTS], scores[:MAX_COMPONENTS]
    return {"boxes": np.asarray(boxes, np.int64).reshape(-1, 4),
            "scores": np.asarray(scores, np.float32)}


def candidates(boxes: np.ndarray, hw: Tuple[int, int], det_imgsz: int, max_boxes: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Component boxes at map scale -> the candidate slots: (boxes [M, 4]
    float32 normalised by the frame, zero where not valid; valid [M]),
    M = max_boxes.  The letterbox's ratio and pads are taken in double and
    rounded to float32, the rest is float32 arithmetic."""
    f = np.float32
    uh, uw = int(hw[0]), int(hw[1])
    r = min(det_imgsz / uh, det_imgsz / uw)
    r32, py, px = f(r), f((det_imgsz - uh * r) / 2.0), f((det_imgsz - uw * r) / 2.0)
    fh, fw = f(uh), f(uw)
    out = np.zeros((max_boxes, 4), np.float32)
    valid = np.zeros(max_boxes, bool)
    b = boxes[:max_boxes].astype(np.float32)
    if not len(b):
        return out, valid
    margin = f((UNCLIP - 1.0) * 0.5) * np.minimum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1])
    s = f(SCALE)
    x1 = np.round((b[:, 0] - margin) * s)
    y1 = np.round((b[:, 1] - margin) * s)
    x2 = np.round((b[:, 2] + margin) * s)
    y2 = np.round((b[:, 3] + margin) * s)
    bx1 = np.maximum((x1 - px) / r32, f(0.0))
    by1 = np.maximum((y1 - py) / r32, f(0.0))
    bx2 = np.minimum((x2 - px) / r32, fw)
    by2 = np.minimum((y2 - py) / r32, fh)
    ok = (bx2 - bx1 >= f(1.0)) & (by2 - by1 >= f(1.0))
    ib = np.floor(np.stack([bx1, by1, bx2, by2], axis=1))
    n = len(b)
    out[:n] = np.where(ok[:, None], ib / np.stack([fw, fh, fw, fh]), f(0.0))
    valid[:n] = ok
    return out, valid
