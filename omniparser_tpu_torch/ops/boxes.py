"""Box geometry as vectorised PyTorch ops.

Conventions: boxes are float tensors [..., 4]; xyxy unless suffixed.
"""

from __future__ import annotations

import torch

# The reference's IoU adds 1e-6 to the union — kept so thresholds bite
# identically near the boundary.
_UNION_EPS = 1e-6


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; negative-extent boxes get their signed product."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def box_xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def box_xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def box_cxcywh_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, w, h], dim=-1)


def pairwise_intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection areas between all pairs: a [N,4], b [M,4] -> [N,M].
    Per-axis overlaps are clamped to 0 independently."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain IoU matrix [N,M] with the reference's +1e-6 union epsilon."""
    inter = pairwise_intersection(a, b)
    return inter / (box_area(a)[:, None] + box_area(b)[None, :] - inter + _UNION_EPS)


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


def int_box_area(boxes: torch.Tensor, w, h) -> torch.Tensor:
    """Pixel area after int-truncating normalised coords (toward zero, as
    Python's int()).  boxes [...,4] normalised xyxy -> int32 area."""
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=boxes.device)
    ib = torch.trunc(boxes.to(torch.float32) * scale).to(torch.int32)
    return (ib[..., 2] - ib[..., 0]) * (ib[..., 3] - ib[..., 1])
