"""Vectorised overlap suppression + OCR/icon merge.

The reference's ``remove_overlap_new`` looks order-dependent, but its
decisions are geometric:

  * an icon is suppressed iff some other icon has max-overlap-ratio >
    iou_threshold and strictly smaller area;
  * for a surviving icon, OCR boxes are scanned in their original order:
    an OCR box more than 80% inside the icon donates its text to the icon
    and is removed from the output; the first OCR box that contains the
    icon by more than 80% kills the icon and stops the scan, so only OCR
    boxes before that stop index donate text.

So the pass is three matrices (one kernel launch on the card) and a few
reductions; only the string concatenation happens on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from omniparser_tpu_torch.ops.boxes import box_area
from omniparser_tpu_torch.ops.hopper_kernels import overlap_matrices


class OverlapResult(NamedTuple):
    """Masks describing the merged element set (all fixed-shape).

    icon_keep:  [N] bool — icon survives suppression and is not inside OCR.
    ocr_keep:   [M] bool — OCR box is valid and was not absorbed by an icon.
    absorb:     [N, M] bool — absorb[i, k]: OCR k's text joins icon i's
                content (in ascending-k order).
    icon_suppressed: [N] bool — dropped by the icon-vs-icon rule.
    """

    icon_keep: torch.Tensor
    ocr_keep: torch.Tensor
    absorb: torch.Tensor
    icon_suppressed: torch.Tensor


def merge_icons_and_ocr(icon_boxes: torch.Tensor, icon_valid: torch.Tensor,
                        ocr_boxes: torch.Tensor, ocr_valid: torch.Tensor,
                        iou_threshold: float) -> OverlapResult:
    """Fixed-shape merge of icon detections with OCR text boxes.

    icon_boxes [N,4] normalised xyxy, icon_valid [N] bool (padding False);
    ocr_boxes [M,4], ocr_valid [M]; iou_threshold: icon-vs-icon
    suppression threshold (server: 0.7).
    """
    n = icon_boxes.shape[0]
    m = ocr_boxes.shape[0]
    dev = icon_boxes.device
    icon_boxes = icon_boxes.to(torch.float32).contiguous()
    ocr_boxes = ocr_boxes.to(torch.float32).contiguous()

    ratio, a_geom, b_geom = overlap_matrices(icon_boxes, ocr_boxes)
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
    return OverlapResult(icon_keep, ocr_keep, absorb, icon_suppressed)
