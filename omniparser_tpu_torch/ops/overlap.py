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

So the pass is three matrices and a few reductions, all in one kernel
launch on the card (``hopper_kernels.merge_masks``; the plain version
beside it is ``merge_masks_plain``); only the string concatenation
happens on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from omniparser_tpu_torch.ops.hopper_kernels import merge_masks


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
    return OverlapResult(*merge_masks(
        icon_boxes.to(torch.float32).contiguous(), icon_valid.contiguous(),
        ocr_boxes.to(torch.float32).contiguous(), ocr_valid.contiguous(), iou_threshold))
