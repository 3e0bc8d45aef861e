"""Box geometry, fixed-shape NMS and the OCR/icon merge, on torch tensors:
the JAX package's ``ops`` names.  Importing builds and loads nothing for
the card: the kernels behind ``nms_fixed_shape`` and
``merge_icons_and_ocr`` are built at their first launch."""

from omniparser_tpu_torch.ops.boxes import (
    box_area,
    box_cxcywh_to_xyxy,
    box_xyxy_to_cxcywh,
    box_xyxy_to_xywh,
    box_xywh_to_xyxy,
    pairwise_intersection,
    pairwise_iou,
    pairwise_max_overlap_ratio,
    int_box_area,
)
from omniparser_tpu_torch.ops.nms import nms_fixed_shape
from omniparser_tpu_torch.ops.overlap import merge_icons_and_ocr, OverlapResult

__all__ = [
    "box_area",
    "box_cxcywh_to_xyxy",
    "box_xyxy_to_cxcywh",
    "box_xyxy_to_xywh",
    "box_xywh_to_xyxy",
    "pairwise_intersection",
    "pairwise_iou",
    "pairwise_max_overlap_ratio",
    "int_box_area",
    "nms_fixed_shape",
    "merge_icons_and_ocr",
    "OverlapResult",
]
