"""Fixed-shape greedy NMS.

Sort once by score, compute the greedy keep mask over the sorted slots
(the hand-written kernel on the card, its plain version on the CPU), then
compact the first ``max_out`` survivors to the front.  Exact greedy
semantics (torchvision's keep set), static output shapes.
"""

from __future__ import annotations

import torch

from omniparser_tpu_torch.ops.hopper_kernels import nms_keep


def nms_fixed_shape(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float, max_out: int):
    """Greedy NMS over fixed slots.

    Args:
      boxes: [N, 4] xyxy (any scale).
      scores: [N] confidences.
      valid: [N] bool — padding slots must be False.
      iou_threshold: suppress j if IoU(i, j) > threshold for a kept,
        higher-scoring i (strict >, matching torchvision).
      max_out: output slot count.

    Returns:
      (boxes [max_out,4], scores [max_out], indices [max_out] int32 into the
       input, keep_valid [max_out] bool), score-sorted descending, padded
       with zeros.  The keep mask is the full greedy mask; its first
       max_out survivors are exactly what max_out select-max steps keep.
    """
    dev = boxes.device
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype, device=dev)
    masked_scores = torch.where(valid, scores, neg_inf)
    # stable: equal scores keep their input order, lower index first
    sorted_scores, order = torch.sort(masked_scores, descending=True, stable=True)
    sboxes = boxes[order].to(torch.float32).contiguous()
    svalid = valid[order].contiguous()

    keep = nms_keep(sboxes, svalid, iou_threshold)

    # compact the kept slots to the front (score order preserved); dropped
    # slots and survivors beyond max_out go to a spare last slot that is cut
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    dest = torch.where(keep & (rank < max_out), rank,
                       torch.full_like(rank, max_out))
    out_boxes = torch.zeros((max_out + 1, 4), dtype=boxes.dtype, device=dev)
    out_boxes[dest] = boxes[order]
    out_scores = torch.zeros((max_out + 1,), dtype=scores.dtype, device=dev)
    out_scores[dest] = sorted_scores
    out_idx = torch.zeros((max_out + 1,), dtype=torch.int32, device=dev)
    out_idx[dest] = order.to(torch.int32)
    out_valid = torch.zeros((max_out + 1,), dtype=torch.bool, device=dev)
    out_valid[dest] = keep
    return (out_boxes[:max_out], out_scores[:max_out], out_idx[:max_out],
            out_valid[:max_out])
