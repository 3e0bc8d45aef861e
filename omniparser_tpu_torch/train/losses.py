"""Detection and caption losses, in float32 over fixed shapes.

Detection follows the YOLOv8 loss family: BCE classification, CIoU box
regression and Distribution Focal Loss on the ltrb bins, with a simplified
center-inside assigner (each anchor is positive for the smallest GT box
containing its center) in place of ultralytics' task-aligned assigner.  It
is a trainable objective of that family, not ultralytics' loss.

The level outputs are the port's ``models/yolov8.YOLOv8`` outputs, NCHW:
per level (box logits [B, 4*REG_MAX, h, w], class logits [B, nc, h, w]).
Boxes are normalised xyxy.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from omniparser_tpu_torch.models.yolov8 import REG_MAX, STRIDES


def _anchor_centers(imgsz: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """All anchor centers (normalised) [A, 2] and per-anchor stride [A],
    level-concatenated, row-major within a level."""
    centers, strides = [], []
    for s in STRIDES:
        n = imgsz // s
        c = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * s / imgsz
        cy, cx = torch.meshgrid(c, c, indexing="ij")
        centers.append(torch.stack([cx.reshape(-1), cy.reshape(-1)], -1))
        strides.append(torch.full((n * n,), float(s), dtype=torch.float32, device=device))
    return torch.cat(centers), torch.cat(strides)


def _ciou(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Complete IoU between matched xyxy boxes [..., 4] -> [...].  The
    aspect term's weight ``alpha`` carries no gradient."""
    eps = 1e-7
    ix1 = torch.maximum(pred[..., 0], gt[..., 0])
    iy1 = torch.maximum(pred[..., 1], gt[..., 1])
    ix2 = torch.minimum(pred[..., 2], gt[..., 2])
    iy2 = torch.minimum(pred[..., 3], gt[..., 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    area_p = (torch.clamp(pred[..., 2] - pred[..., 0], min=0)
              * torch.clamp(pred[..., 3] - pred[..., 1], min=0))
    area_g = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    union = area_p + area_g - inter + eps
    iou = inter / union

    cw = torch.maximum(pred[..., 2], gt[..., 2]) - torch.minimum(pred[..., 0], gt[..., 0])
    ch = torch.maximum(pred[..., 3], gt[..., 3]) - torch.minimum(pred[..., 1], gt[..., 1])
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (((pred[..., 0] + pred[..., 2]) - (gt[..., 0] + gt[..., 2])) ** 2
            + ((pred[..., 1] + pred[..., 3]) - (gt[..., 1] + gt[..., 3])) ** 2) / 4.0
    wp = torch.clamp(pred[..., 2] - pred[..., 0], min=eps)
    hp = torch.clamp(pred[..., 3] - pred[..., 1], min=eps)
    wg = torch.clamp(gt[..., 2] - gt[..., 0], min=eps)
    hg = torch.clamp(gt[..., 3] - gt[..., 1], min=eps)
    v = (4 / math.pi ** 2) * (torch.atan(wg / hg) - torch.atan(wp / hp)) ** 2
    alpha = v / (1 - iou + v + eps)
    return iou - rho2 / c2 - alpha.detach() * v


def detection_loss(
    level_outputs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    gt_boxes: torch.Tensor,  # [B, M, 4] normalised xyxy
    gt_mask: torch.Tensor,  # [B, M] bool
    imgsz: int,
    box_weight: float = 7.5,
    cls_weight: float = 0.5,
    dfl_weight: float = 1.5,
) -> torch.Tensor:
    cls, box, dfl, positive = _detection_terms(level_outputs, gt_boxes, gt_mask, imgsz)
    npos = positive.sum() + 1e-6
    return (box_weight * (box.sum() / npos) + cls_weight * cls.mean()
            + dfl_weight * (dfl.sum() / npos))


def detection_loss_sums(level_outputs, gt_boxes, gt_mask, imgsz: int) -> Dict[str, torch.Tensor]:
    """The sums and counts ``detection_loss`` divides, so that data-parallel
    shards can add theirs before dividing: the BCE sum and element count,
    the CIoU and DFL sums over positives, and the positive count."""
    cls, box, dfl, positive = _detection_terms(level_outputs, gt_boxes, gt_mask, imgsz)
    return {"cls": cls.sum(), "cls_n": torch.full((), float(cls.numel()), device=cls.device),
            "box": box.sum(), "dfl": dfl.sum(), "pos": positive.sum().float()}


def detection_loss_from_sums(sums: Dict[str, torch.Tensor], box_weight: float = 7.5,
                             cls_weight: float = 0.5, dfl_weight: float = 1.5) -> torch.Tensor:
    npos = sums["pos"] + 1e-6
    return (box_weight * (sums["box"] / npos) + cls_weight * (sums["cls"] / sums["cls_n"])
            + dfl_weight * (sums["dfl"] / npos))


def _detection_terms(level_outputs, gt_boxes, gt_mask, imgsz: int):
    """(elementwise class BCE [B,A,nc], 1 - CIoU [B,A] and DFL [B,A] at the
    positive anchors and 0 elsewhere, positive [B,A])."""
    b = gt_boxes.shape[0]
    dev = gt_boxes.device
    centers, stride = _anchor_centers(imgsz, dev)  # [A, 2], [A]
    a = centers.shape[0]
    gt_boxes = gt_boxes.float()

    # flatten predictions over levels, anchors row-major as in NHWC
    box_logits = torch.cat(
        [o[0].float().permute(0, 2, 3, 1).reshape(b, -1, 4, REG_MAX) for o in level_outputs],
        dim=1)  # [B, A, 4, R]
    cls_logits = torch.cat(
        [o[1].float().permute(0, 2, 3, 1).reshape(b, -1, o[1].shape[1]) for o in level_outputs],
        dim=1)  # [B, A, nc]

    # assigner: anchor center inside GT; pick the smallest containing GT
    cx, cy = centers[:, 0], centers[:, 1]
    inside = ((cx[None, :, None] > gt_boxes[:, None, :, 0])
              & (cx[None, :, None] < gt_boxes[:, None, :, 2])
              & (cy[None, :, None] > gt_boxes[:, None, :, 1])
              & (cy[None, :, None] < gt_boxes[:, None, :, 3])
              & gt_mask[:, None, :])  # [B, A, M]
    areas = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])
    cand = torch.where(inside, areas[:, None, :], torch.full_like(areas[:, None, :], math.inf))
    assigned = torch.argmin(cand, dim=-1)  # [B, A]; the first of equal areas
    positive = inside.any(dim=-1)  # [B, A]
    tgt = torch.gather(gt_boxes, 1, assigned[:, :, None].expand(b, a, 4))

    # --- cls BCE (single class: objectness-style) ---
    cls_tgt = positive.float()[..., None].expand_as(cls_logits)
    cls_l = optax_sigmoid_bce(cls_logits, cls_tgt)

    # --- box: CIoU on decoded positives ---
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
    dist = torch.softmax(box_logits, dim=-1) @ bins  # [B, A, 4] in stride units
    dist_n = dist * stride[None, :, None] / imgsz  # normalised units
    pred = torch.stack([cx[None] - dist_n[..., 0], cy[None] - dist_n[..., 1],
                        cx[None] + dist_n[..., 2], cy[None] + dist_n[..., 3]], dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    box_l = torch.where(positive, 1.0 - _ciou(pred, tgt), zero)

    # --- DFL: CE to the two bins adjacent to the target distance ---
    tgt_ltrb = torch.stack([cx[None] - tgt[..., 0], cy[None] - tgt[..., 1],
                            tgt[..., 2] - cx[None], tgt[..., 3] - cy[None]], dim=-1)
    tgt_ltrb = torch.clamp(tgt_ltrb * imgsz / stride[None, :, None], 0, REG_MAX - 1 - 1e-3)
    lo = torch.floor(tgt_ltrb)
    wl = 1.0 - (tgt_ltrb - lo)
    logp = F.log_softmax(box_logits, dim=-1)
    lo_i = lo.long()
    ce_lo = -torch.gather(logp, -1, lo_i[..., None])[..., 0]
    ce_hi = -torch.gather(logp, -1, (lo_i + 1)[..., None])[..., 0]
    dfl = (ce_lo * wl + ce_hi * (1 - wl)).mean(-1)
    dfl_l = torch.where(positive, dfl, zero)
    return cls_l, box_l, dfl_l, positive


def optax_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits, elementwise, in optax's form
    (``optax.sigmoid_binary_cross_entropy``)."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def caption_loss(logits: torch.Tensor, labels: torch.Tensor, pad_id: int = 1) -> torch.Tensor:
    """Teacher-forced CE over non-pad targets: logits [B,T,V], labels [B,T]."""
    nll, n = caption_loss_sums(logits, labels, pad_id)
    return nll / torch.clamp(n, min=1.0)


def caption_loss_sums(logits: torch.Tensor, labels: torch.Tensor, pad_id: int = 1):
    """(the summed NLL of the non-pad targets, their count): what
    ``caption_loss`` divides."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    mask = (labels != pad_id).float()
    return (nll * mask).sum(), mask.sum()
