"""OCR training objectives: the text detector's shrink-map loss and CTC."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def balanced_bce_dice_loss(
    prob_map: torch.Tensor,  # [B, 1, H, W] sigmoid outputs (models/ocr.TextDetector)
    target: torch.Tensor,  # [B, H, W] {0,1}
    neg_ratio: float = 3.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """DBNet-family shrink-map loss: hard-negative-weighted BCE + dice.

    A fixed-shape soft OHEM: negatives are weighted by their probability,
    normalised so that they weigh about ``neg_ratio`` times the positive
    count, in place of a top-k selection."""
    p = prob_map[:, 0].float()
    t = target.float()
    bce = -(t * torch.log(p + eps) + (1 - t) * torch.log(1 - p + eps))

    n_pos = t.sum() + eps
    neg_weight = torch.where(t == 0, p, torch.zeros_like(p))
    neg_weight = neg_weight / (neg_weight.sum() + eps) * neg_ratio * n_pos
    weights = t + neg_weight
    bce_l = (bce * weights).sum() / (weights.sum() + eps)

    inter = (p * t).sum()
    dice_l = 1.0 - 2.0 * inter / (p.sum() + t.sum() + eps)
    return bce_l + dice_l


def ctc_loss(
    logits: torch.Tensor,  # [B, T, C] (blank = class 0)
    labels: torch.Tensor,  # [B, L] int, 0-padded at the end
) -> torch.Tensor:
    """Mean CTC negative log likelihood over the batch, as
    ``optax.ctc_loss(...).mean()``: each sequence's NLL summed, divided by
    B (not also by its label length, as ``F.ctc_loss``'s 'mean' would).
    Blank id 0 (``models/ocr.CHARSET``'s layout); a label's length counts
    its non-zero ids, as optax's 0-label padding does."""
    b, t, _ = logits.shape
    logp = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # [T, B, C]
    labels = labels.long()
    target_lengths = (labels != 0).sum(dim=1)
    input_lengths = torch.full((b,), t, dtype=torch.long, device=logits.device)
    per_seq = F.ctc_loss(logp, labels, input_lengths, target_lengths, blank=0,
                         reduction="none")
    return per_seq.mean()
