"""Pieces the reference networks share: float32 norms, XLA 'SAME' padding
and an eval-mode BatchNorm with the flax epsilon."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)


def layer_norm_f32(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm over the last dim computed in float32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


def float32_region(t: torch.Tensor):
    """A context with autocast off on `t`'s device."""
    return torch.autocast(t.device.type, enabled=False)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad H and W as XLA's 'SAME' does: total = max((ceil(n/s)-1)*s +
    k - n, 0), the smaller half first."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad takes the last dim first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with flax's epsilon, used in eval mode only."""

    def __init__(self, features: int, eps: float = 1e-5, flax_momentum: float = 0.99):
        super().__init__(features, eps=eps, momentum=1.0 - flax_momentum)
