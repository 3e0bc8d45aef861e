"""BatchNorm with flax's training arithmetic.

``nn.BatchNorm2d`` and flax's ``nn.BatchNorm`` normalise a batch alike in
eval mode, but differ in train mode in what they store:

  * flax's ``momentum`` weighs the old statistic (0.99 by default, 0.97 in
    YOLOv8's block); PyTorch's weighs the new one: PyTorch momentum is
    ``1 - flax_momentum``;
  * flax stores the biased batch variance; PyTorch the unbiased one
    (n / (n - 1) larger).

``FlaxBatchNorm2d`` keeps ``nn.BatchNorm2d``'s parameters, buffers and
state-dict keys (so ``weights/convert.py`` and every checkpoint still map)
and, in train mode, computes what flax computes: statistics in float32 with
flax's fast variance ``max(E[x^2] - E[x]^2, 0)``, the batch normalised with
it, and both running statistics updated with flax's momentum.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` over NCHW whose train mode is flax's.

    flax_momentum: flax's ``momentum`` (the old statistic's weight);
    eps: flax's ``epsilon``."""

    def __init__(self, features: int, eps: float = 1e-5, flax_momentum: float = 0.99):
        super().__init__(features, eps=eps, momentum=1.0 - flax_momentum)
        self.flax_momentum = flax_momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x = x.float()
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean.detach() * (1.0 - m))
            self.running_var.mul_(m).add_(var.detach() * (1.0 - m))
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x - mean[None, :, None, None]) * mul[None, :, None, None]
        return y + self.bias.float()[None, :, None, None]
