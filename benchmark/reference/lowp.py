"""The control's lower precision: float8 (e4m3) products, emulated.

Every dense and convolution layer of a reference network multiplies
float8 values: its weight and its input are scaled per tensor so that the
largest magnitude sits at float8's largest (448), rounded to float8 and
scaled back; the product itself accumulates in float32.  This is the step
from the configuration's bfloat16 that would tempt a later change."""

from __future__ import annotations

import torch
import torch.nn as nn

F8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in x's dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / F8_MAX, torch.ones_like(amax))
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


@torch.no_grad()
def to_fp8_products(module: nn.Module) -> nn.Module:
    """Round every Linear and Conv2d weight to float8 in place, and round
    their inputs on the way in."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.copy_(fp8_round(m.weight))
            m.register_forward_pre_hook(lambda mod, args: (fp8_round(args[0]),) + args[1:])
    return module


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)
