"""Seeded initialisation and dtype placement for the package's networks."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

_NORMS = (nn.BatchNorm2d, nn.LayerNorm)


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Initialise every parameter from an explicit generator: matrices
    normal with std 1/sqrt(fan_in), convolutions (each is followed by a
    ReLU or SiLU) with std sqrt(2/fan_in), embeddings and bare parameters
    normal with std 0.02, biases zero, norm scales one and running
    statistics at their identity."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def normal_(p, std):  # drawn on the generator's device
        p.copy_(torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=generator.device) * std)

    seen = set()
    for m in module.modules():
        if isinstance(m, _NORMS):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            normal_(m.weight, (math.sqrt(2.0) if isinstance(m, nn.Conv2d) else 1.0) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 0.02)
        else:
            continue
        seen.update(id(p) for p in m.parameters(recurse=False))
    for name, p in module.named_parameters():
        if id(p) in seen:
            continue
        if name.endswith("bias"):
            p.zero_()
        else:
            normal_(p, 0.02)
    return module


def cast_compute_dtype(module: nn.Module, dtype: torch.dtype,
                       keep_f32: Sequence[str] = ()) -> nn.Module:
    """Cast parameters to `dtype`, except the norm layers (computed in
    float32) and the modules named in `keep_f32` (dotted paths; their own
    parameters, not their children's, stay float32: float32 heads).
    Modules that keep int8 weights in buffers (``models.quant.QLinear``)
    are not cast; their ``compute_dtype`` becomes `dtype`."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    if dtype == torch.float32:
        return module
    for name, m in module.named_modules():
        if isinstance(m, _NORMS) or name in keep_f32:
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


def to_tensor_state(state: Dict) -> Dict[str, torch.Tensor]:
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in state.items()}


def build_module(module: nn.Module, state: Optional[Dict], generator, dtype: torch.dtype,
                 device, keep_f32: Sequence[str] = ()) -> nn.Module:
    """Load `state` (strictly) or initialise from the generator, then place
    the module: compute dtype, device, eval mode."""
    if state is not None:
        res = module.load_state_dict(to_tensor_state(state), strict=False)
        missing = [k for k in res.missing_keys if not k.endswith("num_batches_tracked")]
        if missing or res.unexpected_keys:
            raise KeyError(f"state_dict mismatch: missing {missing[:8]}, "
                           f"unexpected {list(res.unexpected_keys)[:8]}")
    else:
        seeded_init_(module, generator)
    cast_compute_dtype(module, dtype, keep_f32)
    return module.to(device).eval()
