"""The device an entry point runs on: the card unless the caller asks for
the CPU, and an error, not the CPU, where the card is missing."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def float32_region(t: torch.Tensor):
    """A context in which autocast is off on `t`'s device: the float32
    heads (the JAX modules' ``dtype=float32`` layers) stay float32 when a
    trainer runs the network under bfloat16 autocast.  Without autocast it
    changes nothing."""
    return torch.autocast(t.device.type, enabled=False)
