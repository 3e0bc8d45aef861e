"""Seeded captioner weights, drawn on the device from --seed in a few large
calls and in the dtype each parameter is served in.

The parameter list comes from the reference network (built on the meta
device), whose names are the measured package's, so one state_dict serves
both sides: the program is handed it, and the reference widens the same
values to float32.  The scheme is the measured package's seeded init:
dense matrices normal with std 1/sqrt(fan_in), convolutions sqrt(2/fan_in),
embeddings and bare parameters 0.02, biases zero, norm scales one and
running statistics at their identity."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn as nn

_NORMS = (nn.BatchNorm2d, nn.LayerNorm)


def _plan(module: nn.Module, keep_f32: Sequence[str]):
    """(name, shape, kind, std, float32?) for every entry of the state_dict."""
    out = []
    for mname, m in module.named_modules():
        prefix = mname + "." if mname else ""
        f32 = isinstance(m, _NORMS) or mname in keep_f32
        for pname, p in m.named_parameters(recurse=False):
            if isinstance(m, _NORMS):
                kind, std = ("one" if pname == "weight" else "zero"), 0.0
            elif isinstance(m, (nn.Conv2d, nn.Linear)) and pname == "weight":
                fan_in = p[0].numel()
                gain = math.sqrt(2.0) if isinstance(m, nn.Conv2d) else 1.0
                kind, std = "normal", gain / math.sqrt(fan_in)
            elif pname.endswith("bias"):
                kind, std = "zero", 0.0
            else:  # embeddings and bare parameters
                kind, std = "normal", 0.02
            out.append((prefix + pname, tuple(p.shape), kind, std, f32))
        for bname, b in m.named_buffers(recurse=False):
            kind = "one" if bname == "running_var" else "zero"
            out.append((prefix + bname, tuple(b.shape), kind, 0.0, None))
    return out


@torch.no_grad()
def draw_state(make_module, seed: int, device, dtype: torch.dtype,
               keep_f32: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """state_dict of make_module()'s network from `seed`: one normal draw per
    served dtype, sliced into the parameters."""
    with torch.device("meta"):
        module = make_module()
    plan = _plan(module, keep_f32)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    state: Dict[str, torch.Tensor] = {}
    for f32 in (False, True):
        dt = torch.float32 if f32 else dtype
        rows = [r for r in plan if r[2] == "normal" and r[4] == f32]
        total = sum(math.prod(r[1]) for r in rows)
        flat = torch.randn(total, generator=gen, dtype=dt, device=device) if total else None
        off = 0
        for name, shape, _, std, _ in rows:
            n = math.prod(shape)
            state[name] = flat[off:off + n].view(shape).mul_(std)
            off += n
    for name, shape, kind, _, f32 in plan:
        if kind == "normal":
            continue
        dt = (torch.int64 if name.endswith("num_batches_tracked") else
              torch.float32 if f32 in (True, None) else dtype)
        state[name] = (torch.ones if kind == "one" else torch.zeros)(shape, dtype=dt,
                                                                     device=device)
    return state
