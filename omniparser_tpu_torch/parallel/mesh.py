"""A ('dp', 'tp') grid of torch devices, and how tensors and parameters lie
on it.

One process drives the whole grid, as one JAX process drives a mesh:
'dp' splits the batch (screenshots, crops, training examples) into
contiguous shards, one a row; 'tp' splits the captioner's large parameters
over a row's devices.  A device may appear more than once in the grid (a
virtual mesh, like JAX's ``--xla_force_host_platform_device_count`` on the
CPU): the CPU tests build ``make_mesh(['cpu'] * 8, dp=4, tp=2)``, and one
card runs ``make_mesh([cuda:0] * 4, dp=2, tp=2)``.  Modules are copied once
per distinct device, never once per shard.

Tensor parallelism here is gather-on-use: a split parameter rests as tp
shards on its row's devices, and a parametrization concatenates them on
the row's compute device (its first) each time the module reads it, so
every output is the unsplit computation bit for bit and gradients reach
each shard through autograd.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.nn.utils import parametrize

from omniparser_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """devices: [dp, tp] object array of torch.device."""

    devices: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.devices.shape[0], "tp": self.devices.shape[1]}

    def row_device(self, row: int) -> torch.device:
        """Where row `row` computes: its first device."""
        return self.devices[row, 0]


def make_mesh(devices: Optional[Sequence] = None, dp: Optional[int] = None,
              tp: int = 1) -> Mesh:
    """A ('dp', 'tp') mesh over `devices` (default: every visible CUDA
    device; without one this raises: there is no CPU default).  A device
    may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices "
                               "(['cpu'] * n for a mesh on the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    devs = [torch.device(d.type, torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    n = len(devs)
    if dp is None:
        dp = n // tp
    if dp < 1 or tp < 1 or dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    grid = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devs):
        grid[i // tp, i % tp] = d
    return Mesh(grid)


class Sharding:
    """How a tensor lies on a mesh: split along dim 0 into dp contiguous
    shards, one on each row's compute device (`batch`), or whole on every
    row (replicated; one copy a distinct device)."""

    def __init__(self, mesh: Mesh, batch: bool):
        self.mesh, self.batch = mesh, batch

    def shard(self, x) -> List[torch.Tensor]:
        """A tensor or numpy array -> one tensor a dp row.  A host array is
        uploaded once, to the first row's device."""
        m = self.mesh
        rows = range(m.shape["dp"])
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x)).to(m.row_device(0))
        if not self.batch:
            copies = {}
            for i in rows:
                if m.row_device(i) not in copies:
                    copies[m.row_device(i)] = x.to(m.row_device(i))
            return [copies[m.row_device(i)] for i in rows]
        dp = m.shape["dp"]
        if x.shape[0] % dp:
            raise ValueError(f"batch {x.shape[0]} not a multiple of dp={dp}")
        step = x.shape[0] // dp
        return [x[i * step:(i + 1) * step].to(m.row_device(i)) for i in rows]

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """One tensor a row -> the whole, on the first row's device."""
        dev = self.mesh.row_device(0)
        if not self.batch:
            return parts[0].to(dev)
        return torch.cat([p.to(dev) for p in parts])


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (batch) dim over 'dp'."""
    return Sharding(mesh, batch=True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, batch=False)


def module_device(module: nn.Module) -> torch.device:
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return torch.device("cpu")


def same_device(a: torch.device, b: torch.device) -> bool:
    """torch.device('cpu') and a tensor's device: the index of a CPU
    device means nothing; a CUDA device without one is the current one."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = lambda d: d.index if d.index is not None else torch.cuda.current_device()
    return cur(a) == cur(b)


def module_on(module: nn.Module, device: torch.device) -> nn.Module:
    """`module` itself where it lies on `device`, else a copy there."""
    if same_device(module_device(module), device):
        return module
    return copy.deepcopy(module).to(device)


class GatherOnUse(nn.Module):
    """Parametrization of a parameter split into shards along `dim`, each
    at rest on its own device: reading the parameter concatenates the
    shards on `compute` (FSDP-style gather on use)."""

    def __init__(self, dim: int, devices: Sequence[torch.device], compute: torch.device):
        super().__init__()
        self.dim, self.devices, self.compute = dim, list(devices), compute

    def forward(self, *shards: torch.Tensor) -> torch.Tensor:
        return torch.cat([s.to(self.compute) for s in shards], self.dim)

    def right_inverse(self, full: torch.Tensor):
        return tuple(c.contiguous().to(d, copy=True)
                     for c, d in zip(full.chunk(len(self.devices), self.dim), self.devices))


def _flax_last(owner: nn.Module, name: str, leaf: str, p: torch.Tensor, heads):
    """(size of the flax leaf's last dim, the torch dim that holds it) for
    a parameter of `owner`, by the key map of ``weights/convert.py``:
    Dense kernel [in, out] -> Linear.weight [out, in] (dim 0; an
    attention query/key/value kernel [in, heads, hd] -> [heads*hd, in]:
    the last flax dim is hd, inside dim 0), Conv HWIO -> OIHW (dim 0; a
    transposed conv's torch weight is [I, O, ...]: dim 1),
    Embed [V, D] -> Embedding.weight (dim 1), bare parameters in their
    own layout (the last dim)."""
    if isinstance(owner, nn.Embedding) and leaf == "weight":
        return p.shape[1], 1
    if isinstance(owner, nn.modules.conv._ConvNd) and leaf == "weight":
        return (p.shape[1], 1) if owner.transposed else (p.shape[0], 0)  # [I, O, ...]
    if isinstance(owner, nn.Linear) and leaf == "weight":
        proj = name.rpartition(".")[0].rpartition(".")[2]
        if heads is not None and proj in ("query", "key", "value"):
            return p.shape[0] // heads, 0
        return p.shape[0], 0
    return p.shape[-1], p.dim() - 1


def tp_leaves(module: nn.Module, tp: int, min_size: int = 2 ** 14) -> Dict[str, int]:
    """The parameters that JAX's ``shard_params_fsdp_tp`` rule splits over
    'tp' (a leaf of rank >= 2 and size >= min_size whose flax last dim
    divides by tp), by qualified name, with the torch dim to split."""
    mods = dict(module.named_modules())
    out = {}
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = mods[owner_name]
        parent = mods[owner_name.rpartition(".")[0]] if "." in owner_name else module
        last, dim = _flax_last(owner, name, leaf, p, getattr(parent, "heads", None))
        if p.dim() >= 2 and p.numel() >= min_size and last % tp == 0:
            out[name] = dim
    return out


def shard_params_fsdp_tp(module: nn.Module, mesh: Mesh, min_size: int = 2 ** 14,
                         row: int = 0) -> Dict[str, int]:
    """Split `module`'s large parameters over the tp devices of mesh row
    `row`, in place: JAX's rule (``tp_leaves``) picks the leaves, and each
    becomes tp shards read through ``GatherOnUse`` on the row's compute
    device.  A tied parameter (Florence-2's LM head reads the token table)
    is the one parametrized tensor.  Returns the split leaves and their
    dims; with tp = 1 nothing is split."""
    tp = mesh.shape["tp"]
    leaves = tp_leaves(module, tp, min_size)
    if tp > 1:
        devices = list(mesh.devices[row])
        for name, dim in leaves.items():
            owner_name, _, leaf = name.rpartition(".")
            parametrize.register_parametrization(
                module.get_submodule(owner_name), leaf,
                GatherOnUse(dim, devices, mesh.row_device(row)))
    return leaves
