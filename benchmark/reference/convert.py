"""Flat Flax variables (as the orbax reader gives them) -> state_dicts of
the reference networks.  A frozen copy of the measured package's
converter for the two trained trees the benchmark reads."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping of arrays -> flat {"a/b/c": numpy array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


_LEAF = {"scale": "weight", "embedding": "weight", "mean": "running_mean",
         "var": "running_var"}


def _convert_leaf(path: str, parent: str, leaf: str, arr: np.ndarray, quantized: bool):
    if leaf == "kernel":
        if arr.ndim == 4:  # conv HWIO -> OIHW
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:  # dense [in, out] -> [out, in]
            return "weight", arr.T
        if arr.ndim == 3:  # attention heads
            if parent == "out":  # [heads, hd, out]
                return "weight", arr.reshape(-1, arr.shape[-1]).T
            return "weight", arr.reshape(arr.shape[0], -1).T  # [in, heads, hd]
        raise ValueError(f"{path}: kernel of rank {arr.ndim}")
    if leaf == "scale" and quantized:  # a QDense's per-channel scale
        return "scale", arr
    if leaf == "bias":
        return "bias", arr.reshape(-1)
    return _LEAF.get(leaf, leaf), arr


def convert_variables(flat: Mapping[str, np.ndarray], module: nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """Flat Flax variables -> state_dict for `module`."""
    want = {k: v for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    out: Dict[str, torch.Tensor] = {}
    # the modules whose kernel is int8: their 'scale' is a QDense scale
    quantized = {p.rsplit("/", 1)[0] for p, a in flat.items()
                 if p.endswith("/kernel") and np.asarray(a).dtype == np.int8}
    for path, arr in flat.items():
        parts = path.split("/")
        if parts[0] not in ("params", "batch_stats"):
            raise KeyError(f"{path}: unknown collection {parts[0]!r}")
        parts = parts[1:]
        parent = parts[-2] if len(parts) > 1 else ""
        leaf, value = _convert_leaf(path, parent, parts[-1], np.asarray(arr),
                                    path.rsplit("/", 1)[0] in quantized)
        key = ".".join(parts[:-1] + [leaf])
        if key not in want:
            raise KeyError(f"left-over key {path!r}: the module has no {key!r}")
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(f"{path}: shape {tuple(value.shape)} after conversion, "
                             f"the module's {key!r} is {tuple(want[key].shape)}")
        out[key] = torch.tensor(
            value, dtype=torch.int8 if value.dtype == np.int8 else torch.float32)
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"missing keys (no variable maps to them): {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return out
