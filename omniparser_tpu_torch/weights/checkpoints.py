"""Checkpoint save and load for the trained families.

This package writes flat ``.npz`` files: one key per Flax variable,
prefixed by the family (``det/params/stem/conv/kernel``,
``rec/batch_stats/..._ConvBlock_0/BatchNorm_0/mean``, ``cap/params/...``),
float32 numpy, and the captioner's dims as JSON under ``__dims__``.  The
JAX package can read such a file with numpy alone.  Writing orbax trees is
left to the JAX package.

It reads both those files and the orbax trees the JAX package writes
(``weights/orbax_read.py``, without JAX): the trained trees committed under
``omniparser_tpu/weights/`` that ``SOMPipeline``'s ``'auto'`` weight fields
load, and the JAX trainers' output, ``step_N/`` directories included.  A
tree's ``dims.json`` sidecar, where present, is its ``__dims__``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch.nn as nn

from omniparser_tpu_torch.weights.convert import flatten_variables, load_npz, unconvert_state
from omniparser_tpu_torch.weights.orbax_read import is_orbax_dir, read_orbax_tree


def _flat(family: str, value) -> Dict[str, np.ndarray]:
    if isinstance(value, nn.Module):
        value = unconvert_state(value.state_dict(), value)
    return {f"{family}/{k}": np.asarray(v) for k, v in value.items()}


def save_checkpoint(path: str, tree: Dict[str, Any], step: Optional[int] = None,
                    dims=None) -> str:
    """Write `tree` ({'det': module or flat Flax variables, 'rec': ...,
    'cap': ...}) to `path` (``.npz`` appended where missing), or with
    `step` to ``path/step_{step}.npz``; `dims` (a ``FlorenceDims``) goes to
    ``__dims__``.  Returns the file's path."""
    path = os.path.abspath(path)
    if step is not None:
        target = os.path.join(path, f"step_{step}.npz")
    else:
        target = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(target), exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    for family, value in tree.items():
        flat.update(_flat(family, value))
    if dims is not None:
        flat["__dims__"] = np.asarray(json.dumps(dataclasses.asdict(dims)))
    tmp = target[:-4] + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, target)  # a reader never sees half a file
    return target


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint as one flat dict ({'det/params/stem/conv/kernel': array,
    ..., '__dims__': JSON where present}): an orbax directory through
    ``weights/orbax_read.py``, with its ``dims.json`` as ``__dims__``, any
    other path a ``.npz`` file."""
    if os.path.isdir(path):
        if not is_orbax_dir(path):
            raise ValueError(f"{path} is a directory but not an orbax checkpoint "
                             "(it lacks _METADATA or manifest.ocdbt)")
        flat = flatten_variables(read_orbax_tree(path))
        dims = os.path.join(path, "dims.json")
        if os.path.isfile(dims):
            with open(dims) as f:
                flat["__dims__"] = np.asarray(f.read())
        return flat
    return load_npz(path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint: a file `save_checkpoint` (or the export script)
    wrote, or an orbax directory of the JAX package (``step_N/`` too):
    {'det': flat Flax variables, ..., '__dims__': JSON string where
    present}.  ``weights/convert.convert_variables`` turns a family's
    variables into its module's state_dict."""
    out: Dict[str, Any] = {}
    for key, arr in load_flat(path).items():
        if key == "__dims__":
            out[key] = str(arr)
            continue
        family, _, rest = key.partition("/")
        out.setdefault(family, {})[rest] = arr
    return out


def latest_step_dir(path: str) -> Optional[str]:
    """The newest ``step_N.npz`` under `path` (for resuming), or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:-4]) for f in os.listdir(path)
             if f.startswith("step_") and f.endswith(".npz") and f[5:-4].isdigit()]
    return os.path.join(path, f"step_{max(steps)}.npz") if steps else None
