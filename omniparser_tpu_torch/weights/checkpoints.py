"""Checkpoint save and load for the trained families, as flat ``.npz`` files.

The JAX package writes orbax trees, which nothing here can read.  This
package writes the flat layout that ``scripts/export_torch_weights.py``
writes and that ``SOMPipeline``'s weight fields load (``'auto'`` or a path
to a ``.npz``): one key per Flax variable, prefixed by the family
(``det/params/stem/conv/kernel``, ``rec/batch_stats/..._ConvBlock_0/
BatchNorm_0/mean``, ``cap/params/...``), float32 numpy, and the captioner's
dims as JSON under ``__dims__``.  The JAX package can read such a file
with numpy alone.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch.nn as nn

from omniparser_tpu_torch.weights.convert import load_npz, unconvert_state


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


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a file `save_checkpoint` (or the export script) wrote:
    {'det': flat Flax variables, ..., '__dims__': JSON string where
    present}.  ``weights/convert.convert_variables`` turns a family's
    variables into its module's state_dict."""
    out: Dict[str, Any] = {}
    for key, arr in load_npz(path).items():
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
