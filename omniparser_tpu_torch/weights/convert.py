"""Carry the JAX package's variables into this package's ``state_dict``s.

The input is the Flax variable tree **flattened to numpy**:
``{"params/stem/conv/kernel": array, "batch_stats/stem/bn/mean": array,
...}`` (``flatten_variables`` makes it from a nested dict of arrays).  The
PyTorch modules keep the Flax tree's names, so a key maps by its path and
a leaf by its kind:

  * Conv ``kernel`` HWIO -> ``weight`` OIHW (depthwise included: its I is 1);
  * Dense ``kernel`` [in, out] -> ``weight`` [out, in];
  * flax MultiHeadDotProductAttention: query/key/value ``kernel``
    [in, heads, hd] -> [heads*hd, in], their ``bias`` [heads, hd] ->
    [heads*hd]; ``out`` ``kernel`` [heads, hd, out] -> [out, heads*hd];
  * BatchNorm ``scale``/``bias`` + ``batch_stats`` ``mean``/``var`` ->
    ``weight``/``bias``/``running_mean``/``running_var``;
  * LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``
    (the LM head is tied to it in the module, not stored);
  * bare parameters (position tables, the image projection, the logits
    bias) keep their name and layout;
  * the int8 decode tree (``models/quant.py`` of the JAX package): a
    ``QDense``'s int8 ``kernel`` [in, out] -> int8 ``weight`` [out, in], its
    ``scale`` stays ``scale``; ``lm_head_kernel``/``lm_head_scale`` keep
    their name and layout.  int8 leaves stay int8, every other leaf
    becomes float32.

Every converter checks the result against the target module: a key the
module lacks, a key it still needs, or a shape that differs raises with
the key's path.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def flatten_variables(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping of arrays -> flat {"a/b/c": numpy array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_variables(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a flat variable dict written by ``numpy.savez`` (one exported
    checkpoint; see scripts/export_torch_weights.py)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


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


def _meta(make):
    with torch.device("meta"):
        return make()


def convert_yolov8(flat, variant: str = "n", num_classes: int = 1):
    from omniparser_tpu_torch.models.yolov8 import YOLOv8

    return convert_variables(flat, _meta(lambda: YOLOv8(variant, num_classes)))


def convert_yolov9(flat, variant: str = "e", num_classes: int = 1):
    from omniparser_tpu_torch.models.yolov9 import GELAN

    return convert_variables(flat, _meta(lambda: GELAN(variant, num_classes)))


def convert_text_detector(flat, width: int = 32):
    from omniparser_tpu_torch.models.ocr import TextDetector

    return convert_variables(flat, _meta(lambda: TextDetector(width)))


def convert_text_recognizer(flat, width: int = 64, layers: int = 2, heads: int = 4):
    """The position table's length gives the sequence length (W/4)."""
    from omniparser_tpu_torch.models.ocr import TextRecognizer

    seq_len = int(np.asarray(flat["params/pos_embed"]).shape[1])
    return convert_variables(
        flat, _meta(lambda: TextRecognizer(width, layers, heads, seq_len)))


def convert_craft(flat):
    from omniparser_tpu_torch.models.ocr_easy import Craft

    return convert_variables(flat, _meta(Craft))


def convert_easyocr_recognizer(flat):
    """The JAX package's ``TorchLSTM`` pairs (``rnn{i}/fwd``, ``rnn{i}/bwd``)
    become one ``nn.LSTM(bidirectional=True)`` per block (``rnn{i}/rnn``,
    suffixes ``_l0`` and ``_l0_reverse``); the layout is torch's on both.
    The widths are read from the tree (english_g2: 256, 256, 96 classes)."""
    from omniparser_tpu_torch.models.ocr_easy import VggCtcRecognizer

    dims = dict(output_channel=int(np.shape(flat["params/f6/conv/kernel"])[-1]),
                hidden=int(np.shape(flat["params/rnn0/fwd/weight_hh"])[1]),
                num_classes=int(np.shape(flat["params/pred/kernel"])[-1]))

    renamed = {}
    for path, arr in flat.items():
        parts = path.split("/")
        if len(parts) == 4 and parts[2] in ("fwd", "bwd"):
            suffix = "_l0" if parts[2] == "fwd" else "_l0_reverse"
            path = "/".join(parts[:2] + ["rnn", parts[3] + suffix])
        renamed[path] = arr
    return convert_variables(renamed, _meta(lambda: VggCtcRecognizer(**dims)))


def convert_blip2(flat, dims=None):
    """A JAX Blip2 tree (``params/...``) for ``Blip2(dims)``, default
    blip2-opt-2.7b."""
    from omniparser_tpu_torch.models.blip2 import BLIP2_OPT_2_7B, Blip2

    return convert_variables(flat, _meta(lambda: Blip2(dims or BLIP2_OPT_2_7B)))


def convert_florence2(flat, dims=None):
    """A float tree, or the JAX package's int8 decode tree (it holds
    ``lm_head_kernel``), for ``Florence2(dims)`` or ``Florence2(dims,
    quant=True)``."""
    from omniparser_tpu_torch.models.florence2 import BASE, Florence2

    quant = any(k.endswith("/lm_head_kernel") for k in flat)
    return convert_variables(flat, _meta(lambda: Florence2(dims or BASE, quant)))
