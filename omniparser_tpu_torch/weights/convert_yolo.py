"""An ultralytics YOLOv8 checkpoint -> the port's ``YOLOv8`` state_dict.

The reference loads ``icon_detect/model.pt`` through ultralytics.  This
loader takes either

  * a plain torch state_dict file (``torch.save(YOLO(p).model.state_dict(),
    out)`` where ultralytics is installed), or
  * a whole ultralytics ``.pt`` bundle, unpickled with stub classes, so the
    ultralytics package is not needed.

The ultralytics layer indices (``model.{i}``) map onto the module names of
``models/yolov8.py``:

  0 stem | 1 down2 | 2 c2f_2 | 3 down3 | 4 c2f_3 | 5 down4 | 6 c2f_4
  | 7 down5 | 8 c2f_5 | 9 sppf | 12 neck_p4 | 15 neck_p3 | 16 neck_down3
  | 18 neck_p4b | 19 neck_down4 | 21 neck_p5 | 22 head (cv2 = box, cv3 = cls)

The tree this builds has the JAX package's layout (HWIO kernels under
``params``, BatchNorm statistics under ``batch_stats``) and goes through
the same carrier as an exported checkpoint: ``convert.flatten_variables``
-> ``convert.convert_yolov8``, which checks every key and shape against the
module.  DFL's fixed expectation conv (``model.22.dfl``) has no parameters
to carry.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np

_LAYER_MAP = {
    "0": "stem", "1": "down2", "2": "c2f_2", "3": "down3", "4": "c2f_3",
    "5": "down4", "6": "c2f_4", "7": "down5", "8": "c2f_5", "9": "sppf",
    "12": "neck_p4", "15": "neck_p3", "16": "neck_down3", "18": "neck_p4b",
    "19": "neck_down4", "21": "neck_p5",
}


class _Stub:
    """Stands in for a class the unpickler cannot import (ultralytics')."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,), {})


class _StubPickle:
    """A pickle module for ``torch.load`` whose unpickler stubs unknown
    classes."""

    Unpickler = _StubUnpickler
    load = pickle.load


def load_torch_tensors(path: str) -> Dict[str, np.ndarray]:
    """A torch file -> {key: float32 numpy array}, without ultralytics.
    Only load files you trust: a bundle is unpickled."""
    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # a whole ultralytics bundle: weights_only refuses its classes
        obj = torch.load(path, map_location="cpu", weights_only=False,
                         pickle_module=_StubPickle)
    return flatten_state(obj)


def flatten_state(obj) -> Dict[str, np.ndarray]:
    """A state dict, an ultralytics checkpoint dict ({'model': ...}) or an
    unpickled module tree -> {key: float32 numpy array}."""
    import torch

    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        # a stub-unpickled nn.Module tree: walk _modules/_parameters/_buffers
        flat: Dict[str, Any] = {}

        def walk(mod, prefix):
            for attr in ("_parameters", "_buffers"):
                for k, v in (getattr(mod, attr, None) or {}).items():
                    if v is not None:
                        flat[prefix + k] = v
            for k, v in (getattr(mod, "_modules", None) or {}).items():
                if v is not None:
                    walk(v, f"{prefix}{k}.")

        walk(obj, "")
        if not flat:
            raise ValueError("could not extract a state_dict; re-export with "
                             "torch.save(YOLO(path).model.state_dict(), out)")
        obj = flat
    return {k: v.detach().float().numpy() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch [O, I, kh, kw] -> HWIO [kh, kw, I, O]."""
    return np.transpose(w, (2, 3, 1, 0))


def _convert_convbn(sd: Dict, src: str, params: Dict, stats: Dict, dst: str):
    """ultralytics Conv (conv + bn) -> ConvBNAct {conv, bn}."""
    node_p = params.setdefault(dst, {})
    node_s = stats.setdefault(dst, {})
    node_p["conv"] = {"kernel": _conv_kernel(sd[f"{src}.conv.weight"])}
    node_p["bn"] = {"scale": sd[f"{src}.bn.weight"], "bias": sd[f"{src}.bn.bias"]}
    node_s["bn"] = {"mean": sd[f"{src}.bn.running_mean"], "var": sd[f"{src}.bn.running_var"]}


def _convert_c2f(sd: Dict, src: str, params: Dict, stats: Dict, dst: str):
    _convert_convbn(sd, f"{src}.cv1", params.setdefault(dst, {}), stats.setdefault(dst, {}),
                    "cv1")
    _convert_convbn(sd, f"{src}.cv2", params[dst], stats[dst], "cv2")
    i = 0
    while f"{src}.m.{i}.cv1.conv.weight" in sd:
        m_p = params[dst].setdefault(f"m{i}", {})
        m_s = stats[dst].setdefault(f"m{i}", {})
        _convert_convbn(sd, f"{src}.m.{i}.cv1", m_p, m_s, "cv1")
        _convert_convbn(sd, f"{src}.m.{i}.cv2", m_p, m_s, "cv2")
        i += 1


def convert_yolo_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """ultralytics state_dict -> {'params': tree, 'batch_stats': tree}."""
    sd = {k.removeprefix("model.model.").removeprefix("model."): v for k, v in sd.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for idx, name in _LAYER_MAP.items():
        if f"{idx}.conv.weight" in sd:  # plain Conv
            _convert_convbn(sd, idx, params, stats, name)
        elif f"{idx}.cv1.conv.weight" in sd:
            if f"{idx}.m.0.cv1.conv.weight" in sd:  # C2f
                _convert_c2f(sd, idx, params, stats, name)
            else:  # SPPF
                node_p = params.setdefault(name, {})
                node_s = stats.setdefault(name, {})
                _convert_convbn(sd, f"{idx}.cv1", node_p, node_s, "cv1")
                _convert_convbn(sd, f"{idx}.cv2", node_p, node_s, "cv2")
        else:
            raise KeyError(f"layer model.{idx} missing from state_dict")

    # Detect head: model.22.cv2.{lvl} = box (2x Conv + conv2d), cv3 = cls
    head_p = params.setdefault("head", {})
    head_s = stats.setdefault("head", {})
    for lvl in range(3):
        for branch, ours in (("cv2", "box"), ("cv3", "cls")):
            src = f"22.{branch}.{lvl}"
            _convert_convbn(sd, f"{src}.0", head_p, head_s, f"{ours}{lvl}_0")
            _convert_convbn(sd, f"{src}.1", head_p, head_s, f"{ours}{lvl}_1")
            head_p[f"{ours}{lvl}_2"] = {"kernel": _conv_kernel(sd[f"{src}.2.weight"]),
                                        "bias": sd[f"{src}.2.bias"]}
    return {"params": params, "batch_stats": stats}


def load_detector_state(path: str, detector):
    """An ultralytics ``.pt`` or state_dict file -> a state_dict for
    ``detector.make_module()``; a missing layer raises KeyError, a key or
    shape the module does not have raises with the key."""
    from omniparser_tpu_torch.weights.convert import convert_yolov8, flatten_variables

    tree = convert_yolo_state_dict(load_torch_tensors(path))
    return convert_yolov8(flatten_variables(tree), detector.variant, detector.num_classes)
