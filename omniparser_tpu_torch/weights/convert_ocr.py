"""easyocr checkpoints -> the port's ``Craft`` and ``VggCtcRecognizer``.

The reference reads CRAFT (``craft_mlt_25k.pth``) and the english_g2
recogniser (``english_g2.pth``) through ``easyocr.Reader(['en'])``.  Their
keys follow the public model definitions (clovaai/CRAFT-pytorch
``craft.py`` and ``basenet/vgg16_bn.py``; JaidedAI/EasyOCR
``model/vgg_model.py``).  The maps below build the JAX package's tree
layout (HWIO kernels, BatchNorm statistics under ``batch_stats``), which
then goes through the same carrier as the JAX package's own trees
(``convert.convert_craft`` / ``convert.convert_easyocr_recognizer``): every
key and shape is checked against the module there.  A DataParallel
``module.`` prefix is stripped.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

_CRAFT_VGG = [
    ("slice1.0", "slice1.1", "s1c0"), ("slice1.3", "slice1.4", "s1c1"),
    ("slice1.7", "slice1.8", "s1c2"), ("slice1.10", "slice1.11", "s1c3"),
    ("slice2.14", "slice2.15", "s2c0"), ("slice2.17", "slice2.18", "s2c1"),
    ("slice3.20", "slice3.21", "s3c0"), ("slice3.24", "slice3.25", "s3c1"),
    ("slice3.27", "slice3.28", "s3c2"),
    ("slice4.30", "slice4.31", "s4c0"), ("slice4.34", "slice4.35", "s4c1"),
    ("slice4.37", "slice4.38", "s4c2"),
    ("slice5.1", None, "s5c0"), ("slice5.2", None, "s5c1"),
]
# easyocr's VGG_FeatureExtractor: (conv index, its BatchNorm's index, name)
_REC_FEATURES = [
    ("ConvNet.0", None, "f0"), ("ConvNet.3", None, "f1"),
    ("ConvNet.6", None, "f2"), ("ConvNet.8", None, "f3"),
    ("ConvNet.11", "ConvNet.12", "f4"), ("ConvNet.14", "ConvNet.15", "f5"),
    ("ConvNet.18", None, "f6"),
]


def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def _strip_module(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {k.removeprefix("module."): v for k, v in sd.items()}


def _convbn(sd, conv: str, bn: Optional[str], params: Dict, stats: Dict, name: str,
            bias: bool = True) -> None:
    p: Dict[str, Any] = {"conv": {"kernel": np.transpose(_f32(sd[f"{conv}.weight"]),
                                                         (2, 3, 1, 0))}}
    if bias:
        p["conv"]["bias"] = _f32(sd[f"{conv}.bias"])
    if bn is not None:
        p["bn"] = {"scale": _f32(sd[f"{bn}.weight"]), "bias": _f32(sd[f"{bn}.bias"])}
        stats[name] = {"bn": {"mean": _f32(sd[f"{bn}.running_mean"]),
                              "var": _f32(sd[f"{bn}.running_var"])}}
    params[name] = p


def convert_craft_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """CRAFT torch state dict -> {'params', 'batch_stats'} of the JAX
    package's ``Craft``."""
    sd = _strip_module(sd)
    params: Dict[str, Any] = {"basenet": {}}
    stats: Dict[str, Any] = {"basenet": {}}
    for conv, bn, name in _CRAFT_VGG:
        _convbn(sd, f"basenet.{conv}", f"basenet.{bn}" if bn else None,
                params["basenet"], stats["basenet"], name)
    for i in range(1, 5):  # double_conv: Sequential(Conv, BN, ReLU, Conv, BN, ReLU)
        params[f"upconv{i}"], stats[f"upconv{i}"] = {}, {}
        _convbn(sd, f"upconv{i}.conv.0", f"upconv{i}.conv.1", params[f"upconv{i}"],
                stats[f"upconv{i}"], "c0")
        _convbn(sd, f"upconv{i}.conv.3", f"upconv{i}.conv.4", params[f"upconv{i}"],
                stats[f"upconv{i}"], "c1")
    for idx, name in ((0, "cls0"), (2, "cls1"), (4, "cls2"), (6, "cls3"), (8, "cls4")):
        _convbn(sd, f"conv_cls.{idx}", None, params, stats, name)
    return {"params": params, "batch_stats": stats}


def convert_easyocr_rec_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """english_g2-style VGG-BiLSTM-CTC state dict -> {'params',
    'batch_stats'} of the JAX package's ``VggCtcRecognizer``."""
    sd = _strip_module(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for conv, bn, name in _REC_FEATURES:
        # the BatchNorm'd convs are bias-free in easyocr's VGG
        _convbn(sd, f"FeatureExtraction.{conv}", f"FeatureExtraction.{bn}" if bn else None,
                params, stats, name, bias=bn is None)

    def lstm(prefix: str, suffix: str) -> Dict[str, Any]:
        return {k: _f32(sd[f"{prefix}.rnn.{k}_l0{suffix}"])
                for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}

    for i in (0, 1):
        prefix = f"SequenceModeling.{i}"
        params[f"rnn{i}"] = {
            "fwd": lstm(prefix, ""),
            "bwd": lstm(prefix, "_reverse"),
            "linear": {"kernel": _f32(sd[f"{prefix}.linear.weight"]).T,
                       "bias": _f32(sd[f"{prefix}.linear.bias"])},
        }
    params["pred"] = {"kernel": _f32(sd["Prediction.weight"]).T,
                      "bias": _f32(sd["Prediction.bias"])}
    return {"params": params, "batch_stats": stats}


def load_easyocr_states(craft_path: Optional[str] = None, rec_path: Optional[str] = None
                        ) -> Tuple[Optional[Dict], Optional[Dict]]:
    """``craft_mlt_25k.pth`` and ``english_g2.pth`` (either may be None) ->
    (Craft state_dict, VggCtcRecognizer state_dict), read with
    ``torch.load(weights_only=True)``; raises on any key or shape that does
    not fit the module."""
    import torch

    from omniparser_tpu_torch.weights import convert

    def read(path):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items() if isinstance(v, torch.Tensor)}

    det = rec = None
    if craft_path:
        det = convert.convert_craft(convert.flatten_variables(
            convert_craft_state_dict(read(craft_path))))
    if rec_path:
        rec = convert.convert_easyocr_recognizer(convert.flatten_variables(
            convert_easyocr_rec_state_dict(read(rec_path))))
    return det, rec
