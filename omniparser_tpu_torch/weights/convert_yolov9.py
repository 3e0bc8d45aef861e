"""A YOLOv9 (GELAN) TorchScript or state dict -> the port's ``GELAN`` state_dict.

The reference loads ``icon_detect_v3/model.pt`` as a TorchScript archive;
its state dict keeps the yolov9 repository's spellings
(``model.{i}.cv1.conv.weight``, ...).  This converter maps them onto
``models/yolov9.GELAN``:

  * top-level layers are matched by order over the parametric layers
    (Silence, Upsample, Concat and CBFuse own no parameters, and the deploy
    graph's order is the module order below), so the yaml's exact layer
    indices do not matter;
  * sub-module spellings translate mechanically (ELAN ``cv2.0``/``cv2.1`` ->
    ``cv2_csp``/``cv2_conv``, ``m.{i}`` -> ``m{i}``, head ``cv2``/``cv3`` ->
    ``box*``/``cls*``);
  * a deploy-fused RepConvN conv (weight and bias, the BatchNorm folded
    in) loads as an identity BatchNorm that carries the bias (variance
    1 - eps, so that sqrt(var + eps) is 1).

Every source key that maps nowhere is an error, all reported together.
The tree built here has the JAX package's layout and goes through the same
carrier as an exported checkpoint (``convert.convert_yolov9``), which
raises on any key the module lacks or still needs, and on any shape.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np

# the module order == the deploy graph's parametric-layer order.  Single
# form (gelan-c): 17 layers; dual form (gelan-e, icon_detect_v3): 31
_MODULE_ORDER = (
    "stem", "down2", "elan2", "adown3", "elan3", "adown4", "elan4",
    "adown5", "elan5", "sppelan", "neck_p4", "neck_p3", "neck_down3",
    "neck_p4b", "neck_down4", "neck_p5", "head",
)
_MODULE_ORDER_DUAL = (
    "stemA", "downA2", "elanA2", "adownA3", "elanA3", "adownA4", "elanA4",
    "adownA5", "elanA5", "cb1", "cb2", "cb3", "cb4", "cb5",
    "stemB", "downB2", "elanB2", "adownB3", "elanB3", "adownB4", "elanB4",
    "adownB5", "elanB5", "sppelan", "neck_p4", "neck_p3", "neck_down3",
    "neck_p4b", "neck_down4", "neck_p5", "head",
)

_BN_EPS = 1e-3  # ConvBNAct's BatchNorm epsilon


def load_yolov9_tensors(path: str) -> Dict[str, np.ndarray]:
    """A TorchScript archive, or any torch file ``convert_yolo`` reads ->
    {key: float32 numpy array}.  Only load files you trust."""
    import torch

    from omniparser_tpu_torch.weights.convert_yolo import load_torch_tensors

    try:
        m = torch.jit.load(path, map_location="cpu")
    except RuntimeError:  # not TorchScript: a pickled state dict or bundle
        return load_torch_tensors(path)
    return {k: v.detach().float().numpy() for k, v in m.state_dict().items()}


def _kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _set(tree: Dict, path: List[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _translate_sub(parts: List[str]) -> List[str]:
    """A yolov9-repo sub-module path -> the module's path (no leaf)."""
    out: List[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if p in ("cv2", "cv3") and nxt in ("0", "1"):  # ELAN Sequential(RepNCSP, Conv)
            out.append(f"{p}_csp" if nxt == "0" else f"{p}_conv")
            i += 2
        elif p == "m" and nxt is not None and nxt.isdigit():
            out.append(f"m{nxt}")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


def _route_leaf(our: List[str], leaf: List[str], v: np.ndarray, params: Dict, stats: Dict,
                fused: bool, unmatched: List[str], orig: str, linear_conv: bool = False):
    leaf_key = ".".join(leaf)
    if leaf_key == "conv.weight" and v.ndim == 4:
        _set(params, our + ["conv", "kernel"], _kernel(v))
    elif leaf_key == "conv.bias" and linear_conv:  # CBLinear's biased conv
        _set(params, our + ["conv", "bias"], v)
    elif leaf_key == "conv.bias" and fused:  # the identity BatchNorm carries it
        _set(params, our + ["bn", "bias"], v)
    elif leaf_key == "bn.weight":
        _set(params, our + ["bn", "scale"], v)
    elif leaf_key == "bn.bias":
        _set(params, our + ["bn", "bias"], v)
    elif leaf_key == "bn.running_mean":
        _set(stats, our + ["bn", "mean"], v)
    elif leaf_key == "bn.running_var":
        _set(stats, our + ["bn", "var"], v)
    elif leaf_key == "bn.num_batches_tracked":
        pass
    elif leaf == ["weight"] and v.ndim == 4:  # a head's bare final conv
        _set(params, our + ["kernel"], _kernel(v))
    elif leaf == ["bias"]:
        _set(params, our + ["bias"], v)
    else:
        unmatched.append(orig)


def convert_yolov9_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """yolov9 state dict -> {'params': tree, 'batch_stats': tree}; raises
    ValueError listing every key that maps nowhere."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    unmatched: List[str] = []

    layers: Dict[int, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        m = re.match(r"(?:model\.)+(\d+)\.(.*)", k)
        if not m:
            unmatched.append(k)
            continue
        layers.setdefault(int(m.group(1)), {})[m.group(2)] = np.asarray(v)
    if len(layers) == len(_MODULE_ORDER):
        order = _MODULE_ORDER
    elif len(layers) == len(_MODULE_ORDER_DUAL):
        order = _MODULE_ORDER_DUAL
    else:
        raise ValueError(
            f"parametric layer count {len(layers)} matches neither the single "
            f"({len(_MODULE_ORDER)}) nor the dual ({len(_MODULE_ORDER_DUAL)}) GELAN "
            f"deploy form ({sorted(layers)})")

    for idx, dst in zip(sorted(layers), order):
        sub = layers[idx]
        if dst.startswith("cb"):
            # CBLinear: a biased 1x1 conv with no BatchNorm, which is not
            # a fused RepConvN
            for key, v in sub.items():
                _route_leaf([dst], key.split("."), v, params, stats, fused=False,
                            unmatched=unmatched, orig=f"model.{idx}.{key}", linear_conv=True)
            continue
        # fused RepConvN convs: weight and bias with no BatchNorm beside them
        fused_prefixes = {
            k[: -len(".conv.weight")] for k in sub
            if k.endswith(".conv.weight")
            and f"{k[: -len('.conv.weight')]}.conv.bias" in sub
            and f"{k[: -len('.conv.weight')]}.bn.weight" not in sub
        }
        for key, v in sub.items():
            parts = key.split(".")
            if dst == "head":
                # DDetect: cv2.{i}.{j} -> box{i}_{j}, cv3.{i}.{j} -> cls{i}_{j}
                if len(parts) >= 3 and parts[0] in ("cv2", "cv3") and parts[1].isdigit():
                    name = f"{'box' if parts[0] == 'cv2' else 'cls'}{parts[1]}_{parts[2]}"
                    rest = parts[3:]
                    our = ["head", name] + _translate_sub(rest[:-2])
                    _route_leaf(our, rest[-2:], v, params, stats, fused=False,
                                unmatched=unmatched, orig=f"model.{idx}.{key}")
                elif parts[0] != "dfl":  # DFL's fixed conv is the decode's expectation
                    unmatched.append(f"model.{idx}.{key}")
                continue
            prefix = ".".join(parts[:-2])
            _route_leaf([dst] + _translate_sub(parts[:-2]), parts[-2:], v, params, stats,
                        fused=prefix in fused_prefixes, unmatched=unmatched,
                        orig=f"model.{idx}.{key}")
        for prefix in fused_prefixes:
            our = [dst] + _translate_sub(prefix.split("."))
            c = sub[f"{prefix}.conv.weight"].shape[0]
            _set(params, our + ["bn", "scale"], np.ones(c, np.float32))
            _set(stats, our + ["bn", "mean"], np.zeros(c, np.float32))
            _set(stats, our + ["bn", "var"], np.full(c, 1.0 - _BN_EPS, np.float32))

    if unmatched:
        raise ValueError(f"unmatched yolov9 keys (refusing a partial load): "
                         f"{sorted(unmatched)[:20]}{' ...' if len(unmatched) > 20 else ''}")
    return {"params": params, "batch_stats": stats}


def load_yolov9_state(path: str, detector):
    """A yolov9 TorchScript or state dict file -> a state_dict for
    ``detector.make_module()``; raises on any key or shape that does not fit."""
    from omniparser_tpu_torch.weights.convert import convert_yolov9, flatten_variables

    tree = convert_yolov9_state_dict(load_yolov9_tensors(path))
    return convert_yolov9(flatten_variables(tree), detector.variant, detector.num_classes)
