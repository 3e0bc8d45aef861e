"""An HF Salesforce/blip2-opt-2.7b directory -> the port's ``Blip2`` state_dict.

The keys are HF ``modeling_blip_2``'s (``vision_model.encoder.layers.{i}``,
``qformer.encoder.layer.{i}``, ``language_model.model.decoder.layers.{i}``
...).  The map builds the JAX package's tree layout (``[in, out]`` dense
kernels, HWIO patch conv, LayerNorm ``scale``), which goes through the same
carrier as the JAX package's own trees (``convert.convert_blip2``), where
every key and shape is checked against the module.  Keys that map nowhere
are returned as ``unmatched``, as the JAX package's converter returns them;
the tied ``lm_head`` is the token table and is skipped.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Any, Dict, List, Tuple

import numpy as np


def _set(tree, path, leaf, value):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = np.asarray(value, np.float32)


_VISION = {"self_attn.qkv": ["{}_attn", "qkv"],
           "self_attn.projection": ["{}_attn", "projection"],
           "mlp.fc1": ["{}_fc1"], "mlp.fc2": ["{}_fc2"]}
_VISION_NORMS = {"layer_norm1": "{}_ln1", "layer_norm2": "{}_ln2"}
_QFORMER = {
    "attention.attention.query": ["{}_self", "query"],
    "attention.attention.key": ["{}_self", "key"],
    "attention.attention.value": ["{}_self", "value"],
    "attention.output.dense": ["{}_self", "output_dense"],
    "crossattention.attention.query": ["{}_cross", "query"],
    "crossattention.attention.key": ["{}_cross", "key"],
    "crossattention.attention.value": ["{}_cross", "value"],
    "crossattention.output.dense": ["{}_cross", "output_dense"],
    "intermediate_query.dense": ["{}_fc1"],
    "output_query.dense": ["{}_fc2"],
}
_QFORMER_NORMS = {
    "attention.output.LayerNorm": ["{}_self", "output_ln"],
    "crossattention.output.LayerNorm": ["{}_cross", "output_ln"],
    "output_query.LayerNorm": ["{}_ffn_ln"],
}
_OPT_DENSE = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
              "self_attn.out_proj", "fc1", "fc2")
_OPT_NORMS = ("self_attn_layer_norm", "final_layer_norm")


def convert_blip2_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[Dict[str, Any], List[str]]:
    """HF state dict -> ({'params': tree}, unmatched keys)."""
    params: Dict[str, Any] = {}
    unmatched: List[str] = []
    for key, v in sd.items():
        v = np.asarray(v)
        is_w = key.endswith(".weight")
        base = key.rsplit(".", 1)[0]
        dense_leaf, dense_v = ("kernel", v.T) if is_w else ("bias", v)
        norm_leaf = "scale" if is_w else "bias"

        if key == "vision_model.embeddings.class_embedding":
            _set(params, ["vision_model"], "class_embedding", v.reshape(-1))
        elif key == "vision_model.embeddings.position_embedding":
            _set(params, ["vision_model"], "position_embedding",
                 v.reshape(v.shape[-2], v.shape[-1]))
        elif base == "vision_model.embeddings.patch_embedding":
            _set(params, ["vision_model", "patch_embedding"], dense_leaf,
                 np.transpose(v, (2, 3, 1, 0)) if is_w else v)
        elif base == "vision_model.post_layernorm":
            _set(params, ["vision_model", "post_layernorm"], norm_leaf, v)
        elif m := re.match(r"vision_model\.encoder\.layers\.(\d+)\.(.+)$", base):
            i, rest = m.groups()
            if rest in _VISION:
                _set(params, ["vision_model"] + [p.format(f"l{i}") for p in _VISION[rest]],
                     dense_leaf, dense_v)
            elif rest in _VISION_NORMS:
                _set(params, ["vision_model", _VISION_NORMS[rest].format(f"l{i}")],
                     norm_leaf, v)
            else:
                unmatched.append(key)
        elif key == "query_tokens":
            _set(params, ["qformer"], "query_tokens", v)
        elif base == "qformer.layernorm":
            _set(params, ["qformer", "layernorm"], norm_leaf, v)
        elif m := re.match(r"qformer\.encoder\.layer\.(\d+)\.(.+)$", base):
            i, rest = m.groups()
            if rest in _QFORMER:
                _set(params, ["qformer"] + [p.format(f"l{i}") for p in _QFORMER[rest]],
                     dense_leaf, dense_v)
            elif rest in _QFORMER_NORMS:
                _set(params, ["qformer"] + [p.format(f"l{i}") for p in _QFORMER_NORMS[rest]],
                     norm_leaf, v)
            else:
                unmatched.append(key)
        elif base == "language_projection":
            _set(params, ["language_projection"], dense_leaf, dense_v)
        else:
            lk = key.removeprefix("language_model.model.decoder.").removeprefix(
                "language_model.")
            lbase = lk.rsplit(".", 1)[0]
            if lbase in ("embed_tokens", "embed_positions"):
                _set(params, ["language_model", lbase], "embedding", v)
            elif lbase == "final_layer_norm":
                _set(params, ["language_model", "final_layer_norm"], norm_leaf, v)
            elif m := re.match(r"layers\.(\d+)\.(.+)$", lbase):
                i, rest = m.groups()
                root = ["language_model", f"layer{i}"]
                if rest in _OPT_DENSE:
                    _set(params, root + [rest.rsplit(".", 1)[-1]], dense_leaf, dense_v)
                elif rest in _OPT_NORMS:
                    _set(params, root + [rest], norm_leaf, v)
                else:
                    unmatched.append(key)
            elif lbase != "lm_head":  # the head is tied to embed_tokens
                unmatched.append(key)
    return {"params": params}, unmatched


def load_blip2_state(path: str, dims=None):
    """Every ``*.safetensors`` file of an HF blip2-opt directory -> a state
    dict for ``Blip2(dims)`` (default blip2-opt-2.7b).  Unmatched keys warn
    (as the JAX package's loader does); a key the module lacks or still
    needs, or a shape that differs, raises."""
    from omniparser_tpu_torch.weights.convert import convert_blip2, flatten_variables
    from omniparser_tpu_torch.weights.safetensors import read_safetensors

    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"{path}: no *.safetensors file")
    sd: Dict[str, np.ndarray] = {}
    for f in files:
        sd.update(read_safetensors(os.path.join(path, f)))
    tree, unmatched = convert_blip2_state_dict(sd)
    if unmatched:
        warnings.warn(f"{len(unmatched)} unmatched blip2 keys, e.g. {unmatched[:5]}")
    return convert_blip2(flatten_variables(tree), dims)
