"""An HF microsoft/Phi-3-vision directory -> the port's ``Phi3V`` state_dict.

The keys are HF ``modeling_phi3_v``'s: ``model.layers.{i}.self_attn.qkv_proj``
and ``mlp.gate_up_proj`` fused, the CLIP tower under
``model.vision_embed_tokens.img_processor.vision_model.``, the projector as
``model.vision_embed_tokens.img_projection.{0,2}``.  The map builds the JAX
package's tree layout (``[in, out]`` dense kernels, HWIO patch conv, norm
``scale``), which goes through the same carrier as the JAX package's own
trees (``convert.convert_phi3v``), where every key and shape is checked
against the module.  Keys that map nowhere are returned as ``unmatched``.

Skipped by design, as the JAX package skips them: the vision
``post_layernorm`` (the features come from the penultimate layer, which
never passes it), ``glb_GN`` / ``sub_GN`` (HD-transform tile separators:
one 336 crop, no tiling), rotary ``inv_freq`` and CLIP's ``position_ids``
buffer.  Also skipped, unlike the JAX package: the tower layers after the
feature layer (the checkpoint's 24th), which the port does not build; they
are returned apart as ``unused``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from omniparser_tpu_torch.models.phi3v import PHI3V_BASE, Phi3VDims


def _lin(w):
    return np.transpose(w, (1, 0))


def _conv(w):
    return np.transpose(w, (2, 3, 1, 0))


def _set(tree, path, leaf, value):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = np.asarray(value, np.float32)


_VIS = "model.vision_embed_tokens.img_processor.vision_model."
_SKIP = re.compile(
    r"(post_layernorm|glb_GN|sub_GN|rotary_emb\.inv_freq|embeddings\.position_ids)")
_LM_LAYER = re.compile(
    r"model\.layers\.(\d+)\.(self_attn\.(?:qkv_proj|o_proj)|mlp\.(?:gate_up_proj|down_proj)"
    r"|input_layernorm|post_attention_layernorm)\.(weight|bias)")
_PROJ = re.compile(r"model\.vision_embed_tokens\.img_projection\.(\d+)\.(weight|bias)")
_VIS_LAYER = re.compile(
    r"encoder\.layers\.(\d+)\.(self_attn\.(?:q_proj|k_proj|v_proj|out_proj)"
    r"|layer_norm1|layer_norm2|mlp\.fc1|mlp\.fc2)\.(weight|bias)")


def convert_phi3v_state_dict(sd: Dict[str, np.ndarray], dims: Phi3VDims = PHI3V_BASE
                             ) -> Tuple[Dict[str, Any], List[str], List[str]]:
    """HF state dict -> ({'params': tree}, unmatched keys, unused keys: the
    tower layers at or after dims.vision_layers_run)."""
    params: Dict[str, Any] = {}
    unmatched: List[str] = []
    unused: List[str] = []
    for key, v in sd.items():
        if _SKIP.search(key):
            continue
        is_w = key.endswith(".weight")
        dense_leaf = lambda: ("kernel", _lin(v)) if is_w else ("bias", v)
        norm_leaf = "scale" if is_w else "bias"

        if key == "model.embed_tokens.weight":
            _set(params, ["embed_tokens"], "embedding", v)
            continue
        if key.rsplit(".", 1)[0] == "model.norm":
            _set(params, ["final_norm"], norm_leaf, v)
            continue
        if key.rsplit(".", 1)[0] == "lm_head":
            _set(params, ["lm_head"], *dense_leaf())
            continue
        m = _LM_LAYER.fullmatch(key)
        if m:
            i, name = int(m.group(1)), m.group(2).split(".")[-1]
            if "layernorm" in name:
                _set(params, [f"layers_{i}", name], norm_leaf, v)
            else:
                _set(params, [f"layers_{i}", name], *dense_leaf())
            continue
        m = _PROJ.fullmatch(key)
        if m:
            name = {0: "proj_1", 2: "proj_2"}.get(int(m.group(1)))
            if name is None:
                unmatched.append(key)
            else:
                _set(params, [name], *dense_leaf())
            continue
        if not key.startswith(_VIS):
            unmatched.append(key)
            continue
        vk = key[len(_VIS):]
        if vk == "embeddings.class_embedding":
            _set(params, ["vision"], "class_embedding", v.reshape(-1))
        elif vk == "embeddings.position_embedding.weight":
            _set(params, ["vision"], "position_embedding", v)
        elif vk == "embeddings.patch_embedding.weight":
            _set(params, ["vision", "patch_embedding"], "kernel", _conv(v))
        elif vk.startswith("pre_layrnorm."):  # HF CLIP's spelling
            _set(params, ["vision", "pre_layrnorm"], norm_leaf, v)
        elif (m := _VIS_LAYER.fullmatch(vk)) is not None:
            i, mod = int(m.group(1)), m.group(2)
            if i >= dims.vision_layers_run:
                unused.append(key)
            elif mod.startswith("layer_norm"):
                _set(params, ["vision", f"layers_{i}", mod], norm_leaf, v)
            elif mod.startswith("self_attn"):
                _set(params, ["vision", f"layers_{i}", "self_attn", mod.split(".")[1]],
                     *dense_leaf())
            else:  # mlp.fc1 / mlp.fc2
                _set(params, ["vision", f"layers_{i}", mod.split(".")[1]], *dense_leaf())
        else:
            unmatched.append(key)
    return {"params": params}, unmatched, unused


def checkpoint_dims(sd: Dict[str, np.ndarray]) -> Phi3VDims:
    """The published dims at the checkpoint's own depth: its decoder and
    tower layer counts read from the keys."""
    from omniparser_tpu_torch.models import phi3v

    def count(pattern):
        found = {int(m.group(1)) for k in sd if (m := re.match(pattern, k))}
        return max(found) + 1 if found else 0

    return dataclasses.replace(
        phi3v.PHI3V_BASE, lm_layers=count(r"model\.layers\.(\d+)\."),
        vision_layers=count(re.escape(_VIS) + r"encoder\.layers\.(\d+)\."))


def load_phi3v_state(path: str, dims: Optional[Phi3VDims] = None):
    """Every ``*.safetensors`` shard of an HF Phi-3-vision directory, in
    sorted order -> (state dict for ``Phi3V(dims)``, dims); dims None reads
    the depth from the keys (``checkpoint_dims``).  Unmatched keys warn (as
    the JAX package's loader does); a key the module lacks or still needs,
    or a shape that differs, raises."""
    from omniparser_tpu_torch.weights.convert import convert_phi3v, flatten_variables
    from omniparser_tpu_torch.weights.safetensors import read_safetensors

    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"{path}: no *.safetensors file")
    sd: Dict[str, np.ndarray] = {}
    for f in files:
        sd.update(read_safetensors(os.path.join(path, f)))
    dims = dims or checkpoint_dims(sd)
    tree, unmatched, _ = convert_phi3v_state_dict(sd, dims)
    if unmatched:
        warnings.warn(f"{len(unmatched)} unmatched phi3v keys, e.g. {unmatched[:5]}")
    return convert_phi3v(flatten_variables(tree), dims), dims
