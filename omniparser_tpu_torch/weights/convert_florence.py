"""An HF Florence-2 checkpoint directory -> the port's ``Florence2``
state_dict.

The reference loads ``icon_caption/model.safetensors`` through HF
``trust_remote_code``.  This converter maps those keys (the remote-code
spelling and the first-party transformers spelling of the DaViT tower,
the BART language model under ``language_model.``) onto the JAX package's
Florence-2 tree, which ``convert.flatten_variables`` ->
``convert.convert_florence2`` carries into the module and checks key by key.
The file is read with ``weights/safetensors.py`` (numpy alone).

Tied weights: ``encoder.embed_tokens``, ``decoder.embed_tokens`` and
``lm_head`` are views of ``shared``; a checkpoint holds all of them or only
one, and ``shared`` is rebuilt from an alias where it is missing.

Transposes:
  torch Linear [out, in]        -> Dense kernel [in, out]
  torch Conv2d [O, I, kh, kw]   -> Conv kernel [kh, kw, I, O]
  torch depthwise [C, 1, k, k]  -> [k, k, 1, C]
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Tuple

import numpy as np

from omniparser_tpu_torch.models.florence2 import BASE, FlorenceDims


def _lin(w):  # torch Linear -> Dense
    return np.transpose(w, (1, 0))


def _conv(w):  # torch Conv2d -> flax Conv
    return np.transpose(w, (2, 3, 1, 0))


def _set(tree: Dict, path: List[str], leaf, value):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = np.asarray(value, np.float32)


def _cosine_embedding(seq_len: int, dim: int) -> np.ndarray:
    """Florence-2's PositionalEmbeddingCosine1D (visual temporal embed)."""
    pos = np.arange(seq_len)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    out = np.zeros((seq_len, dim), np.float32)
    out[:, 0::2] = np.sin(pos * div)
    out[:, 1::2] = np.cos(pos * div)
    return out


def convert_florence_state_dict(
    sd: Dict[str, np.ndarray], dims: FlorenceDims = BASE
) -> Tuple[Dict[str, Any], List[str]]:
    """Returns ({'params': tree}, unmatched_keys)."""
    params: Dict[str, Any] = {}
    unmatched: List[str] = []
    tied_aliases: List[Tuple[str, np.ndarray]] = []

    # --- attention/dense rename tables -------------------------------- #
    lm_layer = {
        "self_attn.q_proj": ("self_attn", "q_proj"),
        "self_attn.k_proj": ("self_attn", "k_proj"),
        "self_attn.v_proj": ("self_attn", "v_proj"),
        "self_attn.out_proj": ("self_attn", "out_proj"),
        "encoder_attn.q_proj": ("encoder_attn", "q_proj"),
        "encoder_attn.k_proj": ("encoder_attn", "k_proj"),
        "encoder_attn.v_proj": ("encoder_attn", "v_proj"),
        "encoder_attn.out_proj": ("encoder_attn", "out_proj"),
    }
    lm_norms = {"self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"}

    davit_dense = {
        "attn.qkv": "qkv", "attn.proj": "proj",
        "ffn.fn.net.fc1": "fc1", "ffn.fn.net.fc2": "fc2",
        "mlp.fc1": "fc1", "mlp.fc2": "fc2",  # alt spelling
    }
    davit_norms = {"norm1": "norm1", "norm2": "norm2"}
    davit_cpe = {"conv1.fn.dw": "cpe1", "conv2.fn.dw": "cpe2"}
    # transformers-native Florence2 spelling (transformers>=4.56 ships the
    # model first-party; its re-uploaded checkpoints rename the remote-code
    # modules): spatial/channel blocks are named, attn/ffn flattened, CPE
    # convs lose the .fn.dw wrapper
    davit_native = {
        "window_attn.qkv": ("attn", "qkv"), "window_attn.proj": ("attn", "proj"),
        "channel_attn.qkv": ("attn", "qkv"), "channel_attn.proj": ("attn", "proj"),
        "ffn.fc1": ("mlp", "fc1"), "ffn.fc2": ("mlp", "fc2"),
    }
    davit_native_cpe = {"conv1": "cpe1", "conv2": "cpe2"}

    for key, v in sd.items():
        # native full-model state dicts nest everything under `model.`
        k = key.removeprefix("model.")
        is_weight = k.endswith(".weight")
        is_bias = k.endswith(".bias")
        base = k.rsplit(".", 1)[0]

        # ---------------- vision tower ---------------- #
        # conv embeds: remote code names the conv `proj`, native `conv`
        m = re.match(r"vision_tower\.convs\.(\d)\.(proj|conv|norm)$", base)
        if m:
            s, kind = m.groups()
            if kind != "norm":
                _set(params, ["vision", "davit", f"patch_embed{s}_conv"],
                     "kernel" if is_weight else "bias", _conv(v) if is_weight else v)
            else:
                _set(params, ["vision", "davit", f"patch_embed{s}_norm"],
                     "scale" if is_weight else "bias", v)
            continue

        m = re.match(r"vision_tower\.blocks\.(\d)\.(\d+)\.(0|1)\.(.+)$", base)
        if m:
            s, d, half, rest = m.groups()
            blk = f"stage{s}_blk{d}_" + ("spatial" if half == "0" else "channel")
            root = ["vision", "davit", blk]
            if rest in davit_cpe:
                _set(params, root + [davit_cpe[rest], "proj"],
                     "kernel" if is_weight else "bias", _conv(v) if is_weight else v)
            elif rest in davit_dense:
                sub = "attn" if rest.startswith("attn") else "mlp"
                _set(params, root + [sub, davit_dense[rest]],
                     "kernel" if is_weight else "bias", _lin(v) if is_weight else v)
            elif rest in davit_norms:
                _set(params, root + [davit_norms[rest]], "scale" if is_weight else "bias", v)
            else:
                unmatched.append(key)
            continue

        m = re.match(
            r"vision_tower\.blocks\.(\d)\.(\d+)\.(spatial_block|channel_block)\.(.+)$",
            base,
        )
        if m:  # transformers-native block spelling
            s, d, half, rest = m.groups()
            blk = f"stage{s}_blk{d}_" + (
                "spatial" if half == "spatial_block" else "channel"
            )
            root = ["vision", "davit", blk]
            if rest in davit_native_cpe:
                _set(params, root + [davit_native_cpe[rest], "proj"],
                     "kernel" if is_weight else "bias", _conv(v) if is_weight else v)
            elif rest in davit_native:
                sub, leaf = davit_native[rest]
                _set(params, root + [sub, leaf],
                     "kernel" if is_weight else "bias", _lin(v) if is_weight else v)
            elif rest in davit_norms:
                _set(params, root + [davit_norms[rest]], "scale" if is_weight else "bias", v)
            else:
                unmatched.append(key)
            continue

        # projection head around the tower
        if base == "image_projection":
            _set(params, ["vision"], "image_projection",
                 v if v.shape[0] != dims.d_model else np.transpose(v))
            continue
        if base.startswith("image_proj_norm"):
            _set(params, ["vision", "image_proj_norm"], "scale" if is_weight else "bias", v)
            continue
        if base.startswith("image_pos_embed.row_embeddings"):
            _set(params, ["vision"], "image_pos_embed_row", v)
            continue
        if base.startswith("image_pos_embed.column_embeddings"):
            _set(params, ["vision"], "image_pos_embed_col", v)
            continue
        if base.startswith("visual_temporal_embed"):
            _set(params, ["vision"], "visual_temporal_embed", v[:1])
            continue

        # ---------------- language model ---------------- #
        lk = k.removeprefix("language_model.").removeprefix("model.")
        lbase = lk.rsplit(".", 1)[0]
        if lbase in ("encoder.embed_tokens", "decoder.embed_tokens", "lm_head"):
            # BART weight tying: these are views of `shared`. torch
            # state_dicts include the duplicates, safetensors saves drop
            # them — either way `shared` is the single source of truth.
            # Recorded so the post-pass can (a) recover `shared` when the
            # checkpoint's dedup kept an alias name instead, and (b) warn
            # on a genuinely untied (fine-tuned) head being dropped.
            tied_aliases.append((lk, v))
            continue
        if lbase == "shared":
            _set(params, ["language_model", "shared"], "embedding", v)
            continue
        if lbase in ("encoder.embed_positions", "decoder.embed_positions"):
            side = "encoder" if lbase.startswith("encoder") else "decoder"
            _set(params, ["language_model", f"{side}_embed_positions"], "embedding", v)
            continue
        if lbase in ("encoder.layernorm_embedding", "decoder.layernorm_embedding"):
            side = "encoder" if lbase.startswith("encoder") else "decoder"
            _set(params, ["language_model", f"{side}_layernorm_embedding"],
                 "scale" if is_weight else "bias", v)
            continue
        if lk == "final_logits_bias":
            _set(params, ["language_model"], "final_logits_bias", v.reshape(-1))
            continue
        m = re.match(r"(encoder|decoder)\.layers\.(\d+)\.(.+)$", lbase)
        if m:
            side, i, rest = m.groups()
            root = ["language_model", f"{side}_layer{i}"]
            if rest in lm_layer:
                attn, proj = lm_layer[rest]
                _set(params, root + [attn, proj], "kernel" if is_weight else "bias",
                     _lin(v) if is_weight else v)
            elif rest in lm_norms:
                _set(params, root + [rest], "scale" if is_weight else "bias", v)
            elif rest in ("fc1", "fc2"):
                _set(params, root + [rest], "kernel" if is_weight else "bias",
                     _lin(v) if is_weight else v)
            else:
                unmatched.append(key)
            continue

        unmatched.append(key)

    # temporal embed may be cosine (non-learned) in the checkpoint
    vis = params.setdefault("vision", {})
    if "visual_temporal_embed" not in vis:
        vis["visual_temporal_embed"] = _cosine_embedding(1, dims.embed_dims[-1])

    # tied-weight post-pass: which alias name survives a checkpoint's
    # dedup depends on the remote code's _tied_weights_keys — if `shared`
    # itself was dropped, recover it from an alias; if an alias DIFFERS
    # from shared (untied / fine-tuned lm_head), warn instead of silently
    # ignoring it (the Florence2 module always ties, so it cannot be kept)
    lm = params.setdefault("language_model", {})
    if tied_aliases and "shared" not in lm:
        name, v = tied_aliases[0]
        lm["shared"] = {"embedding": v}
    if "shared" in lm:
        ref = lm["shared"]["embedding"]
        for name, v in tied_aliases:
            if v.shape != ref.shape or not np.array_equal(v, ref):
                import warnings

                warnings.warn(
                    f"tied alias {name} differs from shared embedding — "
                    "an untied (fine-tuned) head cannot be represented by "
                    "the weight-tied Florence2 module and was dropped"
                )

    return {"params": params}, unmatched


def load_florence_state(path: str, dims: FlorenceDims = BASE):
    """A checkpoint directory (model.safetensors + tokenizer files) ->
    (state_dict for ``Florence2(dims)``, dims, tokenizer directory).
    Unmatched checkpoint keys warn; a key the module lacks or a shape that
    differs raises with its path."""
    import warnings

    from omniparser_tpu_torch.weights.convert import convert_florence2, flatten_variables
    from omniparser_tpu_torch.weights.safetensors import read_safetensors

    sd = read_safetensors(os.path.join(path, "model.safetensors"))
    variables, unmatched = convert_florence_state_dict(sd, dims)
    if unmatched:
        warnings.warn(f"{len(unmatched)} unmatched florence keys, e.g. {unmatched[:5]}")
    return convert_florence2(flatten_variables(variables), dims), dims, path
