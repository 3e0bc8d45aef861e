"""BLIP-2 OPT (backend "blip2"): EVA ViT-g, Q-Former and OPT, a beam
search over every content-less icon, in calls of K crops per screenshot,
outside the fused device step.

The interface is the one that ``captioners/florence.py`` writes down."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.judge import CAPTION_BLOCK, fallback_ids

# the published processor's normalisation and OmniParser v1's prompt
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
PROMPT = "The image shows"


def _raw(cfg: Dict) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["captioner_dims"].items()}


def reference(cfg: Dict):
    from benchmark.reference import blip2 as net

    dims = net.Blip2Dims(**_raw(cfg))
    return dims, lambda: net.Blip2(dims), ("language_model.embed_tokens",)


def port_dims(cfg: Dict):
    from omniparser_tpu_torch.models.blip2 import Blip2Dims

    return Blip2Dims(**_raw(cfg))


def warm(pipe, shape, images) -> None:
    """The blank parse per shape, then one parse with captions (the beam
    decode's calls of K crops)."""
    pipe.warmup(shapes=(tuple(shape),), cap_buckets=())
    pipe.parse_batch(images[:1])


def fused(cfg: Dict) -> bool:
    return False


def _logp(judge, net, crops, tokens) -> torch.Tensor:
    """log-probabilities [N, T, V] of each generated position, teacher-
    forced over (queries ++ prompt ++ tokens)."""
    d, dev = judge.nets.dims, judge.dev
    mean = torch.tensor(MEAN, device=dev)[:, None, None]
    std = torch.tensor(STD, device=dev)[:, None, None]
    x = F.interpolate(crops.permute(0, 3, 1, 2), size=(d.image_size, d.image_size),
                      mode="bilinear", align_corners=False, antialias=True)
    pix = (x / 255.0 - mean) / std
    n, t = tokens.shape
    prompt = torch.tensor([d.bos_token_id] + fallback_ids(PROMPT, False), device=dev)
    lm = net.language_model
    q = net.language_projection(net.qformer(net.vision_model(pix)))
    ids = torch.cat([prompt[None].expand(n, -1), tokens[:, :-1]], dim=1)
    emb = torch.cat([q, lm.embed_tokens(ids).float()], dim=1)
    length = emb.shape[1]
    pos = lm.embed_positions(torch.arange(length, device=dev) + 2)
    h = emb + pos[None]
    mask = (torch.arange(length, device=dev)[None, :]
            <= torch.arange(length, device=dev)[:, None])[None, None]
    hd = d.lm_width // d.lm_heads
    for i in range(d.lm_layers):
        cache = [torch.zeros((n, d.lm_heads, length, hd), device=dev) for _ in range(2)]
        h = getattr(lm, f"layer{i}")(h, mask, cache, 0)
    h = F.layer_norm(h, lm.final_layer_norm.normalized_shape, lm.final_layer_norm.weight,
                     lm.final_layer_norm.bias, lm.final_layer_norm.eps)
    prefix = d.num_query_tokens + prompt.shape[0]
    logits = h[:, prefix - 1:prefix - 1 + t] @ lm.embed_tokens.weight.float().T
    return torch.log_softmax(logits, dim=-1)


def readings(judge, crops, tokens, scores, overflow, lower) -> Dict[str, float]:
    """caption_score_gap: the largest gap between a served beam's
    length-normalised score and the reference's score of the same tokens:
    the log-probabilities of every generated token up to and including the
    first end token (a pad id generated before it is a token like any
    other), over the beam's length as the configuration's decode counts
    it, its tokens that are not the pad id plus the prompt's."""
    d, dev = judge.nets.dims, judge.dev
    p = 1 + len(fallback_ids(PROMPT, False))
    worst = 0.0
    for s in range(0, crops.shape[0], CAPTION_BLOCK):
        c, tok = crops[s:s + CAPTION_BLOCK], tokens[s:s + CAPTION_BLOCK]
        t = tok.shape[1]
        length = (tok != d.pad_token_id).sum(1).float() + p
        is_eos = tok == d.eos_token_id
        first = torch.where(is_eos.any(1), is_eos.int().argmax(1), torch.full_like(
            is_eos[:, 0], t - 1, dtype=torch.long))
        counted = torch.arange(t, device=dev)[None, :] <= first[:, None]

        def score(net):
            lp = _logp(judge, net, c, tok)
            picked = lp.gather(-1, tok[..., None])[..., 0]
            return (torch.where(counted, picked, torch.zeros_like(picked)).sum(1)
                    / length).cpu().numpy()

        ref = score(judge.nets.captioner)
        got = score(lower.captioner) if lower is not None else scores[s:s + CAPTION_BLOCK]
        worst = max(worst, float(np.abs(got - ref).max()))
    return {"caption_score_gap": worst}


def served_text(cfg: Dict, text: str, logp: float) -> str:
    """The beam decode's captions are served as decoded."""
    return text
