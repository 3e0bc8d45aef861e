"""Florence-2 (backend "florence"): the batched greedy caption decode that
parse_batch runs over every screenshot's first K icons, fused into the
device step's crops, and the per-screenshot overflow past K.

Each file of benchmark/captioners/ is one captioner backend, found by the
name in the configuration's ``pipeline.captioner.backend``, and exports:

  reference(cfg) -> (dims, make_module, keep_f32)
      the reference's dims object for the configuration's
      ``captioner_dims``, a function that builds the reference network
      (the seeded draw builds it on the meta device for its parameter
      list), and the module names whose parameters are served in float32
  port_dims(cfg)
      the measured package's own dims object for ``captioner_dims``
  warm(pipe, shape, images)
      every shape the cell's traffic drives through this captioner, on
      the built pipeline, with the cell's screen shape and its heaviest
      screenshots
  fused(cfg) -> bool
      whether captions come out of the fused device step (the batched
      decode over its crops) rather than calls of K crops per screenshot
  readings(judge, crops, tokens, scores, overflow, lower) -> dict
      the captioner's numbers for `correct`: the served tokens and scores
      of the sampled captions against the reference's, teacher-forced
      (``reference/judge.py`` passes itself, the reference crops, the
      tokens, the scores, which captions came from an overflow call, and
      the control's networks or None)
  served_text(cfg, text, logp) -> str
      the string the port serves for a caption decoded as `text` with the
      score `logp` (a confidence gate where the captioner has one)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.judge import CAPTION_BLOCK, fallback_ids

# the published processor's normalisation and the <CAPTION> task's prompt
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
PROMPT = "What does the image describe?"


def _raw(cfg: Dict) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["captioner_dims"].items()}


def reference(cfg: Dict):
    from benchmark.reference import florence2 as net

    dims = net.FlorenceDims(**_raw(cfg))
    return dims, lambda: net.Florence2(dims), ("language_model", "language_model.shared")


def port_dims(cfg: Dict):
    from omniparser_tpu_torch.models.florence2 import FlorenceDims

    return FlorenceDims(**_raw(cfg))


def warm(pipe, shape, images) -> None:
    """Each caption decode bucket that parse_batch can use, then real
    screenshots through parse_batch."""
    k = pipe.config.captioner.batch_size
    buckets = []
    b = 8
    while b <= pipe._DECODE_CHUNK:
        buckets.append(b)
        b *= 2
    pipe.warmup(shapes=(tuple(shape),), cap_buckets=tuple(buckets) + (k,))
    pipe.parse_batch(images)


def fused(cfg: Dict) -> bool:
    return bool(cfg["pipeline"]["captioner"].get("split_decode", True))


def readings(judge, crops, tokens, scores, overflow, lower) -> Dict[str, float]:
    """The captions' score gaps, root-mean-square over the batched
    decode's captions and over the overflow decode's apart: the served
    mean log-probability of the greedy tokens (up to and including the
    first end token, as the decode counts it) against the reference's,
    teacher-forced along the same tokens."""
    d, dev = judge.nets.dims, judge.dev
    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    prompt = torch.tensor(fallback_ids(PROMPT, True), device=dev)
    gaps = []
    for s in range(0, crops.shape[0], CAPTION_BLOCK):
        c = crops[s:s + CAPTION_BLOCK]
        tok = tokens[s:s + CAPTION_BLOCK]
        n, t = tok.shape
        pix = (c / 255.0 - mean) / std
        pr = prompt[None].expand(n, -1)
        dec = torch.cat([torch.full((n, 1), d.decoder_start_token_id, device=dev,
                                    dtype=torch.long), tok[:, :-1]], dim=1)
        is_eos = tok == d.eos_token_id
        first = torch.where(is_eos.any(1), is_eos.int().argmax(1), torch.full_like(
            is_eos[:, 0], t - 1, dtype=torch.long))
        counted = (torch.arange(t, device=dev)[None, :] <= first[:, None]).float()

        def score(net):
            lp = torch.log_softmax(net(pix, pr, dec).float(), dim=-1)
            picked = lp.gather(-1, tok[..., None])[..., 0]
            return ((picked * counted).sum(1) / counted.sum(1)).cpu().numpy()

        ref = score(judge.nets.captioner)
        got = score(lower.captioner) if lower is not None else scores[s:s + CAPTION_BLOCK]
        gaps.append(got - ref)
    gaps = np.concatenate(gaps)
    r = {}
    for name, sel in (("caption_score_rms_gap", ~overflow),
                      ("caption_overflow_score_rms_gap", overflow)):
        if sel.any():
            r[name] = float(np.sqrt(np.mean(gaps[sel] ** 2)))
    return r


def served_text(cfg: Dict, text: str, logp: float) -> str:
    """The decode-confidence gate: below the configuration's min_logp the
    port serves the junk-class phrase."""
    floor = cfg["pipeline"]["captioner"].get("min_logp")
    return "image icon" if floor is not None and logp < floor else text
