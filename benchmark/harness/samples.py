"""The sampled requests' outputs, as the timed path produced them, sorted
into what the reference judges: each screenshot's download, its detector
head, its text-detector map, its caption segments (the boxes, crops,
tokens and scores of every generate call that served it, and whether the
call was the overflow's) and the elements served to it.

parse_batch captions in this order, which the sorting follows: for a
captioner fused into the device step, one decode per chunk of at most
`chunk` slots over every image's first K needed icons (in image order),
then, image by image, the icons beyond K in calls of K crops; for a
captioner outside the step, image by image, every needed icon in calls of
K crops."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _need(out) -> np.ndarray:
    return np.nonzero(out["icon_keep"] & ~out["absorb"].any(axis=1))[0]


def caption_segments(batch: Dict, fused: bool, k: int, chunk: int) -> List[List[Dict]]:
    outs, calls = batch["out"], list(batch["generate"])
    per_image: List[List[Dict]] = [[] for _ in outs]
    needs = [_need(o) for o in outs]
    if fused:
        counts = [min(len(n), k) for n in needs]
        total = sum(counts)
        n_chunks = -(-total // chunk)
        chunk_calls, calls = calls[:n_chunks], calls[n_chunks:]
        off = 0
        for i, (out, c) in enumerate(zip(outs, counts)):
            if c:
                rows = range(off, off + c)
                crops = [chunk_calls[s // chunk][0][s % chunk] for s in rows]
                toks = [chunk_calls[s // chunk][1][s % chunk] for s in rows]
                lps = [chunk_calls[s // chunk][2][s % chunk] for s in rows]
                per_image[i].append(_segment(out["det_boxes"][needs[i][:c]], crops, toks, lps,
                                             overflow=False))
            off += c
        rest = [n[k:] for n in needs]
    else:
        rest = needs
    for i, idx in enumerate(rest):
        for s in range(0, len(idx), k):
            crops, toks, lps = calls.pop(0)
            m = len(idx[s:s + k])
            per_image[i].append(_segment(outs[i]["det_boxes"][idx[s:s + k]],
                                         list(crops[:m]), list(toks[:m]), list(lps[:m]),
                                         overflow=fused))
    if calls:
        raise RuntimeError(f"{len(calls)} generate calls of the batch are not accounted for")
    return per_image


def _segment(boxes, crops, toks, lps, overflow: bool) -> Dict:
    import torch

    return {"overflow": overflow, "boxes": np.ascontiguousarray(boxes, np.float32),
            "crops": torch.stack(crops),
            "tokens": torch.stack(toks).cpu().numpy().astype(np.int64),
            "scores": torch.stack(lps).float().cpu().numpy()}


def assemble(captured: Dict, fused: bool, k: int, chunk: int) -> List[Dict]:
    """captured: sample key -> (batch, position) -> the samples, in key order."""
    segs_of = {}
    samples = []
    for key in sorted(captured):
        batch, i = captured[key]
        if i >= len(batch["out"]):  # the timed path never produced this answer
            continue
        if id(batch) not in segs_of:
            segs_of[id(batch)] = caption_segments(batch, fused, k, chunk)
        samples.append({"key": key, "image": batch["images"][i], "out": batch["out"][i],
                        "det": batch["det"][i], "ocr_map": batch["ocr_map"][i],
                        "rec": batch["rec"][i], "result": batch["results"][i],
                        "captions": segs_of[id(batch)][i]})
    return samples
