"""Connected components for the OCR text-detector postprocess, on the
tensor's device.

Labels the binarised probability map and returns only per-component
boxes/scores, with the semantics of the JAX package's
``device_components`` (4-connectivity, raster order of each component's
first pixel, min_area/min_score filters applied before the output cap):

  * labelling: min-label propagation to a fixed point.  One round takes,
    for every contiguous masked run of a row and then of a column, the
    minimum label of the run (run ids from a cumulative sum of run starts,
    minima by ``scatter_reduce``).  The fixed point — every pixel holds the
    flat index of its component's raster-first pixel — does not depend on
    how it is reached.  Each round ends with one host read of "changed?".
  * per-component reduction: each pixel's root label maps to a dense rank
    slot; bbox/area/score reduce by scatter over the slots.

Everything is fixed-shape: [pre_cap] raw component slots, compacted to
[max_out] filtered outputs + a count, with dropped-component counters.
"""

from __future__ import annotations

from typing import Dict

import torch


def _run_min_rows(labels: torch.Tensor, mask: torch.Tensor, inf: int) -> torch.Tensor:
    """Min label over each contiguous masked run along the last axis."""
    h, w = mask.shape
    prev = torch.zeros_like(mask)
    prev[:, 1:] = mask[:, :-1]
    starts = mask & ~prev
    run_id = torch.cumsum(starts.reshape(-1).to(torch.int64), 0) - 1  # [H*W]
    flat_mask = mask.reshape(-1)
    idx = torch.where(flat_mask, run_id, torch.full_like(run_id, h * w))
    mins = torch.full((h * w + 1,), inf, dtype=labels.dtype, device=labels.device)
    mins = mins.scatter_reduce(0, idx, labels.reshape(-1), reduce="amin", include_self=True)
    out = torch.where(flat_mask, mins[idx], torch.full_like(mins[idx], inf))
    return out.reshape(h, w)


def _propagate_labels(mask: torch.Tensor, inf: int) -> torch.Tensor:
    """4-connected min-label propagation to convergence.  mask [H,W] bool ->
    [H,W] int64: masked pixels hold the min flat index of their component,
    unmasked pixels hold `inf`."""
    h, w = mask.shape
    flat = torch.arange(h * w, dtype=torch.int64, device=mask.device).reshape(h, w)
    labels = torch.where(mask, flat, torch.full_like(flat, inf))
    mask_t = mask.t().contiguous()

    def one_round(l):
        l = _run_min_rows(l, mask, inf)
        return _run_min_rows(l.t().contiguous(), mask_t, inf).t().contiguous()

    while True:
        nl = one_round(labels)
        if torch.equal(nl, labels):
            return labels
        labels = nl


def device_components(prob: torch.Tensor, bin_threshold: float = 0.3,
                      min_score: float = 0.3, min_area: int = 4,
                      max_out: int = 1024, pre_cap: int = 1024) -> Dict[str, torch.Tensor]:
    """Connected components of (prob > bin_threshold) with per-component
    stats.  prob: [H, W] float32 in [0, 1] (apply any quantisation BEFORE
    calling).

    Returns dict of fixed-shape tensors on prob's device:
      boxes    [max_out, 4] int32  xyxy, x2/y2 exclusive, raster order
      scores   [max_out] float32   mean prob over component pixels
      areas    [max_out] int32
      count    [] int32            filtered components in `boxes`
      overflow [] int32            components dropped by pre_cap/max_out
    """
    h, w = prob.shape
    dev = prob.device
    inf = h * w
    mask = prob > bin_threshold
    labels_f = _propagate_labels(mask, inf).reshape(-1)

    flatpix = torch.arange(h * w, dtype=torch.int64, device=dev)
    mask_f = mask.reshape(-1)
    is_root = mask_f & (labels_f == flatpix)
    rank = torch.cumsum(is_root.to(torch.int64), 0) - 1
    n_roots = is_root.sum()

    # per-pixel slot: rank of its component's root (pre_cap = dumping slot)
    dense = torch.where(is_root & (rank < pre_cap), rank, torch.full_like(rank, pre_cap))
    dense = torch.cat([dense, torch.full((1,), pre_cap, dtype=dense.dtype, device=dev)])
    slots = dense[labels_f]  # [H*W] in [0, pre_cap]; unmasked pixels -> pre_cap

    xs = flatpix % w
    ys = flatpix // w
    n_slots = pre_cap + 1

    def reduce(values, init, how):
        buf = torch.full((n_slots,), init, dtype=values.dtype, device=dev)
        return buf.scatter_reduce(0, slots, values, reduce=how, include_self=True)[:pre_cap]

    x1 = reduce(xs, inf, "amin")
    y1 = reduce(ys, inf, "amin")
    x2 = reduce(xs, -1, "amax")
    y2 = reduce(ys, -1, "amax")
    area = reduce(torch.ones_like(xs), 0, "sum")
    # float64 accumulation: the sum's order is not fixed on the card, and
    # in float64 the order cannot reach the float32 result
    psum = reduce(prob.reshape(-1).to(torch.float64), 0.0, "sum").to(torch.float32)
    score = psum / torch.clamp(area, min=1).to(torch.float32)

    occupied = area > 0
    keep = occupied & (area >= min_area) & (score >= min_score)

    # compact filtered components (slot order IS root raster order)
    out_rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    dest = torch.where(keep & (out_rank < max_out), out_rank,
                       torch.full_like(out_rank, max_out))
    boxes_all = torch.stack([x1, y1, x2 + 1, y2 + 1], dim=1).to(torch.int32)
    boxes = torch.zeros((max_out + 1, 4), dtype=torch.int32, device=dev)
    boxes[dest] = boxes_all
    scores = torch.zeros((max_out + 1,), dtype=torch.float32, device=dev)
    scores[dest] = score
    areas = torch.zeros((max_out + 1,), dtype=torch.int32, device=dev)
    areas[dest] = area.to(torch.int32)
    n_keep = keep.sum()
    count = torch.clamp(n_keep, max=max_out)
    overflow = (n_keep - count) + torch.clamp(n_roots - pre_cap, min=0)
    return {"boxes": boxes[:max_out], "scores": scores[:max_out],
            "areas": areas[:max_out], "count": count.to(torch.int32),
            "overflow": overflow.to(torch.int32)}


def quantize_u8_parity(prob: torch.Tensor) -> torch.Tensor:
    """Round to the uint8 grid (k/255) so binarise/score thresholds see the
    values a uint8 download of the map would carry."""
    q = torch.floor(torch.clamp(prob, 0.0, 1.0) * 255.0 + 0.5)
    return q / 255.0


def candidate_boxes_from_cc(cc_boxes: torch.Tensor, cc_count: torch.Tensor, r,
                            pad_yx, hw, max_boxes: int, scale: int = 2,
                            unclip: float = 2.0):
    """Component boxes at det-map scale -> normalised text-line candidate
    boxes in the uploaded frame: unclip + letterbox unmap + min-size filter.

    cc_boxes: [C, 4] int32 xyxy at det-map scale (x2/y2 exclusive), raster
    order.  cc_count: [] int32.  r / pad_yx: letterbox scale + (pad_y,
    pad_x), rounded to float32 here.  hw: (h, w) of the uploaded frame.

    Returns (boxes_norm [max_boxes, 4] fp32, valid [max_boxes] bool,
    overflow [] int32 — candidates dropped by the max_boxes cap).
    """
    dev = cc_boxes.device
    b = cc_boxes[:max_boxes].to(torch.float32)
    n = torch.clamp(cc_count, max=max_boxes)
    valid = torch.arange(max_boxes, dtype=torch.int32, device=dev) < n
    wc = b[:, 2] - b[:, 0]
    hc = b[:, 3] - b[:, 1]
    # the margin is a multiple of 0.5 and *scale makes every corner an
    # exact integer — the rounding mode cannot matter
    margin = float((unclip - 1.0) * 0.5) * torch.minimum(wc, hc)
    s = float(scale)
    x1 = torch.round((b[:, 0] - margin) * s)
    y1 = torch.round((b[:, 1] - margin) * s)
    x2 = torch.round((b[:, 2] + margin) * s)
    y2 = torch.round((b[:, 3] + margin) * s)

    def f32(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    r32, py, px = f32(r), f32(pad_yx[0]), f32(pad_yx[1])
    fh, fw = f32(int(hw[0])), f32(int(hw[1]))
    bx1 = torch.clamp((x1 - px) / r32, min=0.0)
    by1 = torch.clamp((y1 - py) / r32, min=0.0)
    bx2 = torch.minimum((x2 - px) / r32, fw)
    by2 = torch.minimum((y2 - py) / r32, fh)
    ok = valid & (bx2 - bx1 >= 1.0) & (by2 - by1 >= 1.0)
    ib = torch.stack([torch.floor(bx1), torch.floor(by1),
                      torch.floor(bx2), torch.floor(by2)], dim=1)
    norm = ib / torch.stack([fw, fh, fw, fh])
    norm = torch.where(ok[:, None], norm, torch.zeros_like(norm))
    overflow = torch.clamp(cc_count - max_boxes, min=0)
    return norm, ok, overflow.to(torch.int32)


def candidate_boxes_np(comps, r, pads, w: int, h: int, scale: int = 2,
                       unclip: float = 2.0):
    """Numpy float32 restatement of ``candidate_boxes_from_cc`` for the
    host candidate path: [(box_xyxy, score)] components at det-map scale ->
    compacted [x1, y1, x2, y2] int pixel boxes in the uploaded frame.

    Both share operation order and float32 precision, so their truncated
    integer boxes are identical (the unmap divides by the letterbox ratio,
    and float64 could truncate a knife-edge value to another integer)."""
    import numpy as np

    if not comps:
        return []
    b = np.asarray([c[0] for c in comps], np.float32).reshape(-1, 4)
    wc = b[:, 2] - b[:, 0]
    hc = b[:, 3] - b[:, 1]
    margin = np.float32((unclip - 1.0) * 0.5) * np.minimum(wc, hc)
    s = np.float32(scale)
    x1 = np.round((b[:, 0] - margin) * s)
    y1 = np.round((b[:, 1] - margin) * s)
    x2 = np.round((b[:, 2] + margin) * s)
    y2 = np.round((b[:, 3] + margin) * s)
    r32 = np.float32(r)
    py, px = np.float32(pads[0]), np.float32(pads[1])
    bx1 = np.maximum((x1 - px) / r32, np.float32(0.0))
    by1 = np.maximum((y1 - py) / r32, np.float32(0.0))
    bx2 = np.minimum((x2 - px) / r32, np.float32(w))
    by2 = np.minimum((y2 - py) / r32, np.float32(h))
    ok = (bx2 - bx1 >= 1.0) & (by2 - by1 >= 1.0)
    ib = np.stack([bx1, by1, bx2, by2], axis=1).astype(np.int64)
    return [list(int(v) for v in row) for row in ib[ok]]
