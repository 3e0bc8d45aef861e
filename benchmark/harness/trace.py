"""The traced run's device view: torch.profiler (CUDA activity only) over a
slice of the window, the union of kernel intervals, kernel time by name,
and the idle gaps labelled by what the host was doing.

A marker kernel on a side stream, launched right after the profiler starts,
ties the trace's clock to the host's: gaps are then labelled from the
harness's own host spans (batcher wait, dispatch, finish, decode, caption)."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

MARKER_CYCLES = 1000


def profile_slice(device, start_s: float, length_s: float, t0: float) -> Dict:
    """Profile [t0 + start_s, t0 + start_s + length_s] of the window."""
    from torch.profiler import ProfilerActivity, profile

    delay = t0 + start_s - time.perf_counter()
    if delay > 0:
        time.sleep(delay)
    side = torch.cuda.Stream(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_mark = time.perf_counter()
        with torch.cuda.stream(side):
            torch.cuda._sleep(MARKER_CYCLES)
        time.sleep(max(length_s - (time.perf_counter() - t_mark), 0.0))
        torch.cuda.synchronize(device)
        t_end = time.perf_counter()
    kernels: List[Tuple[str, float, float]] = []  # (name, start_us, end_us)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, float(e.time_range.start), float(e.time_range.end)))
    return {"kernels": kernels, "t_mark": t_mark, "t_end": t_end}


def reduce_slice(sl: Dict, host_spans: List[Tuple[str, float, float]]) -> Dict:
    """busy seconds (union of kernel intervals), the traced window, device
    time by kernel name, and the ten longest idle gaps with their labels."""
    ks = sorted(sl["kernels"], key=lambda k: k[1])
    marker = [k for k in ks if "spin" in k[0] or "sleep" in k[0]]
    ks = [k for k in ks if not ("spin" in k[0] or "sleep" in k[0])]
    if not ks:
        return {"busy_s": 0.0, "window_s": sl["t_end"] - sl["t_mark"], "by_name": {},
                "gaps": []}
    origin_us = marker[0][1] if marker else ks[0][1]
    window_us = (sl["t_end"] - sl["t_mark"]) * 1e6
    by_name: Dict[str, List[float]] = {}
    merged: List[List[float]] = []
    for name, s, e in ks:
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += (e - s) / 1e6
        row[1] += 1
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    gaps = []
    edges = [origin_us] + [x for seg in merged for x in seg] + [origin_us + window_us]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:10]:
        ha = sl["t_mark"] + (a - origin_us) / 1e6
        hb = sl["t_mark"] + (b - origin_us) / 1e6
        labelled.append((label(ha, hb, host_spans), (b - a) / 1e6))
    return {"busy_s": busy_us / 1e6, "window_s": window_us / 1e6, "by_name": by_name,
            "gaps": labelled}


# a gap takes the label of the host span that overlaps it most, in this
# order of precedence where two overlap alike
_ORDER = ("caption", "dispatch", "finish", "decode", "batcher_wait")


def label(a: float, b: float, spans: List[Tuple[str, float, float]]) -> str:
    best, best_overlap = "other", 0.0
    for name, s, e in spans:
        ov = min(b, e) - max(a, s)
        if ov > best_overlap or (ov == best_overlap and ov > 0 and
                                 _ORDER.index(name) < _ORDER.index(best)):
            best, best_overlap = name, ov
    return best


def host_spans(batches: List[Dict], caption_host: List[Tuple[float, float]]):
    """The harness's host spans: each batch's dispatch / finish / decode (in
    parse_batch's order, from its last_timings), the batcher's wait between
    batches, and every caption generate call."""
    spans = []
    prev_end = None
    for b in batches:
        if prev_end is not None and b["t0"] > prev_end:
            spans.append(("batcher_wait", prev_end, b["t0"]))
        t = b["t0"]
        for name in ("dispatch", "finish", "decode"):
            d = b.get(name, 0.0)
            spans.append((name, t, t + d))
            t += d
        prev_end = b["t1"]
    spans += [("caption", a, b) for a, b in caption_host]
    return spans
