#!/usr/bin/env python3
"""End-to-end parse benchmark of the PyTorch/CUDA port on one NVIDIA card.

    python3 bench_torch.py [--weights trained|seeded] [--inputs rendered|synthetic]
                           [--seed N] [--size S] [--count 8] [--calls 100]
                           [--rounds R] [--device cuda|cpu]

The port's counterpart of ``bench.py`` (the JAX package's benchmark, which
stays as it is) and of ``scripts/profile_device_step.py``.  Configuration
as ``bench.py``'s: ``PipelineConfig()`` with ``max_upload_side =
max_som_side = 1920``, an int8 captioner pinned to Florence-2-base dims with
seeded weights (the trained ``cap_synth`` is a reduced model and would
flatter the throughput), and the detector and OCR trained (``--weights
trained``, the default: ``'auto'``, the orbax trees ``det_synth`` and
``ocr_en_synth`` committed under ``omniparser_tpu/weights/``, read without
JAX; missing, the script raises) or seeded from ``--seed`` (``--weights
seeded``).

Inputs: ``--count`` screenshots made from ``--seed`` before any timing:
``render_gui_scene`` scenes of ``--size`` (default 1280; they need the TTF
faces, or the carried ones that ``scripts/export_torch_weights.py`` writes
into ``omniparser_tpu_torch/weights/exported/fonts/``) or, with ``--inputs
synthetic``, a font-free generator (long side ``--size``, default 1920, at
16:9).  Passes, in order: warm-up; latency (``parse_image`` of the first,
``--calls`` times); throughput (``parse_batch`` of all, 5 to 9 rounds under
75 s, or ``--rounds``); FLOPs; a traced pass of each path; a stage pass
(synchronised stages, then the caption decode alone); the check that
``parse_batch`` gives each screenshot what ``parse_image`` gives it.  The
end-to-end numbers come from the untraced passes.

Prints one JSON line, last, and exits non-zero where ``correct`` is false.
Without a card it raises; ``--device cpu`` is for tests and rehearsal, and
there every device field is null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from omniparser_tpu_torch.config import PipelineConfig
from omniparser_tpu_torch.utils.device import resolve_device

BASELINE_SHOTS_PER_SEC = 1.0 / 0.6  # A100 V2 reference point, as in bench.py
PEAK_BF16_FLOPS = 989e12            # H100 SXM dense bf16, at 700 W
BUDGET_S = 75.0
TREES = ("det_synth", "ocr_en_synth")  # the trained weights of --weights trained
KERNELS = ("nms_keep", "merge_masks", "crop_resize")
STAGE_PARSES = 5
DECODE_REPEATS = 10
BOX_ATOL = 1e-3      # parse_batch against parse_image, normalised boxes
RECALL_IOU = 0.5
# null where the run was not on a card: a CPU number is no device metric
DEVICE_FIELDS = ("mfu", "device_time_share", "device_ms", "launches_per_parse", "peak_bytes",
                 "device_stage_ms", "decode_device_ms", "top_kernels", "kernel_launches")
FLOPS_NOTE = ("torch.utils.flop_counter.FlopCounterMode over one parse_image, decode "
              "included: matmuls, convolutions and attention products at 2 FLOPs a "
              "multiply-add (an int8 product counts once, as the bf16 GEMM it runs as); "
              "elementwise ops, reductions and the three ctypes kernels (nms_keep, "
              "merge_masks, crop_resize: about 0.07 ms a parse) are not counted. "
              "mfu = device_flops_per_parse / (p50_latency_s x peak_flops)")


def bench_config(weights: str = "trained") -> PipelineConfig:
    """bench.py's serving configuration; 'seeded' seeds the detector and OCR too."""
    base = PipelineConfig()
    cfg = dataclasses.replace(
        base, max_upload_side=1920, max_som_side=1920,
        captioner=dataclasses.replace(base.captioner, quant="int8"),
        captioner_weights=None)
    if weights == "seeded":
        cfg = dataclasses.replace(cfg, detector_weights=None, ocr_weights=None)
    return cfg


def require_trees() -> dict:
    """{field: path} of the trained trees; raises, naming the tree, where
    one is missing (pass --weights seeded to run without them)."""
    from omniparser_tpu_torch import pipeline

    root = os.path.dirname(os.path.abspath(__file__))
    return {"detector_weights": os.path.relpath(pipeline.trained_tree(TREES[0]), root),
            "ocr_weights": os.path.relpath(pipeline.trained_tree(TREES[1]), root)}


def synthetic_screenshot(rng, h: int = 1080, w: int = 1920) -> np.ndarray:
    """Filled rectangles, bars and high-contrast blocks; no font library."""
    img = np.full((h, w, 3), 236, np.uint8)
    img[:48] = (40, 44, 52)                                   # title bar
    img[48:, :260] = (250, 250, 250)                          # side panel
    for i in range(14):                                       # side-panel rows
        y = 80 + i * 60
        img[y:y + 28, 24:52] = rng.integers(30, 200, 3)       # icon block
        x = 70
        for _ in range(int(rng.integers(2, 5))):              # "words": dark bars
            ww = int(rng.integers(18, 60))
            img[y + 8:y + 20, x:x + ww] = 25
            x += ww + 8
    for r in range(6):                                        # tool-bar icons
        for c in range(18):
            y, x = 70 + r * 150, 300 + c * 88
            col = rng.integers(0, 255, 3)
            img[y:y + 56, x:x + 56] = col
            img[y + 14:y + 42, x + 14:x + 42] = 255 - col
            xx = x
            for _ in range(int(rng.integers(1, 3))):          # caption bars
                ww = int(rng.integers(14, 34))
                img[y + 66:y + 76, xx:xx + ww] = 20
                xx += ww + 6
    for i in range(9):                                        # paragraph lines
        y = 960 + i * 12
        img[y:y + 7, 300:300 + int(rng.integers(600, 1500))] = 60
    return img


def make_inputs(kind: str, seed: int, count: int = 8, size=None):
    """(screenshots, icon boxes in pixels of each for rendered scenes, else None)."""
    rng = np.random.default_rng(seed)
    if kind == "synthetic":
        w = size or 1920
        return [synthetic_screenshot(rng, w * 9 // 16, w) for _ in range(count)], None
    from omniparser_tpu_torch.train.synth_gui import render_gui_scene

    scenes = [render_gui_scene(rng, size=size or 1280) for _ in range(count)]
    return ([np.asarray(s[0]) for s in scenes],
            [np.asarray(s[1], np.float32).reshape(-1, 4) for s in scenes])


def nearest_rank(xs, q: float) -> float:
    s = sorted(xs)
    return float(s[max(math.ceil(q * len(s)) - 1, 0)])


def time_latency(pipe, image, calls: int):
    lat, runs = [], []
    for _ in range(calls):
        t = time.perf_counter()
        pipe.parse_image(image)   # its results are on the host: the device is done
        lat.append(time.perf_counter() - t)
        runs.append(dict(pipe.last_timings))
    return {"p50": float(np.median(lat)), "p90": nearest_rank(lat, 0.9), "n": len(lat),
            "counts": dict(pipe.last_counts),
            "stages": {k: float(np.median([r.get(k, 0.0) for r in runs])) for k in runs[0]}}


def time_throughput(pipe, images, rounds=None):
    """parse_batch of all the images, `rounds` times, or 5 to 9 rounds under
    BUDGET_S -> (timings, the last round's results)."""
    times, results = [], None
    t_bench = time.perf_counter()
    for i in range(rounds or 9):
        if rounds is None and i >= 5 and time.perf_counter() - t_bench > BUDGET_S:
            break
        t0 = time.perf_counter()
        results = pipe.parse_batch(images)
        times.append(time.perf_counter() - t0)
    n = len(images)
    return {"value": n / float(np.median(times)), "best": n / float(np.min(times)),
            "median_round_s": float(np.median(times)), "round_s": times}, results


def count_flops(pipe, image):
    """(FLOPs of one parse_image, decode included; their split by the module
    that ran): each call of the OCR detector and of the caption decode in
    that parse is counted again by a counter of its own, nested in the
    parse's, and the fused step is the rest."""
    from torch.utils.flop_counter import FlopCounterMode

    split = {"ocr_detect": 0, "fused_step": 0, "decode": 0}

    def counted(fn, key):
        def call(*args, **kwargs):
            with FlopCounterMode(display=False) as fc:
                out = fn(*args, **kwargs)
            split[key] += int(fc.get_total_flops())
            return out
        return call

    parts = [(obj, name, key) for obj, name, key in ((pipe.ocr, "dispatch_det", "ocr_detect"),
                                                     (pipe.captioner, "generate", "decode"))
             if hasattr(obj, name)]
    for obj, name, key in parts:
        setattr(obj, name, counted(getattr(obj, name), key))
    try:
        with FlopCounterMode(display=False) as fc:
            pipe.parse_image(image)
    finally:
        for obj, name, _ in parts:
            delattr(obj, name)   # the class's method again
    total = int(fc.get_total_flops())
    split["fused_step"] = total - split["ocr_detect"] - split["decode"]
    return total, split


def _launch_counters():
    from omniparser_tpu_torch.ops import hopper_crop, hopper_kernels

    return hopper_kernels.launch_counts, hopper_crop.launch_counts


def _profiled(call, dev):
    """(the kernel rows (name, count, device ms) of one `call` under
    torch.profiler, largest first; the hand-written kernels' launches).  On
    the card it traces the device alone: the kernel rows are all it reads,
    and the host's operator rows would triple the post-processing."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU]
    for d in _launch_counters():
        d.update(dict.fromkeys(d, 0))
    with profile(activities=acts) as prof:
        call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    counts = {k: v for d in _launch_counters() for k, v in d.items()}
    # kernel rows only (an operator's row repeats its kernels' device time)
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
                  key=lambda r: -r[2])
    return rows, counts


def traced_pass(call, wall_s: float, shots: int, dev):
    """One `call` of `shots` screenshots under torch.profiler: its device time
    against `wall_s`, the untraced wall of the same call."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rows, counts = _profiled(call, dev)
    device_ms = sum(r[2] for r in rows)
    launches = int(sum(r[1] for r in rows))
    return {"device_ms": device_ms, "device_time_share": device_ms / (wall_s * 1e3),
            "launches": launches, "launches_per_parse": launches / shots,
            "top_kernels": [{"name": r[0][:80], "count": r[1], "ms": r[2]} for r in rows[:12]],
            "kernel_launches": {k: counts[k] for k in KERNELS},
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                           else None)}


def stage_pass(pipe, image, dev, parses: int = STAGE_PARSES, repeats: int = DECODE_REPEATS):
    """Synchronised stage medians over `parses` parse_image calls (the
    pipeline's own lap names), then the caption decode alone at the parse's
    slot bucket: CUDA events over `repeats` calls, and its busy device time,
    launches and idle share from one call under the profiler."""
    runs = []
    try:
        for _ in range(parses):
            pipe.stage_ms = {}
            pipe.parse_image(image)
            runs.append(pipe.stage_ms)
    finally:
        pipe.stage_ms = None
    names = list(dict.fromkeys(k for r in runs for k in r))
    stages = {k: float(np.median([r.get(k, 0.0) for r in runs])) for k in names}
    kb = pipe.last_counts.get("kb", 0)
    decode = {"kb": kb, "repeats": repeats, "events_ms": None, "busy_ms": None,
              "launches": None, "idle_share": None}
    if dev.type != "cuda" or not kb or pipe._florence is None:
        return stages, decode
    cs = pipe.config.captioner.crop_size
    crops = torch.zeros((kb, cs, cs, 3), dtype=torch.float32, device=dev)
    gen = pipe._florence.generate
    gen(crops)
    ms = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        gen(crops)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    rows, _ = _profiled(lambda: gen(crops), dev)
    busy = sum(r[2] for r in rows)
    decode.update(events_ms=float(np.median(ms)), events_ms_each=ms, busy_ms=busy,
                  launches=int(sum(r[1] for r in rows)),
                  idle_share=1.0 - busy / float(np.median(ms)))
    return stages, decode


def _iou_matches(gt: np.ndarray, pred: np.ndarray, thr: float) -> int:
    """Greedy one-to-one matches of `gt` to `pred` boxes (xyxy) at IoU >= thr."""
    from omniparser_tpu_torch.ops.boxes import pairwise_iou

    if not len(gt) or not len(pred):
        return 0
    iou = pairwise_iou(torch.from_numpy(gt), torch.from_numpy(pred)).numpy()
    hit = 0
    while True:
        i, j = np.unravel_index(np.argmax(iou), iou.shape)
        if iou[i, j] < thr:
            return hit
        hit += 1
        iou[i, :] = -1.0
        iou[:, j] = -1.0


def compare_elements(got, want):
    """(the first difference in count, type, source, interactivity or a box
    beyond BOX_ATOL, or None; caption texts that differ; other texts that differ)."""
    if len(got) != len(want):
        return f"{len(got)} elements against {len(want)}", 0, 0
    flips = texts = 0
    for i, (a, b) in enumerate(zip(got, want)):
        for k in ("type", "source", "interactivity"):
            if a[k] != b[k]:
                return f"element {i} {k}: {a[k]!r} against {b[k]!r}", flips, texts
        if np.max(np.abs(np.subtract(a["bbox"], b["bbox"]))) > BOX_ATOL:
            return f"element {i} bbox: {a['bbox']} against {b['bbox']}", flips, texts
        if a["content"] != b["content"]:
            if a["source"] == "box_yolo_content_yolo":
                flips += 1
            else:
                texts += 1
    return None, flips, texts


def check_outputs(pipe, images, batch_results, truth=None):
    """parse_batch's elements against parse_image's for each screenshot
    (captions that differ are counted: batch shapes flip greedy near-ties in
    bfloat16); every box finite in [0, 1] with content; with `truth` (each
    rendered scene's icon boxes in pixels) the icon recall at RECALL_IOU."""
    per, ok, hits, n_gt, ocr_lines = [], True, 0, 0, []
    for i, (img, (_, _, got)) in enumerate(zip(images, batch_results)):
        _, _, want = pipe.parse_image(img)
        diff, flips, texts = compare_elements(got, want)
        sane = all(e["content"] is not None and all(np.isfinite(v) and -1e-6 <= v <= 1 + 1e-6
                                                    for v in e["bbox"]) for e in want)
        ok = ok and diff is None and sane
        per.append({"elements": len(want), "first_difference": diff, "sane": sane,
                    "caption_texts_differing": flips, "other_texts_differing": texts})
        ocr_lines.append(sum(e["type"] == "text" for e in want))
        if truth is not None:
            h, w = img.shape[:2]
            pred = np.asarray([e["bbox"] for e in want if e["type"] == "icon"],
                              np.float32).reshape(-1, 4) * np.float32([w, h, w, h])
            hits += _iou_matches(truth[i], pred, RECALL_IOU)
            n_gt += len(truth[i])
    return {"correct": ok, "per_screenshot": per, "ocr_lines": ocr_lines,
            "icon_recall": hits / n_gt if truth is not None and n_gt else None,
            "icons": n_gt if truth is not None else None}


def card_info(dev):
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[dev.index or 0]
    return {"name": torch.cuda.get_device_name(dev), "power_limit": line.split(",")[-1].strip(),
            "count": torch.cuda.device_count(), "nvidia_smi": line}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", choices=("trained", "seeded"), default="trained")
    ap.add_argument("--inputs", choices=("rendered", "synthetic"), default="rendered")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=None,
                    help="rendered: the square side (1280); synthetic: the long side (1920)")
    ap.add_argument("--count", type=int, default=8)
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=None,
                    help="parse_batch rounds (default: 5 to 9 under 75 s)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, *, reduce=None, captioner_dims=None):
    """Run the benchmark and print its JSON line.  `reduce` (a config ->
    config function) and `captioner_dims` shrink the networks for tests."""
    from omniparser_tpu_torch.pipeline import SOMPipeline

    args = parse_args(argv)
    dev = resolve_device(args.device)
    trees = require_trees() if args.weights == "trained" else None
    cfg = bench_config(args.weights)
    if reduce is not None:
        cfg = reduce(cfg)
    pass_s = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        pass_s[name] = now - clock[0]
        clock[0] = now

    if args.inputs == "rendered":
        from omniparser_tpu_torch.train.synth_text import require_fonts

        require_fonts()  # names the carried faces where no TTF face is found
    images, truth = make_inputs(args.inputs, args.seed, args.count, args.size)
    lap("inputs")
    pipe = SOMPipeline(cfg, device=dev, seed=args.seed, captioner_dims=captioner_dims)
    lap("build")
    pipe.warmup(shapes=sorted({im.shape[:2] for im in images}))
    pipe.parse_batch(images)
    lap("warmup")
    lat = time_latency(pipe, images[0], args.calls)
    lap("latency")
    thr, batch_results = time_throughput(pipe, images, args.rounds)
    lap("throughput")
    flops, split = count_flops(pipe, images[0])
    lap("flops")
    traced = {"parse_image": traced_pass(lambda: pipe.parse_image(images[0]), lat["p50"], 1, dev),
              "parse_batch": traced_pass(lambda: pipe.parse_batch(images),
                                         thr["median_round_s"], len(images), dev)}
    lap("traced")
    stages, decode = stage_pass(pipe, images[0], dev)
    lap("stages")
    check = check_outputs(pipe, images, batch_results,
                          truth if args.weights == "trained" else None)
    lap("check")

    out = {
        "metric": "screenshots/sec/chip end-to-end parse",
        "value": thr["value"],
        "unit": "screenshots/sec",
        "vs_baseline": thr["value"] / BASELINE_SHOTS_PER_SEC,
        "best_round_shots_per_sec": thr["best"],
        "baseline_note": "assumed 0.6 s/frame A100 (public V2 figure); "
                         "not measurable in-image — see PERF.md",
        "p50_latency_s": lat["p50"],
        "p90_latency_s": lat["p90"],
        "n_calls": lat["n"],
        "rounds_s": thr["round_s"],
        "mfu": flops / (lat["p50"] * PEAK_BF16_FLOPS),
        "peak_flops": PEAK_BF16_FLOPS,
        "device_flops_per_parse": flops,
        "device_flops_split": split,
        "flops_note": FLOPS_NOTE,
        "device_time_share": traced["parse_image"]["device_time_share"],
        "device_ms": {p: t["device_ms"] for p, t in traced.items()},
        "launches_per_parse": {p: t["launches_per_parse"] for p, t in traced.items()},
        "peak_bytes": {p: t["peak_bytes"] for p, t in traced.items()},
        "top_kernels": {p: t["top_kernels"] for p, t in traced.items()},
        "kernel_launches": {p: t["kernel_launches"] for p, t in traced.items()},
        "device_stage_ms": stages,
        "decode_device_ms": decode,
        "captioner_quant": cfg.captioner.quant,
        "ocr_weights": bool(cfg.ocr_weights),
        "stage_timings_s": lat["stages"],
        "device": card_info(dev),
        "weights": args.weights,
        "weights_source": trees or "seeded",
        "inputs": {"kind": args.inputs, "seed": args.seed, "size": list(images[0].shape[:2]),
                   "count": len(images)},
        "pass_s": pass_s,
        "counts": lat["counts"],
        "correct": check.pop("correct"),
        "check": check,
    }
    if dev.type != "cuda":
        out.update({k: None for k in DEVICE_FIELDS})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["correct"] else 1)
