#!/usr/bin/env python3
"""Drive omniparser_tpu_torch once on an NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Needs one CUDA device, ``nvcc`` and the repository around it; it fails at
once without a card.  Phases, one JSON line each:

  device          the card (nvidia-smi name and power limit), torch/CUDA versions
  build           nvcc build of omniparser_tpu_torch/csrc/*.cu into
                  omniparser_tpu_torch/build/
  kernels         each hand-written kernel against its plain PyTorch version
                  on the card, at the main path's shapes, with timings and
                  the least time the card could take for the same work; the
                  NMS kernel also in its edge cases (N around a 64-box block,
                  all kept, all invalid, a chain across blocks) and with its
                  two launches timed apart; the fused merge in MERGE_CASES
                  (and a case above 48 KB of shared memory), all four masks
                  exact; BLIP-2's beam decode attention (beam_attention.cu) at
                  the main path's shape (bfloat16, 128 crops x 5 beams, 32
                  heads of 80, prefix 48, steps 0, 49 and 98 of 100, a random
                  ancestry table) and in float32, float16 and a case above
                  48 KB of shared memory, within one ulp of the output's
                  largest magnitude (BEAM_ATOL)
  parse           one 1080x1920 synthetic screenshot through
                  SOMPipeline.parse_elements at the default widths
                  (YOLOv8-n @1280, TextDetector @1920, TextRecognizer on
                  32x480 lines, Florence-2-base dims), seeded random weights;
                  the kernels' launch counters must rise, the caption decode
                  must run, two runs must agree, the merge must be one
                  launch of the fused kernel; the parse's own NMS window and
                  merge inputs against the plain versions; then a
                  torch.profiler pass
                  (device time against wall)
  batch           SOMPipeline.parse_batch over four screenshots of three
                  sizes (1080x1920 twice, 768x1366, 1440x2560) with the
                  parse's pipeline, against parse_image of each: every field
                  but caption text equal, one generate per <=256-slot chunk,
                  each kernel launched as often as the four parse_images
                  launch it; walls (screenshots/s) of both, and a profiler
                  pass over one parse_batch
  serve           OmniparserServer over that pipeline on 127.0.0.1: the
                  probe, 8 concurrent POST /parse/ through urllib, /metrics;
                  every answer equal to its image's parse_image but for
                  caption text, a batch of more than one request formed;
                  p50/p99 latency, requests/s; a clean shutdown
  int8            a FlorenceCaptioner with quant='int8' quantized from the
                  parse's captioner's weights: int8 decoder and head, the
                  first decode step's logits within tests/test_quant.py's
                  bounds of the float captioner's on the parse's crops, the
                  int8 product against a float32 GEMM, resident bytes and
                  decode ms of both captioners (int8 also with the float32
                  GEMM swapped in), one parse_elements through it
  compat          the reference's two calls: the merge kernel at the host
                  OCR slot buckets (M = 32..256) against its plain version;
                  the parse's seeded detector and captioner written as an
                  ultralytics state dict and an HF Florence-2 directory,
                  loaded back through Omniparser(dict) and found equal;
                  check_ocr_box (greedy, beam, paragraphs; a seeded TorchOCR
                  at text threshold 0) -> get_som_labeled_img, then once more
                  with OCR boxes made from the detector's icons (absorb, an
                  icon inside OCR and the caption decode must all happen);
                  parse_image with device_components and with
                  fused_candidates off, equal to the fused parse
  families        the reference's other model families at full width, seeded,
                  on the parse's screenshot: YOLOv9-E (SOMPipeline
                  variant='v9e' @1280, parse_elements twice, equal; launches
                  nms_keep 1, merge_masks 1, crop_resize 2; the parse's NMS
                  window against nms_keep_plain; wall, device time, idle
                  share, peak bytes; get_yolo_model(variant='v9e') + predict
                  at 640 and 1280; a 3-class GELAN's class-offset NMS window
                  against nms_keep_plain; the seeded GELAN written as a
                  TorchScript archive under icon_detect_v3/ and loaded back
                  through get_yolo_model(path) and Omniparser(dict), equal);
                  the easyocr arch (TorchOCR(arch='easyocr', rec_height=64),
                  CRAFT @1920 with its seeded region head scaled to find
                  text: check_ocr_box -> get_som_labeled_img, a fused
                  parse_image, K3's 64x480 line grid against its plain
                  version, craft_mlt_25k.pth / english_g2.pth written and read
                  back equal); BLIP-2 opt-2.7b built on the card
                  (get_caption_model_processor('blip2'), 5 beams, 100 new
                  tokens): get_som_labeled_img with OCR boxes made from the
                  icons, so that icons are beam-captioned, twice and equal,
                  K3's caption grid against its plain version, resident and
                  peak bytes, beam-decode ms; a reduced BLIP-2 written as an
                  HF safetensors directory and read back equal; Phi-3-V
                  (phi-3-vision-128k-instruct, built on the card by
                  build_phi3v through get_caption_model_processor('phi3_v'),
                  greedy, batches of 5, 25 new tokens): get_som_labeled_img
                  with OCR boxes made from the icons, twice and equal,
                  launches nms_keep 1, merge_masks 1, crop_resize 1, K3's
                  caption grid against its plain version, caption ms,
                  resident and peak bytes; a reduced Phi-3-V written as an
                  HF directory in two shards and read back equal through
                  get_caption_model_processor('phi3_v', path) and
                  Omniparser(dict)
  eval            eval/screenspot.run_eval through the parse's pipeline with
                  a MockLLM over rows made from phase parse's screenshot
                  (the card's machine has no TTF font, so eval/synth_bench's
                  scenes cannot be rendered there): scores, wall per row,
                  launches per row
  train           the trainers at their CLI widths and batch sizes, 20 steps
                  each on seeded arrays (no font to render their datasets):
                  train_detector (YOLOv8-n @640, batch 8), train_ocr's
                  recogniser (32x480, batch 256; its crops from 512 seeded
                  64x1536 buffers through crops_from_buffers, K3's line grid,
                  one launch a buffer) and detector (640, batch 8),
                  train_captioner (SYNTH_CAP_DIMS, batch 128; its 64x64 crops
                  from 256 seeded 96x96 tiles through K3's resize grid) and
                  the joint train_step (YOLOv8-n @640 + Florence-2 BASE dims,
                  batch 8): each step's loss and synchronised wall, one
                  profiled step (device ms, launches, idle share), peak bytes,
                  throughput; each loss finite and falling (last-5 mean below
                  first-5); 16 crops of each data path against
                  crop_resize_plain; then train_roundtrip: the trained
                  networks saved by weights/checkpoints.py, read back equal,
                  loaded through SOMPipeline's weight fields equal, and one
                  parse_image of phase parse's screenshot (nms_keep 1,
                  merge_masks 1, crop_resize 2)
  mesh            the device mesh (parallel/) on a virtual mesh of the card:
                  ShardedParse of four 1080x1920 screenshots at (1, 1) and over
                  [cuda:0] * 4 at (2, 2) with the parse's pipeline (launches
                  nms_keep 4, merge_masks 4, crop_resize 4 x (line blocks + 1);
                  against parse_image of each, elements matched by box:
                  unmatched ones, differing fields, caption texts and the
                  largest box difference counted, not required equal in
                  bfloat16), walls, screenshots/s, a profiler pass and peak bytes
                  beside parse_batch of the four; ShardedCaptioner at (2, 2) on
                  the fused step's 128 caption crops (bfloat16 token rows that
                  differ counted; a float32 copy with TF32 off must give equal
                  tokens); single-step decode (split_decode off) parse_image of
                  phase parse's screenshot, equal to the split path's (launches
                  1 / 1 / 2); three steps of make_sharded_train_step at (2, 2)
                  against train_step (YOLOv8-n @640 + Florence-2 BASE dims,
                  batch 8, float32, TF32 off) within TRAIN_PARITY
  parity_on_card  the fused step on the card against the same step on the
                  CPU, same weights and image, float32, reduced size; then
                  that card pipeline's parse_batch of phase batch's four
                  screenshots against its parse_image of each (caption texts
                  that differ are counted); then get_som_labeled_img on both
                  with OCR boxes made from the CPU's icons (absorb and the
                  icon drop must fire; every integer field equal); then the
                  families: a 'dualtest' GELAN's detect_graph, the easyocr
                  arch's check_ocr_box (CRAFT @640, 64x480 lines) and
                  TINY_BLIP2's 5-beam blip2_generate (tokens equal); Phi-3-V:
                  TINY_PHI3V's greedy tokens and a reduced-width
                  SOMPipeline(backend='phi3v') parse_image (elements equal);
                  run_eval with a MockLLM (scores and records equal);
                  training: three steps of the joint train_step and of each
                  trainer's step at reduced widths from the same weights and
                  augmentation draws, losses and states within TRAIN_PARITY;
                  a reduced ShardedParse at (2, 2) on the card against the CPU's
                  (float32, TF32 off): every field but the boxes equal, boxes
                  within 1e-4
  trained         the trained orbax trees committed under omniparser_tpu/weights/
                  (det_synth, ocr_en_synth, cap_synth) read from the checkout by
                  weights/orbax_read.py (the zstd decoder built by g++ apart):
                  arrays, bytes stored and decoded, ms, MB/s, and each tree's
                  digest against TREE_DIGESTS; SOMPipeline(PipelineConfig()),
                  every weight field 'auto', on two 1080x1920 synthetic
                  screenshots in float32 (TF32 off), the card against the CPU:
                  elements, types, sources, texts, captions and counts equal,
                  boxes within 1e-4; then a bfloat16 parse timed: wall, device
                  ms, launches, idle share; launches nms_keep 1, merge_masks 1,
                  crop_resize one a block of 32 OCR lines, one for the caption
                  grid, one a K captions beyond the K slots (2 on these screens)
  bench           bench_torch.main (the port's benchmark) with seeded weights
                  on four synthetic screenshots, 10 latency calls and two
                  parse_batch rounds: its JSON line parses and holds every
                  key, ``correct`` is true, no device field is null, and the
                  traced parse_image launches nms_keep, merge_masks and
                  crop_resize 1, 1 and 2 times, the traced parse_batch of
                  four 4, 4 and 8 times

Each path (parse, batch, serve, int8, compat, families, eval, train_roundtrip,
the mesh's ShardedParse at both shapes and single-step parse_image, the
trained bfloat16 parse, the benchmark's traced parse_image and parse_batch; the training data paths for
crop_resize) runs with the kernels' launch counters
set to 0 just before it and read just after, and fails if a kernel of the path
was not launched.  Then the card's nvidia-smi line, one {"kernels": [...]} line
(``launches``: the parse's counts; ``launches_by_path``: every path's) and,
last, {"ok": true, "device": {...}}.  Any failing phase ends the run non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

import omniparser_tpu_torch  # noqa: F401  (fails at once where the package is absent)
from bench_torch import synthetic_screenshot  # the screenshots of both scripts

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores

# parity_on_card: the card against the CPU in float32 with TF32 off.  Integer
# outputs may differ in this many slots each (a swapped pair of near-equal
# scores moves the slots behind it), float outputs by these amounts: boxes
# are normalised to [0,1], scores and confidences are probabilities, crops
# are pixels in [0,255].
PARITY_MAX_SLOTS = 4
PARITY_ATOL = {"det_boxes": 1e-4, "det_scores": 1e-4, "ocr_boxes": 1e-4, "rec_conf": 1e-4,
               "crops": 1e-3}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_BLOCKER = None


def _block_queue(ms_wanted: float) -> None:
    """Queue plain matrix products that keep the card busy for about
    `ms_wanted`, so that what is enqueued behind them waits on the card
    and not on the host."""
    global _BLOCKER
    if _BLOCKER is None:
        a = torch.randn((8192, 8192), device="cuda")
        for _ in range(2):
            a @ a
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        a @ a
        e1.record()
        torch.cuda.synchronize()
        _BLOCKER = (a, e0.elapsed_time(e1))
    a, each = _BLOCKER
    for _ in range(int(ms_wanted / each) + 1):
        a @ a


def time_ms(fn, iters: int, warmup: int = 2, preload: bool = True) -> float:
    """Device milliseconds per call: `iters` calls between two CUDA events
    after a warm-up; the median of three such repeats.  With `preload` the
    calls are enqueued while the card is still busy with earlier work, so
    the events bracket the kernels back to back and the host's enqueue
    time (tens of microseconds a call through Python) does not show.
    Without it the figure is what an eager caller waits: host-bound where
    the call is many small kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3  # enqueue time of one call
    torch.cuda.synchronize()
    reps = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if preload:
            _block_queue(host_ms * iters * 1.5 + 1.0)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        reps.append(a.elapsed_time(b) / iters)
    return float(sorted(reps)[1])


def bound(bytes_moved: float, flops: float):
    tb, tf = bytes_moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ------------------------------------------------------------------ #
# inputs, all from numpy.random.default_rng(seed)
# ------------------------------------------------------------------ #


def clustered_boxes(rng, n: int, clusters: int, scale: float = 1280.0) -> np.ndarray:
    """Boxes in tight clusters (dense suppression), xyxy in pixels."""
    centres = rng.uniform(0.05, 0.95, (clusters, 2)) * scale
    sizes = rng.uniform(20, 120, (clusters, 2))
    which = rng.integers(0, clusters, n)
    c = centres[which] + rng.normal(0, 6.0, (n, 2))
    wh = sizes[which] * rng.uniform(0.8, 1.25, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], axis=1).astype(np.float32)


def nms_case(rng, n: int):
    boxes = clustered_boxes(rng, n, clusters=max(n // 12, 4))
    d = min(40, n // 2)
    boxes[n // 2: n // 2 + d] = boxes[:d]                   # duplicate boxes
    boxes[100:116, 2] = boxes[100:116, 0]                   # zero-area boxes
    valid = np.ones(n, bool)
    valid[rng.integers(0, n, n // 16)] = False              # invalid slots inside
    valid[n - n // 10:] = False                             # and the padding tail
    return boxes, valid


def nms_edge_cases(rng):
    """K1's edge cases: N on both sides of a 64-box block and of the
    pipelined scan's limit (4096), every box kept, every box invalid, and a
    suppression chain across block boundaries."""
    cases = {f"n{n}": nms_case(rng, n) for n in (1, 63, 64, 65, 4000, 4096, 8192, 20000)}
    g = np.arange(64, dtype=np.float32) * 10
    x, y = np.meshgrid(g, g)
    grid = np.stack([x, y, x + 8, y + 8], -1).reshape(-1, 4).astype(np.float32)
    cases["all_kept"] = (grid, np.ones(4096, bool))
    cases["all_invalid"] = (nms_case(rng, 4096)[0], np.zeros(4096, bool))
    # A (63) suppresses B (64); B would have suppressed C (128), so C is kept
    d = np.arange(4096, dtype=np.float32) * 40 + 1000
    chain = np.stack([d % 40000, d // 40000 * 40, d % 40000 + 10, d // 40000 * 40 + 10], -1)
    chain[63], chain[64], chain[128] = [0, 0, 10, 10], [5, 0, 15, 10], [11, 0, 21, 10]
    cases["chain"] = (chain.astype(np.float32), np.ones(4096, bool))
    return cases


def overlap_case(rng, n: int, m: int):
    xy = rng.uniform(0, 0.8, (n, 2))
    wh = rng.uniform(0.01, 0.2, (n, 2))
    icons = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    xy = rng.uniform(0, 0.9, (m, 2))
    wh = rng.uniform(0.005, 0.1, (m, 2)) * np.array([3.0, 0.5])
    ocr = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    c = (icons[:40, :2] + icons[:40, 2:]) / 2
    half = (icons[:40, 2:] - icons[:40, :2]) / 2
    ocr[:40] = np.concatenate([c - 0.5 * half, c + 0.5 * half], axis=1)      # inside icons
    ocr[40:60] = np.concatenate([c[:20] - 1.5 * half[:20], c[:20] + 1.5 * half[:20]], axis=1)
    icons[n - 30:] = icons[:30] * 0.99 + 0.004                               # near-duplicates
    icons[200:208, 3] = icons[200:208, 1]                                    # zero-area icons
    ocr[100:104, 2] = ocr[100:104, 0]                                        # zero-area OCR
    # exactly 0.80 containment on a binary grid: the OCR box is the icon's
    # upper 4/5, so icon-inside-OCR is 0.8 in exact arithmetic (not > 0.80)
    for k in range(8):
        o = 0.125 * (k % 4)
        icons[300 + k] = [o, 0.25, o + 0.3125, 0.5625]
        ocr[120 + k] = [o, 0.25, o + 0.3125, 0.25 + 0.25]
    return icons, ocr


def unit_boxes(rng, n: int, max_size: float, min_size: float = 0.01) -> np.ndarray:
    """Random normalised xyxy boxes with positive extent."""
    xy = rng.uniform(0, 1 - max_size, (n, 2))
    wh = rng.uniform(min_size, max_size, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def inside_boxes(boxes: np.ndarray, frac: float) -> np.ndarray:
    """Boxes at `frac` of each box's half-extent around its centre."""
    c = (boxes[:, :2] + boxes[:, 2:]) / 2
    half = (boxes[:, 2:] - boxes[:, :2]) / 2
    return np.concatenate([c - frac * half, c + frac * half], axis=1).astype(np.float32)


def _merge_random(rng, n: int, m: int):
    icons = unit_boxes(rng, n, 0.35)
    ocr = unit_boxes(rng, m, 0.12)
    q = min(n, m) // 2
    ocr[:q] = inside_boxes(icons[:q], 0.4)                     # inside icons
    ocr[q:q + q // 2] = inside_boxes(icons[:q // 2], 1.4)      # around icons
    if n > 4:
        icons[n - 2:] = icons[:2] * np.float32(0.98) + np.float32(0.01)  # near-duplicates
    return icons, rng.uniform(size=n) > 0.1, ocr, rng.uniform(size=m) > 0.1


def _merge_kstop_0(rng):
    """OCR box 0 contains both icons: each stops at k = 0 and absorbs none
    of the boxes inside it that come later."""
    icons = np.array([[0.40, 0.40, 0.45, 0.44], [0.41, 0.41, 0.44, 0.43]], np.float32)
    ocr = np.concatenate([[[0.3, 0.3, 0.6, 0.6]], inside_boxes(icons, 0.5),
                          unit_boxes(rng, 37, 0.05)]).astype(np.float32)
    return icons, np.ones(2, bool), ocr, np.ones(len(ocr), bool)


def _merge_kstop_m(rng):
    """No OCR box contains an icon: k_stop = M (40, not a multiple of 32),
    and the last box, inside icon 0, is absorbed."""
    icons = np.array([[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9]], np.float32)
    ocr = np.tile(np.array([[0.92, 0.92, 0.95, 0.95]], np.float32), (40, 1))
    ocr[39] = inside_boxes(icons[:1], 0.5)[0]
    ocr[3] = inside_boxes(icons[1:], 0.3)[0]
    return icons, np.ones(2, bool), ocr, np.ones(40, bool)


def _merge_chains(rng):
    """Icons in several blocks absorb the same OCR boxes (a box donates to
    every icon it sits in); icon 20's scan stops at k = 37, inside the second
    32-wide chunk, after absorbing boxes on both sides of k = 32 and right
    before the stop; icon 21 is contained by boxes in both chunks (k = 10,
    44) and stops at the first."""
    n, m = 22, 45
    # shifted by k/1024: the same area to the last bit, so none suppresses another
    big = np.array([0.25, 0.25, 0.625, 0.625], np.float32)
    icons = np.tile(big, (n, 1)) + (np.arange(n, dtype=np.float32) / 1024)[:, None]
    icons[20] = [0.05, 0.05, 0.15, 0.15]
    icons[21] = [0.7, 0.05, 0.8, 0.15]
    ocr = unit_boxes(rng, m, 0.04) * np.float32(0.1) + np.float32(0.85)
    ocr[[2, 5, 31, 33, 35]] = inside_boxes(np.tile(big, (5, 1)), 0.3)
    ocr[[1, 34, 36, 40]] = inside_boxes(icons[20:21].repeat(4, 0), 0.5)
    ocr[37] = [0.04, 0.04, 0.16, 0.14]                         # contains icon 20
    ocr[[3, 20]] = inside_boxes(icons[21:22].repeat(2, 0), 0.4)
    ocr[[10, 44]] = [[0.69, 0.04, 0.81, 0.15], [0.69, 0.04, 0.81, 0.16]]  # contain icon 21
    return icons, np.ones(n, bool), ocr, np.ones(m, bool)


def _merge_same_box(rng):
    """OCR box 1 is icon 0 itself, each more than 0.80 inside the other:
    the absorb rule wins, the scan goes on past it and absorbs box 5 too."""
    icons = np.array([[0.2, 0.2, 0.4, 0.3], [0.6, 0.6, 0.7, 0.7]], np.float32)
    ocr = unit_boxes(rng, 9, 0.05) * np.float32(0.1) + np.float32(0.85)
    ocr[1] = icons[0]
    ocr[5] = inside_boxes(icons[:1], 0.5)[0]
    return icons, np.ones(2, bool), ocr, np.ones(9, bool)


def _merge_zero_area(rng):
    icons, iv, ocr, ov = _merge_random(rng, 33, 7)
    icons[3:6, 2] = icons[3:6, 0]                              # zero width
    icons[6:8, 3] = icons[6:8, 1]                              # zero height
    icons[8] = icons[9]
    icons[8, 2] = icons[8, 0]                                  # a zero-area copy of icon 9
    ocr[0:2, 2] = ocr[0:2, 0]
    ocr[2] = inside_boxes(icons[4:5], 0.5)[0]
    return icons, iv, ocr, ov


def _merge_ties(rng):
    """overlap_case's exact-0.80 ties alone: OCR box k is icon k's upper
    4/5, so icon-inside-OCR is 0.8 in exact arithmetic, not > 0.80, and no
    icon is dropped."""
    o = 0.125 * np.arange(4)
    icons = np.stack([o, np.full(4, 0.25), o + 0.3125, np.full(4, 0.5625)], 1).astype(np.float32)
    ocr = icons.copy()
    ocr[:, 3] = 0.5
    return icons, np.ones(4, bool), ocr, np.ones(4, bool)


def _merge_all_invalid(rng):
    icons, _, ocr, _ = _merge_random(rng, 33, 7)
    return icons, np.zeros(33, bool), ocr, np.zeros(7, bool)


def _merge_no_ocr(rng):
    """The pipeline's no-OCR bucket: 32 zero boxes, none valid."""
    icons, iv, _, _ = _merge_random(rng, 33, 7)
    return icons, iv, np.zeros((32, 4), np.float32), np.zeros(32, bool)


def _merge_main(rng):
    icons, ocr = overlap_case(rng, 512, 256)
    return icons, rng.uniform(size=512) > 0.1, ocr, rng.uniform(size=256) > 0.05


# the fused merge's cases: (icon boxes, icon valid, OCR boxes, OCR valid),
# from a numpy generator; tests/test_torch_merge.py replays the kernel on
# the same cases on the CPU
MERGE_CASES = {
    "1x1": lambda rng: (np.array([[0.1, 0.1, 0.5, 0.5]], np.float32), np.ones(1, bool),
                        np.array([[0.2, 0.2, 0.3, 0.3]], np.float32), np.ones(1, bool)),
    "33x7": lambda rng: _merge_random(rng, 33, 7),
    "512x256": _merge_main,
    "all_invalid": _merge_all_invalid,
    "kstop_0": _merge_kstop_0,
    "kstop_m": _merge_kstop_m,
    "chains": _merge_chains,
    "same_box": _merge_same_box,
    "zero_area": _merge_zero_area,
    "ties_080": _merge_ties,
    "no_ocr_32": _merge_no_ocr,
    "n0": lambda rng: (np.zeros((0, 4), np.float32), np.zeros(0, bool),
                       unit_boxes(rng, 7, 0.1), np.ones(7, bool)),
}


def crop_case(rng, k: int):
    h, w, hb, wb = 1080, 1920, 1152, 1920
    img = np.zeros((hb, wb, 3), np.uint8)
    img[:h, :w] = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    xy = rng.uniform(0, 0.9, (k, 2))
    wh = rng.uniform(0.01, 0.1, (k, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 1.0)], axis=1).astype(np.float32)
    boxes[0] = [0.0, 0.0, 1.0, 1.0]                 # whole frame
    boxes[1] = [0.97, 0.97, 1.0, 1.0]               # bottom-right edge
    boxes[2] = [0.0, 0.5, 0.02, 0.52]               # left edge
    boxes[3] = [0.3, 0.3, 0.3, 0.3]                 # degenerate
    boxes[4] = [0.9995, 0.9995, 1.0, 1.0]           # degenerate at the corner
    boxes[5] = [0.5, 0.5, 0.5016, 0.5028]           # 3x3 px upscaled
    boxes[6] = [0.25, 0.25, 0.2526, 0.2519]         # 5x2 px upscaled
    return img, (h, w), boxes


# ------------------------------------------------------------------ #
# phases
# ------------------------------------------------------------------ #


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=line, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return line


def phase_build():
    from omniparser_tpu_torch.ops import cuda_build

    info = cuda_build.build_all(verbose=True)
    ptxas = [l.strip() for l in info["log"].splitlines() if "registers" in l]
    emit("build", seconds=round(info["seconds"], 3), built=info["built"],
         cached=info["cached"], flags=" ".join(cuda_build.NVCC_FLAGS), ptxas=ptxas)


def nms_stage_ms(b, v, thr: float, iters: int = 200, lib=None):
    """K1's two launches timed apart, through the C entries that nms_keep
    launches (from `lib`, another build of nms.cu, where given), on buffers
    made once: (mask_ms, scan_ms).  The keep mask they give is checked."""
    from omniparser_tpu_torch.ops import cuda_build, hopper_kernels

    n = b.shape[0]
    mask_fn, scan_fn = hopper_kernels.nms_entries(n, lib)
    mask = torch.empty((hopper_kernels.nms_mask_words(n),), dtype=torch.int64, device=b.device)
    keep = torch.empty((n,), dtype=torch.bool, device=b.device)
    stream = cuda_build.current_stream()

    def mask_call():
        cuda_build.check(mask_fn(b.data_ptr(), mask.data_ptr(), n, thr, stream), "nms_mask")

    def scan_call():
        cuda_build.check(scan_fn(v.data_ptr(), keep.data_ptr(), mask.data_ptr(), n, stream),
                         "nms_scan")

    mask_call()
    scan_call()
    if not torch.equal(keep, hopper_kernels.nms_keep_plain(b, v, thr)):
        fail(f"nms_keep's two launches disagree with the plain version at N={n}")
    return time_ms(mask_call, iters), time_ms(scan_call, iters)


def phase_kernels(seed: int):
    import torch.nn.functional as F

    from omniparser_tpu_torch.ops import hopper_crop, hopper_kernels, preprocess

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    cu = lambda a: torch.from_numpy(a).to(dev)
    records = []

    # ---- K1: greedy NMS keep mask, exact -------------------------------
    thr = 0.1
    rec = None
    for n in (512, 4096):
        boxes, valid = nms_case(rng, n)
        b, v = cu(boxes), cu(valid)
        got = hopper_kernels.nms_keep(b, v, thr)
        want = hopper_kernels.nms_keep_plain(b, v, thr)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        keeps = int(want.sum())
        emit("kernels", kernel="nms_keep", n=n, thr=thr, keeps=keeps, valid=int(valid.sum()),
             mismatches=mism)
        if mism:
            fail(f"nms_keep disagrees with its plain version at N={n}: {mism} slots")
        if n == 4096:
            ms = time_ms(lambda: hopper_kernels.nms_keep(b, v, thr), 50)
            # 4096 dependent steps of small kernels: too long to queue behind
            # a blocker, so this one is the eager caller's (host-bound) time
            plain_ms = time_ms(lambda: hopper_kernels.nms_keep_plain(b, v, thr), 1,
                               warmup=1, preload=False)
            # the work these inputs need: each kept box against the valid
            # boxes after it, 13 float operations a pair
            k_np, v_np = want.cpu().numpy(), valid
            after = np.cumsum(v_np[::-1])[::-1] - v_np
            flops = 13.0 * float(after[k_np].sum())
            bms, by = bound(n * 18, flops)
            rec = {"name": "nms_keep", "route": "cuda",
                   "source": "omniparser_tpu_torch/csrc/nms.cu",
                   "replaces": "omniparser_tpu/ops/pallas_kernels.py:97",
                   "launches": 0, "max_abs_err": float(mism), "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bms, "bound_by": by, "library_ms": None,
                   "shape": {"N": n, "keeps": keeps}, "bytes_moved": n * 18,
                   "mask_bytes": hopper_kernels.nms_mask_words(n) * 8}
            rec["mask_ms"], rec["scan_ms"] = nms_stage_ms(b, v, thr)
    # the edge cases, from their own generator so that the cases above and
    # below stay what earlier runs drew
    for name, (boxes, valid) in nms_edge_cases(np.random.default_rng(seed + 7)).items():
        b, v = cu(boxes), cu(valid)
        want = hopper_kernels.nms_keep_plain(b, v, thr)
        mism = int((hopper_kernels.nms_keep(b, v, thr) != want).sum())
        emit("kernels", kernel="nms_keep", case=name, n=len(valid), keeps=int(want.sum()),
             valid=int(valid.sum()), mismatches=mism)
        if mism:
            fail(f"nms_keep disagrees with its plain version in case {name}: {mism} slots")
        if name == "chain" and not (want[63] and not want[64] and want[128]):
            fail("the chain case does not chain")
        if name == "all_kept":
            if not bool(want.all()):
                fail("the all-kept case suppresses a box")
            rec["all_kept_ms"] = time_ms(lambda: hopper_kernels.nms_keep(b, v, thr), 50)
            rec["all_kept_mask_ms"], rec["all_kept_scan_ms"] = nms_stage_ms(b, v, thr)
            nk = len(valid)
            rec["all_kept_bound_ms"] = bound(nk * 18, 13.0 * nk * (nk - 1) / 2)[0]
    records.append(rec)

    # ---- K2: merge matrices, a/b exact, ratio 1e-6 ---------------------
    n, m = 512, 256
    icons, ocr = overlap_case(rng, n, m)
    ic, oc = cu(icons), cu(ocr)
    gr, ga, gb = hopper_kernels.overlap_matrices(ic, oc)
    wr, wa, wb = hopper_kernels.overlap_matrices_plain(ic, oc)
    torch.cuda.synchronize()
    mism_a, mism_b = int((ga != wa).sum()), int((gb != wb).sum())
    err = float((gr - wr).abs().max())
    emit("kernels", kernel="overlap_matrices", n=n, m=m, a_true=int(wa.sum()),
         b_true=int(wb.sum()), a_mismatches=mism_a, b_mismatches=mism_b, ratio_max_abs_diff=err)
    if mism_a or mism_b or not err <= 1e-6 or not torch.isfinite(gr).all():
        fail("overlap_matrices disagrees with its plain version")
    k2_bytes = (n + m) * 16 + n * n * 4 + 2 * n * m
    bms, by = bound(k2_bytes, n * n * 22.0 + n * m * 16.0)
    records.append({
        "name": "overlap_matrices", "route": "cuda",
        "source": "omniparser_tpu_torch/csrc/overlap.cu",
        "replaces": "omniparser_tpu/ops/pallas_kernels.py:163",
        "launches": 0, "max_abs_err": err,
        "ms": time_ms(lambda: hopper_kernels.overlap_matrices(ic, oc), 200),
        "plain_ms": time_ms(lambda: hopper_kernels.overlap_matrices_plain(ic, oc), 20),
        "bound_ms": bms, "bound_by": by, "library_ms": None, "shape": {"N": n, "M": m},
        "bytes_moved": k2_bytes})

    # ---- K2, the fused merge: all four masks exact ---------------------
    records.append(merge_record(np.random.default_rng(seed + 11), dev))

    # ---- BLIP-2's beam decode attention through the ancestry table -----
    records.append(beam_attention_record(np.random.default_rng(seed + 13), dev))

    # ---- K3: crop-gather, atol 1e-2 ------------------------------------
    k, s = 128, 64
    img, hw, boxes = crop_case(rng, k)
    im, bx = cu(img), cu(boxes)
    got = hopper_crop.crop_resize(im, hw, bx, s)
    want = hopper_crop.crop_resize_plain(im, hw, bx, s)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # the same kernel under the line-grid rule, at the recogniser's block shape
    lb = bx[:32].clone()
    lb[:, 2] = torch.clamp(lb[:, 0] + (lb[:, 2] - lb[:, 0]) * 4, max=1.0)
    got_l = hopper_crop.crop_resize(im, hw, lb, (32, 480), grid="line")
    want_l = hopper_crop.crop_resize_plain(im, hw, lb, (32, 480), grid="line")
    torch.cuda.synchronize()
    err_l = float((got_l - want_l).abs().max())
    emit("kernels", kernel="crop_resize", k=k, out=s, frame=list(img.shape),
         max_abs_diff=err, line_grid_max_abs_diff=err_l, atol=1e-2)
    if not (err <= 1e-2 and err_l <= 1e-2 and torch.isfinite(got).all()):
        fail("crop_resize disagrees with its plain version")
    # the source bytes these boxes need: the taps are separable, so a box
    # reads (distinct tap columns) x (distinct tap rows) pixels, at most
    # 2S x 2S however large it is, and as few as its own pixels when small
    xs, ys = preprocess.resize_grid(bx, hw, (s, s))

    def distinct_taps(c, size):
        c0 = np.clip(np.floor(c.cpu().numpy()).astype(np.int64), 0, size - 1)
        both = np.concatenate([c0, np.clip(c0 + 1, 0, size - 1)], axis=1)
        return np.array([len(np.unique(row)) for row in both])

    src_bytes = float((distinct_taps(xs, img.shape[1]) * distinct_taps(ys, img.shape[0])).sum() * 3)
    out_bytes = k * s * s * 3 * 4
    bms, by = bound(src_bytes + k * 16 + 8 + out_bytes, k * s * s * 60.0)
    # the library's one call for the same sampling: grid_sample over the
    # plain version's own source coordinates (timed here, used nowhere else)
    gx = xs / (img.shape[1] - 1) * 2 - 1
    gy = ys / (img.shape[0] - 1) * 2 - 1
    grid = torch.stack([gx[:, None, :].expand(k, s, s), gy[:, :, None].expand(k, s, s)], dim=-1)
    imf = im.permute(2, 0, 1)[None].float().expand(k, 3, *img.shape[:2]).contiguous()
    lib = lambda: F.grid_sample(imf, grid, mode="bilinear", padding_mode="border",
                                align_corners=True)
    lib_err = float((lib().permute(0, 2, 3, 1) - want).abs().max())
    records.append({
        "name": "crop_resize", "route": "cuda",
        "source": "omniparser_tpu_torch/csrc/crop.cu",
        "replaces": "omniparser_tpu/ops/pallas_crop.py:143",
        "launches": 0, "max_abs_err": err,
        "ms": time_ms(lambda: hopper_crop.crop_resize(im, hw, bx, s), 200),
        "plain_ms": time_ms(lambda: hopper_crop.crop_resize_plain(im, hw, bx, s), 20),
        "bound_ms": bms, "bound_by": by, "library_ms": time_ms(lib, 20, warmup=1),
        "library_max_abs_diff": lib_err, "shape": {"K": k, "S": s, "frame": list(img.shape)},
        "bytes_moved": src_bytes + k * 16 + 8 + out_bytes, "source_bytes": src_bytes,
        "line_grid_max_abs_diff": err_l,
        "line_grid_ms": time_ms(
            lambda: hopper_crop.crop_resize(im, hw, lb, (32, 480), grid="line"), 200)})
    for r in records:
        emit("kernels", timing=r)
    return records


# BLIP-2's decode at the main path's shape: 128 crops x 5 beams, OPT-2.7B's
# 32 heads of 80, a prefix of 48 (32 queries, bos and a 15-id prompt), 100
# new tokens; steps 0, 49 and 98 (the mean step is 49)
BEAM_CASE = {"B": 128, "K": 5, "H": 32, "P": 48, "T": 100, "hd": 80}
BEAM_STEPS = (0, 49, 98)
# one bfloat16 ulp (2^-7 of the value) at the output's largest magnitude:
# the kernel and the plain version differ only in the order of their float32
# sums, so the last rounding (p.v to bfloat16) may land one ulp apart; a
# score or probability that rounds the other way moves an output far less
BEAM_ATOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10, torch.float32: 1e-5}


def beam_case(rng, dtype, dev, B, K, H, P, T, hd):
    """Stores of random values and a random ancestry table (each entry a
    slot in [0, K)), q scaled as the decoder scales it."""
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev).to(dtype)
    q = (torch.randn((B * K, H, 1, hd), generator=g, device=dev) * hd ** -0.5).to(dtype)
    parents = torch.from_numpy(rng.integers(0, K, (B, K, T)).astype(np.int32)).to(dev)
    return q, rnd(B, H, P, hd), rnd(B, H, P, hd), rnd(B * K, H, T, hd), rnd(B * K, H, T, hd), \
        parents


def beam_attention_record(rng, dev):
    """The kernel against its plain version at the main path's shape in
    bfloat16 (three steps), and at the other widths the port builds (TINY
    BLIP-2's float32 heads of 8, float16); timed at the mean step beside
    its bound, the plain version and the library's attention over the
    gathered cache (the port never calls it)."""
    import torch.nn.functional as F

    from omniparser_tpu_torch.ops import beam_attention as ba

    c = BEAM_CASE
    args = beam_case(rng, torch.bfloat16, dev, **c)
    errs = {}
    before = ba.launch_counts["beam_attention"]
    for step in BEAM_STEPS:
        got = ba.beam_attention(*args, step)
        want = ba.beam_attention_plain(*args, step)
        torch.cuda.synchronize()
        errs[step] = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        emit("kernels", kernel="beam_attention", dtype="bfloat16", step=step,
             max_abs_diff=errs[step], max_abs=scale, atol=BEAM_ATOL[torch.bfloat16] * scale)
        if not errs[step] <= BEAM_ATOL[torch.bfloat16] * scale or not torch.isfinite(got).all():
            fail(f"beam_attention disagrees with its plain version at step {step}")
    for dtype, shape in ((torch.float32, dict(B=4, K=5, H=4, P=7, T=12, hd=8)),
                         (torch.float16, dict(c, B=8)), (torch.float32, dict(c, B=8)),
                         (torch.bfloat16, dict(B=3, K=8, H=2, P=300, T=900, hd=128))):
        other = beam_case(rng, dtype, dev, **shape)
        for step in (0, shape["T"] - 1):
            got = ba.beam_attention(*other, step)
            want = ba.beam_attention_plain(*other, step)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            emit("kernels", kernel="beam_attention", dtype=str(dtype), shape=shape, step=step,
                 max_abs_diff=err, atol=BEAM_ATOL[dtype] * scale)
            if not err <= BEAM_ATOL[dtype] * scale:
                fail(f"beam_attention disagrees with its plain version: {dtype} {shape}")
    if ba.launch_counts["beam_attention"] == before:
        fail("beam_attention launched no kernel")
    step = BEAM_STEPS[1]
    read = ba.read_bytes(args[1], args[3], args[5], step)
    bms, by = bound(read + 2 * args[0].numel() * 2 + args[5][:, :, :step + 1].numel() * 4,
                    4.0 * c["B"] * c["K"] * c["H"] * c["hd"] * (c["P"] + step + 1))
    q, pk, pv, gk, gv, parents = args
    keys, values = ba.beam_rows(pk, gk, parents, step), ba.beam_rows(pv, gv, parents, step)
    lib = lambda: F.scaled_dot_product_attention(q, keys, values, scale=1.0)
    lib_err = float((lib().float() - ba.beam_attention_plain(*args, step).float()).abs().max())
    return {"name": "beam_attention", "route": "cuda",
            "source": "omniparser_tpu_torch/csrc/beam_attention.cu",
            "replaces": "none (BLIP-2's per-step cache reorder and masked attention)",
            "launches": 0, "max_abs_err": max(errs.values()),
            "ms": time_ms(lambda: ba.beam_attention(*args, step), 50),
            "plain_ms": time_ms(lambda: ba.beam_attention_plain(*args, step), 5),
            "bound_ms": bms, "bound_by": by, "library_ms": time_ms(lib, 20),
            "library_max_abs_diff": lib_err, "shape": dict(c, step=step),
            "bytes_moved": read, "max_abs_err_by_step": errs}


MERGE_OUTPUTS = ("icon_keep", "ocr_keep", "absorb", "icon_suppressed")
MERGE_IOU = 0.7  # PipelineConfig.iou_threshold


def merge_mismatches(args, thr: float = MERGE_IOU):
    """merge_masks against merge_masks_plain on the same card tensors:
    ({output: mismatching slots}, the plain outputs)."""
    from omniparser_tpu_torch.ops import hopper_kernels

    got = hopper_kernels.merge_masks(*args, thr)
    want = hopper_kernels.merge_masks_plain(*args, thr)
    torch.cuda.synchronize()
    return {k: int((g != w).sum()) for k, g, w in zip(MERGE_OUTPUTS, got, want)}, want


def merge_ops(args, want) -> float:
    """The float operations these inputs need: the areas (3 a box), the
    ratio (22) for each valid icon against each valid, smaller icon, and the
    two containment ratios (16) for each icon that survives suppression
    against each valid OCR box up to and including its stop index."""
    from omniparser_tpu_torch.ops import hopper_kernels

    ib, iv, ob, ov = args
    n, m = ib.shape[0], ob.shape[0]
    area = (ib[:, 2] - ib[:, 0]) * (ib[:, 3] - ib[:, 1])
    pairs = int((iv[:, None] & iv[None, :] & (area[:, None] > area[None, :])).sum())
    _, a, b = hopper_kernels.overlap_matrices_plain(ib, ob)
    b = b & ~a & ov[None, :]
    stop = torch.where(b.any(1), torch.argmax(b.to(torch.int8), 1), m)  # each row's k_stop
    ks = torch.arange(m, device=ib.device)
    scanned = int((ov[None, :] & (ks[None, :] <= stop[:, None]))[iv & ~want[3]].sum())
    return float(3 * (n + m) + 22 * pairs + 16 * scanned)


def merge_record(rng, dev):
    """K2's main-path entry, the fused merge: every case of MERGE_CASES and
    a case above 48 KB of shared memory against the plain version, then
    timed at 512x256 (and checked again after the timing's launches, which
    reuse the bitmask scratch)."""
    from omniparser_tpu_torch.ops import hopper_kernels

    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cases = {name: make(rng) for name, make in MERGE_CASES.items()}
    big = overlap_case(rng, 4096, 1024)
    cases["4096x1024"] = (big[0], rng.uniform(size=4096) > 0.1, big[1],
                          rng.uniform(size=1024) > 0.05)
    main = None
    for name, case in cases.items():
        args = tuple(cu(a) for a in case)
        mism, want = merge_mismatches(args)
        emit("kernels", kernel="merge_masks", case=name, n=len(case[0]), m=len(case[2]),
             icon_keep=int(want[0].sum()), ocr_keep=int(want[1].sum()),
             absorb=int(want[2].sum()), icon_suppressed=int(want[3].sum()), mismatches=mism)
        if any(mism.values()):
            fail(f"merge_masks disagrees with its plain version in case {name}: {mism}")
        if name == "512x256":
            main = (args, want)
        if name == "zero_area":
            # below 0 a disjoint pair passes the threshold: no disjoint skip
            for thr in (-0.1, 0.0):
                mism, want = merge_mismatches(args, thr)
                emit("kernels", kernel="merge_masks", case=name, thr=thr,
                     icon_suppressed=int(want[3].sum()), mismatches=mism)
                if any(mism.values()):
                    fail(f"merge_masks disagrees with its plain version at threshold {thr}: "
                         f"{mism}")
    args, want = main
    n, m = args[0].shape[0], args[2].shape[0]
    call = lambda: hopper_kernels.merge_masks(*args, MERGE_IOU)
    plain = lambda: hopper_kernels.merge_masks_plain(*args, MERGE_IOU)
    ms = time_ms(call, 200)
    mism, _ = merge_mismatches(args)
    if any(mism.values()):
        fail(f"merge_masks disagrees with its plain version after the timing loop: {mism}")
    # each input read once, each output written once
    nbytes = (n + m) * 17 + n * m + 2 * n + m
    flops = merge_ops(args, want)
    bms, by = bound(nbytes, flops)
    dense_flops = n * n * 22.0 + n * m * 16.0
    return {"name": "merge_masks", "route": "cuda",
            "source": "omniparser_tpu_torch/csrc/overlap.cu",
            "replaces": "omniparser_tpu/ops/pallas_kernels.py:163",
            "launches": 0, "max_abs_err": float(sum(mism.values())), "ms": ms,
            "plain_ms": time_ms(plain, 20),
            # what an eager caller waits for the plain version: its ~35
            # launches enqueued from the host, nothing queued ahead
            "plain_eager_ms": time_ms(plain, 20, preload=False),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": {"N": n, "M": m}, "bytes_moved": nbytes, "flops": flops,
            "dense_flops": dense_flops, "dense_bound_ms": bound(nbytes, dense_flops)[0],
            "eager_ms": time_ms(call, 20, preload=False)}


def all_counts():
    from omniparser_tpu_torch.ops import beam_attention, hopper_crop, hopper_kernels

    return {**hopper_kernels.launch_counts, **hopper_crop.launch_counts,
            **beam_attention.launch_counts}


def reset_counts():
    from omniparser_tpu_torch.ops import beam_attention, hopper_crop, hopper_kernels

    for d in (hopper_kernels.launch_counts, hopper_crop.launch_counts,
              beam_attention.launch_counts):
        for k in d:
            d[k] = 0


def phase_parse(seed: int, records):
    from omniparser_tpu_torch.config import PipelineConfig
    from omniparser_tpu_torch.pipeline import SOMPipeline

    rng = np.random.default_rng(seed + 1)
    image = synthetic_screenshot(rng)
    base = PipelineConfig(detector_weights=None, ocr_weights=None, captioner_weights=None)
    t0 = time.perf_counter()
    pipe = SOMPipeline(base, device="cuda", seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emit("parse", weights="seeded-init", seed=seed, image=list(image.shape),
         model_build_seconds=round(build_s, 2),
         widths={"detector": "yolov8n@1280 window 4096 slots 512",
                 "ocr_det": "TextDetector@1920", "ocr_rec": "32x480 blocks of 32, 256 slots",
                 "captioner": "florence-2-base dims, K=128 @64x64, 20 new tokens",
                 "dtype": base.detector.dtype})

    def run(cfg, stage_ms=None):
        pipe.config = cfg
        pipe.stage_ms = stage_ms
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            labels, elements = pipe.parse_elements(image)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return labels, elements, wall, [str(c.message) for c in caught]

    chosen = None
    tried = []
    # seeded weights are not trained: if a stage finds no work at the
    # default thresholds, lower them through the config's own fields
    for box_thr, text_thr in ((base.detector.box_threshold, base.ocr.text_threshold),
                              (base.detector.box_threshold, 0.0), (0.001, 0.0)):
        cfg = dataclasses.replace(
            base, detector=dataclasses.replace(base.detector, box_threshold=box_thr),
            ocr=dataclasses.replace(base.ocr, text_threshold=text_thr))
        _, elements, wall, _ = run(cfg)   # also the warm-up of this setting
        c = dict(pipe.last_counts)
        tried.append({"box_threshold": box_thr, "text_threshold": text_thr, **c})
        work = c["det_keep"] > 0 and c["ocr_candidates"] > 0 and c["kb"] > 0
        if work and (chosen is None or (c["ocr_valid"] > 0 and chosen[1]["ocr_valid"] == 0)):
            chosen = (cfg, c)
        if work and c["ocr_valid"] > 0:
            break
    emit("parse", thresholds_tried=tried)
    if chosen is None:
        fail("no threshold setting gave the detector, the recogniser and the caption "
             "decode work to do")
    cfg = chosen[0]

    # the counted run: counters to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    labels_a, elements_a, wall_a, warns = run(cfg)
    counts = all_counts()
    run_counts = dict(pipe.last_counts)
    timings = {k: round(v * 1e3, 3) for k, v in pipe.last_timings.items()}
    # a second run with per-stage synchronised times, and for determinism
    stage_ms = {}
    labels_b, elements_b, wall_b, _ = run(cfg, stage_ms)
    peak = torch.cuda.max_memory_allocated()

    # candidates above the threshold, from the detector's raw decode, and
    # the NMS window the detector hands nms_keep (outside the counted run)
    from omniparser_tpu_torch.ops import hopper_kernels
    from omniparser_tpu_torch.ops import nms as nms_mod

    window = []

    def recording_nms_keep(b, v, thr):
        window.append((b.clone(), v.clone(), thr))
        return hopper_kernels.nms_keep(b, v, thr)

    nms_mod.nms_keep = recording_nms_keep
    try:
        ctx = pipe._stage_upload(image)
        raw = pipe.detector.detect_graph(
            pipe.det_module, ctx["padded_dev"], (ctx["uh"], ctx["uw"]),
            cfg.detector.box_threshold, cfg.detector.nms_iou_threshold, with_raw=True)[-1][1]
    finally:
        nms_mod.nms_keep = hopper_kernels.nms_keep
    above = int((raw > cfg.detector.box_threshold).sum())
    wb, wv, wthr = window[0]
    want = hopper_kernels.nms_keep_plain(wb, wv, wthr)
    mism = int((hopper_kernels.nms_keep(wb, wv, wthr) != want).sum())
    emit("kernels", kernel="nms_keep", case="main_path_window", n=int(wv.numel()),
         keeps=int(want.sum()), valid=int(wv.sum()), thr=wthr, mismatches=mism)
    if mism:
        fail(f"nms_keep disagrees with its plain version on the parse's window: {mism} slots")

    # the merge's own inputs, from one more parse (outside the counted run)
    from omniparser_tpu_torch.ops import overlap as overlap_mod

    merge_inputs = []

    def recording_merge_masks(*args):
        merge_inputs.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return hopper_kernels.merge_masks(*args)

    overlap_mod.merge_masks = recording_merge_masks
    try:
        run(cfg)
    finally:
        overlap_mod.merge_masks = hopper_kernels.merge_masks
    *margs, mthr = merge_inputs[0]
    mism, want = merge_mismatches(tuple(margs), mthr)
    emit("kernels", kernel="merge_masks", case="main_path_merge", n=int(margs[0].shape[0]),
         m=int(margs[2].shape[0]), icon_valid=int(margs[1].sum()), ocr_valid=int(margs[3].sum()),
         thr=mthr, icon_keep=int(want[0].sum()), ocr_keep=int(want[1].sum()),
         absorb=int(want[2].sum()), icon_suppressed=int(want[3].sum()), mismatches=mism)
    if any(mism.values()):
        fail(f"merge_masks disagrees with its plain version on the parse's merge: {mism}")

    emit("parse", box_threshold=cfg.detector.box_threshold,
         text_threshold=cfg.ocr.text_threshold, detector_candidates_above_threshold=above,
         counts=run_counts, launches=counts, wall_ms=[round(wall_a, 2), round(wall_b, 2)],
         host_stage_ms=timings, device_stage_ms={k: round(v, 3) for k, v in stage_ms.items()},
         max_memory_allocated=peak, warnings=warns)
    for name in ("nms_keep", "merge_masks", "crop_resize"):
        if counts.get(name, 0) < 1:
            fail(f"kernel {name} was not launched during the parse")
    # the merge is one launch of the fused kernel, not the matrices
    if counts["merge_masks"] != 1 or counts["overlap_matrices"] != 0:
        fail(f"the parse launched merge_masks {counts['merge_masks']} times and "
             f"overlap_matrices {counts['overlap_matrices']} times (want 1 and 0)")
    if run_counts["kb"] < 1:
        fail("the caption decode never ran")
    if elements_a != elements_b or labels_a != labels_b:
        fail("two parses of the same image differ")
    if not elements_a:
        fail("the parse returned no elements")
    for e in elements_a:
        if set(e) != {"type", "bbox", "interactivity", "content", "source"}:
            fail(f"malformed element {e}")
        if not all(np.isfinite(v) and -1e-6 <= v <= 1 + 1e-6 for v in e["bbox"]):
            fail(f"bbox out of range {e}")
        if e["content"] is None:
            fail(f"element without content {e}")
    emit("parse", elements=len(elements_a), sample=elements_a[:2] + elements_a[-2:])
    for r in records:
        r["launches"] = counts[r["name"]]

    # where the parse's time goes: the summed device time of all kernels
    # against the wall, from one more parse under torch.profiler
    walls = [run(cfg)[2] for _ in range(3)]
    emit("parse", profile=profile_pass(lambda: run(cfg)[2], walls))

    if importlib.util.find_spec("cv2") is None:
        emit("parse", overlay="skipped, no cv2")
    else:
        annotated, _, _ = pipe.parse_image(image)
        emit("parse", overlay=list(annotated.shape))
    pipe.config = cfg
    pipe.stage_ms = None
    return pipe, image


def profile_pass(call, walls):
    """One more call under torch.profiler: the summed device time of all
    kernels against the median of `walls` (ms); `call` returns its wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = call()
    # kernel rows only (an operator's row repeats its kernels' device time)
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
                  key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    return {
        "wall_ms": [round(w_, 2) for w_ in walls], "wall_ms_under_profiler": round(wall_prof, 2),
        "device_ms": round(device_ms, 3),
        "device_idle_share": (round(1.0 - device_ms / float(np.median(walls)), 4)
                              if rows else "not measured: the profiler gave no device time"),
        "kernel_launches": int(sum(r[1] for r in rows)),
        "top": [{"name": r[0][:80], "count": r[1], "ms": round(r[2], 3)} for r in rows[:12]]}


KERNELS_OF_THE_PATH = ("nms_keep", "merge_masks", "crop_resize")


def path_counts(path: str, counts, launches_by_path) -> None:
    """Record one path's launch counts and fail where a kernel of the path
    was not launched."""
    launches_by_path[path] = dict(counts)
    for name in KERNELS_OF_THE_PATH:
        if counts.get(name, 0) < 1:
            fail(f"kernel {name} was not launched during the {path} path")


def same_but_captions(got, want):
    """(the first field that differs other than a caption's text, or None;
    the number of caption texts that differ)."""
    if len(got) != len(want):
        return f"{len(got)} elements against {len(want)}", 0
    flips = 0
    for i, (a, b) in enumerate(zip(got, want)):
        for k in ("type", "bbox", "interactivity", "source"):
            if a[k] != b[k]:
                return f"element {i} {k}: {a[k]} against {b[k]}", flips
        if a["source"] == "box_yolo_content_yolo":  # a captioned slot
            if a["content"] is None or b["content"] is None:
                return f"element {i}: a captioned slot without a caption", flips
            flips += a["content"] != b["content"]
        elif a["content"] != b["content"]:
            return f"element {i} OCR text: {a['content']!r} against {b['content']!r}", flips
    return None, flips


BATCH_SHAPES = ((1080, 1920), (1080, 1920), (768, 1366), (1440, 2560))


def phase_batch(seed: int, pipe, launches_by_path):
    """parse_batch over four screenshots of three raw buckets against
    parse_image of each."""
    images = [synthetic_screenshot(np.random.default_rng(seed + 21 + i), h, w)
              for i, (h, w) in enumerate(BATCH_SHAPES)]
    cap = pipe.captioner
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe.parse_batch(images)  # warm-up: the new buckets' first launches
        torch.cuda.synchronize()
        calls = cap.generate_calls
        reset_counts()
        batched = pipe.parse_batch(images)
        torch.cuda.synchronize()
        counts = all_counts()
        generate_calls = cap.generate_calls - calls
        chunks = list(pipe.last_decode_chunks)
        single, single_counts, need = [], {}, []
        for img in images:
            reset_counts()
            single.append(pipe.parse_image(img))
            need.append(pipe.last_counts["cap_need"])
            for k, v in all_counts().items():
                single_counts[k] = single_counts.get(k, 0) + v
    path_counts("batch", counts, launches_by_path)
    flips = []
    for i, ((_, _, eb), (_, _, es)) in enumerate(zip(batched, single)):
        bad, n = same_but_captions(eb, es)
        if bad:
            fail(f"batch: image {i} differs from its parse_image: {bad}")
        flips.append(n)
    slots = sum(need)
    want_chunks = -(-slots // pipe._DECODE_CHUNK)
    emit("batch", shapes=[list(i.shape) for i in images], elements=[len(e) for _, _, e in batched],
         caption_slots=need, decode_chunks=chunks, generate_calls=generate_calls,
         caption_texts_differing=flips, caption_texts=sum(
             e["source"] == "box_yolo_content_yolo" for _, _, el in batched for e in el),
         launches=counts, launches_of_the_four_parse_images=single_counts)
    if slots == 0:
        fail("batch: no image needed a caption, so the batched decode never ran")
    if generate_calls != want_chunks or sum(chunks) != slots or len(chunks) != want_chunks:
        fail(f"batch: {generate_calls} generate calls over chunks {chunks} for {slots} slots "
             f"(want {want_chunks} of at most {pipe._DECODE_CHUNK})")
    n = len(images)
    if counts["nms_keep"] != n or counts["merge_masks"] != n:
        fail(f"batch: nms_keep {counts['nms_keep']}, merge_masks {counts['merge_masks']} "
             f"launches for {n} images (want one each per image)")
    if any(counts[k] != single_counts.get(k, 0) for k in KERNELS_OF_THE_PATH):
        fail(f"batch: launches {counts} differ from the four parse_images' {single_counts}")
    if counts["crop_resize"] < 2 * n:
        fail(f"batch: crop_resize launched {counts['crop_resize']} times for {n} images "
             "(want the line grid and the caption grid of each)")

    def wall(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def one_at_a_time():
        for img in images:
            pipe.parse_image(img)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        batch_ms = [wall(lambda: pipe.parse_batch(images)) for _ in range(3)]
        single_ms = [wall(one_at_a_time) for _ in range(3)]
        prof = profile_pass(lambda: wall(lambda: pipe.parse_batch(images)), batch_ms)
    emit("batch", wall_ms={"parse_batch": [round(x, 2) for x in batch_ms],
                           "four_parse_image": [round(x, 2) for x in single_ms]},
         screenshots_per_s={"parse_batch": [round(n / x * 1e3, 3) for x in batch_ms],
                            "parse_image": [round(n / x * 1e3, 3) for x in single_ms]},
         profile=prof)
    return images, single


def phase_serve(seed: int, pipe, images, single, launches_by_path):
    """The REST server over the parse's pipeline, 8 concurrent requests."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from omniparser_tpu_torch.config import ServerConfig
    from omniparser_tpu_torch.serving import OmniparserServer
    from omniparser_tpu_torch.utils.image import encode_image_base64

    extra = [synthetic_screenshot(np.random.default_rng(seed + 31 + i)) for i in range(4)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = [e for _, _, e in single] + [pipe.parse_image(img)[2] for img in extra]
    bodies = [json.dumps({"base64_image": encode_image_base64(img)}).encode()
              for img in list(images) + extra]
    srv = OmniparserServer(pipe.config, ServerConfig(port=0, batch_window_ms=50, max_batch=8),
                           pipeline=pipe)
    serving = threading.Thread(target=srv.serve_forever, kwargs={"host": "127.0.0.1"},
                               daemon=True)
    serving.start()
    t0 = time.perf_counter()
    while srv._httpd is None or not srv._httpd.server_address[1]:
        if time.perf_counter() - t0 > 30:
            fail("serve: the server did not start")
        time.sleep(0.01)
    base = f"http://127.0.0.1:{srv._httpd.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, json.loads(r.read())

    def post(body):
        req = urllib.request.Request(base + "/parse/", body,
                                     {"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            out = r.status, json.loads(r.read())
        return (time.perf_counter() - t) * 1e3, out

    status, probe = get("/probe/")
    if status != 200 or "ready" not in probe.get("message", ""):
        fail(f"serve: /probe/ answered {status} {probe}")
    reset_counts()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(bodies)) as ex:
        answers = list(ex.map(post, bodies))
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = all_counts()
    status, metrics = get("/metrics")
    srv.shutdown()
    serving.join(30)
    path_counts("serve", counts, launches_by_path)
    flips = []
    for i, (_, (code, body)) in enumerate(answers):
        if code != 200:
            fail(f"serve: request {i} answered {code}")
        if set(body) != {"som_image_base64", "parsed_content_list", "latency"}:
            fail(f"serve: request {i} answered the keys {sorted(body)}")
        bad, n = same_but_captions(body["parsed_content_list"], want[i])
        if bad:
            fail(f"serve: request {i} differs from its image's parse_image: {bad}")
        flips.append(n)
    sizes = metrics["histograms"].get("parse_batch_size", {})
    lat = sorted(ms for ms, _ in answers)
    emit("serve", requests=len(bodies), http_status=status,
         batches=sizes.get("count"), requests_batched=sizes.get("sum"),
         latency_ms={"p50": float(np.percentile(lat, 50)), "p99": float(np.percentile(lat, 99)),
                     "all": [round(x, 2) for x in lat]},
         requests_per_s=len(bodies) / total_ms * 1e3, wall_ms=round(total_ms, 2),
         caption_texts_differing=flips, caption_texts=sum(
             e["source"] == "box_yolo_content_yolo" for el in want for e in el),
         launches=counts, server_seconds={k: metrics["histograms"][k]["mean"] for k in sorted(
             metrics["histograms"]) if k.endswith("_seconds")},
         shutdown={"serve_thread_alive": serving.is_alive(),
                   "batcher_alive": srv.batcher._thread.is_alive(),
                   "queued": srv.batcher._queue.qsize()})
    if not sizes or not sizes.get("sum", 0) > sizes.get("count", 0):
        fail(f"serve: no batch of more than one request formed ({sizes})")
    if serving.is_alive() or srv.batcher._thread.is_alive() or srv.batcher._queue.qsize():
        fail("serve: the server did not shut down cleanly")


# ------------------------------------------------------------------ #
# upstream checkpoint formats, written from seeded weights
# ------------------------------------------------------------------ #


def ultralytics_state_dict(state):
    """The port's YOLOv8 state_dict -> an ultralytics DetectionModel's keys
    (``model.{i}...``), the inverse of weights/convert_yolo.py's layer map.
    Both sides keep torch layouts, so only the names change."""
    from omniparser_tpu_torch.weights.convert_yolo import _LAYER_MAP

    index = {name: i for i, name in _LAYER_MAP.items()}
    out = {}
    for key, v in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        top, rest = key.split(".", 1)
        if top == "head":  # box{l}_{j} -> cv2.{l}.{j}, cls{l}_{j} -> cv3.{l}.{j}
            kind, lvl, j, leaf = re.match(r"(box|cls)(\d)_(\d)\.(.+)$", rest).groups()
            new = f"22.{'cv2' if kind == 'box' else 'cv3'}.{lvl}.{j}.{leaf}"
        else:
            new = f"{index[top]}." + re.sub(r"^m(\d+)\.", r"m.\1.", rest)
        out["model." + new] = v.detach().float().cpu().contiguous()
    return out


_DAVIT_HF = {"cpe1.proj": "conv1.fn.dw", "cpe2.proj": "conv2.fn.dw", "norm1": "norm1",
             "norm2": "norm2", "attn.qkv": "attn.qkv", "attn.proj": "attn.proj",
             "mlp.fc1": "ffn.fn.net.fc1", "mlp.fc2": "ffn.fn.net.fc2"}


def hf_florence_state_dict(state):
    """The port's Florence2 state_dict -> the HF checkpoint's keys (the
    remote-code spelling that weights/convert_florence.py reads), float32
    numpy, with the tied ``lm_head`` alias beside ``shared``.  Both sides
    keep torch layouts, so only the names change."""
    out = {}
    for key, v in state.items():
        a = v.detach().float().cpu().numpy()
        m = re.match(r"vision\.davit\.patch_embed(\d)_(conv|norm)\.(\w+)$", key)
        if m:
            s, kind, leaf = m.groups()
            out[f"vision_tower.convs.{s}.{'proj' if kind == 'conv' else 'norm'}.{leaf}"] = a
            continue
        m = re.match(r"vision\.davit\.stage(\d)_blk(\d+)_(spatial|channel)\.(.+)\.(\w+)$", key)
        if m:
            s, d, half, rest, leaf = m.groups()
            out[f"vision_tower.blocks.{s}.{d}.{0 if half == 'spatial' else 1}."
                f"{_DAVIT_HF[rest]}.{leaf}"] = a
            continue
        m = re.match(r"language_model\.(encoder|decoder)_(embed_positions|layernorm_embedding)"
                     r"\.(\w+)$", key)
        if m:
            side, what, leaf = m.groups()
            out[f"language_model.model.{side}.{what}.{leaf}"] = a
            continue
        m = re.match(r"language_model\.(encoder|decoder)_layer(\d+)\.(.+)$", key)
        if m:
            side, i, rest = m.groups()
            out[f"language_model.model.{side}.layers.{i}.{rest}"] = a
            continue
        fixed = {
            "vision.image_projection": "image_projection",
            "vision.image_proj_norm.weight": "image_proj_norm.weight",
            "vision.image_proj_norm.bias": "image_proj_norm.bias",
            "vision.image_pos_embed_row": "image_pos_embed.row_embeddings.weight",
            "vision.image_pos_embed_col": "image_pos_embed.column_embeddings.weight",
            "vision.visual_temporal_embed": "visual_temporal_embed.pos_idx_to_embed",
            "language_model.shared.weight": "language_model.model.shared.weight",
        }
        if key == "language_model.final_logits_bias":
            out["language_model.final_logits_bias"] = a.reshape(1, -1)
        elif key in fixed:
            out[fixed[key]] = a
        else:
            raise KeyError(f"no HF spelling for {key!r}")
    out["language_model.lm_head.weight"] = out["language_model.model.shared.weight"]
    return out


def write_upstream_checkpoints(directory, det_module, florence_model):
    """An ultralytics-format detector file (``torch.save`` of a state_dict
    under ``model.*`` keys) and an HF-format Florence-2 directory
    (``model.safetensors`` in float32 and a ``config.json``) from the given
    modules' weights.  Returns (detector path, captioner directory, bytes)."""
    import os

    from omniparser_tpu_torch.weights.safetensors import write_safetensors

    pt = os.path.join(directory, "icon_detect", "model.pt")
    hf = os.path.join(directory, "icon_caption")
    os.makedirs(os.path.dirname(pt))
    os.makedirs(hf)
    torch.save(ultralytics_state_dict(det_module.state_dict()), pt)
    d = florence_model.dims
    write_safetensors(os.path.join(hf, "model.safetensors"),
                      hf_florence_state_dict(florence_model.state_dict()))
    with open(os.path.join(hf, "config.json"), "w") as f:
        json.dump({"model_type": "florence2", "vision_config": {
            "depths": list(d.depths), "dim_embed": list(d.embed_dims)},
            "text_config": {"d_model": d.d_model, "vocab_size": d.vocab_size}}, f)
    size = os.path.getsize(pt) + os.path.getsize(os.path.join(hf, "model.safetensors"))
    return pt, hf, size


def state_mismatches(got, want):
    """Keys whose tensors differ (shape, or any value once `want` is cast
    to `got`'s dtype) between two state_dicts, and keys only one side has."""
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        a, b = got[k].cpu(), want[k].cpu()
        if a.shape != b.shape or not torch.equal(a, b.to(a.dtype)):
            bad.append(k)
    return bad


def same_elements(got, want, atol: float):
    """The first element field that differs (boxes beyond atol), or None;
    captions are compared too, and counted apart: (field, caption flips)."""
    if len(got) != len(want):
        return f"{len(got)} elements against {len(want)}", 0
    flips = 0
    for i, (a, b) in enumerate(zip(got, want)):
        for k in ("type", "interactivity", "source"):
            if a[k] != b[k]:
                return f"element {i} {k}: {a[k]} against {b[k]}", flips
        if max(abs(x - y) for x, y in zip(a["bbox"], b["bbox"])) > atol:
            return f"element {i} bbox: {a['bbox']} against {b['bbox']}", flips
        if a["source"] == "box_yolo_content_yolo":
            flips += a["content"] != b["content"]
        elif a["content"] != b["content"]:
            return f"element {i} content: {a['content']!r} against {b['content']!r}", flips
    return None, flips


def provided_ocr_boxes(icons: np.ndarray, h: int, w: int):
    """OCR boxes (pixel xyxy ints) made from detected icons: one inside an
    icon (its text is absorbed), one containing an icon (the icon is
    dropped), one overlapping an icon by half, one apart from every icon.
    The icons used are the smallest of at least 12 px a side that no
    smaller icon suppresses and that touch each other nowhere."""
    b = np.asarray(icons, np.float64).reshape(-1, 4)
    wh = b[:, 2:] - b[:, :2]
    area = wh[:, 0] * wh[:, 1]
    lt, rb = np.maximum(b[:, None, :2], b[None, :, :2]), np.minimum(b[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=2)
    with np.errstate(divide="ignore", invalid="ignore"):  # zero-area icons: never picked
        ratio = np.maximum(inter / (area[:, None] + area[None, :] - inter + 1e-6),
                           np.maximum(inter / area[:, None], inter / area[None, :]))
    # icons that no smaller icon suppresses (the merge's rule at 0.9), and
    # that touch none of the others picked
    picked = []
    for i in np.argsort(area, kind="stable"):
        if wh[i, 0] < 12 or wh[i, 1] < 12:
            continue
        if ((ratio[i] > 0.9) & (area < area[i])).any() or (inter[i, picked] > 0).any():
            continue
        picked.append(int(i))
        if len(picked) == 3:
            break
    if len(picked) < 3:
        fail(f"{len(picked)} separate icons of 12 px or more to build OCR boxes on, want 3")
    a, c, o = b[picked[0]], b[picked[1]], b[picked[2]]
    qa, qc = (a[2:] - a[:2]) / 4, (c[2:] - c[:2]) / 5
    boxes = [np.concatenate([a[:2] + qa, a[2:] - qa]),             # inside icon a
             np.concatenate([c[:2] - qc, c[2:] + qc]),             # contains icon c
             o + np.array([1, 0, 1, 0]) * (o[2] - o[0]) / 2]       # half over icon o
    texts = ["inside", "contains", "overlaps"]
    for y in range(0, h - 20, 10):                                 # apart from all
        hit = next((x for x in range(0, w - 20, 10) if not (
            (b[:, 0] < x + 20) & (b[:, 2] > x) & (b[:, 1] < y + 20) & (b[:, 3] > y)).any()), None)
        if hit is not None:
            boxes.append(np.array([hit, y, hit + 20, y + 20], np.float64))
            texts.append("apart")
            break
    out = [[int(np.clip(round(v), 0, lim)) for v, lim in zip(bx, (w, h, w, h))] for bx in boxes]
    return out, texts


def parity_compat(cpu, gpu, image):
    """get_som_labeled_img on the CPU and on the card with the same
    weights and OCR boxes made from the CPU's own icons, so that absorb and
    the OCR-removes-icon rule both fire: every integer field equal, boxes
    to PARITY_ATOL['det_boxes']."""
    from omniparser_tpu_torch import compat

    h, w = image.shape[:2]
    box_thr, nms_iou = 0.05, cpu.config.detector.nms_iou_threshold
    icons, _, _ = compat.predict_yolo((cpu.detector, cpu.det_module), image, box_thr,
                                      iou_threshold=nms_iou, device="cpu")
    ocr_bbox, ocr_text = provided_ocr_boxes(icons, h, w)
    runs = {}
    for name, pipe in (("cpu", cpu), ("cuda", gpu)):
        reset_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, _, elements = compat.get_som_labeled_img(
                image, (pipe.detector, pipe.det_module), BOX_TRESHOLD=box_thr,
                ocr_bbox=ocr_bbox, ocr_text=ocr_text, use_local_semantics=False,
                device=pipe.device)
        if name == "cuda":
            torch.cuda.synchronize()
        counts = all_counts()
        used = [p for p in compat._PIPELINE_CACHE.values() if p.det_module is pipe.det_module]
        runs[name] = (elements, dict(used[0].last_counts), counts)
    (e_cpu, c_cpu, _), (e_gpu, c_gpu, launches) = runs["cpu"], runs["cuda"]
    bad, _ = same_elements(e_gpu, e_cpu, PARITY_ATOL["det_boxes"])
    keys = ("det_keep", "ocr_candidates", "ocr_valid", "ocr_absorbed", "icons_inside_ocr",
            "elements")
    emit("parity_on_card", check="compat get_som_labeled_img, CPU against card, float32, "
         "TF32 off", icons=len(icons), ocr_bbox=ocr_bbox, ocr_text=ocr_text,
         counts={k: {"cpu": c_cpu[k], "cuda": c_gpu[k]} for k in keys}, launches=launches,
         differs=bad)
    if bad:
        fail(f"parity_on_card: compat parse differs between CPU and card: {bad}")
    if any(c_cpu[k] != c_gpu[k] for k in keys):
        fail("parity_on_card: compat counts differ between CPU and card")
    if not (c_gpu["ocr_absorbed"] > 0 and c_gpu["icons_inside_ocr"] > 0):
        fail(f"parity_on_card: the compat case absorbed {c_gpu['ocr_absorbed']} OCR boxes and "
             f"dropped {c_gpu['icons_inside_ocr']} icons inside OCR (want both > 0)")
    if launches["nms_keep"] != 1 or launches["merge_masks"] != 1:
        fail(f"parity_on_card: the card's compat parse launched {launches}")


def phase_compat(seed: int, pipe, image, cfg, launches_by_path):
    """The reference's two calls, check_ocr_box -> get_som_labeled_img,
    with the parse's seeded networks carried through the upstream file
    formats, and the host-candidate OCR parses against the fused path."""
    import os

    from omniparser_tpu_torch import compat
    from omniparser_tpu_torch.models.ocr import TorchOCR
    from omniparser_tpu_torch.ocr import NullOCR
    from omniparser_tpu_torch.pipeline import Omniparser, SOMPipeline

    dev = pipe.device

    def wall(call):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # K2 at the host OCR slot buckets: N = 512 icons against M = 32 .. 256
    rng = np.random.default_rng(seed + 41)
    for m in (32, 64, 128, 256):
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in _merge_random(rng, 512, m))
        mism, want = merge_mismatches(args, 0.9)  # the compat call's iou_threshold
        emit("compat", kernel="merge_masks", case=f"512x{m}", absorb=int(want[2].sum()),
             mismatches=mism)
        if any(mism.values()):
            fail(f"compat: merge_masks disagrees with its plain version at M = {m}: {mism}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        (pt, hf, nbytes), write_ms = wall(lambda: write_upstream_checkpoints(
            tmp, pipe.det_module, pipe.captioner.model))
        # the reference's config dict; the OCR is check_ocr_box's below
        omni, load_ms = wall(lambda: Omniparser(
            {"som_model_path": pt, "caption_model_path": hf, "BOX_TRESHOLD": 0.05},
            device=dev, ocr=NullOCR(), captioner_dims=pipe.captioner.dims))
        bad_det = state_mismatches(omni.pipeline.det_module.state_dict(),
                                   pipe.det_module.state_dict())
        bad_cap = state_mismatches(omni.pipeline.captioner.model.state_dict(),
                                   pipe.captioner.model.state_dict())
    emit("compat", checkpoints={"ultralytics_pt": "icon_detect/model.pt",
                                "hf_dir": "icon_caption/ (model.safetensors float32, config.json)",
                                "bytes": nbytes, "write_ms": round(write_ms, 1),
                                "omniparser_load_ms": round(load_ms, 1)},
         state_equal={"detector": not bad_det, "captioner": not bad_cap},
         differing_keys=(bad_det + bad_cap)[:8])
    if bad_det or bad_cap:
        fail(f"compat: the loaded checkpoints differ from the seeded state: {(bad_det + bad_cap)[:8]}")

    model = (omni.pipeline.detector, omni.pipeline.det_module)
    caption = omni.pipeline.captioner
    ocr = TorchOCR(dataclasses.replace(cfg.ocr, text_threshold=0.0), dev,
                   pipe.ocr.det.state_dict(), pipe.ocr.rec.state_dict())
    args = {"text_threshold": 0.0}
    kw = dict(BOX_TRESHOLD=0.05, caption_model_processor=caption, device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        # warm-up of both calls (first launches at these shapes)
        (texts, boxes), _ = compat.check_ocr_box(image, output_bb_format="xyxy",
                                                 easyocr_args=args, backend=ocr, device=dev)
        compat.get_som_labeled_img(image, model, ocr_bbox=boxes, ocr_text=texts, **kw)
        variants = {}
        for decoder in ("greedy", "beamsearch"):
            for paragraph in (False, True):
                ((t, b), _), ms = wall(lambda: compat.check_ocr_box(
                    image, output_bb_format="xyxy", backend=ocr, device=dev,
                    easyocr_args=dict(args, decoder=decoder, paragraph=paragraph)))
                variants[f"{decoder}{'_paragraph' if paragraph else ''}"] = {
                    "boxes": len(b), "ms": round(ms, 2), "sample": t[:2]}
        # the counted path: counters to 0 just before, read just after
        reset_counts()
        (((texts, boxes), _), ocr_ms) = wall(lambda: compat.check_ocr_box(
            image, output_bb_format="xyxy", easyocr_args=args, backend=ocr, device=dev))
        (som, labels, elements), som_ms = wall(lambda: compat.get_som_labeled_img(
            image, model, ocr_bbox=boxes, ocr_text=texts, **kw))
        counts = all_counts()
    cached = [p for p in compat._PIPELINE_CACHE.values() if p.captioner is caption]
    c = dict(cached[0].last_counts)
    path_counts("compat", counts, launches_by_path)
    emit("compat", check_ocr_box=variants, check_ocr_box_ms=round(ocr_ms, 2),
         get_som_labeled_img_ms=round(som_ms, 2), ocr_boxes=len(boxes), elements=len(elements),
         ocr_boxes_to_the_merge=c["ocr_valid"],
         ocr_absorbed=c["ocr_absorbed"], icons_inside_ocr=c["icons_inside_ocr"],
         captioned=c["cap_need"], kb=c["kb"], launches=counts,
         som_png_bytes=len(som), warnings=sorted({str(w.message)[:80] for w in caught}))
    if not boxes:
        fail("compat: check_ocr_box found no text at text threshold 0")
    if c["ocr_valid"] != len(boxes):
        fail(f"compat: {len(boxes)} OCR boxes handed in, {c['ocr_valid']} reached the merge")
    if counts["nms_keep"] != 1 or counts["merge_masks"] != 1 or counts["overlap_matrices"]:
        fail(f"compat: launches {counts} (want nms_keep 1, merge_masks 1, overlap_matrices 0)")
    if counts["crop_resize"] < 2:
        fail(f"compat: crop_resize launched {counts['crop_resize']} times (want the line grid "
             "and the caption grid)")
    if not elements or len(labels) != len(elements):
        fail("compat: get_som_labeled_img returned no elements")
    if not any(e["type"] == "text" and e["content"] in texts for e in elements) and \
            not c["ocr_absorbed"]:
        fail("compat: no OCR text reached the elements")

    # get_som_labeled_img again with OCR boxes made from this model's own
    # icons (seeded OCR boxes cover every icon, so the call above captions
    # nothing): absorb, the icon drop and the caption decode at full width
    icons, _, _ = compat.predict_yolo(model, image, 0.05, device=dev,
                                      iou_threshold=cfg.detector.nms_iou_threshold)
    made_boxes, made_texts = provided_ocr_boxes(icons, *image.shape[:2])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        compat.get_som_labeled_img(image, model, ocr_bbox=made_boxes, ocr_text=made_texts, **kw)
        reset_counts()
        (_, _, made_elements), made_ms = wall(lambda: compat.get_som_labeled_img(
            image, model, ocr_bbox=made_boxes, ocr_text=made_texts, **kw))
        made_counts = all_counts()
    m = dict(cached[0].last_counts)
    path_counts("compat_made_ocr_boxes", made_counts, launches_by_path)
    emit("compat", made_ocr_boxes=made_boxes, made_ocr_text=made_texts,
         get_som_labeled_img_ms=round(made_ms, 2), elements=len(made_elements),
         ocr_boxes_to_the_merge=m["ocr_valid"], ocr_absorbed=m["ocr_absorbed"],
         icons_inside_ocr=m["icons_inside_ocr"], captioned=m["cap_need"], kb=m["kb"],
         launches=made_counts)
    if not (m["ocr_absorbed"] > 0 and m["icons_inside_ocr"] > 0 and m["kb"] > 0):
        fail(f"compat: with OCR boxes made from the icons, absorbed {m['ocr_absorbed']}, "
             f"icons inside OCR {m['icons_inside_ocr']}, caption bucket {m['kb']} (want all > 0)")
    if any(e["content"] is None for e in made_elements):
        fail("compat: an element without content")

    # host-candidate OCR: the parse's networks with the candidates on the
    # host, against the fused device-candidate parse
    host = {}
    for name, flags in (("host_components", {"device_components": False}),
                        ("host_candidates", {"fused_candidates": False})):
        hcfg = dataclasses.replace(cfg, ocr=dataclasses.replace(cfg.ocr, **flags))
        hocr = pipe.ocr if flags.get("device_components", True) else TorchOCR(
            hcfg.ocr, dev, pipe.ocr.det.state_dict(), pipe.ocr.rec.state_dict())
        hp = SOMPipeline(hcfg, dev, detector=pipe.detector, det_module=pipe.det_module,
                         ocr=hocr, captioner=pipe.captioner)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            hp.parse_image(image)  # warm-up
            reset_counts()
            (_, _, got), ms = wall(lambda: hp.parse_image(image))
            hcounts = all_counts()
            pipe.config = cfg
            _, _, want = pipe.parse_image(image)
        path_counts(name, hcounts, launches_by_path)
        bad, flips = same_elements(got, want, 0.0)
        host[name] = {"elements": len(got), "ms": round(ms, 2), "caption_flips": flips,
                      "ocr_candidates": hp.last_counts["ocr_candidates"], "launches": hcounts}
        if bad:
            fail(f"compat: {name} parse differs from the fused path: {bad}")
    emit("compat", host_candidate_parses=host)
    del omni, caption, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ #
# phase families: YOLOv9-E, the easyocr arch and BLIP-2 opt-2.7b
# ------------------------------------------------------------------ #


@contextlib.contextmanager
def recording(owner, name: str):
    """owner.name replaced, for the block, by a pass-through that keeps a
    copy of every call's arguments: [(args, kwargs), ...]."""
    real = getattr(owner, name)
    calls = []

    def wrapper(*args, **kw):
        calls.append((tuple(a.clone() if torch.is_tensor(a) else a for a in args), dict(kw)))
        return real(*args, **kw)

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


def check_nms_calls(case: str, calls) -> None:
    """Each recorded NMS window through nms_keep against nms_keep_plain."""
    from omniparser_tpu_torch.ops import hopper_kernels

    if not calls:
        fail(f"families: {case} ran no NMS")
    for (b, v, thr), _ in calls:
        want = hopper_kernels.nms_keep_plain(b, v, thr)
        mism = int((hopper_kernels.nms_keep(b, v, thr) != want).sum())
        emit("families", kernel="nms_keep", case=case, n=int(v.numel()), valid=int(v.sum()),
             keeps=int(want.sum()), coord_max=float(b.abs().max()), thr=thr, mismatches=mism)
        if mism:
            fail(f"families: nms_keep disagrees with its plain version on {case}: {mism} slots")


def check_crop_calls(case: str, calls) -> None:
    """Each recorded crop-gather through crop_resize against its plain version."""
    from omniparser_tpu_torch.ops import hopper_crop

    if not calls:
        fail(f"families: {case} gathered no crops")
    for args, kw in calls:
        got = hopper_crop.crop_resize(*args, **kw)
        want = hopper_crop.crop_resize_plain(*args, **kw)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        emit("families", kernel="crop_resize", case=case, k=int(args[2].shape[0]),
             out_hw=list(got.shape[1:3]), grid=kw.get("grid", "resize"), max_abs_diff=err,
             atol=1e-2)
        if not err <= 1e-2:
            fail(f"families: crop_resize disagrees with its plain version on {case}: {err}")


def sync_wall(call):
    """(call's result, milliseconds to a synchronise after it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def yolov9_state_dict(state):
    """The port's GELAN state_dict -> the yolov9 repository's keys
    (``model.{i}...``), the inverse of weights/convert_yolov9.py's map."""
    from omniparser_tpu_torch.weights.convert_yolov9 import _MODULE_ORDER, _MODULE_ORDER_DUAL

    dual = any(k.startswith("stemA.") for k in state)
    index = {name: i for i, name in enumerate(_MODULE_ORDER_DUAL if dual else _MODULE_ORDER)}
    out = {}
    for key, v in state.items():
        top, rest = key.split(".", 1)
        if top == "head":  # box{l}_{j} -> cv2.{l}.{j}, cls{l}_{j} -> cv3.{l}.{j}
            kind, lvl, j, leaf = re.match(r"(box|cls)(\d)_(\d)\.(.+)$", rest).groups()
            rest = f"{'cv2' if kind == 'box' else 'cv3'}.{lvl}.{j}.{leaf}"
        else:
            rest = re.sub(r"\b(cv[23])_csp\b", r"\1.0", rest)
            rest = re.sub(r"\b(cv[23])_conv\b", r"\1.1", rest)
            rest = re.sub(r"\bm(\d+)\b", r"m.\1", rest)
        v = v.detach().cpu()
        out[f"model.{index[top]}.{rest}"] = v.float() if v.is_floating_point() else v
    return out


def write_torchscript_state(path: str, sd) -> None:
    """A TorchScript archive whose state dict is `sd` (the reference's
    icon_detect_v3/model.pt is a TorchScript archive with yolov9 keys)."""
    root = torch.nn.Module()
    for k, v in sd.items():
        parts, m = k.split("."), root
        for p in parts[:-1]:
            if p not in m._modules:
                m.add_module(p, torch.nn.Module())
            m = m._modules[p]
        m.register_buffer(parts[-1], v)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = root.model

        def forward(self, x):
            return x

    torch.jit.trace(Holder(), torch.zeros(1)).save(path)


def easyocr_state_dicts(det_state, rec_state):
    """The port's Craft and VggCtcRecognizer state_dicts -> easyocr's
    checkpoint keys (CRAFT under DataParallel's ``module.``), the inverse of
    weights/convert_ocr.py's maps."""
    from omniparser_tpu_torch.weights.convert_ocr import _CRAFT_VGG, _REC_FEATURES

    owners = {f"basenet.{name}": (f"basenet.{conv}", f"basenet.{bn}" if bn else None)
              for conv, bn, name in _CRAFT_VGG}
    for i in range(1, 5):
        owners[f"upconv{i}.c0"] = (f"upconv{i}.conv.0", f"upconv{i}.conv.1")
        owners[f"upconv{i}.c1"] = (f"upconv{i}.conv.3", f"upconv{i}.conv.4")
    for idx, name in ((0, "cls0"), (2, "cls1"), (4, "cls2"), (6, "cls3"), (8, "cls4")):
        owners[name] = (f"conv_cls.{idx}", None)
    for conv, bn, name in _REC_FEATURES:
        owners[name] = (f"FeatureExtraction.{conv}", f"FeatureExtraction.{bn}" if bn else None)

    def rename(state, prefix=""):
        out = {}
        for key, v in state.items():
            m = re.match(r"(.+)\.(conv|bn)\.(\w+)$", key)
            r = re.match(r"rnn(\d)\.(rnn|linear)\.(\w+)$", key)
            if m and m.group(1) in owners:
                owner, kind, leaf = m.groups()
                new = owners[owner][0 if kind == "conv" else 1] + "." + leaf
            elif r:
                new = "SequenceModeling.{}.{}.{}".format(*r.groups())
            elif key.startswith("pred."):
                new = "Prediction." + key[len("pred."):]
            else:
                raise KeyError(f"no easyocr spelling for {key!r}")
            v = v.detach().cpu()
            out[prefix + new] = v.float() if v.is_floating_point() else v
        return out

    return rename(det_state, "module."), rename(rec_state)


_HF_VISION = {"attn.qkv": "self_attn.qkv", "attn.projection": "self_attn.projection",
              "fc1": "mlp.fc1", "fc2": "mlp.fc2", "ln1": "layer_norm1", "ln2": "layer_norm2"}
_HF_QFORMER = {"fc1": "intermediate_query.dense", "fc2": "output_query.dense",
               "ffn_ln": "output_query.LayerNorm"}
for _side, _hf in (("self", "attention"), ("cross", "crossattention")):
    _HF_QFORMER.update({f"{_side}.{p}": f"{_hf}.attention.{p}" for p in ("query", "key", "value")})
    _HF_QFORMER[f"{_side}.output_dense"] = f"{_hf}.output.dense"
    _HF_QFORMER[f"{_side}.output_ln"] = f"{_hf}.output.LayerNorm"


def hf_blip2_state_dict(state):
    """The port's Blip2 state_dict -> HF modeling_blip_2's keys, float32
    numpy, with the tied ``lm_head`` beside the token table: the inverse of
    weights/convert_blip2.py's map (both keep torch layouts)."""
    out = {}
    for key, v in state.items():
        a = v.detach().float().cpu().numpy()
        if m := re.match(r"vision_model\.l(\d+)_(.+)\.(\w+)$", key):
            i, mid, leaf = m.groups()
            key = f"vision_model.encoder.layers.{i}.{_HF_VISION[mid]}.{leaf}"
        elif m := re.match(r"qformer\.l(\d+)_(.+)\.(\w+)$", key):
            i, mid, leaf = m.groups()
            key = f"qformer.encoder.layer.{i}.{_HF_QFORMER[mid]}.{leaf}"
        elif m := re.match(r"language_model\.layer(\d+)\.(.+)\.(\w+)$", key):
            i, mid, leaf = m.groups()
            mid = f"self_attn.{mid}" if mid.endswith("_proj") else mid
            key = f"language_model.model.decoder.layers.{i}.{mid}.{leaf}"
        elif key.startswith("language_model."):
            key = "language_model.model.decoder." + key[len("language_model."):]
        elif key == "vision_model.class_embedding":
            key, a = "vision_model.embeddings.class_embedding", a.reshape(1, 1, -1)
        elif key == "vision_model.position_embedding":
            key, a = "vision_model.embeddings.position_embedding", a[None]
        elif key.startswith("vision_model.patch_embedding."):
            key = "vision_model.embeddings." + key[len("vision_model."):]
        elif key == "qformer.query_tokens":
            key = "query_tokens"
        out[key] = a
    out["language_model.lm_head.weight"] = out["language_model.model.decoder.embed_tokens.weight"]
    return out


def calibrate_craft_head(ocr, image, scale: float = 20.0, share: float = 0.15) -> float:
    """Seeded CRAFT draws no region above the detector's 0.3: scale its
    region head by `scale` and set the head's bias so that `share` of this
    image's region map lies above 0.3 (tests/test_torch_easyocr.py does the
    same to its numpy weights).  Returns the bias."""
    from omniparser_tpu_torch.ops.preprocess import letterbox, pad_to_bucket, pick_bucket_2d

    h, w = image.shape[:2]
    padded = torch.from_numpy(pad_to_bucket(image, *pick_bucket_2d(h, w))[0]).to(ocr.device)
    img, _, _ = letterbox(padded, (h, w), ocr.config.det_imgsz)
    head = ocr.det.cls4.conv
    with torch.no_grad():
        raw = ocr.det(img.permute(2, 0, 1)[None])[0, 0].float()
        centred = (raw - head.bias[0].float()) * scale
        bias = 0.3 + 1e-3 - torch.quantile(centred.flatten(), 1.0 - share)
        head.weight[0] *= scale
        head.bias[0] = bias
    return float(bias)


def family_yolov9(seed: int, pipe, image, launches_by_path):
    """YOLOv9-E through SOMPipeline at 1280, the reference wrapper's predict
    at 640 and 1280, a 3-class GELAN's per-class NMS window, and a seeded
    GELAN written as a TorchScript archive under icon_detect_v3/ and loaded
    back through get_yolo_model and Omniparser(dict)."""
    import os

    from omniparser_tpu_torch import compat
    from omniparser_tpu_torch.models.yolov9 import YOLOv9Detector
    from omniparser_tpu_torch.ocr import NullOCR
    from omniparser_tpu_torch.ops import nms as nms_mod
    from omniparser_tpu_torch.pipeline import NullCaptioner, Omniparser, SOMPipeline
    from omniparser_tpu_torch.weights.init import build_module

    dev = pipe.device
    cfg = dataclasses.replace(pipe.config,
                              detector=dataclasses.replace(pipe.config.detector, variant="v9e"))
    v9, build_ms = sync_wall(lambda: SOMPipeline(cfg, dev, ocr=pipe.ocr, captioner=pipe.captioner,
                                                 seed=seed))
    if not isinstance(v9.detector, YOLOv9Detector) or v9.detector.variant != "e":
        fail(f"families: variant 'v9e' built {v9.detector}")

    def parse():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return v9.parse_elements(image)

    parse()  # warm-up: the first launches at these shapes
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (labels_a, elements_a), wall_a = sync_wall(parse)
    counts = all_counts()
    peak = torch.cuda.max_memory_allocated()
    c = dict(v9.last_counts)
    (labels_b, elements_b), wall_b = sync_wall(parse)
    path_counts("v9e_parse", counts, launches_by_path)
    with recording(nms_mod, "nms_keep") as calls:
        parse()
    check_nms_calls("v9e_parse_window", calls)
    walls = [sync_wall(parse)[1] for _ in range(3)]
    prof = profile_pass(lambda: sync_wall(parse)[1], walls)
    v9.stage_ms = {}  # one more parse with each stage synchronised
    parse()
    emit("families", family="yolov9", path="SOMPipeline(variant='v9e') parse_elements @1280",
         build_ms=round(build_ms, 1), counts=c, launches=counts,
         wall_ms=[round(wall_a, 2), round(wall_b, 2)], profile=prof,
         device_stage_ms={k: round(v, 3) for k, v in v9.stage_ms.items()},
         max_memory_allocated=peak, elements=len(elements_a))
    want = {"nms_keep": 1, "merge_masks": 1, "crop_resize": 2, "overlap_matrices": 0}
    if any(counts[k] != n for k, n in want.items()):
        fail(f"families: the v9e parse launched {counts} (want {want})")
    if elements_a != elements_b or labels_a != labels_b:
        fail("families: two v9e parses of the same image differ")
    del v9

    # the reference wrapper's predict, from get_yolo_model(variant='v9e')
    det, module = compat.get_yolo_model(variant="v9e", device=dev)
    predicted = {}
    for imgsz in (640, 1280):
        det.predict(module, image, conf=0.05, imgsz=imgsz)  # warm-up
        reset_counts()
        (res,), ms = sync_wall(lambda: det.predict(module, image, conf=0.05, imgsz=imgsz))
        counts = all_counts()
        launches_by_path[f"v9e_predict_{imgsz}"] = counts
        predicted[imgsz] = {"boxes": int(len(res.boxes.conf)), "ms": round(ms, 2),
                            "launches": counts}
        if counts["nms_keep"] != 1 or not len(res.boxes.conf):
            fail(f"families: predict at {imgsz} launched {counts}, kept {len(res.boxes.conf)}")
    # per-class NMS: 3 classes, boxes moved by class x (max - min + 1)
    det3 = YOLOv9Detector(variant="e", num_classes=3)
    module3 = build_module(det3.make_module(), None, torch.Generator().manual_seed(seed + 3),
                           torch.bfloat16, dev)
    with recording(nms_mod, "nms_keep") as calls:
        (res3,) = det3.predict(module3, image, conf=0.05, imgsz=1280)
    check_nms_calls("v9e_3class_offset_window", calls)
    del det3, module3

    with tempfile.TemporaryDirectory(prefix="chip_smoke_v9_") as tmp:
        path = os.path.join(tmp, "icon_detect_v3", "model.pt")
        os.makedirs(os.path.dirname(path))
        _, write_ms = sync_wall(lambda: write_torchscript_state(
            path, yolov9_state_dict(module.state_dict())))
        (det_l, module_l), load_ms = sync_wall(lambda: compat.get_yolo_model(path, device=dev))
        bad = state_mismatches(module_l.state_dict(), module.state_dict())
        omni, omni_ms = sync_wall(lambda: Omniparser({"som_model_path": path}, device=dev,
                                                     ocr=NullOCR(), captioner=NullCaptioner()))
        bad += state_mismatches(omni.pipeline.det_module.state_dict(), module.state_dict())
        nbytes = os.path.getsize(path)
    emit("families", family="yolov9", predict=predicted, three_class_kept=len(res3.boxes.conf),
         torchscript={"path": "icon_detect_v3/model.pt", "bytes": nbytes,
                      "write_ms": round(write_ms, 1), "get_yolo_model_ms": round(load_ms, 1),
                      "omniparser_dict_ms": round(omni_ms, 1),
                      "omniparser_detector": type(omni.pipeline.detector).__name__ + "/"
                      + omni.pipeline.detector.variant},
         state_equal=not bad, differing_keys=bad[:8])
    if bad or not isinstance(omni.pipeline.detector, YOLOv9Detector) or \
            not isinstance(det_l, YOLOv9Detector):
        fail(f"families: the icon_detect_v3 archive loaded back differently: {bad[:8]}")
    del omni, module, module_l
    torch.cuda.empty_cache()


def family_easyocr(seed: int, pipe, image, launches_by_path):
    """TorchOCR(arch='easyocr', rec_height=64): CRAFT at 1920 through
    check_ocr_box -> get_som_labeled_img and through a fused parse_image,
    K3's 64x480 line grid against its plain version, and the seeded
    networks written as craft_mlt_25k.pth / english_g2.pth and read back."""
    import os

    from omniparser_tpu_torch import compat
    from omniparser_tpu_torch.models.ocr import TorchOCR
    from omniparser_tpu_torch.ops import hopper_crop
    from omniparser_tpu_torch.pipeline import SOMPipeline
    from omniparser_tpu_torch.weights.convert_ocr import load_easyocr_states

    dev = pipe.device
    ocfg = dataclasses.replace(pipe.config.ocr, arch="easyocr", rec_height=64, text_threshold=0.0)
    ocr, build_ms = sync_wall(lambda: TorchOCR(ocfg, dev,
                                               generator=torch.Generator().manual_seed(seed + 5)))
    bias = calibrate_craft_head(ocr, image)
    model = (pipe.detector, pipe.det_module)
    args = {"text_threshold": 0.0}

    def two_calls():
        (texts, boxes), _ = compat.check_ocr_box(image, output_bb_format="xyxy",
                                                 easyocr_args=args, backend=ocr, device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, _, elements = compat.get_som_labeled_img(
                image, model, BOX_TRESHOLD=pipe.config.detector.box_threshold, ocr_bbox=boxes,
                ocr_text=texts, device=dev)
        return texts, boxes, elements

    two_calls()  # warm-up
    (((texts, boxes), _), ocr_ms) = sync_wall(lambda: compat.check_ocr_box(
        image, output_bb_format="xyxy", easyocr_args=args, backend=ocr, device=dev))
    reset_counts()
    (_, _, elements), calls_ms = sync_wall(two_calls)
    counts = all_counts()
    path_counts("easyocr_check_ocr_box_get_som", counts, launches_by_path)
    emit("families", family="easyocr", path="check_ocr_box -> get_som_labeled_img, CRAFT @1920",
         build_ms=round(build_ms, 1), craft_head_bias=bias, check_ocr_box_ms=round(ocr_ms, 2),
         two_calls_ms=round(calls_ms, 2), ocr_boxes=len(boxes), sample=texts[:3],
         elements=len(elements), launches=counts)
    if not boxes:
        fail("families: check_ocr_box with the easyocr arch found no text at threshold 0")

    ep = SOMPipeline(dataclasses.replace(pipe.config, ocr=ocfg), dev, detector=pipe.detector,
                     det_module=pipe.det_module, ocr=ocr, captioner=pipe.captioner)

    def parse():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return ep.parse_image(image)

    parse()  # warm-up
    reset_counts()
    (_, _, el_a), wall_a = sync_wall(parse)
    counts = all_counts()
    c = dict(ep.last_counts)
    path_counts("easyocr_parse", counts, launches_by_path)
    with recording(hopper_crop, "crop_resize") as calls:
        _, _, el_b = parse()
    lines = [call for call in calls if call[1].get("grid") == "line"]
    check_crop_calls("easyocr_line_grid", lines)
    ep.stage_ms = {}  # one more parse with each stage synchronised
    parse()
    emit("families", family="easyocr", path="SOMPipeline(ocr arch 'easyocr') parse_image",
         wall_ms=round(wall_a, 2), counts=c, launches=counts,
         device_stage_ms={k: round(v, 3) for k, v in ep.stage_ms.items()},
         line_grid=[list(call[0][3]) for call in lines])
    # the line grid once per block of rec_block lines, then the caption grid
    if counts["nms_keep"] != 1 or counts["merge_masks"] != 1 or \
            counts["crop_resize"] != len(lines) + 1:
        fail(f"families: the easyocr parse launched {counts} ({len(lines)} line blocks)")
    if c["ocr_candidates"] < 1 or el_a != el_b:
        fail(f"families: the easyocr parse had {c['ocr_candidates']} candidates, "
             f"or two parses differ")
    if any(tuple(call[0][3]) != (64, ocfg.rec_max_width) for call in lines):
        fail("families: the easyocr line grid is not 64 rows")
    del ep

    with tempfile.TemporaryDirectory(prefix="chip_smoke_easyocr_") as tmp:
        craft_sd, rec_sd = easyocr_state_dicts(ocr.det.state_dict(), ocr.rec.state_dict())
        craft_p, rec_p = os.path.join(tmp, "craft_mlt_25k.pth"), os.path.join(tmp, "english_g2.pth")
        torch.save(craft_sd, craft_p)
        torch.save(rec_sd, rec_p)
        (det_s, rec_s), load_ms = sync_wall(lambda: load_easyocr_states(craft_p, rec_p))
        nbytes = os.path.getsize(craft_p) + os.path.getsize(rec_p)
    drop = lambda s: {k: v for k, v in s.items() if not k.endswith("num_batches_tracked")}
    bad = (state_mismatches(det_s, drop(ocr.det.state_dict()))
           + state_mismatches(rec_s, drop(ocr.rec.state_dict())))
    emit("families", family="easyocr", checkpoints={"files": ["craft_mlt_25k.pth",
                                                              "english_g2.pth"],
                                                    "bytes": nbytes, "load_ms": round(load_ms, 1)},
         state_equal=not bad, differing_keys=bad[:8])
    if bad:
        fail(f"families: the easyocr checkpoints loaded back differently: {bad[:8]}")
    del ocr
    torch.cuda.empty_cache()


def family_blip2(seed: int, pipe, image, launches_by_path):
    """BLIP-2 opt-2.7b seeded on the card (get_caption_model_processor):
    get_som_labeled_img with OCR boxes made from the detector's icons, so
    that icons are captioned by 5-beam search; two calls equal; K3's caption
    grid against its plain version; a reduced BLIP-2 written as an
    HF-spelled safetensors directory and read back."""
    import os

    from omniparser_tpu_torch import compat
    from omniparser_tpu_torch.models.blip2 import BLIP2_OPT_2_7B, build_blip2
    from omniparser_tpu_torch.ops import hopper_crop
    from omniparser_tpu_torch.weights.convert_blip2 import load_blip2_state
    from omniparser_tpu_torch.weights.safetensors import write_safetensors

    dev = pipe.device
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cap, build_ms = sync_wall(lambda: compat.get_caption_model_processor("blip2", device=dev))
    resident = torch.cuda.memory_allocated() - before
    n_params = sum(p.numel() for p in cap.model.parameters())
    decode_ms = []
    generate = cap.generate

    def timed_generate(crops):
        out, ms = sync_wall(lambda: generate(crops))
        decode_ms.append(round(ms, 2))
        return out

    cap.generate = timed_generate
    model = (pipe.detector, pipe.det_module)
    icons, _, _ = compat.predict_yolo(model, image, 0.05, device=dev,
                                      iou_threshold=pipe.config.detector.nms_iou_threshold)
    made_boxes, made_texts = provided_ocr_boxes(icons, *image.shape[:2])

    def call():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return compat.get_som_labeled_img(image, model, BOX_TRESHOLD=0.05,
                                              ocr_bbox=made_boxes, ocr_text=made_texts,
                                              caption_model_processor=cap, device=dev)[2]

    with recording(hopper_crop, "crop_resize") as crops:
        elements_a = call()  # also the warm-up
    check_crop_calls("blip2_caption_grid", crops)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    elements_b, ms = sync_wall(call)
    counts = all_counts()
    peak = torch.cuda.max_memory_allocated()
    path_counts("blip2_get_som_labeled_img", counts, launches_by_path)
    cached = [p for p in compat._PIPELINE_CACHE.values() if p.captioner is cap]
    c = dict(cached[0].last_counts)
    captions = [e["content"] for e in elements_b if e["source"] == "box_yolo_content_yolo"]
    emit("families", family="blip2", path="get_som_labeled_img, BLIP-2 opt-2.7b, 5 beams, "
         f"{cap.max_new_tokens} new tokens", params=n_params, build_ms=round(build_ms, 1),
         resident_bytes=resident, max_memory_allocated=peak, get_som_labeled_img_ms=round(ms, 2),
         beam_decode_ms=decode_ms, caption_batches=len(decode_ms) // 2, counts=c,
         captions=len(captions), sample=captions[:3], launches=counts,
         ocr_absorbed=c["ocr_absorbed"], icons_inside_ocr=c["icons_inside_ocr"])
    if not any(isinstance(t, str) and t.strip() for t in captions):
        fail("families: BLIP-2 captioned no icon")
    if elements_a != elements_b:
        fail("families: two BLIP-2 get_som_labeled_img calls gave different captions")
    if counts["nms_keep"] != 1 or counts["merge_masks"] != 1 or counts["beam_attention"] < 1:
        fail(f"families: the BLIP-2 call launched {counts}")
    compat._PIPELINE_CACHE.clear()
    del cap, cached
    torch.cuda.empty_cache()

    # an HF-spelled safetensors directory from a reduced BLIP-2 (full widths)
    red = dataclasses.replace(BLIP2_OPT_2_7B, vision_layers=2, qformer_layers=2, lm_layers=2)
    small = build_blip2(red, None, torch.float32, dev, seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_blip2_") as tmp:
        _, write_ms = sync_wall(lambda: write_safetensors(
            os.path.join(tmp, "model.safetensors"), hf_blip2_state_dict(small.state_dict())))
        state, load_ms = sync_wall(lambda: load_blip2_state(tmp, red))
        nbytes = os.path.getsize(os.path.join(tmp, "model.safetensors"))
    bad = state_mismatches(state, small.state_dict())
    emit("families", family="blip2", hf_dir={"dims": "opt-2.7b widths, 2+2+2 layers",
                                             "bytes": nbytes, "write_ms": round(write_ms, 1),
                                             "load_ms": round(load_ms, 1)},
         state_equal=not bad, differing_keys=bad[:8])
    if bad:
        fail(f"families: the BLIP-2 directory loaded back differently: {bad[:8]}")
    del small, state
    torch.cuda.empty_cache()


_HF_VIS = "model.vision_embed_tokens.img_processor.vision_model."


def hf_phi3v_state_dict(state, dims, rng):
    """A Phi3V state_dict spelled as an HF Phi-3-vision checkpoint (numpy),
    with the keys the loader skips or leaves unused: the tower's last layer
    (random), post_layernorm and the HD separators."""
    out = {}
    for k, v in state.items():
        a = v.float().cpu().numpy()
        parts = k.split(".")
        if parts[0] == "embed_tokens":
            out["model.embed_tokens.weight"] = a
        elif parts[0] == "final_norm":
            out["model.norm.weight"] = a
        elif parts[0] == "lm_head":
            out["lm_head.weight"] = a
        elif parts[0] in ("proj_1", "proj_2"):
            idx = 0 if parts[0] == "proj_1" else 2
            out[f"model.vision_embed_tokens.img_projection.{idx}.{parts[1]}"] = a
        elif parts[0].startswith("layers_"):
            i, mod = parts[0][len("layers_"):], parts[1]
            group = ("self_attn." if mod in ("qkv_proj", "o_proj") else
                     "mlp." if mod in ("gate_up_proj", "down_proj") else "")
            out[f"model.layers.{i}.{group}{mod}.{parts[2]}"] = a
        elif parts[1] == "class_embedding":
            out[_HF_VIS + "embeddings.class_embedding"] = a
        elif parts[1] in ("position_embedding", "patch_embedding"):
            out[_HF_VIS + f"embeddings.{parts[1]}.weight"] = a
        elif parts[1] == "pre_layrnorm":
            out[_HF_VIS + "pre_layrnorm." + parts[2]] = a
        else:  # vision.layers_{i}.<module>...
            i, rest = parts[1][len("layers_"):], parts[2:]
            mod = ".".join(["mlp"] + rest if rest[0] in ("fc1", "fc2") else rest)
            out[_HF_VIS + f"encoder.layers.{i}.{mod}"] = a
    w, last = dims.vision_width, dims.vision_layers - 1
    extra = {f"encoder.layers.{last}.self_attn.q_proj.weight": (w, w),
             f"encoder.layers.{last}.mlp.fc1.weight": (dims.vision_mlp, w),
             f"encoder.layers.{last}.layer_norm1.weight": (w,),
             "post_layernorm.weight": (w,), "post_layernorm.bias": (w,)}
    for k, shape in extra.items():
        out[_HF_VIS + k] = rng.standard_normal(shape).astype(np.float32)
    out["model.vision_embed_tokens.glb_GN"] = np.zeros((1, 1, 4 * w), np.float32)
    out["model.vision_embed_tokens.sub_GN"] = np.zeros((1, 1, 1, 4 * w), np.float32)
    return out


def phi3v_caption_profile(cap, seed: int):
    """One caption batch of the Phi-3-V captioner (batch_size seeded 64x64
    crops, the caption grid's size), its prefill apart from the whole
    greedy decode: three walls of each, then one more call of each under
    torch.profiler (device time, kernel launches, idle share).  A decode
    step is the difference over max_new - 1 steps; its bound is the bytes
    it must read (the decoder's weights and the LM head, once a step) at
    3.35 TB/s."""
    from omniparser_tpu_torch.models.phi3v import phi3v_generate

    dev, n = cap.device, cap.max_new_tokens
    g = torch.Generator(device=dev).manual_seed(seed)
    crops = torch.rand((cap.batch_size, 64, 64, 3), generator=g, device=dev) * 255
    pre, suf = (torch.from_numpy(a).to(dev) for a in (cap.prefix_ids, cap.suffix_ids))

    @torch.no_grad()
    def prefill():  # phi3v_generate's first token
        h, _, _ = cap.model.prefill(cap.preprocess(crops), pre, suf, n)
        return cap.model.logits(h[:, -1]).argmax(-1)

    def generate():
        return phi3v_generate(cap.model, cap.preprocess(crops), pre, suf, n)

    prof = {}
    for name, fn in (("prefill", prefill), ("generate", generate)):
        fn()
        walls = [sync_wall(fn)[1] for _ in range(3)]
        prof[name] = profile_pass(lambda: sync_wall(fn)[1], walls)
    p, gen, steps = prof["prefill"], prof["generate"], n - 1
    step_wall = (float(np.median(gen["wall_ms"])) - float(np.median(p["wall_ms"]))) / steps
    step_bytes = sum(t.numel() * t.element_size() for k, t in cap.model.state_dict().items()
                     if not k.startswith(("vision.", "proj_", "embed_tokens")))
    step = {"wall_ms": round(step_wall, 3), "bytes_read": step_bytes,
            "bound_ms": round(step_bytes / 3.35e12 * 1e3, 3), "bound_by": "bytes"}
    if isinstance(gen["device_idle_share"], float) and isinstance(p["device_idle_share"], float):
        step_dev = (gen["device_ms"] - p["device_ms"]) / steps
        step.update(device_ms=round(step_dev, 3),
                    kernel_launches=round((gen["kernel_launches"] - p["kernel_launches"]) / steps,
                                          1),
                    device_idle_share=round(1.0 - step_dev / step_wall, 4))
    return {"batch": cap.batch_size, "new_tokens": n, "prompt_positions": int(
        cap.prefix_ids.size + (cap.dims.image_size // cap.dims.patch_size // 2) ** 2
        + cap.suffix_ids.size), "prefill": p, "generate": gen, "decode_step": step}


def family_phi3v(seed: int, pipe, image, launches_by_path):
    """Phi-3-V (phi-3-vision-128k-instruct widths and depth) seeded on the
    card through build_phi3v (get_caption_model_processor('phi3_v'), 25
    greedy tokens in batches of 5): get_som_labeled_img with OCR boxes made
    from the detector's icons, so that icons are captioned; two calls
    equal; K3's caption grid against its plain version; a reduced Phi-3-V
    (full widths, 2+2 layers run) written as an HF directory in two shards
    and read back through get_caption_model_processor('phi3_v', path) and
    Omniparser(dict)."""
    import os

    from omniparser_tpu_torch import compat
    from omniparser_tpu_torch.models.phi3v import PHI3V_BASE, build_phi3v
    from omniparser_tpu_torch.ocr import NullOCR
    from omniparser_tpu_torch.ops import hopper_crop
    from omniparser_tpu_torch.pipeline import Omniparser
    from omniparser_tpu_torch.weights.safetensors import write_safetensors

    dev = pipe.device
    gc.collect()  # an earlier family's captioner may sit in a reference cycle
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cap, build_ms = sync_wall(lambda: compat.get_caption_model_processor("phi3_v", device=dev))
    resident = torch.cuda.memory_allocated() - before
    n_params = sum(p.numel() for p in cap.model.parameters())
    caption_ms = []
    caption_crops = cap.caption_crops

    def timed_caption_crops(crops, valid):
        out, ms = sync_wall(lambda: caption_crops(crops, valid))
        caption_ms.append(round(ms, 2))
        return out

    cap.caption_crops = timed_caption_crops
    model = (pipe.detector, pipe.det_module)
    icons, _, _ = compat.predict_yolo(model, image, 0.05, device=dev,
                                      iou_threshold=pipe.config.detector.nms_iou_threshold)
    made_boxes, made_texts = provided_ocr_boxes(icons, *image.shape[:2])

    def call():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return compat.get_som_labeled_img(image, model, BOX_TRESHOLD=0.05,
                                              ocr_bbox=made_boxes, ocr_text=made_texts,
                                              caption_model_processor=cap, device=dev)[2]

    with recording(hopper_crop, "crop_resize") as crops:
        elements_a = call()  # also the warm-up
    check_crop_calls("phi3v_caption_grid", crops)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    calls_before = cap.generate_calls
    elements_b, ms = sync_wall(call)
    counts = all_counts()
    peak = torch.cuda.max_memory_allocated()
    path_counts("phi3v_get_som_labeled_img", counts, launches_by_path)
    cached = [p for p in compat._PIPELINE_CACHE.values() if p.captioner is cap]
    c = dict(cached[0].last_counts)
    captions = [e["content"] for e in elements_b if e["source"] == "box_yolo_content_yolo"]
    emit("families", family="phi3v", path="get_som_labeled_img, phi-3-vision-128k-instruct "
         f"dims, greedy, batches of {cap.batch_size}, {cap.max_new_tokens} new tokens",
         params=n_params, build_ms=round(build_ms, 1), resident_bytes=resident,
         max_memory_allocated=peak, get_som_labeled_img_ms=round(ms, 2),
         caption_ms=caption_ms, generate_calls=cap.generate_calls - calls_before,
         caption_ms_per_generated_token=round(
             caption_ms[-1] / max(1, (cap.generate_calls - calls_before) * cap.max_new_tokens), 3),
         counts=c, icons_captioned=len(captions), sample=captions[:3], launches=counts,
         ocr_absorbed=c["ocr_absorbed"], icons_inside_ocr=c["icons_inside_ocr"])
    if not any(isinstance(t, str) and t.strip() for t in captions):
        fail("families: Phi-3-V captioned no icon")
    if elements_a != elements_b:
        fail("families: two Phi-3-V get_som_labeled_img calls gave different captions")
    want = {"nms_keep": 1, "merge_masks": 1, "crop_resize": 1, "overlap_matrices": 0}
    if any(counts[k] != v for k, v in want.items()):
        fail(f"families: the Phi-3-V call launched {counts}, want {want}")
    emit("families", family="phi3v", caption_profile=phi3v_caption_profile(cap, seed))
    compat._PIPELINE_CACHE.clear()
    del cap, cached
    gc.collect()
    torch.cuda.empty_cache()

    # an HF-spelled directory in two shards from a reduced Phi-3-V (full widths)
    red = dataclasses.replace(PHI3V_BASE, vision_layers=3, lm_layers=2)
    small = build_phi3v(red, None, torch.float32, dev, seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phi3v_") as tmp:
        sd = hf_phi3v_state_dict(small.state_dict(), red, np.random.default_rng(seed))
        keys = sorted(sd)

        def write():
            for i, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
                write_safetensors(os.path.join(tmp, f"model-0000{i + 1}-of-00002.safetensors"),
                                  {k: sd[k] for k in part})

        _, write_ms = sync_wall(write)
        nbytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        loaded, load_ms = sync_wall(
            lambda: compat.get_caption_model_processor("phi3_v", tmp, device=dev))
        omni, omni_ms = sync_wall(lambda: Omniparser(
            {"caption_model_name": "phi3_v", "caption_model_path": tmp}, device=dev,
            ocr=NullOCR()))
    want_state = small.state_dict()
    bad = {name: state_mismatches(got.model.state_dict(), want_state)
           for name, got in (("get_caption_model_processor", loaded),
                             ("Omniparser(dict)", omni.pipeline.captioner))}
    emit("families", family="phi3v", hf_dir={"dims": "phi-3-vision widths, 3 tower layers "
                                                     "(2 run) + 2 decoder layers",
                                             "shards": 2, "bytes": nbytes,
                                             "write_ms": round(write_ms, 1),
                                             "get_caption_model_processor_ms": round(load_ms, 1),
                                             "omniparser_dict_ms": round(omni_ms, 1)},
         loaded_dims_equal=loaded.dims == red, state_equal={k: not v for k, v in bad.items()},
         differing_keys={k: v[:8] for k, v in bad.items()})
    if loaded.dims != red or any(bad.values()):
        fail(f"families: the Phi-3-V directory loaded back differently: {bad}")
    del small, loaded, omni, sd
    torch.cuda.empty_cache()


def phase_families(seed: int, pipe, image, launches_by_path):
    """The reference's other model families at full width, seeded: each
    path's counters at 0 just before it and read just after."""
    family_yolov9(seed, pipe, image, launches_by_path)
    family_easyocr(seed, pipe, image, launches_by_path)
    family_blip2(seed, pipe, image, launches_by_path)
    family_phi3v(seed, pipe, image, launches_by_path)


def parity_families(seed: int, dev: str = "cuda"):
    """The families on the card (`dev`) against the CPU in float32 (TF32
    off, set by the caller), same weights and inputs: a 'dualtest' GELAN's
    detect_graph, the easyocr arch at a reduced size, TINY_BLIP2's beam
    search (tokens equal)."""
    from omniparser_tpu_torch import compat
    from omniparser_tpu_torch.config import OcrConfig
    from omniparser_tpu_torch.models.blip2 import TINY_BLIP2, blip2_generate, build_blip2
    from omniparser_tpu_torch.models.ocr import TorchOCR
    from omniparser_tpu_torch.models.yolov9 import YOLOv9Detector
    from omniparser_tpu_torch.ops.preprocess import pad_to_bucket, pick_bucket_2d
    from omniparser_tpu_torch.weights.init import build_module

    image = synthetic_screenshot(np.random.default_rng(seed + 1))[:540, :960].copy()
    h, w = image.shape[:2]
    padded = pad_to_bucket(image, *pick_bucket_2d(h, w))[0]

    det = YOLOv9Detector(variant="dualtest", num_classes=2, imgsz=640, max_det=128,
                         prefilter=1024)
    cpu_m = build_module(det.make_module(), None, torch.Generator().manual_seed(seed),
                         torch.float32, "cpu")
    gpu_m = build_module(det.make_module(), cpu_m.state_dict(), None, torch.float32, dev)
    # seeded scores crowd near 0.5: a threshold with about 600 candidates
    # above it (the window holds them all) keeps the sort's near-ties few
    raw = det.detect_graph(cpu_m, torch.from_numpy(padded), (h, w), 0.05, 0.5,
                           with_raw=True)[-1][1]
    thr = float(torch.sort(raw, descending=True).values[min(600, raw.numel() - 1)])
    out = {}
    for name, m in (("cpu", cpu_m), ("cuda", gpu_m)):
        r = det.detect_graph(m, torch.from_numpy(padded).to(next(m.parameters()).device),
                             (h, w), thr, 0.5, with_stats=True)
        out[name] = [t.cpu() for t in r]
    (bc, sc, vc, oc), (bg, sg, vg, og) = out["cpu"], out["cuda"]
    both = vc & vg
    slots = int((vc != vg).sum())
    diff = {"det_boxes": float((bc - bg)[both].abs().max()) if both.any() else 0.0,
            "det_scores": float((sc - sg)[both].abs().max()) if both.any() else 0.0}
    emit("parity_on_card", check="'dualtest' GELAN detect_graph, CPU against card, float32",
         box_threshold=thr, kept={"cpu": int(vc.sum()), "cuda": int(vg.sum())},
         differing_slots=slots,
         overflow={"cpu": int(oc), "cuda": int(og)}, max_abs_diff=diff)
    if slots > PARITY_MAX_SLOTS or not vc.any():
        fail(f"parity_on_card: the GELAN keep set differs in {slots} slots")
    for k, v in diff.items():
        if not v <= PARITY_ATOL[k]:
            fail(f"parity_on_card: GELAN {k} differs by {v}")

    ocfg = OcrConfig(arch="easyocr", det_imgsz=640, rec_height=64, dtype="float32",
                     text_threshold=0.0)
    cpu_ocr = TorchOCR(ocfg, "cpu", generator=torch.Generator().manual_seed(seed + 5))
    calibrate_craft_head(cpu_ocr, image)
    gpu_ocr = TorchOCR(ocfg, dev, cpu_ocr.det.state_dict(), cpu_ocr.rec.state_dict())
    got = {}
    for name, o in (("cpu", cpu_ocr), ("cuda", gpu_ocr)):
        (texts, boxes), _ = compat.check_ocr_box(image, output_bb_format="xyxy", backend=o,
                                                 device=o.device)
        got[name] = (texts, [list(b) for b in boxes])
    (tc, bc_), (tg, bg_) = got["cpu"], got["cuda"]
    box_slots = len(set(map(tuple, bc_)) ^ set(map(tuple, bg_)))
    text_slots = sum(a != b for a, b in zip(tc, tg)) + abs(len(tc) - len(tg))
    emit("parity_on_card", check="easyocr arch check_ocr_box (CRAFT @640, 64x480 lines), "
         "CPU against card, float32", boxes={"cpu": len(bc_), "cuda": len(bg_)},
         differing_boxes=box_slots, differing_texts=text_slots, sample=tg[:3])
    if not bc_ or box_slots > PARITY_MAX_SLOTS or text_slots > PARITY_MAX_SLOTS:
        fail(f"parity_on_card: easyocr boxes differ in {box_slots}, texts in {text_slots}")

    cpu_b = build_blip2(TINY_BLIP2, None, torch.float32, "cpu", seed)
    gpu_b = build_blip2(TINY_BLIP2, cpu_b.state_dict(), torch.float32, dev)
    rng = np.random.default_rng(seed + 9)
    px = torch.from_numpy(rng.random((4, 3, 28, 28), np.float32))
    prompt = torch.tensor([[2, 40, 41, 42]] * 4)
    toks = {}
    launches = all_counts()["beam_attention"]
    for name, d in (("cpu", "cpu"), ("cuda", dev)):
        m = cpu_b if name == "cpu" else gpu_b
        toks[name] = blip2_generate(m, px.to(d), prompt.to(d), 12, 5)[0].cpu()
    launches = all_counts()["beam_attention"] - launches
    same = bool(torch.equal(toks["cpu"], toks["cuda"]))
    emit("parity_on_card", check="TINY_BLIP2 blip2_generate, 5 beams, 12 tokens, CPU against "
         "card, float32", tokens_equal=same, tokens=toks["cuda"].tolist(),
         beam_attention_launches=launches)
    if not same:
        fail("parity_on_card: TINY_BLIP2 beam search gave other tokens on the card")
    if dev != "cpu" and launches != 11 * TINY_BLIP2.lm_layers:
        fail(f"parity_on_card: the card's decode launched beam_attention {launches} times")


def parity_phi3v(seed: int, cpu, cfg, image, dev: str = "cuda"):
    """Phi-3-V on the card (`dev`) against the CPU in float32 (TF32 off,
    set by the caller), same weights and inputs: TINY_PHI3V's greedy
    tokens, then a reduced-width SOMPipeline(backend='phi3v') parse_image
    (the parity pipeline's detector and OCR): every element equal, boxes
    to PARITY_ATOL['det_boxes'], captions and OCR texts equal."""
    from omniparser_tpu_torch.config import CaptionerConfig, OcrConfig
    from omniparser_tpu_torch.models.phi3v import TINY_PHI3V, build_phi3v, phi3v_generate
    from omniparser_tpu_torch.pipeline import SOMPipeline

    cpu_m = build_phi3v(TINY_PHI3V, None, torch.float32, "cpu", seed)
    gpu_m = build_phi3v(TINY_PHI3V, cpu_m.state_dict(), torch.float32, dev)
    rng = np.random.default_rng(seed + 11)
    px = torch.from_numpy(rng.standard_normal((5, 3, 28, 28)).astype(np.float32))
    pre, suf = torch.tensor([70, 38, 31]), torch.tensor([20, 14, 15, 42, 30])
    toks = {name: phi3v_generate(m, px.to(d), pre.to(d), suf.to(d), 25).cpu()
            for name, m, d in (("cpu", cpu_m, "cpu"), ("cuda", gpu_m, dev))}
    same = bool(torch.equal(toks["cpu"], toks["cuda"]))
    emit("parity_on_card", check="TINY_PHI3V phi3v_generate, 5 crops, 25 greedy tokens, CPU "
         "against card, float32", tokens_equal=same, tokens=toks["cuda"].tolist())
    if not same:
        fail("parity_on_card: TINY_PHI3V greedy tokens differ on the card")

    dims = dataclasses.replace(TINY_PHI3V, image_size=56, vision_width=64, vision_heads=4,
                               vision_mlp=128, vision_layers=3, lm_width=128, lm_heads=4,
                               lm_mlp=256)
    pcfg = dataclasses.replace(
        cfg, captioner=CaptionerConfig(backend="phi3v", dtype="float32", max_new_tokens=10),
        ocr=dataclasses.replace(cfg.ocr, text_threshold=OcrConfig().text_threshold))
    states = dict(detector_state=cpu.det_module.state_dict(),
                  ocr_states=(cpu.ocr.det.state_dict(), cpu.ocr.rec.state_dict()),
                  captioner_dims=dims)
    cpu_p = SOMPipeline(pcfg, "cpu", seed=seed, **states)
    gpu_p = SOMPipeline(pcfg, dev, captioner_state=cpu_p.captioner.model.state_dict(), **states)
    runs = {}
    for name, p in (("cpu", cpu_p), ("cuda", gpu_p)):
        reset_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runs[name] = p.parse_image(image)[2]
        runs[name + "_launches"] = all_counts()
    bad, flips = same_elements(runs["cuda"], runs["cpu"], PARITY_ATOL["det_boxes"])
    captioned = sum(e["source"] == "box_yolo_content_yolo" for e in runs["cpu"])
    emit("parity_on_card", check="SOMPipeline(backend='phi3v') parse_image, reduced widths "
         "(tower 64 wide at 56 px, decoder 128 wide), CPU against card, float32",
         elements=len(runs["cpu"]), captioned=captioned, differs=bad,
         caption_texts_differing=flips, generate_calls=gpu_p.captioner.generate_calls,
         launches=runs["cuda_launches"], sample=[e["content"] for e in runs["cuda"]][:4])
    if bad or flips:
        fail(f"parity_on_card: the Phi-3-V parse differs between CPU and card: {bad}, "
             f"{flips} captions")
    if not captioned:
        fail("parity_on_card: the Phi-3-V parse captioned no icon")


def eval_rows(image, elements, n: int = 4):
    """ScreenSpot rows over one screenshot and a MockLLM's answers: the
    first n parsed elements as targets, each answered with its own id, and
    one target answered with an id the parse does not have (wrong)."""
    rows = [{"img_path": image, "instruction": f"click element {i}", "gt_bbox": list(e["bbox"]),
             "group": e["type"]} for i, e in enumerate(elements[:n])]
    rows.append({"img_path": image, "instruction": "click past the last element",
                 "gt_bbox": [0.0, 0.0, 1.0, 1.0], "group": "none"})
    return rows, [f"Click BBox ID: {i}" for i in range(len(rows) - 1)] + [
        f"Click BBox ID: {len(elements)}"]


def run_eval_records(pipe, image, elements):
    """screenspot.run_eval of eval_rows through `pipe` -> (scores, the
    logged records)."""
    import os

    from omniparser_tpu_torch.eval.llm import MockLLM
    from omniparser_tpu_torch.eval.screenspot import ScreenSpotModel, run_eval

    rows, answers = eval_rows(image, elements)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        log = os.path.join(tmp, "log.jsonl")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            scores = run_eval(ScreenSpotModel(pipe, MockLLM(answers)), rows, log_path=log)
        with open(log) as f:
            return scores, [json.loads(line) for line in f]


def parity_eval(cpu, gpu, image):
    """screenspot.run_eval with a MockLLM over the parity screenshot on the
    CPU and on the card (float32, TF32 off): the same scores, and row for
    row the same correctness and predicted point (to PARITY_ATOL['det_boxes'])."""
    _, _, elements = cpu.parse_image(image)
    out = {name: run_eval_records(p, image, elements) for name, p in (("cpu", cpu),
                                                                      ("cuda", gpu))}
    (s_cpu, r_cpu), (s_gpu, r_gpu) = out["cpu"], out["cuda"]
    diff = max((max(abs(a - b) for a, b in zip(x["pred"], y["pred"]))
                for x, y in zip(r_cpu, r_gpu) if x["pred"] and y["pred"]), default=0.0)
    same = (s_cpu == s_gpu and [r["correctness"] for r in r_cpu] == [r["correctness"] for r in r_gpu]
            and [r["pred"] is None for r in r_cpu] == [r["pred"] is None for r in r_gpu])
    emit("parity_on_card", check="screenspot.run_eval with a MockLLM, CPU against card, "
         "float32", rows=len(r_cpu), scores=s_gpu, same=same, pred_max_abs_diff=diff)
    if not same or not diff <= PARITY_ATOL["det_boxes"]:
        fail(f"parity_on_card: run_eval differs between CPU and card: {s_cpu} / {s_gpu}, {diff}")


def phase_eval(pipe, image, launches_by_path):
    """The eval harnesses on the card: screenspot.run_eval (a MockLLM, rows
    made from the parse's own elements) through the parse's pipeline.  The
    card's machine has no TTF face (no /usr/share/fonts, no matplotlib), so
    eval/synth_bench's scenes cannot be rendered there; this phase runs the
    same loop (parse, pseudo-HTML prompt, Click BBox ID, centroid scoring)
    over phase parse's screenshot instead."""
    from omniparser_tpu_torch.eval.screenspot import reformat_messages

    _, _, elements = pipe.parse_image(image)
    reset_counts()
    (scores, records), ms = sync_wall(lambda: run_eval_records(pipe, image, elements))
    counts = all_counts()
    path_counts("eval_run_eval", counts, launches_by_path)
    n = len(records)
    want = (n - 1) / n
    emit("eval", path="screenspot.run_eval, MockLLM, rows from phase parse's screenshot, "
         "one parse a row", rows=n, scores=scores, wall_ms=round(ms, 2),
         wall_ms_per_row=round(ms / n, 2), launches=counts,
         launches_per_row={k: v / n for k, v in counts.items()},
         prompt_lines=len(reformat_messages(elements).splitlines()),
         note="the scores are fixed by the rows (each target answered with its own id but "
              "the last); they measure the loop, not the parse, on seeded weights")
    if scores["overall"] != want or [r["correctness"] for r in records][-1] != "wrong":
        fail(f"eval: run_eval scored {scores['overall']}, want {want}")
    if counts["nms_keep"] != n or counts["merge_masks"] != n:
        fail(f"eval: {n} rows launched {counts}")


# tests/test_quant.py's bounds on the int8 logits, over the float logits' std
INT8_MAX_DELTA = 0.35
INT8_MEAN_DELTA = 0.05


def phase_int8(pipe, image, launches_by_path):
    """The int8 captioner quantized from the parse's captioner's weights."""
    from omniparser_tpu_torch.models.florence2 import FlorenceCaptioner
    from omniparser_tpu_torch.models.quant import QLinear, resident_bytes

    fp = pipe.captioner
    t0 = time.perf_counter()
    state = {k: v.float().cpu() for k, v in fp.model.state_dict().items()}
    q8 = FlorenceCaptioner(dataclasses.replace(fp.config, quant="int8"), fp.dims, state,
                           device=pipe.device)
    del state
    build_s = time.perf_counter() - t0
    lm = q8.model.language_model
    projs = [m for i in range(fp.dims.decoder_layers)
             for layer in [getattr(lm, f"decoder_layer{i}")]
             for m in (layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj,
                       layer.self_attn.out_proj, layer.encoder_attn.q_proj,
                       layer.encoder_attn.k_proj, layer.encoder_attn.v_proj,
                       layer.encoder_attn.out_proj, layer.fc1, layer.fc2)]
    if not all(isinstance(m, QLinear) and m.weight.dtype == torch.int8 for m in projs):
        fail("int8: a decoder projection is not int8")
    if lm.lm_head_kernel.dtype != torch.int8 or hasattr(lm, "shared"):
        fail("int8: the LM head is not int8, or the float shared table is still there")

    # the parse's own caption crops
    ctx = pipe._stage_upload(image)
    ctx["ocr_fut"] = pipe.ocr.dispatch_det(ctx["padded_dev"], (ctx["uh"], ctx["uw"]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        crops = pipe._stage_dispatch(ctx, None, None)
    pipe._download(ctx)
    need = int(ctx["out"]["cap_valid"].sum())
    crops = crops[:max(need, 1)]
    start = torch.full((crops.shape[0], 1), fp.dims.decoder_start_token_id, dtype=torch.int64,
                       device=crops.device)

    def first_step(cap):
        prompt = torch.from_numpy(np.tile(cap.prompt_ids[None], (crops.shape[0], 1)))
        prompt = prompt.to(crops.device)
        with torch.no_grad():
            return cap.model(cap.preprocess(crops), prompt, start)[:, -1].float()

    ref, got = first_step(fp), first_step(q8)
    std = float(ref.std()) + 1e-6
    d_max, d_mean = float((got - ref).abs().max()) / std, float((got - ref).abs().mean()) / std
    argmax_same = float((got.argmax(-1) == ref.argmax(-1)).float().mean())

    kb = fp.config.batch_size
    slots = crops[torch.arange(kb, device=crops.device) % crops.shape[0]]

    def decode_ms(cap):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cap.generate(slots)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    # the shipped int8 product (16-bit on the tensor cores, float32 out)
    # against the float32 GEMM of the converted operands, in turns
    from omniparser_tpu_torch.models import quant as quant_ops

    shipped = quant_ops.product_f32

    def gemm_f32(x, w):
        return torch.matmul(x.float(), w.float().t())

    xs = torch.randn((kb, fp.dims.d_model), generator=torch.Generator().manual_seed(5))
    xs = xs.to(crops.device, fp.model.language_model._dtype())
    ws = lm.decoder_layer0.fc1.weight.to(xs.dtype)
    product_err = float((shipped(xs, ws) - gemm_f32(xs, ws)).abs().max())
    product_scale = float(gemm_f32(xs, ws).abs().max())
    runs = (("fp", fp, shipped), ("int8", q8, shipped), ("int8_float32_gemm", q8, gemm_f32))
    decode = {name: [] for name, _, _ in runs}
    decode_profile = {}
    try:
        for i in range(6):  # the first round is a warm-up
            for name, cap, form in runs:
                quant_ops.product_f32 = form
                ms = decode_ms(cap)
                if i:
                    decode[name].append(round(ms, 2))
        for name, cap, form in runs:
            quant_ops.product_f32 = form
            prof = profile_pass(lambda c=cap: decode_ms(c), decode[name])
            decode_profile[name] = {k: prof[k] for k in (
                "device_ms", "kernel_launches", "device_idle_share")}
            decode_profile[name]["top"] = prof["top"][:4]
    finally:
        quant_ops.product_f32 = shipped

    pipe.captioner = pipe._florence = q8
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            reset_counts()
            _, elements = pipe.parse_elements(image)
            torch.cuda.synchronize()
            counts = all_counts()
        kb_run = pipe.last_counts["kb"]
    finally:
        pipe.captioner = pipe._florence = fp
    path_counts("int8", counts, launches_by_path)
    captioned = [e for e in elements if e["source"] == "box_yolo_content_yolo"]
    emit("int8", build_seconds=round(build_s, 2), crops=int(crops.shape[0]),
         first_step_logits={"max_abs_delta_over_std": d_max, "mean_abs_delta_over_std": d_mean,
                            "bounds": [INT8_MAX_DELTA, INT8_MEAN_DELTA],
                            "argmax_agreement": argmax_same},
         resident_bytes={"fp": resident_bytes(fp.model), "int8": resident_bytes(q8.model),
                         "fp_dtype": fp.config.dtype},
         decode_ms_at_kb=dict(kb=kb, **decode), decode_profile=decode_profile,
         int8_product={"form": "torch.mm(bf16, bf16, out_dtype=float32)" if xs.dtype ==
                       torch.bfloat16 else str(xs.dtype), "max_abs_diff_to_float32_gemm":
                       product_err, "max_abs_value": product_scale},
         parse_elements={"elements": len(elements), "kb": kb_run, "captioned": len(captioned),
                         "sample": captioned[:2]},
         launches=counts)
    if not (d_max < INT8_MAX_DELTA and d_mean < INT8_MEAN_DELTA):
        fail(f"int8: first-step logits off the float ones by max {d_max:.4f}, mean "
             f"{d_mean:.4f} of their std (bounds {INT8_MAX_DELTA}, {INT8_MEAN_DELTA})")
    if not product_err <= 1e-4 * product_scale:  # the same exact products, summed in another order
        fail(f"int8: the card's product differs from the float32 GEMM by {product_err} "
             f"(values up to {product_scale})")
    if kb_run < 1 or not captioned or any(e["content"] is None for e in captioned):
        fail("int8: the parse with the int8 captioner did not decode")
    del q8
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ #
# phase train: the trainers at their CLI widths, on seeded arrays
# ------------------------------------------------------------------ #

TRAIN_STEPS = 20
TRAIN_PROFILED_STEP = 15  # one step under torch.profiler, out of the medians
TRAIN_IMGSZ = 640  # the icon detector trainer's IMGSZ, and the joint step's


class StepRecorder:
    """A trainer's ``on_step``: synchronises after every step and keeps its
    loss and end time; profiles step TRAIN_PROFILED_STEP alone."""

    def __init__(self):
        torch.cuda.synchronize()
        self.t = [time.perf_counter()]
        self.losses = []
        self.prof = None
        self.profiled = None

    def __call__(self, step: int, loss) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        now = time.perf_counter()
        self.losses.append(float(loss))
        self.t.append(now)
        if step == TRAIN_PROFILED_STEP - 1:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.t_prof = time.perf_counter()
        elif step == TRAIN_PROFILED_STEP and self.prof is not None:
            self.prof.stop()
            rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                           for e in self.prof.key_averages()
                           if str(e.device_type).endswith("CUDA")
                           and e.self_device_time_total > 0), key=lambda r: -r[2])
            self.profiled = {"wall_ms": round((now - self.t_prof) * 1e3, 3),
                             "device_ms": round(sum(r[2] for r in rows), 3),
                             "kernel_launches": int(sum(r[1] for r in rows)),
                             "top": [{"name": r[0][:80], "count": r[1], "ms": round(r[2], 3)}
                                     for r in rows[:8]]}
            self.prof = None
            self.t[-1] = time.perf_counter()  # the next step starts after the read

    def summary(self, per_step: int, unit: str):
        walls = [(b - a) * 1e3 for a, b in zip(self.t, self.t[1:])]
        steady = [w for i, w in enumerate(walls) if i >= 3 and i != TRAIN_PROFILED_STEP]
        med = float(np.median(steady))
        prof = dict(self.profiled or {})
        if prof.get("kernel_launches"):
            prof["device_idle_share"] = round(1.0 - prof["device_ms"] / med, 4)
        else:
            prof["device_idle_share"] = "not measured: the profiler gave no device time"
        return {"losses": [round(v, 5) for v in self.losses],
                "step_wall_ms": [round(w, 3) for w in walls],
                "step_wall_ms_median": round(med, 3), "profiled_step": prof,
                f"{unit}_per_s": round(per_step / med * 1e3, 2)}


def check_falls(item: str, losses) -> None:
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        fail(f"train: {item} gave {len(losses)} losses, finite: {bool(np.isfinite(losses).all())}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        fail(f"train: {item}'s loss did not fall: first-5 mean {first}, last-5 mean {last}")


def train_item(item: str, run, per_step: int, unit: str, **fields):
    """Run one trainer with a StepRecorder: its readings with the peak
    device bytes; fails unless the loss is finite and falls."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = StepRecorder()
    out = run(rec)
    torch.cuda.synchronize()
    emit("train", item=item, **fields, **rec.summary(per_step, unit),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    check_falls(item, rec.losses)
    return out


def seeded_det_data(rng, n: int, size: int = 640, max_gt: int = 64):
    """Filled rectangles on a light noisy background: (images u8, boxes
    normalised xyxy, mask), the icon detector trainer's arrays."""
    images = np.clip(rng.normal(225, 12, (n, size, size, 3)), 0, 255).astype(np.uint8)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    mask = np.zeros((n, max_gt), bool)
    for i in range(n):
        for j in range(int(rng.integers(8, 40))):
            w, h = (int(v) for v in rng.integers(14, 90, 2))
            x, y = int(rng.integers(0, size - w)), int(rng.integers(0, size - h))
            images[i, y:y + h, x:x + w] = rng.integers(0, 160, 3)
            boxes[i, j] = np.asarray([x, y, x + w, y + h], np.float32) / size
            mask[i, j] = True
    return images, boxes, mask


def seeded_text_data(rng, n: int, size: int = 640):
    """Dark bars (text lines) on light screens and their shrink maps: the
    text detector trainer's arrays."""
    from omniparser_tpu_torch.train.synth_text import shrink_map

    screens = np.full((n, size, size, 3), 240, np.uint8)
    maps = np.zeros((n, size // 2, size // 2), np.uint8)
    for i in range(n):
        boxes = []
        for _ in range(int(rng.integers(10, 30))):
            w, h = int(rng.integers(30, 300)), int(rng.integers(8, 28))
            x, y = int(rng.integers(0, size - w)), int(rng.integers(0, size - h))
            screens[i, y:y + h, x:x + w] = rng.integers(0, 90)
            boxes.append([x, y, x + w, y + h])
        maps[i] = shrink_map(boxes, size)
    return screens, maps


def seeded_line_buffers(rng, n: int, max_label: int, buf_hw=(64, 1536)):
    """64x1536 line buffers, each with a natural-size 'render' top-left (a
    light field with one dark bar a character), and labels of 1..56 ids:
    the recogniser's data before the crop."""
    from omniparser_tpu_torch.models.ocr import NUM_CLASSES

    bh, bw = buf_hw
    bufs = np.zeros((n, bh, bw, 3), np.uint8)
    hws = np.zeros((n, 2), np.int32)
    labels = np.zeros((n, max_label), np.int32)
    for i in range(n):
        k = int(rng.integers(1, max_label + 1))
        h, cw = int(rng.integers(16, bh + 1)), int(rng.integers(6, 24))
        w = min(bw, k * cw + 8)
        bufs[i, :h, :w] = 235
        for j in range(k):
            x = 4 + j * cw
            bufs[i, h // 4: 3 * h // 4, x: min(x + cw // 2, w)] = 20 + 3 * (j % 20)
        hws[i] = (h, w)
        labels[i, :k] = rng.integers(1, NUM_CLASSES, k)
    return bufs, hws, labels


def seeded_icon_tiles(rng, n: int, kinds: int, tile: int = 96):
    """96x96 tiles with one glyph block of a kind's colour and inner cut at
    a jittered place: (tiles u8, normalised boxes with +-10% jitter, kind
    ids)."""
    palette = rng.integers(0, 256, (kinds, 3))
    tiles = np.zeros((n, tile, tile, 3), np.uint8)
    boxes = np.zeros((n, 4), np.float32)
    ids = rng.integers(0, kinds, n).astype(np.int32)
    for i in range(n):
        tiles[i] = rng.integers(180, 256)
        s = int(rng.integers(24, 60))
        x, y = (int(v) for v in rng.integers(4, tile - s - 4, 2))
        tiles[i, y:y + s, x:x + s] = palette[ids[i]]
        c = s // (2 + int(ids[i]) % 4)
        tiles[i, y + c:y + s - c, x + c:x + s - c] = 255 - palette[ids[i]]
        boxes[i] = np.clip(np.asarray([x, y, x + s, y + s]) + rng.uniform(-0.1, 0.1, 4) * s,
                           0, tile) / tile
    return tiles, boxes, ids


def check_data_crops(case: str, images, hws, boxes, out_hw, grid: str, dev="cuda") -> float:
    """K3 on the first 16 data-path crops (after the path's counts were
    read) against crop_resize_plain on the CPU, within 1e-2.  (Not against
    the plain version on the card: PyTorch divides a CUDA tensor by a
    Python scalar as a product with its reciprocal, one ulp from K3's and
    the CPU's IEEE quotient; ROADMAP C.22.)"""
    from omniparser_tpu_torch.ops import hopper_crop

    err = 0.0
    for i in range(16):
        im = torch.from_numpy(np.ascontiguousarray(images[i]))
        bx = torch.from_numpy(np.ascontiguousarray(boxes[i:i + 1], np.float32))
        hw = (int(hws[i][0]), int(hws[i][1]))
        got = hopper_crop.crop_resize(im.to(dev), hw, bx.to(dev), out_hw, grid=grid).cpu()
        want = hopper_crop.crop_resize_plain(im, hw, bx, out_hw, grid=grid)
        err = max(err, float((got - want).abs().max()))
    emit("train", kernel="crop_resize", case=case, crops=16,
         out_hw=[out_hw] * 2 if isinstance(out_hw, int) else list(out_hw), grid=grid,
         max_abs_diff_to_cpu_plain=err, atol=1e-2)
    if not err <= 1e-2:
        fail(f"train: crop_resize disagrees with its plain version on {case}: {err}")
    return err


def data_path(item: str, call, want_launches: int, launches_by_path, **fields):
    """A data path's crops with the counters at 0 just before and read just
    after: crop_resize must be launched once an input."""
    reset_counts()
    out, ms = sync_wall(call)
    counts = all_counts()
    launches_by_path[item] = counts
    emit("train", item=item, **fields, launches=counts, wall_ms=round(ms, 2))
    if counts["crop_resize"] != want_launches:
        fail(f"train: {item} launched crop_resize {counts['crop_resize']} times for "
             f"{want_launches} inputs")
    return out


def phase_train(seed: int, image, launches_by_path, dev="cuda"):
    """The trainers at their CLI widths and batch sizes on seeded arrays
    (the card's machine has no TTF face to render their datasets), then
    the trained networks saved, loaded by SOMPipeline and run on phase
    parse's screenshot."""
    from omniparser_tpu_torch.models.florence2 import BASE, TASK_PROMPTS
    from omniparser_tpu_torch.models.tokenizer import load_tokenizer
    from omniparser_tpu_torch.train import train_captioner as ttc
    from omniparser_tpu_torch.train import train_detector as ttd
    from omniparser_tpu_torch.train import train_ocr as tto
    from omniparser_tpu_torch.train.synth_text import crops_from_buffers
    from omniparser_tpu_torch.train.train_step import (
        make_synthetic_batch, make_train_state, train_step)

    rng = np.random.default_rng(seed + 900)
    n = TRAIN_STEPS

    data = seeded_det_data(rng, 16, TRAIN_IMGSZ)
    det = train_item("train_detector", lambda r: ttd.train_detector(
        n, 8, seed, 16, device=dev, data=data, on_step=r), 8, "images",
        widths="YOLOv8-n, 1 class, 640, batch 8, clip 5 + adamw(cosine 2e-3, alpha 0.05, "
               "wd 1e-4), augmentation on, bfloat16 autocast", dataset=16)

    bufs, hws, labels = seeded_line_buffers(rng, 512, tto.MAX_LABEL)
    crops = data_path("train_rec_data",
                      lambda: crops_from_buffers(bufs, hws, tto.REC_HW, device=dev),
                      len(bufs), launches_by_path, buffers=len(bufs),
                      buffer_hw=list(bufs.shape[1:3]), crop_hw=list(tto.REC_HW))
    check_data_crops("rec_line_grid", bufs, hws, np.asarray([[0.0, 0.0, 1.0, 1.0]] * 16),
                     tto.REC_HW, "line", dev)
    rec = train_item("train_ocr_recognizer", lambda r: tto.train_recognizer(
        n, 256, seed=seed, data=(crops, labels), log_every=n, device=dev, on_step=r), 256,
        "lines",
        widths="TextRecognizer() at 32x480, batch 256, CTC over 1..56-id labels, clip 1 + "
               "adamw(warmup-cosine 1e-3), augmentation on, bfloat16 autocast",
        dataset=len(crops))

    screens, maps = seeded_text_data(rng, 16)
    tdet = train_item("train_ocr_detector", lambda r: tto.train_detector(
        n, 8, seed=seed + 100, data=(screens, maps), log_every=n, device=dev, on_step=r), 8,
        "images",
        widths="TextDetector() at 640, batch 8, BCE+dice on 320x320 maps, clip 1 + "
               "adamw(warmup-cosine 5e-4), augmentation on, bfloat16 autocast", dataset=16)

    tiles, boxes, ids = seeded_icon_tiles(rng, 256, len(ttc.CAPTIONS))
    cap_crops = data_path("train_cap_data", lambda: ttc.crop_tiles(tiles, boxes, device=dev),
                          len(tiles), launches_by_path, tiles=len(tiles), crop=ttc.CROP)
    check_data_crops("cap_resize_grid", tiles, [(ttc.TILE, ttc.TILE)] * 16, boxes,
                     ttc.CROP, "resize", dev)
    cap = train_item("train_captioner", lambda r: ttc.train_captioner(
        n, 128, seed=seed, data=(cap_crops, ids), log_every=n, device=dev, on_step=r), 128,
        "crops",
        widths="Florence2(SYNTH_CAP_DIMS), batch 128, 64x64, label smoothing 0.1, clip 1 + "
               "adamw(warmup-cosine 3e-4), augmentation on, tail average, bfloat16 autocast",
        dataset=len(cap_crops))

    prompt_len = len(load_tokenizer(None).encode(TASK_PROMPTS["<CAPTION>"]))

    def joint(r):
        gen = torch.Generator(dev).manual_seed(seed)
        st = make_train_state(imgsz=TRAIN_IMGSZ, florence_dims=BASE, learning_rate=1e-4,
                              generator=gen, device=dev)
        batch = make_synthetic_batch(gen, 8, TRAIN_IMGSZ, max_gt=8, crop=64,
                                     prompt_len=prompt_len, cap_len=20)
        for s in range(n):
            r(s, train_step(st, batch)["loss"])
        return (sum(p.numel() for p in st.det_module.parameters()),
                sum(p.numel() for p in st.florence.parameters()))

    params = train_item("train_step_joint", joint, 8, "images",
                        widths="YOLOv8-n @640 + Florence-2 BASE dims, batch 8, crops 64x64, "
                               f"prompt {prompt_len} ids, captions 20 ids, adamw 1e-4, "
                               "bfloat16 autocast, one fixed batch")
    emit("train", item="train_step_joint", parameters={"detector": params[0],
                                                       "florence": params[1]})
    gc.collect()
    torch.cuda.empty_cache()
    train_roundtrip(det, tdet, rec, cap, image, launches_by_path, dev)


def train_roundtrip(det, tdet, rec, cap, image, launches_by_path, dev="cuda"):
    """The phase's trained networks saved through weights/checkpoints.py,
    read back bit-equal, loaded through SOMPipeline's weight fields
    (bit-equal to what was saved, in the pipeline's dtype), then one
    parse_image of phase parse's screenshot: nms_keep 1, merge_masks 1,
    crop_resize 2."""
    import os

    from omniparser_tpu_torch.config import PipelineConfig
    from omniparser_tpu_torch.pipeline import SOMPipeline
    from omniparser_tpu_torch.train.train_captioner import SYNTH_CAP_DIMS
    from omniparser_tpu_torch.weights.checkpoints import load_checkpoint, save_checkpoint
    from omniparser_tpu_torch.weights.convert import unconvert_state

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        p_det = save_checkpoint(f"{tmp}/det_synth", {"det": det})
        p_ocr = save_checkpoint(f"{tmp}/ocr_en_synth", {"det": tdet, "rec": rec})
        p_cap = save_checkpoint(f"{tmp}/cap_synth", {"cap": cap}, dims=SYNTH_CAP_DIMS)
        save_ms = (time.perf_counter() - t0) * 1e3
        for path, fam, mod in ((p_det, "det", det), (p_ocr, "det", tdet), (p_ocr, "rec", rec),
                               (p_cap, "cap", cap)):
            flat, want = load_checkpoint(path)[fam], unconvert_state(mod.state_dict(), mod)
            if set(flat) != set(want) or any(not np.array_equal(flat[k], want[k]) for k in want):
                fail(f"train_roundtrip: {path} ({fam}) does not read back what was saved")
        base = PipelineConfig(detector_weights=p_det, ocr_weights=p_ocr, captioner_weights=p_cap)
        t0 = time.perf_counter()
        pipe = SOMPipeline(base, device=dev)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        sizes = {os.path.basename(p): os.path.getsize(p) for p in (p_det, p_ocr, p_cap)}
    if pipe.captioner.dims != SYNTH_CAP_DIMS:
        fail(f"train_roundtrip: the captioner loaded at {pipe.captioner.dims}")
    for got, want in ((pipe.det_module, det), (pipe.ocr.det, tdet), (pipe.ocr.rec, rec),
                      (pipe.captioner.model, cap)):
        sg = got.state_dict()
        for k, v in want.state_dict().items():
            if not k.endswith("num_batches_tracked") and not torch.equal(sg[k], v.to(sg[k].dtype)):
                fail(f"train_roundtrip: {type(want).__name__}.{k} loaded unequal to the saved")
    # trained 20 steps on seeded arrays: lower the thresholds until every
    # stage has work, as phase parse does for seeded weights
    chosen, tried = None, []
    for box_thr, text_thr in ((base.detector.box_threshold, base.ocr.text_threshold),
                              (base.detector.box_threshold, 0.0), (0.001, 0.0)):
        pipe.config = dataclasses.replace(
            base, detector=dataclasses.replace(base.detector, box_threshold=box_thr),
            ocr=dataclasses.replace(base.ocr, text_threshold=text_thr))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pipe.parse_image(image)
        c = dict(pipe.last_counts)
        tried.append({"box_threshold": box_thr, "text_threshold": text_thr, **c})
        if c["det_keep"] > 0 and c["ocr_candidates"] > 0 and c["kb"] > 0:
            chosen = (box_thr, text_thr)
            break
    if chosen is None:
        fail(f"train_roundtrip: no threshold gave every stage work: {tried}")
    reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (_, _, elements), ms = sync_wall(lambda: pipe.parse_image(image))
    counts = all_counts()
    path_counts("train_roundtrip", counts, launches_by_path)
    emit("train", item="train_roundtrip", file_bytes=sizes, save_ms=round(save_ms, 2),
         load_ms=round(load_ms, 2), thresholds_tried=tried, counts=dict(pipe.last_counts),
         elements=len(elements), sample=elements[:2], parse_wall_ms=round(ms, 2),
         launches=counts)
    if (counts["nms_keep"], counts["merge_masks"], counts["crop_resize"]) != (1, 1, 2):
        fail(f"train_roundtrip: the parse launched {counts} (want nms_keep 1, merge_masks 1, "
             "crop_resize 2)")
    if not elements:
        fail("train_roundtrip: the parse returned no elements")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()


# parity_on_card's training cases, CPU against card in float32 with TF32
# off.  The first step starts from equal weights, so its loss and the
# running statistics it writes differ only by sums taken in another order.
# Each case's first step runs at a learning rate above 0 (an optimiser
# whose schedule warms up from 0 starts at its first nonzero count), so
# the first update is held too.  The first update: Adam moves a parameter
# by about +-lr wherever its gradient is well above eps, so a gradient near
# zero that the two sides' sums give opposite signs puts its element 2 * lr
# apart; only a small share of the elements may be (param_far_share).  The
# later steps' gradients are taken at those slightly different parameters,
# so every later update differs by about lr times the gradients' relative
# difference: after the last step a parameter is held within 2 * lr a step,
# the share of elements apart to later_far_share, and the later losses and
# running statistics (a deep layer's over a few values of a 64-pixel batch)
# within the looser bounds.  YOLOv8 is exempt from the later share (not
# from the 2 * lr a step): at 64 pixels and batch 2 its deepest BatchNorms
# normalise 2x2 maps over 8 values, so the first update's flips move those
# statistics and with them the later gradients of most of the network; its
# parameters were read 16% (joint step) and 69% (detector trainer) apart by
# more than 1e-5 after three steps, each within the 2 * lr bound, where
# the OCR networks and Florence-2 stayed at or under 0.11% (H100).
TRAIN_PARITY = {"first_loss_rtol": 1e-4, "later_loss_rtol": 2e-3,
                "param_far_share": 0.01, "later_far_share": 0.01, "param_close_atol": 1e-5,
                "first_stats_rtol": 1e-4, "first_stats_atol": 1e-5,
                "stats_rtol": 1e-2, "stats_atol": 5e-3}


def stats_diff(case: str, cpu_mod, gpu_mod, first: bool) -> float:
    """The largest running-statistic difference, held to the first step's
    bound or the later one's."""
    rtol = TRAIN_PARITY["first_stats_rtol" if first else "stats_rtol"]
    atol = TRAIN_PARITY["first_stats_atol" if first else "stats_atol"]
    worst = 0.0
    sb = gpu_mod.state_dict()
    for k, a in cpu_mod.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            d = (a.float() - sb[k].float().cpu()).abs()
            worst = max(worst, float(d.max()))
            if float((d - atol - rtol * a.abs()).max()) > 0:
                fail(f"parity_on_card: {case} {k} differs by {float(d.max())} after "
                     f"{'the first step' if first else 'the last step'}")
    return worst


def module_diff(case: str, cpu_mod, gpu_mod, lr: float, steps: int, far_share):
    """Parameters and running statistics of the two sides after `steps`
    steps (1: the first), held to TRAIN_PARITY: within 2 * lr a step, and
    at most a `far_share` of the elements (None: not held) beyond
    param_close_atol; returns what was read."""
    far = total = 0
    max_p = 0.0
    sb = gpu_mod.state_dict()
    for k, a in cpu_mod.state_dict().items():
        if k.endswith(("num_batches_tracked", "running_mean", "running_var")):
            continue
        d = (a.float() - sb[k].float().cpu()).abs()
        max_p = max(max_p, float(d.max()))
        far += int((d > TRAIN_PARITY["param_close_atol"]).sum())
        total += d.numel()
    share = far / total
    if max_p > 2 * lr * steps + TRAIN_PARITY["param_close_atol"] or \
            (far_share is not None and share > far_share):
        fail(f"parity_on_card: {case} parameters apart by up to {max_p} (lr {lr}, {steps} "
             f"steps), {far} of {total} elements beyond {TRAIN_PARITY['param_close_atol']} "
             f"(share held to {far_share})")
    return {"max_param_diff": max_p, "params_apart": far, "params": total,
            "share_held_to": far_share,
            "max_stats_diff": stats_diff(case, cpu_mod, gpu_mod, steps == 1)}


def check_train_losses(case: str, a, b) -> None:
    first = abs(a[0] - b[0]) / abs(a[0])
    later = max(abs(x - y) / abs(x) for x, y in zip(a[1:], b[1:]))
    if first > TRAIN_PARITY["first_loss_rtol"] or later > TRAIN_PARITY["later_loss_rtol"]:
        fail(f"parity_on_card: {case} losses {a} (cpu) against {b} (card)")


def parity_train(seed: int, dev: str = "cuda"):
    """Three steps of the joint train_step (YOLOv8-n @64 + the tiny
    Florence-2) and of each trainer's step at reduced widths, CPU against
    card from the same weights and batches; each step's augmentation draws
    are made once on the CPU and handed to both sides."""
    from omniparser_tpu_torch.models.florence2 import Florence2, FlorenceDims
    from omniparser_tpu_torch.models.ocr import NUM_CLASSES, TextDetector, TextRecognizer
    from omniparser_tpu_torch.models.yolov8 import YOLOv8
    from omniparser_tpu_torch.train import train_captioner as ttc
    from omniparser_tpu_torch.train import train_detector as ttd
    from omniparser_tpu_torch.train import train_ocr as tto
    from omniparser_tpu_torch.train.ocr_losses import balanced_bce_dice_loss, ctc_loss
    from omniparser_tpu_torch.train.train_step import (
        TINY_TRAIN_DIMS, make_synthetic_batch, make_train_state, train_step)
    from omniparser_tpu_torch.weights.init import flax_init_

    f32, steps, sides = torch.float32, 3, ("cpu", dev)
    rng = np.random.default_rng(seed + 950)
    report = {}

    sts = [make_train_state(imgsz=64, florence_dims=TINY_TRAIN_DIMS, learning_rate=1e-3,
                            generator=torch.Generator(d).manual_seed(seed), device=d, dtype=f32)
           for d in sides]
    sts[1].det_module.load_state_dict(sts[0].det_module.state_dict())
    sts[1].florence.load_state_dict(sts[0].florence.state_dict())
    batch = make_synthetic_batch(torch.Generator().manual_seed(seed + 1), 2, 64)
    losses, first_stats = ([], []), 0.0
    for i in range(steps):
        for side, (st, d) in enumerate(zip(sts, sides)):
            losses[side].append(float(train_step(st, {k: v.to(d) for k, v in batch.items()})
                                      ["loss"]))
        if i == 0:
            first_stats = {
                "detector": module_diff("train_step", sts[0].det_module, sts[1].det_module,
                                        1e-3, 1, TRAIN_PARITY["param_far_share"]),
                "florence": module_diff("train_step", sts[0].florence, sts[1].florence, 1e-3, 1,
                                        TRAIN_PARITY["param_far_share"])}
    check_train_losses("train_step", *losses)
    report["train_step"] = {
        "losses": losses, "first_step": first_stats,
        "detector": module_diff("train_step", sts[0].det_module, sts[1].det_module, 1e-3,
                                steps, None),
        "florence": module_diff("train_step", sts[0].florence, sts[1].florence, 1e-3, steps,
                                TRAIN_PARITY["later_far_share"])}
    del sts

    def run_pair(case, make, make_opt, step, draw, lr, xs, ys, later_share):
        """`steps` steps of `step(module, opt, x, y, draws)` on both sides
        from one flax_init_ of `make()`, each optimiser begun at its
        schedule's first nonzero learning rate."""
        with torch.device("cpu"):
            a = flax_init_(make(), torch.Generator().manual_seed(seed))
        b = make().to(dev)
        b.load_state_dict(a.state_dict())
        pair = (a, b)
        opts = [make_opt(m, d) for m, d in zip(pair, sides)]
        for o in opts:
            while o.schedule(o.count) == 0.0:
                o.count += 1
        lrs = [o.schedule(o.count + i) for i in range(steps)]
        g = torch.Generator().manual_seed(seed + 7)
        ls, first_stats = ([], []), 0.0
        for i in range(steps):
            dr = draw(g, xs[i].shape)
            for side, d in enumerate(sides):
                to = lambda t: (torch.from_numpy(t) if isinstance(t, np.ndarray) else t).to(d)
                ls[side].append(float(step(pair[side], opts[side], to(xs[i]),
                                           tuple(to(y) for y in ys[i]),
                                           {k: v.to(d) for k, v in dr.items()})))
            if i == 0:
                first_stats = module_diff(case, a, b, lr, 1, TRAIN_PARITY["param_far_share"])
        check_train_losses(case, *ls)
        report[case] = {"losses": {"cpu": ls[0], "card": ls[1]}, "learning_rates": lrs,
                        "first_step": first_stats,
                        "state": module_diff(case, a, b, lr, steps, later_share)}

    imgs = rng.integers(0, 256, (steps, 2, 64, 64, 3), dtype=np.uint8)
    xy = rng.uniform(0.05, 0.5, (steps, 2, 6, 2))
    gtb = np.concatenate([xy, xy + rng.uniform(0.1, 0.4, (steps, 2, 6, 2))], -1)
    run_pair("train_detector", YOLOv8,
             lambda m, d: ttd.make_detector_trainer(4, 0, 2e-3, d, module=m)[1],
             lambda m, o, x, y, dr: ttd.detector_step(m, o, x, y[0], y[1], dr, f32, 64),
             ttd.augment_draws, 2e-3, imgs,
             [(gtb[i].astype(np.float32), np.ones((2, 6), bool)) for i in range(steps)], None)

    lines = rng.random((steps, 4, 32, 64, 3)).astype(np.float32)
    labels = np.zeros((steps, 4, 8), np.int64)
    labels[..., :5] = rng.integers(1, NUM_CLASSES, (steps, 4, 5))
    run_pair("train_ocr_recognizer", lambda: TextRecognizer(16, 1, 2, seq_len=16),
             lambda m, d: tto.make_recognizer_trainer(4, 0, 1e-3, d, module=m)[1],
             lambda m, o, x, y, dr: tto.ocr_step(m, o, ctc_loss, x, y[0], dr, f32),
             tto.augment_draws, 1e-3, lines, [(labels[i],) for i in range(steps)],
             TRAIN_PARITY["later_far_share"])

    screens = rng.random((steps, 2, 64, 64, 3)).astype(np.float32)
    maps = (rng.random((steps, 2, 32, 32)) < 0.15).astype(np.float32)
    run_pair("train_ocr_detector", lambda: TextDetector(8),
             lambda m, d: tto.make_text_detector_trainer(4, 0, 5e-4, d, module=m)[1],
             lambda m, o, x, y, dr: tto.ocr_step(m, o, balanced_bce_dice_loss, x, y[0], dr, f32),
             tto.augment_draws, 5e-4, screens, [(maps[i],) for i in range(steps)],
             TRAIN_PARITY["later_far_share"])

    dims = FlorenceDims(**{**dataclasses.asdict(TINY_TRAIN_DIMS), "vocab_size": 160})
    tables = {torch.device(d).type: ttc.CaptionTables(d) for d in sides}
    crops = rng.random((steps, 4, 32, 32, 3)).astype(np.float32)
    kinds = rng.integers(0, len(ttc.CAPTIONS), (steps, 4)).astype(np.int64)
    run_pair("train_captioner", lambda: Florence2(dims),
             lambda m, d: ttc.make_captioner_trainer(4, 0, 3e-4, d, module=m)[1],
             lambda m, o, x, y, dr: ttc.captioner_step(m, o, tables[x.device.type], x, y[0], dr,
                                                       f32),
             tto.augment_draws, 3e-4, crops, [(kinds[i],) for i in range(steps)],
             TRAIN_PARITY["later_far_share"])
    emit("parity_on_card", check="training: three steps, CPU against card, float32, TF32 off",
         tolerances=TRAIN_PARITY, cases=report)


def phase_parity(seed: int):
    """The fused step on the card against the same step on the CPU."""
    from omniparser_tpu_torch.config import (
        CaptionerConfig, DetectorConfig, OcrConfig, PipelineConfig)
    from omniparser_tpu_torch.models.florence2 import FlorenceDims
    from omniparser_tpu_torch.pipeline import SOMPipeline, fused_parse_step

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PipelineConfig(
        detector=DetectorConfig(default_imgsz=640, dtype="float32"),
        ocr=OcrConfig(det_imgsz=960, dtype="float32", text_threshold=0.0),
        captioner=CaptionerConfig(dtype="float32"),
        detector_weights=None, ocr_weights=None, captioner_weights=None)
    dims = FlorenceDims(depths=(1, 1, 2, 1), encoder_layers=2, decoder_layers=2)
    image = synthetic_screenshot(np.random.default_rng(seed + 1))[:540, :960].copy()
    cpu = SOMPipeline(cfg, device="cpu", captioner_dims=dims, seed=seed)
    gpu = SOMPipeline(
        cfg, device="cuda", captioner_dims=dims,
        detector_state=cpu.det_module.state_dict(),
        ocr_states=(cpu.ocr.det.state_dict(), cpu.ocr.rec.state_dict()),
        captioner_state=cpu.captioner.model.state_dict())

    outs = {}
    for name, pipe in (("cpu", cpu), ("cuda", gpu)):
        ctx = pipe._stage_upload(image)
        cc, r, pads = pipe.ocr.dispatch_det(ctx["padded_dev"], (ctx["uh"], ctx["uw"]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = fused_parse_step(
                cfg, pipe.detector, pipe.det_module, pipe.ocr, True, ctx["padded_dev"],
                (ctx["uh"], ctx["uw"]), (ctx["h"], ctx["w"]), cc["boxes"], cc["count"], r, pads,
                cfg.detector.box_threshold, cfg.detector.nms_iou_threshold, cfg.iou_threshold,
                cfg.ocr.text_threshold, True)
        out["cc_boxes"], out["cc_count"] = cc["boxes"], cc["count"]
        outs[name] = {k: v.cpu() for k, v in out.items()}
    a, b = outs["cpu"], outs["cuda"]
    exact = {}
    for k in ("cc_count", "cc_boxes", "det_valid", "det_overflow", "icon_keep", "ocr_keep",
              "absorb", "ocr_valid", "ocr_cand_valid", "rec_ids", "cap_valid", "cap_src"):
        diff = a[k] != b[k]
        exact[k] = int((diff.flatten(1).any(1) if diff.dim() > 1 else diff).sum())  # slots
    both = a["det_valid"] & b["det_valid"]
    close = {
        "det_boxes": float((a["det_boxes"] - b["det_boxes"])[both].abs().max()) if both.any() else 0.0,
        "det_scores": float((a["det_scores"] - b["det_scores"])[both].abs().max()) if both.any() else 0.0,
        "ocr_boxes": float((a["ocr_boxes"] - b["ocr_boxes"]).abs().max()),
        "rec_conf": float((a["rec_conf"] - b["rec_conf"]).abs().max()),
    }
    same_slots = a["cap_valid"] & b["cap_valid"] & (a["cap_src"] == b["cap_src"])
    close["crops"] = (float((a["crops"] - b["crops"])[same_slots].abs().max())
                      if same_slots.any() else 0.0)
    emit("parity_on_card", dtype="float32", tf32="off (cudnn.allow_tf32=False, "
         "cuda.matmul.allow_tf32=False)", image=list(image.shape),
         sizes={"detector": cfg.detector.default_imgsz, "ocr_det": cfg.ocr.det_imgsz,
                "florence_depths": list(dims.depths)},
         det_keep={"cpu": int(a["det_valid"].sum()), "cuda": int(b["det_valid"].sum())},
         differing_slots=exact, max_abs_diff=close,
         reason="seeded untrained weights give many near-equal scores; float32 sums taken "
                "in another order on the card can swap two neighbours in the sort, and a "
                "swapped pair changes the greedy keep set after it")
    # the printed reason allows a handful of slots; more is a wrong step
    for k, v in exact.items():
        if v > PARITY_MAX_SLOTS:
            fail(f"parity_on_card: {k} differs in {v} slots (at most {PARITY_MAX_SLOTS} allowed)")
    for k, v in close.items():
        if not v <= PARITY_ATOL[k]:
            fail(f"parity_on_card: {k} differs by {v} (at most {PARITY_ATOL[k]} allowed)")
    # parse_batch against parse_image on the card in float32 with TF32 off:
    # the phase-batch check without bfloat16 near-ties in the decode.  The
    # default text threshold, so that icons without OCR text need captions.
    wit = SOMPipeline(
        dataclasses.replace(cfg, ocr=dataclasses.replace(
            cfg.ocr, text_threshold=OcrConfig().text_threshold)),
        device="cuda", captioner_dims=dims,
        detector_state=cpu.det_module.state_dict(),
        ocr_states=(cpu.ocr.det.state_dict(), cpu.ocr.rec.state_dict()),
        captioner_state=cpu.captioner.model.state_dict())
    images = [synthetic_screenshot(np.random.default_rng(seed + 21 + i), h, w)
              for i, (h, w) in enumerate(BATCH_SHAPES)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        batched = wit.parse_batch(images)
        chunks = list(wit.last_decode_chunks)
        single = [wit.parse_image(img) for img in images]
    flips = []
    for i, ((_, _, eb), (_, _, es)) in enumerate(zip(batched, single)):
        bad, n = same_but_captions(eb, es)
        if bad:
            fail(f"parity_on_card: float32 parse_batch image {i} differs from its "
                 f"parse_image: {bad}")
        flips.append(n)
    captioned = sum(e["source"] == "box_yolo_content_yolo" for _, _, el in single for e in el)
    emit("parity_on_card", check="parse_batch against parse_image, float32, TF32 off",
         shapes=[list(i.shape) for i in images], decode_chunks=chunks,
         caption_texts_differing=flips, caption_texts=captioned)
    if not captioned or sum(chunks) == 0:
        fail("parity_on_card: the float32 parse_batch decoded no caption")
    del wit
    # the reference's two-call API with provided OCR boxes (ROADMAP C.10)
    parity_compat(cpu, gpu, image)
    parity_mesh(seed, cpu, cfg, dims)
    parity_phi3v(seed, cpu, cfg, image)
    parity_eval(cpu, gpu, image)
    del cpu, gpu
    torch.cuda.empty_cache()
    parity_families(seed)
    parity_train(seed)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ #
# phase mesh: the device mesh (parallel/) on a virtual mesh of one card
# ------------------------------------------------------------------ #

MESH_SHAPES = ((1, 1), (2, 2))  # (dp, tp) over [cuda:0] * (dp * tp)


def mesh_of(dp: int, tp: int, dev: str = "cuda"):
    """A (dp, tp) mesh that repeats one device: the card's cuda:0, or the CPU."""
    from omniparser_tpu_torch.parallel.mesh import make_mesh

    d = torch.device("cuda", 0) if dev == "cuda" else torch.device(dev)
    return make_mesh([d] * (dp * tp), dp=dp, tp=tp)


def _iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - ix * iy
    return ix * iy / union if union > 0 else 0.0


def element_diffs(got, want):
    """How a parse's elements differ from another's, matched by box (each
    element of `got` to the unmatched one of `want` it overlaps most, IoU
    at least 0.5; tests/test_sharded_parse.py's set parity): element counts,
    elements left unmatched, fields of matched pairs that differ other than
    caption text and boxes, caption texts that differ, the largest box
    difference, and whether the order is the same."""
    rest, unmatched, fields, flips, box = list(want), 0, 0, 0, 0.0
    for a in got:
        b = max(rest, key=lambda e: _iou(a["bbox"], e["bbox"]), default=None)
        if b is None or _iou(a["bbox"], b["bbox"]) < 0.5:
            unmatched += 1
            continue
        rest.remove(b)
        fields += sum(a[k] != b[k] for k in ("type", "interactivity", "source"))
        if a["source"] == b["source"] == "box_yolo_content_yolo":
            flips += a["content"] != b["content"]
        else:
            fields += a["content"] != b["content"]
        box = max(box, float(np.abs(np.asarray(a["bbox"]) - np.asarray(b["bbox"])).max()))
    return {"elements": [len(got), len(want)], "unmatched": unmatched + len(rest),
            "differing_fields": int(fields), "caption_texts_differing": int(flips),
            "max_box_diff": box, "same_order": [e["bbox"] for e in got] == [
                e["bbox"] for e in want]}


def check_elements(path: str, results) -> None:
    """Fail on a malformed parse: no elements, a bad schema, a box out of
    range, an element without content."""
    for _, _, elements in results:
        if not elements:
            fail(f"{path}: a parse returned no elements")
        for e in elements:
            if set(e) != {"type", "bbox", "interactivity", "content", "source"}:
                fail(f"{path}: malformed element {e}")
            if not all(np.isfinite(v) and -1e-6 <= v <= 1 + 1e-6 for v in e["bbox"]):
                fail(f"{path}: bbox out of range {e}")
            if e["content"] is None:
                fail(f"{path}: element without content {e}")


def phase_mesh(seed: int, pipe, image, launches_by_path, dev: str = "cuda"):
    """The device mesh at full width on a virtual mesh of the card:
    ShardedParse of four 1080x1920 screenshots at (1, 1) and (2, 2) against
    parse_image of each and beside parse_batch of the four; ShardedCaptioner
    at (2, 2) on 128 crops against the unsharded captioner; single-step
    decode against the split one; the sharded train step at (2, 2) against
    train_step."""
    from omniparser_tpu_torch.models.florence2 import FlorenceCaptioner
    from omniparser_tpu_torch.parallel.sharded import ShardedCaptioner
    from omniparser_tpu_torch.parallel.sharded_parse import ShardedParse
    from omniparser_tpu_torch.pipeline import SOMPipeline

    t_phase = time.perf_counter()
    images = [synthetic_screenshot(np.random.default_rng(seed + 21 + i)) for i in range(4)]
    n = len(images)

    def wall(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        single, line_blocks = [], []
        for img in images:
            reset_counts()
            single.append(pipe.parse_image(img))
            line_blocks.append(all_counts()["crop_resize"] - 1)
        pipe.parse_batch(images)
        batch_ms = [wall(lambda: pipe.parse_batch(images)) for _ in range(3)]
        batch_prof = profile_pass(lambda: wall(lambda: pipe.parse_batch(images)), batch_ms)
    emit("mesh", images=[list(i.shape) for i in images], line_blocks=line_blocks,
         parse_batch={"wall_ms": [round(x, 2) for x in batch_ms],
                      "screenshots_per_s": [round(n / x * 1e3, 3) for x in batch_ms],
                      "profile": batch_prof})

    for dp, tp in MESH_SHAPES:
        path = f"mesh_sharded_parse_{dp}x{tp}"
        sp = ShardedParse(pipe, mesh_of(dp, tp, dev))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sp.parse_images(images)  # warm-up: the batched shapes' first launches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            got = sp.parse_images(images)
            torch.cuda.synchronize()
            counts = all_counts()
            peak = torch.cuda.max_memory_allocated()
            walls = [wall(lambda: sp.parse_images(images)) for _ in range(3)]
            prof = profile_pass(lambda: wall(lambda: sp.parse_images(images)), walls)
        path_counts(path, counts, launches_by_path)
        check_elements(path, got)
        want_crop = n * (max(line_blocks) + 1)
        emit("mesh", path=path, dp=dp, tp=tp, launches=counts,
             launches_wanted={"nms_keep": n, "merge_masks": n, "crop_resize": want_crop},
             against_parse_image=[element_diffs(g[2], s[2]) for g, s in zip(got, single)],
             wall_ms=[round(x, 2) for x in walls],
             screenshots_per_s=[round(n / x * 1e3, 3) for x in walls],
             host_stage_ms={k: round(v * 1e3, 3) for k, v in sp.last_timings.items()},
             profile=prof, max_memory_allocated=peak)
        if counts["nms_keep"] != n or counts["merge_masks"] != n or \
                counts["crop_resize"] != want_crop or counts["overlap_matrices"]:
            fail(f"mesh: {path} launched {counts}, want nms_keep {n}, merge_masks {n}, "
                 f"crop_resize {want_crop} (each image's line blocks and caption grid)")
        del sp

    # ShardedCaptioner at (2, 2) on the fused step's 128 caption crops: in
    # the pipeline's bfloat16 (each row decodes 64 crops, where cuBLAS may
    # pick another kernel than for 128, ROADMAP C.7: flips counted), then
    # a float32 copy with TF32 off, whose tokens must be equal
    ctx = pipe._stage_upload(image)
    ctx["ocr_fut"] = pipe.ocr.dispatch_det(ctx["padded_dev"], (ctx["uh"], ctx["uw"]))
    crops = pipe._stage_dispatch(ctx, None, None)
    cap = pipe.captioner
    sc = ShardedCaptioner(cap, mesh_of(2, 2, dev))
    want_t, want_lp = cap.generate(crops)
    got_t, got_lp = sc.generate(crops)
    rows = int((got_t != want_t).any(dim=1).sum())
    cap_ms = {"unsharded": [round(wall(lambda: cap.generate(crops)), 2) for _ in range(3)],
              "sharded_2x2": [round(wall(lambda: sc.generate(crops)), 2) for _ in range(3)]}
    del sc
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cap32 = FlorenceCaptioner(dataclasses.replace(cap.config, dtype="float32"), cap.dims,
                              cap.model.state_dict(), device=dev)
    want32, _ = cap32.generate(crops)
    got32, _ = ShardedCaptioner(cap32, mesh_of(2, 2, dev)).generate(crops)
    rows32 = int((got32 != want32).any(dim=1).sum())
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    emit("mesh", check="ShardedCaptioner (2, 2) against the unsharded captioner",
         crops=list(crops.shape), bfloat16={"token_rows_differing": rows,
                                           "max_logp_diff": float((got_lp - want_lp).abs().max())},
         float32_tf32_off={"token_rows_differing": rows32}, decode_wall_ms=cap_ms)
    if rows32:
        fail(f"mesh: in float32 ShardedCaptioner's tokens differ from the unsharded ones "
             f"in {rows32} rows")
    del cap32

    # single-step decode: the fused step decodes all K slots
    cfg1 = dataclasses.replace(pipe.config, captioner=dataclasses.replace(
        pipe.config.captioner, split_decode=False))
    one = SOMPipeline(cfg1, device=dev, detector=pipe.detector, det_module=pipe.det_module,
                      ocr=pipe.ocr, captioner=cap)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one.parse_image(image)  # warm-up
        reset_counts()
        _, _, el_one = one.parse_image(image)
        torch.cuda.synchronize()
        counts = all_counts()
        _, _, el_split = pipe.parse_image(image)
        one_ms = [wall(lambda: one.parse_image(image)) for _ in range(3)]
        split_ms = [wall(lambda: pipe.parse_image(image)) for _ in range(3)]
    path_counts("single_step_parse_image", counts, launches_by_path)
    diff = element_diffs(el_one, el_split)
    emit("mesh", check="single-step decode (split_decode off) against the split decode",
         launches=counts, kb=one.last_counts["kb"], against_split=diff,
         wall_ms={"single_step": [round(x, 2) for x in one_ms],
                  "split": [round(x, 2) for x in split_ms]})
    if el_one != el_split:
        fail(f"mesh: single-step decode's elements differ from the split path's: {diff}")
    if counts["nms_keep"] != 1 or counts["merge_masks"] != 1 or \
            counts["crop_resize"] != launches_by_path["parse"]["crop_resize"]:
        fail(f"mesh: single-step parse_image launched {counts}")
    del one
    mesh_train(seed, dev)
    emit("mesh", seconds=round(time.perf_counter() - t_phase, 1))


class _Whole:
    """A module's state dict on the host, with each split parameter read
    whole (through its gather), for module_diff."""

    def __init__(self, module):
        self.module = module

    def state_dict(self):
        from torch.nn.utils import parametrize

        out = {}
        for name, m in self.module.named_modules():
            pre = name + "." if name else ""
            for k, t in m.named_parameters(recurse=False):
                out[pre + k] = t.detach()
            for k, t in m.named_buffers(recurse=False):
                out[pre + k] = t
            if parametrize.is_parametrized(m):
                for k in m.parametrizations:
                    out[pre + k] = getattr(m, k).detach()
        return {k: v.cpu() for k, v in out.items() if ".parametrizations." not in k
                and not k.startswith("parametrizations.")}


def mesh_train(seed: int, dev: str = "cuda", imgsz: int = TRAIN_IMGSZ, dims=None, mesh=None):
    """Three steps of make_sharded_train_step at (2, 2) (`mesh`, default the
    virtual one of `dev`) against train_step from the same state and batch:
    YOLOv8-n + Florence-2 BASE dims, batch 8, float32 with TF32 off, held to
    TRAIN_PARITY's shares."""
    from omniparser_tpu_torch.models.florence2 import BASE, TASK_PROMPTS
    from omniparser_tpu_torch.models.tokenizer import load_tokenizer
    from omniparser_tpu_torch.train.train_step import (
        make_sharded_train_step, make_synthetic_batch, make_train_state, train_step)

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dims = dims or BASE
    lr, steps = 1e-4, 3
    sts = [make_train_state(imgsz=imgsz, florence_dims=dims, learning_rate=lr, device=dev,
                            generator=torch.Generator(dev).manual_seed(seed),
                            dtype=torch.float32) for _ in range(2)]
    sts[1].det_module.load_state_dict(sts[0].det_module.state_dict())
    sts[1].florence.load_state_dict(sts[0].florence.state_dict())
    step = make_sharded_train_step(sts[1], mesh or mesh_of(2, 2, dev))
    prompt_len = len(load_tokenizer(None).encode(TASK_PROMPTS["<CAPTION>"]))
    batch = make_synthetic_batch(torch.Generator(dev).manual_seed(seed + 1), 8, imgsz, max_gt=8,
                                 crop=64, prompt_len=prompt_len, cap_len=20)
    losses, walls, first = ([], []), ([], []), {}
    for i in range(steps):
        for side, call in enumerate((lambda: train_step(sts[0], batch), lambda: step(batch))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses[side].append(float(call()["loss"]))
            walls[side].append(round((time.perf_counter() - t0) * 1e3, 2))
        if i == 0:
            first = {"detector": module_diff("sharded train step", _Whole(sts[0].det_module),
                                             _Whole(sts[1].det_module), lr, 1,
                                             TRAIN_PARITY["param_far_share"]),
                     "florence": module_diff("sharded train step", _Whole(sts[0].florence),
                                             _Whole(sts[1].florence), lr, 1,
                                             TRAIN_PARITY["param_far_share"])}
    check_train_losses("sharded train step", *losses)
    split = sum(1 for _ in sts[1].florence.modules()
                if getattr(_, "parametrizations", None) is not None)
    emit("mesh", check="make_sharded_train_step (2, 2) against train_step, float32, TF32 off",
         widths=f"YOLOv8-n @{imgsz} + Florence-2 {'BASE' if dims is BASE else 'reduced'} "
                "dims, batch 8, adamw 1e-4", losses={"train_step": losses[0],
                                                     "sharded": losses[1]},
         step_wall_ms={"train_step": walls[0], "sharded": walls[1]},
         florence_modules_split_over_tp=split, first_step=first,
         after_three={"detector": module_diff("sharded train step", _Whole(sts[0].det_module),
                                              _Whole(sts[1].det_module), lr, steps, None),
                      "florence": module_diff("sharded train step", _Whole(sts[0].florence),
                                              _Whole(sts[1].florence), lr, steps,
                                              TRAIN_PARITY["later_far_share"])},
         tolerances=TRAIN_PARITY)
    if not split:
        fail("mesh: the sharded train step split no Florence-2 parameter over tp")
    del sts, step
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()


def parity_mesh(seed: int, cpu, cfg, dims, dev: str = "cuda"):
    """A reduced ShardedParse at (2, 2) on the card against the same on the
    CPU, float32 with TF32 off, at text threshold 0 (OCR text reaches the
    merge) and at the default one (icons without text need captions):
    every field but the boxes equal, boxes within 1e-4.  The detector's
    class convolutions are scaled so that its scores spread over (0, 1)
    (no near-ties for the two sides' float32 sums to swap)."""
    from omniparser_tpu_torch.config import OcrConfig
    from omniparser_tpu_torch.parallel.mesh import make_mesh
    from omniparser_tpu_torch.parallel.sharded_parse import ShardedParse
    from omniparser_tpu_torch.pipeline import SOMPipeline

    det_state = {k: v.clone() for k, v in cpu.det_module.state_dict().items()}
    for i in range(3):
        det_state[f"head.cls{i}_2.weight"] *= 20.0
    sides = [SOMPipeline(cfg, device=d, captioner_dims=dims, detector_state=det_state,
                         ocr_states=(cpu.ocr.det.state_dict(), cpu.ocr.rec.state_dict()),
                         captioner_state=cpu.captioner.model.state_dict())
             for d in ("cpu", dev)]
    sharded = [ShardedParse(p, m) for p, m in zip(
        sides, (make_mesh(["cpu"] * 4, dp=2, tp=2), mesh_of(2, 2, dev)))]
    images = [synthetic_screenshot(np.random.default_rng(seed + 41 + i), 540, 960)
              for i in range(2)]
    found = {}
    for thr in (0.0, OcrConfig().text_threshold):
        for p in sides:
            p.config = dataclasses.replace(cfg, ocr=dataclasses.replace(cfg.ocr,
                                                                         text_threshold=thr))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a, b = (sp.parse_images(images) for sp in sharded)
        diffs = [element_diffs(y[2], x[2]) for x, y in zip(a, b)]
        strict = [same_elements(y[2], x[2], 1e-4) for x, y in zip(a, b)]
        found[thr] = {"text": sum(e["type"] == "text" for _, _, el in a for e in el),
                      "captions": sum(e["source"] == "box_yolo_content_yolo"
                                      for _, _, el in a for e in el)}
        emit("parity_on_card", check="ShardedParse (2, 2), card against CPU, float32, TF32 off",
             text_threshold=thr, images=[list(i.shape) for i in images], against_cpu=diffs,
             elements=found[thr])
        for (bad, flips), d in zip(strict, diffs):
            if bad or flips:  # in order, every field, boxes within 1e-4
                fail(f"parity_on_card: ShardedParse on the card differs from the CPU's: "
                     f"{bad}, {flips} captions; {diffs}")
    if not found[0.0]["text"] or not found[OcrConfig().text_threshold]["captions"]:
        fail(f"parity_on_card: the sharded parses read no text or decoded no caption: {found}")


TRAINED_TREES = ("det_synth", "ocr_en_synth", "cap_synth")
# weights/orbax_read.tree_digest of each committed tree, as the JAX package's
# load_checkpoint restores it (tests/test_torch_orbax.py derives them so)
TREE_DIGESTS = {
    "det_synth": "ca3723923866411bbe9c5ea784439da02ff5f4315ed3bcef8b991a7232919b6b",
    "ocr_en_synth": "8ccf49d869c6c6c8bf50d31bfe25782d1c97ec44afadc5d5d06e3b610da56056",
    "cap_synth": "9662c8eefc2cc6d5aaa263f41ef0f1e5a2d27b0aa886389ccf89eb8a659b5b6c",
}
TRAINED_BOX_ATOL = 1e-4  # normalised boxes, card against CPU in float32 (ROADMAP C.10)
TRAINED_SHOTS = 2


@contextlib.contextmanager
def tf32_off():
    was = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was


def with_dtype(cfg, dtype: str):
    """`cfg` with the detector, OCR and captioner in `dtype`."""
    return dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, dtype=dtype),
        ocr=dataclasses.replace(cfg.ocr, dtype=dtype),
        captioner=dataclasses.replace(cfg.captioner, dtype=dtype))


def read_trees():
    """The committed trees through the port's reader: per tree its arrays,
    bytes stored and decoded, wall ms of a first and a second read, decoded
    MB/s and digest; fails where a digest differs from TREE_DIGESTS."""
    from omniparser_tpu_torch.pipeline import TRAINED_DIR
    from omniparser_tpu_torch.utils import zstd
    from omniparser_tpu_torch.weights.convert import flatten_variables
    from omniparser_tpu_torch.weights.orbax_read import read_orbax_tree, tree_digest

    built = not os.path.exists(zstd._lib_path())
    t0 = time.perf_counter()
    zstd.load()  # g++ builds csrc/zstd_decode.cpp here, apart from the reads
    out = {"decoder_built": built, "decoder_build_s": round(time.perf_counter() - t0, 3)}
    for name in TRAINED_TREES:
        path = os.path.join(TRAINED_DIR, name)
        stored = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
                     for f in fs)
        walls = []
        for _ in range(2):
            t = time.perf_counter()
            tree = read_orbax_tree(path)
            walls.append((time.perf_counter() - t) * 1e3)
        leaves = flatten_variables(tree)
        decoded = sum(a.nbytes for a in leaves.values())
        digest = tree_digest(tree)
        out[name] = {"arrays": len(leaves), "stored_bytes": stored, "decoded_bytes": decoded,
                     "ms": [round(w, 2) for w in walls],
                     "decoded_mb_per_s": round(decoded / 1e6 / (walls[0] / 1e3), 2),
                     "digest": digest}
        if digest != TREE_DIGESTS[name]:
            fail(f"trained: the digest of {name} is {digest}, want {TREE_DIGESTS[name]}")
    return out


def parses_equal(got, want, atol: float = TRAINED_BOX_ATOL):
    """Per image of two [(elements, counts)] lists: the first differing
    field (texts and captions exact, boxes within atol), caption texts
    apart, and the counts that differ; (all equal, rows)."""
    rows = []
    for (ea, ca), (eb, cb) in zip(got, want):
        field, flips = same_elements(ea, eb, atol)
        box = max((max(abs(x - y) for x, y in zip(a["bbox"], b["bbox"]))
                   for a, b in zip(ea, eb)), default=0.0)
        rows.append({"elements": len(ea), "first_difference": field, "caption_flips": flips,
                     "max_box_diff": box,
                     "counts_differing": {k: [ca[k], cb.get(k)] for k in ca if ca[k] != cb.get(k)}})
    ok = all(r["first_difference"] is None and not r["caption_flips"] and not r["counts_differing"]
             for r in rows)
    return ok, rows


def parse_shots(pipe, images):
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for img in images:
            _, elements = pipe.parse_elements(img)
            out.append((elements, dict(pipe.last_counts)))
    return out


def phase_trained(seed: int, launches_by_path, dev: str = "cuda"):
    """The trained trees committed under omniparser_tpu/weights/, read from
    the checkout without JAX: digests, card against CPU in float32, and a
    timed bfloat16 parse whose launches join `launches_by_path`."""
    from omniparser_tpu_torch.config import PipelineConfig
    from omniparser_tpu_torch.pipeline import SOMPipeline

    t0 = time.perf_counter()
    emit("trained", trees=read_trees())

    rng = np.random.default_rng(seed + 13)
    images = [synthetic_screenshot(rng) for _ in range(TRAINED_SHOTS)]
    cfg32 = with_dtype(PipelineConfig(), "float32")  # every weight field 'auto'
    with tf32_off():
        t = time.perf_counter()
        card = SOMPipeline(cfg32, device=dev)
        got = parse_shots(card, images)
        card_s = time.perf_counter() - t
        del card
        t = time.perf_counter()
        want = parse_shots(SOMPipeline(cfg32, device="cpu"), images)
        cpu_s = time.perf_counter() - t
    ok, rows = parses_equal(got, want)
    for r, (elements, counts) in zip(rows, got):
        r.update(counts=counts, texts=sum(e["type"] == "text" for e in elements),
                 sample=[e["content"] for e in elements[:3]])
    emit("trained", parity="float32, TF32 off, card against CPU", images=[list(images[0].shape)],
         equal=ok, per_image=rows, card_s=round(card_s, 2), cpu_s=round(cpu_s, 2))
    if not ok:
        fail(f"trained: the card's float32 parses differ from the CPU's: {rows}")
    if not all(r["elements"] and r["counts"]["kb"] for r in rows):
        fail(f"trained: a parse found no element or decoded no caption: {rows}")

    # bfloat16, as users run it: wall, launches, device ms and idle share
    pipe = SOMPipeline(PipelineConfig(), device=dev)
    image = images[0]

    def wall():
        torch.cuda.synchronize()
        t = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, elements = pipe.parse_elements(image)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, elements

    wall()  # warm-up of this screenshot's shapes
    reset_counts()
    first, elements = wall()
    counts = all_counts()
    run_counts = dict(pipe.last_counts)
    walls = [first] + [wall()[0] for _ in range(2)]
    # K3's launches: one line grid per rec_block of OCR candidates (the
    # recogniser's block loop, none without text), the fused step's caption
    # grid, and one more per K content-less icons beyond its K slots
    # (pipeline._caption_boxes)
    cfg = pipe.config
    k = cfg.captioner.batch_size
    captioned = sum(e["source"] == "box_yolo_content_yolo" for e in elements)
    grids = {"line": -(-run_counts["ocr_candidates"] // cfg.ocr.rec_block), "caption": 1,
             "caption_overflow": -(-max(captioned - run_counts["cap_need"], 0) // k)}
    path_counts("trained_parse", counts, launches_by_path)
    emit("trained", dtype="bfloat16", counts=run_counts, elements=len(elements),
         captioned=captioned, launches=counts, crop_grids=grids,
         profile=profile_pass(lambda: wall()[0], walls),
         seconds=round(time.perf_counter() - t0, 1))
    want_launches = {"nms_keep": 1, "merge_masks": 1, "crop_resize": sum(grids.values())}
    if {n: counts.get(n, 0) for n in want_launches} != want_launches:
        fail(f"trained: the bfloat16 parse launched {counts}, want {want_launches}")
    del pipe
    torch.cuda.empty_cache()


# seeded weights and synthetic screenshots: a plain checkout carries no export
# and no font (the trained trees are phase trained's)
BENCH_ARGV = ("--weights", "seeded", "--inputs", "synthetic", "--calls", "10",
              "--rounds", "2", "--count", "4")
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "best_round_shots_per_sec",
              "p50_latency_s", "mfu", "device_flops_per_parse", "device_flops_split",
              "device_time_share", "captioner_quant", "ocr_weights", "stage_timings_s",
              "device", "weights", "inputs", "p90_latency_s", "n_calls", "launches_per_parse",
              "peak_bytes", "device_stage_ms", "decode_device_ms", "top_kernels",
              "kernel_launches", "correct", "flops_note")


def phase_bench(launches_by_path):
    """The port's benchmark script, run through its main function; its
    traced paths' launch counts join `launches_by_path`."""
    import io

    import bench_torch

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_torch.main(list(BENCH_ARGV))
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    emit("bench", seconds=round(time.perf_counter() - t0, 1), **line)
    missing = [k for k in BENCH_KEYS if k not in line]
    if missing:
        fail(f"bench: the JSON line lacks {missing}")
    if line["correct"] is not True:
        fail(f"bench: parse_batch disagrees with parse_image: {line['check']}")
    nulls = [k for k in bench_torch.DEVICE_FIELDS if line[k] is None]
    if nulls or line["decode_device_ms"]["events_ms"] is None or not line["device_stage_ms"]:
        fail(f"bench: device fields are null on the card: {nulls}")
    n = line["inputs"]["count"]
    for path, shots in (("parse_image", 1), ("parse_batch", n)):
        counts = line["kernel_launches"][path]
        path_counts("bench_" + path, counts, launches_by_path)
        want = {"nms_keep": shots, "merge_masks": shots, "crop_resize": 2 * shots}
        if counts != want:
            fail(f"bench: the traced {path} of {shots} launched {counts}, want {want}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one CUDA device")
    t0 = time.perf_counter()
    smi_line = phase_device()
    phase_build()
    records = phase_kernels(args.seed)
    pipe, image = phase_parse(args.seed, records)
    launches_by_path = {"parse": {r["name"]: r["launches"] for r in records}}
    images, single = phase_batch(args.seed, pipe, launches_by_path)
    phase_serve(args.seed, pipe, images, single, launches_by_path)
    phase_int8(pipe, image, launches_by_path)
    phase_compat(args.seed, pipe, image, pipe.config, launches_by_path)
    phase_families(args.seed, pipe, image, launches_by_path)
    phase_eval(pipe, image, launches_by_path)
    phase_train(args.seed, image, launches_by_path)
    phase_mesh(args.seed, pipe, image, launches_by_path)
    emit("launches", by_path=launches_by_path)
    del pipe, single
    torch.cuda.empty_cache()
    phase_parity(args.seed)
    phase_trained(args.seed, launches_by_path)
    phase_bench(launches_by_path)
    emit("done", seconds=round(time.perf_counter() - t0, 1))
    print(smi_line, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         "launches_by_path": {p: c.get(r["name"], 0) for p, c in launches_by_path.items()}}
        for r in records]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
