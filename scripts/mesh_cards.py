#!/usr/bin/env python3
"""The device mesh over distinct cards: what a virtual mesh of one card
cannot run (networks copied to other cards, split parameters resting on
other cards, the train step's statistics and gradients crossing cards).

    python3 scripts/mesh_cards.py [--seed N]

Needs at least four visible CUDA devices and uses four (the first four).
Over ``make_mesh`` of them, each against the single-card path on cuda:0:

  parity     a reduced float32 pipeline (``chip_smoke.parity_mesh``'s widths,
             TF32 off, its class convolutions scaled so that scores spread):
             ShardedParse of four screenshots at (4, 1) and (2, 2) against
             parse_image of each, every field in order and boxes within 1e-4;
             ShardedCaptioner at (2, 2) on the caption crops, tokens equal
  full       the default widths in bfloat16, seeded: ShardedParse of four
             1080x1920 screenshots at (4, 1) and (2, 2) beside parse_batch on
             one card: walls, screenshots/s, launches, and the elements
             against parse_image matched by box (counted, not required equal:
             a batched bfloat16 convolution may round otherwise)
  train      three steps of make_sharded_train_step at (2, 2) across the
             cards against train_step (``chip_smoke.mesh_train``, float32)

One JSON line a check, the cards' nvidia-smi lines, and last
{"ok": true, "device": {...}}; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402


def _wall(call):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return out, (time.perf_counter() - t0) * 1e3


def parity(seed: int, cards) -> None:
    from omniparser_tpu_torch.config import (
        CaptionerConfig, DetectorConfig, OcrConfig, PipelineConfig)
    from omniparser_tpu_torch.models.florence2 import FlorenceDims
    from omniparser_tpu_torch.parallel.mesh import make_mesh
    from omniparser_tpu_torch.parallel.sharded import ShardedCaptioner
    from omniparser_tpu_torch.parallel.sharded_parse import ShardedParse
    from omniparser_tpu_torch.pipeline import SOMPipeline

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PipelineConfig(detector=DetectorConfig(default_imgsz=640, dtype="float32"),
                         ocr=OcrConfig(det_imgsz=960, dtype="float32"),
                         captioner=CaptionerConfig(dtype="float32"),
                         detector_weights=None, ocr_weights=None, captioner_weights=None)
    dims = FlorenceDims(depths=(1, 1, 2, 1), encoder_layers=2, decoder_layers=2)
    pipe = SOMPipeline(cfg, device=cards[0], captioner_dims=dims, seed=seed)
    with torch.no_grad():
        for i in range(3):
            getattr(pipe.det_module.head, f"cls{i}_2").weight.mul_(20.0)
    images = [c.synthetic_screenshot(np.random.default_rng(seed + 41 + i), 540, 960)
              for i in range(4)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        single = [pipe.parse_image(img) for img in images]
        for dp, tp in ((4, 1), (2, 2)):
            got = ShardedParse(pipe, make_mesh(cards, dp=dp, tp=tp)).parse_images(images)
            strict = [c.same_elements(g[2], s[2], 1e-4) for g, s in zip(got, single)]
            c.emit("mesh_cards", check=f"ShardedParse ({dp}, {tp}) over distinct cards "
                   "against parse_image on one, float32, TF32 off",
                   elements=[len(g[2]) for g in got],
                   captions=sum(e["source"] == "box_yolo_content_yolo" for g in got
                                for e in g[2]),
                   against_parse_image=[c.element_diffs(g[2], s[2])
                                        for g, s in zip(got, single)])
            for bad, flips in strict:
                if bad or flips:
                    c.fail(f"mesh_cards: ShardedParse ({dp}, {tp}): {bad}, {flips} captions")
    ctx = pipe._stage_upload(images[0])
    ctx["ocr_fut"] = pipe.ocr.dispatch_det(ctx["padded_dev"], (ctx["uh"], ctx["uw"]))
    crops = pipe._stage_dispatch(ctx, None, None)
    want, _ = pipe.captioner.generate(crops)
    got, _ = ShardedCaptioner(pipe.captioner, make_mesh(cards, dp=2, tp=2)).generate(crops)
    rows = int((got != want).any(dim=1).sum())
    c.emit("mesh_cards", check="ShardedCaptioner (2, 2) over distinct cards, float32",
           crops=list(crops.shape), token_rows_differing=rows)
    if rows:
        c.fail(f"mesh_cards: ShardedCaptioner's tokens differ in {rows} rows")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True


def full(seed: int, cards) -> None:
    from omniparser_tpu_torch.config import PipelineConfig
    from omniparser_tpu_torch.parallel.mesh import make_mesh
    from omniparser_tpu_torch.parallel.sharded_parse import ShardedParse
    from omniparser_tpu_torch.pipeline import SOMPipeline

    cfg = PipelineConfig(detector_weights=None, ocr_weights=None, captioner_weights=None)
    pipe = SOMPipeline(cfg, device=cards[0], seed=seed)
    images = [c.synthetic_screenshot(np.random.default_rng(seed + 21 + i)) for i in range(4)]
    n = len(images)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        single = [pipe.parse_image(img) for img in images]
        pipe.parse_batch(images)
        batch_ms = [_wall(lambda: pipe.parse_batch(images))[1] for _ in range(3)]
        c.emit("mesh_cards", check="parse_batch of four on one card",
               wall_ms=[round(x, 2) for x in batch_ms],
               screenshots_per_s=[round(n / x * 1e3, 3) for x in batch_ms])
        for dp, tp in ((4, 1), (2, 2)):
            sp = ShardedParse(pipe, make_mesh(cards, dp=dp, tp=tp))
            sp.parse_images(images)  # warm-up on every card
            c.reset_counts()
            got, _ = _wall(lambda: sp.parse_images(images))
            counts = c.all_counts()
            walls = [_wall(lambda: sp.parse_images(images))[1] for _ in range(3)]
            c.check_elements(f"mesh_cards ({dp}, {tp})", got)
            c.emit("mesh_cards", check=f"ShardedParse ({dp}, {tp}) over distinct cards, "
                   "bfloat16, default widths", launches=counts,
                   wall_ms=[round(x, 2) for x in walls],
                   screenshots_per_s=[round(n / x * 1e3, 3) for x in walls],
                   against_parse_image=[c.element_diffs(g[2], s[2])
                                        for g, s in zip(got, single)],
                   max_memory_allocated={str(d): torch.cuda.max_memory_allocated(d)
                                         for d in cards})
            if counts["nms_keep"] != n or counts["merge_masks"] != n:
                c.fail(f"mesh_cards: ShardedParse ({dp}, {tp}) launched {counts}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        c.fail("this script needs four CUDA devices")
    cards = [torch.device("cuda", i) for i in range(4)]
    c.phase_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    c.phase_build()
    parity(args.seed, cards)
    full(args.seed, cards)
    from omniparser_tpu_torch.parallel.mesh import make_mesh

    c.mesh_train(args.seed, mesh=make_mesh(cards, dp=2, tp=2))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
