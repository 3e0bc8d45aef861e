"""Standalone demo of the PyTorch/CUDA port (the counterpart of demo.py).

Parses screenshots with ``omniparser_tpu_torch.SOMPipeline`` and writes, for
each, the SOM overlay (``<stem>_som.png``) and the element table
(``<stem>_elements.json``).  The reference demo's knobs: box threshold
0.05 and overlap IoU 0.1 (set on the config here).  Runs on the card;
``--device cpu`` runs on the CPU:

    python examples/demo_torch.py imgs/*.png --out demo_out --box_threshold 0.05
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None, pipeline=None):
    """Parse the images named in `argv`; `pipeline` (a SOMPipeline) replaces
    the one built from the default config and the threshold arguments."""
    ap = argparse.ArgumentParser("omniparser_tpu_torch demo")
    ap.add_argument("images", nargs="+")
    ap.add_argument("--out", default=os.path.join(ROOT, "demo_out"))
    ap.add_argument("--box_threshold", type=float, default=0.05)
    ap.add_argument("--iou_threshold", type=float, default=0.1)
    ap.add_argument("--ocr_backend", default="jax")  # the port's device OCR keeps this name
    ap.add_argument("--no_captions", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import cv2

    from omniparser_tpu_torch.config import PipelineConfig
    from omniparser_tpu_torch.pipeline import SOMPipeline
    from omniparser_tpu_torch.utils.image import load_image_rgb

    if pipeline is None:
        base = PipelineConfig()
        cfg = dataclasses.replace(
            base, iou_threshold=args.iou_threshold,
            detector=dataclasses.replace(base.detector, box_threshold=args.box_threshold),
            ocr=dataclasses.replace(base.ocr, backend=args.ocr_backend),
            captioner=dataclasses.replace(
                base.captioner, backend="null" if args.no_captions else "florence"))
        pipeline = SOMPipeline(cfg, device=args.device)
    os.makedirs(args.out, exist_ok=True)

    images = [load_image_rgb(p) for p in args.images]
    t0 = time.perf_counter()
    results = pipeline.parse_batch(images)
    wall = time.perf_counter() - t0
    print(f"parsed {len(images)} screenshots in {wall:.2f}s "
          f"({len(images) / wall:.2f} shots/sec)")

    for path, (annotated, _, elements) in zip(args.images, results):
        stem = os.path.splitext(os.path.basename(path))[0]
        cv2.imwrite(os.path.join(args.out, f"{stem}_som.png"),
                    cv2.cvtColor(annotated, cv2.COLOR_RGB2BGR))
        with open(os.path.join(args.out, f"{stem}_elements.json"), "w") as f:
            json.dump(elements, f, indent=2)
        print(f"\n{path}: {len(elements)} elements")
        for line in pipeline.content_lines(elements)[:10]:
            print("  " + line)
        if len(elements) > 10:
            print(f"  ... ({len(elements) - 10} more)")
    print(f"\noutputs in {args.out}/")
    return results


if __name__ == "__main__":
    main()
