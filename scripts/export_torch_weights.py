#!/usr/bin/env python3
"""Export the shipped orbax checkpoints to flat .npz files for the
PyTorch/CUDA package.

    python scripts/export_torch_weights.py [--out DIR]

Reads ``omniparser_tpu/weights/{det_synth,ocr_en_synth,cap_synth}`` through
the JAX package and writes
``det_synth.npz``, ``ocr_en_synth.npz`` and ``cap_synth.npz`` with keys
``det/params/...``, ``rec/batch_stats/...``, ``cap/params/...`` (and the
captioner's ``__dims__`` JSON).  The default directory,
``omniparser_tpu_torch/weights/exported/``, is git-ignored: exported files
are never committed.  ``omniparser_tpu_torch.SOMPipeline`` loads one given
as a weight field's path and converts it with
``omniparser_tpu_torch/weights/convert.py``; its 'auto' fields read the same
trees directly, without JAX (``weights/orbax_read.py``).

It also copies this machine's TTF faces (``/usr/share/fonts`` and
matplotlib's, as ``train/synth_text.glob_fonts`` finds them) into
``fonts/`` beside the weights, with a ``fonts.json`` of each face's order,
repeat weight, banned characters and half (``system/`` or
``matplotlib/``), so that a machine with no face renders from the same
set (``synth_text.carried_fonts``): the same scenes where its Pillow lays
text out as this machine's does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "omniparser_tpu_torch", "weights",
                                                  "exported"))
    args = ap.parse_args()

    from omniparser_tpu_torch.train.synth_text import carry_fonts

    fonts = carry_fonts(os.path.join(args.out, "fonts"))
    print("fonts", len(fonts), "faces,", sum(e[1] for e in fonts), "entries with repeats")

    import jax

    jax.config.update("jax_platforms", "cpu")
    from omniparser_tpu.config import CaptionerConfig, DetectorConfig, OcrConfig
    from omniparser_tpu.models.florence2 import FlorenceCaptioner, default_captioner_weights
    from omniparser_tpu.models.ocr import JaxOCR, default_ocr_weights
    from omniparser_tpu.models.yolov8 import Detector, default_detector_weights
    from omniparser_tpu.weights.checkpoints import load_checkpoint
    from omniparser_tpu_torch.weights.convert import flatten_variables as _flat

    os.makedirs(args.out, exist_ok=True)
    to_np = lambda t: jax.tree.map(np.asarray, t)

    det = Detector()
    like = {"det": to_np(det.init_params(jax.random.PRNGKey(0)))}
    tree = load_checkpoint(default_detector_weights(DetectorConfig()), like=like)
    np.savez(os.path.join(args.out, "det_synth.npz"), **_flat(to_np(tree)))

    ocr_cfg = OcrConfig()
    ocr = JaxOCR(ocr_cfg, weights=default_ocr_weights(ocr_cfg))
    np.savez(os.path.join(args.out, "ocr_en_synth.npz"),
             **_flat({"det": to_np(ocr.det_params), "rec": to_np(ocr.rec_params)}))

    cap_dir = default_captioner_weights()
    cap = FlorenceCaptioner.from_synth_checkpoint(cap_dir, CaptionerConfig())
    with open(os.path.join(cap_dir, "dims.json")) as f:
        dims = json.load(f)
    dims.setdefault("patch_prenorm", [False, False, False, False])
    np.savez(os.path.join(args.out, "cap_synth.npz"), __dims__=np.asarray(json.dumps(dims)),
             **_flat({"cap": to_np(cap.params)}))
    for name in sorted(os.listdir(args.out)):
        print(name, os.path.getsize(os.path.join(args.out, name)))


if __name__ == "__main__":
    main()
