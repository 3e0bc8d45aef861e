"""Real-pixels grounding benchmark over the reference's own screenshots
(a copy of the JAX package's ``eval/real_bench.py``).

The same eval loop as ``eval/synth_bench.py`` (parse -> pseudo-HTML
screen_info -> scripted grounder -> `Click BBox ID` -> centroid-in-gt
scoring) on the real screenshots of the reference repository's ``imgs/``
directory (``IMGS``, the same fixed location the JAX package reads), against
the hand-annotated targets in ``eval/real_gt.json`` (pixel boxes on the
full-resolution images).  It runs only where that directory exists.

CLI:  python -m omniparser_tpu_torch.eval.real_bench [--log out.jsonl] [--device cpu]
prints one JSON line: accuracy overall and by group (text / icon).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

from omniparser_tpu_torch.eval.screenspot import ScreenSpotModel, run_eval
from omniparser_tpu_torch.eval.synth_bench import ScriptedGrounder

_GT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "real_gt.json")
# the reference repository's screenshots (the JAX package's `_IMGS`)
IMGS = "/root/reference/imgs"


def load_dataset(gt_path: str = _GT, imgs_dir: str = IMGS) -> List[Dict]:
    """real_gt.json rows -> eval rows, their pixel boxes normalised by each
    image's true size (run_eval scores ratio coordinates).  Raises where
    `imgs_dir` does not exist; an image it lacks is left out."""
    from omniparser_tpu_torch.utils.image import load_image_rgb

    if not os.path.isdir(imgs_dir):
        raise FileNotFoundError(f"the reference screenshots are not here: {imgs_dir} "
                                "does not exist")
    with open(gt_path) as f:
        gt = json.load(f)
    rows: List[Dict] = []
    for image_name, targets in gt["images"].items():
        path = os.path.join(imgs_dir, image_name)
        if not os.path.exists(path):
            continue
        img = load_image_rgb(path)
        h, w = img.shape[:2]
        for t in targets:
            x1, y1, x2, y2 = t["gt_bbox_px"]
            rows.append({
                "img_path": img,
                "instruction": t["instruction"],
                "gt_bbox": [x1 / w, y1 / h, x2 / w, y2 / h],
                "group": t["group"],
                "image_name": image_name,
                "size_px": float(min(x2 - x1, y2 - y1)),
            })
    return rows


def run(pipeline=None, log_path=None, gt_path: str = _GT, imgs_dir: str = IMGS,
        device="cuda") -> Dict:
    """Scores of `pipeline` (default: PipelineConfig()'s on `device`)."""
    dataset = load_dataset(gt_path, imgs_dir)
    if pipeline is None:
        from omniparser_tpu_torch.config import PipelineConfig
        from omniparser_tpu_torch.pipeline import SOMPipeline

        pipeline = SOMPipeline(PipelineConfig(), device)
    return run_eval(ScreenSpotModel(pipeline, ScriptedGrounder()), dataset, log_path=log_path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(log_path=args.log, device=args.device)))


if __name__ == "__main__":
    main()
