"""Synthetic grounding benchmark over the port's pipeline: the
ScreenSpot-Pro loop without the dataset or a paid LLM (a copy of the JAX
package's ``eval/synth_bench.py``).

The same eval loop as ``eval/screenspot.py`` (parse -> pseudo-HTML
screen_info -> grounding prompt -> `Click BBox ID` -> centroid-in-gt-bbox
scoring) on held-out procedural GUI scenes, with a *scripted* grounder that
matches the instruction against the screen_info alt texts.  The LLM step is
thereby deterministic and near-perfect, so the score isolates what the
parse contributes: detection, OCR, captions, element ids and coordinate
fidelity.  The scenes need TTF fonts (``train/synth_text.py``).

CLI:  python -m omniparser_tpu_torch.eval.synth_bench --scenes 6 [--device cpu]
prints one JSON line: accuracy overall and by group (text / icon).
"""

from __future__ import annotations

import argparse
import json
import re
from typing import Dict, List, Tuple

import numpy as np

from omniparser_tpu_torch.eval.screenspot import ScreenSpotModel, run_eval

_SCREEN_LINE = re.compile(
    r"<(?:p|img) id=(\d+) class=\"(\w+)\" alt=\"(.*?)\"> </(?:p|img)>")
_INSTR = re.compile(r"perform the command '(.*?)'\.\n", re.S)


class ScriptedGrounder:
    """LLM-client stand-in: picks the screen element whose alt text best
    matches the instruction target.  Replies in the exact format the
    reference prompts for (`Click BBox ID: <id>`), so the full response
    parser / label_coordinates path is exercised."""

    def __call__(self, messages, system: str = "") -> Tuple[str, Dict]:
        prompt = messages[0]["content"][0]["text"]
        m = _INSTR.search(prompt)
        instruction = m.group(1) if m else ""
        target = instruction.lower()
        for prefix in ("click the text ", "click the ", "click "):
            if target.startswith(prefix):
                target = target[len(prefix):]
                break
        target = target.strip("'\" ")

        best_id, best_score = None, 0.0
        for sid, _cls, alt in _SCREEN_LINE.findall(prompt):
            alt_l = alt.lower().strip()
            if not alt_l:
                continue
            if alt_l == target:
                score = 3.0
            elif target in alt_l or alt_l in target:
                score = 2.0
            else:  # word overlap
                tw = {w for w in target.split() if len(w) >= 3}
                aw = {w for w in alt_l.split() if len(w) >= 3}
                score = len(tw & aw) / max(len(tw), 1)
            if score > best_score:
                best_id, best_score = sid, score
        if best_id is None or best_score < 0.5:
            return "No matching element.\nClick BBox ID: -", {}
        return f"Matched by alt text.\n```Click BBox ID: {best_id}```", {}


def make_dataset(n_scenes: int, seed: int = 777100,
                 size: int = 640) -> List[Dict]:
    """Held-out scenes -> eval rows {'img_path': np image, 'instruction',
    'gt_bbox' ratio xyxy, 'group'}.  Icon targets use only glyph kinds
    that appear exactly once in their scene (unambiguous referents);
    text targets quote the rendered string."""
    from omniparser_tpu_torch.train.synth_gui import render_gui_scene
    from omniparser_tpu_torch.train.train_captioner import CAPTIONS

    rng = np.random.default_rng(seed)
    rows: List[Dict] = []
    for _ in range(n_scenes):
        img, icons, tboxes, texts, kinds = render_gui_scene(
            rng, size=size, return_kinds=True)
        # only unambiguous referents make instructions: a word that appears
        # twice in a scene cannot be grounded by text alone (the same rule
        # the icon targets use)
        lowered = [t.strip().lower() for t in texts]
        for box, text in zip(tboxes, texts):
            if len(text.strip()) < 4:
                continue
            if lowered.count(text.strip().lower()) != 1:
                continue
            rows.append({
                "img_path": img,
                "instruction": f"click the text '{text.strip()}'",
                "gt_bbox": [c / size for c in box],
                "group": "text",
                "size_px": float(min(box[2] - box[0], box[3] - box[1])),
            })
        once = {k for k in set(kinds) if kinds.count(k) == 1}
        for box, kind in zip(icons, kinds):
            if kind not in once:
                continue
            rows.append({
                "img_path": img,
                "instruction": f"click the {CAPTIONS[kind]}",
                "gt_bbox": [c / size for c in box],
                "group": "icon",
                "size_px": float(min(box[2] - box[0], box[3] - box[1])),
            })
    return rows


def run(n_scenes: int = 6, seed: int = 777100, pipeline=None, log_path=None,
        device="cuda") -> Dict:
    """Scores of `pipeline` on n_scenes held-out scenes.  The default
    pipeline is PipelineConfig()'s (weights 'auto': the committed trees) on
    `device`, with the detector at the scenes' own 640 bucket."""
    if pipeline is None:
        import dataclasses

        from omniparser_tpu_torch.config import PipelineConfig
        from omniparser_tpu_torch.pipeline import SOMPipeline

        base = PipelineConfig()
        cfg = dataclasses.replace(
            base, detector=dataclasses.replace(base.detector, default_imgsz=640))
        pipeline = SOMPipeline(cfg, device)
    model = ScreenSpotModel(pipeline, ScriptedGrounder())
    dataset = make_dataset(n_scenes, seed)
    return run_eval(model, dataset, log_path=log_path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenes", type=int, default=6)
    ap.add_argument("--seed", type=int, default=777100)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.scenes, args.seed, log_path=args.log, device=args.device)))


if __name__ == "__main__":
    main()
