"""ScreenSpot-Pro grounding adapter over the port's pipeline (a copy of
the JAX package's ``eval/screenspot.py``).

The reference's model wrapper for the SS-Pro repo: parse the screenshot,
reformat the elements to pseudo-HTML, prompt an LLM with the raw and the
SOM images, read back `Click BBox ID: <id>`, and answer with that box's
centroid.  Also an offline runner that scores a JSONL dataset the way the
reference's shipped log is scored (point-in-gt-bbox correctness).
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional

import numpy as np

from omniparser_tpu_torch.utils.image import encode_image_base64, load_image_rgb

GROUNDING_PROMPT = """In this UI screenshot, I want to perform the command '{instruction}'.
Please provide the ids of the element you want to operates. The screen elements are:
{screen_info}
First give reasons, then output the id in the last line with the format:
```Click BBox ID: <id>```"""


def reformat_messages(elements: List[Dict]) -> str:
    """Element list -> pseudo-HTML lines (ss_pro_gpt4o_omniv2.py:53-63)."""
    lines = []
    for i, e in enumerate(elements):
        tag = "p" if e["type"] == "text" else "img"
        lines.append(f"<{tag} id={i} class=\"{e['type']}\" alt=\"{e['content']}\"> </{tag}>")
    return "\n".join(lines)


def extract_bbox_id(response: str) -> Optional[int]:
    """Parse 'Click BBox ID: <id>' from the tail of the response
    (ss_pro_gpt4o_omniv2.py:196-207 — tolerant, last match wins)."""
    matches = re.findall(r"Click BBox ID:\s*`?(\d+)", response)
    return int(matches[-1]) if matches else None


class ScreenSpotModel:
    """`GPT4XModel`-shaped adapter: the port's parse + a pluggable LLM."""

    def __init__(self, pipeline, llm_client: Callable):
        self.pipeline = pipeline
        self.llm = llm_client

    def ground_only_positive(self, instruction: str, image) -> Dict:
        if isinstance(image, str):
            image_rgb = load_image_rgb(image)
        else:
            image_rgb = np.asarray(image)
        h, w = image_rgb.shape[:2]
        annotated, label_coords, elements = self.pipeline.parse_image(image_rgb)
        screen_info = reformat_messages(elements)
        prompt = GROUNDING_PROMPT.format(instruction=instruction, screen_info=screen_info)

        messages = [
            {
                "role": "user",
                "content": [
                    {"type": "text", "text": prompt},
                    {"type": "image",
                     "source": {"type": "base64", "media_type": "image/png",
                                "data": encode_image_base64(image_rgb)}},
                    {"type": "image",
                     "source": {"type": "base64", "media_type": "image/png",
                                "data": encode_image_base64(annotated)}},
                ],
            }
        ]
        response, _ = self.llm(messages, system="You are an expert at GUI grounding.")
        box_id = extract_bbox_id(response)

        point = None
        bbox = None
        if box_id is not None and str(box_id) in {str(i) for i in range(len(elements))}:
            x, y, bw, bh = label_coords[str(box_id)]
            # label_coords are ratio xywh when output_coord_in_ratio
            point = [x + bw / 2, y + bh / 2]
            bbox = [x, y, x + bw, y + bh]
        return {
            "result": "positive",
            "format": "x1y1x2y2",
            "raw_response": response,
            "bbox": bbox,
            "point": point,
        }


def _point_in_box(pred, gt_bbox) -> bool:
    """The single correctness rule (shared by scorer + log writer)."""
    if pred is None:
        return False
    x, y = pred
    x1, y1, x2, y2 = gt_bbox
    return x1 <= x <= x2 and y1 <= y <= y2


def wilson_ci(k: int, n: int, z: float = 1.96):
    """95% Wilson score interval for a binomial proportion: honest bounds
    at small n."""
    if n == 0:
        return [0.0, 1.0]
    p = k / n
    d = 1 + z * z / n
    center = (p + z * z / (2 * n)) / d
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / d
    return [float(max(center - half, 0.0)), float(min(center + half, 1.0))]


def _size_bucket(px: float) -> str:
    """Target side length -> bucket (thresholds roughly matching small UI
    chrome / normal controls / large widgets)."""
    if px < 24:
        return "small"
    if px < 64:
        return "medium"
    return "large"


def score_records(records: List[Dict]) -> Dict:
    """Accuracy by group (the reference log's schema: pred point in gt
    bbox => correct).  Record: {'pred': [x,y] ratio or px, 'gt_bbox':
    [x1,y1,x2,y2], 'group': str, optional 'size_px': float}.

    Returns flat per-group accuracies (back-compat) plus 'groups' rows
    with n + 95% Wilson CIs, and 'by_size' rows (group x size bucket)
    when records carry size_px."""
    by_group: Dict[str, List[bool]] = {}
    by_size: Dict[str, List[bool]] = {}
    for r in records:
        ok = _point_in_box(r.get("pred"), r["gt_bbox"])
        g = r.get("group", "all")
        by_group.setdefault(g, []).append(ok)
        if r.get("size_px") is not None:
            by_size.setdefault(f"{g}/{_size_bucket(r['size_px'])}",
                               []).append(ok)
    out = {g: float(np.mean(v)) for g, v in by_group.items()}
    total = [ok for v in by_group.values() for ok in v]
    out["overall"] = float(np.mean(total)) if total else 0.0
    out["n"] = len(total)
    out["overall_ci95"] = wilson_ci(int(np.sum(total)), len(total))
    out["groups"] = {
        g: {"acc": float(np.mean(v)), "n": len(v),
            "ci95": wilson_ci(int(np.sum(v)), len(v))}
        for g, v in by_group.items()
    }
    if by_size:
        out["by_size"] = {
            g: {"acc": float(np.mean(v)), "n": len(v),
                "ci95": wilson_ci(int(np.sum(v)), len(v))}
            for g, v in sorted(by_size.items())
        }
    return out


def run_eval(model: ScreenSpotModel, dataset: List[Dict], log_path: Optional[str] = None):
    """dataset rows: {'img_path', 'instruction', 'gt_bbox' ratio xyxy,
    'group'}.  Returns score_records output; writes a JSONL log like the
    reference's eval/logs_sspro_omniv2.json."""
    records = []
    for i, row in enumerate(dataset):
        res = model.ground_only_positive(row["instruction"], row["img_path"])
        rec = {
            # in-memory images (eval/synth_bench.py) log as placeholders
            "img_path": (row["img_path"] if isinstance(row["img_path"], str)
                         else f"<in-memory image {i}>"),
            "group": row.get("group", "all"),
            "instruction": row["instruction"],
            "pred": res["point"],
            "gt_bbox": row["gt_bbox"],
            "size_px": row.get("size_px"),
        }
        rec["correctness"] = (
            "correct" if _point_in_box(res["point"], row["gt_bbox"]) else "wrong"
        )
        records.append(rec)
    if log_path:
        with open(log_path, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    return score_records(records)
