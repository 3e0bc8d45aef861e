"""Agent trajectories -> training batches.

The reference's orchestrated agent writes per-step screenshots and a
trajectory.json for training-data pipelines
(vlm_agent_with_orchestrator.py:129-133, 273-285) but ships no consumer.
Here trajectory directories become detector fine-tune batches (screenshot
and element boxes as weak labels) and captioner fine-tune pairs (icon
crops and content strings) for ``train/train_step.py``.  The batches are
numpy, in the JAX package's layout (images NHWC in [0, 1]).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np


def iter_steps(traj_dir: str) -> Iterator[Dict]:
    """Yield {'step', 'image' (RGB), 'elements', 'action'} per logged step."""
    from omniparser_tpu_torch.utils.image import load_image_rgb

    traj_path = os.path.join(traj_dir, "trajectory.json")
    lines = []
    if os.path.exists(traj_path):
        with open(traj_path) as f:
            lines = [json.loads(l) for l in f if l.strip()]
    by_step = {rec["step"]: rec for rec in lines}

    step = 0
    while True:
        raw = os.path.join(traj_dir, f"step{step}_raw.png")
        elems = os.path.join(traj_dir, f"step{step}_elements.json")
        if not os.path.exists(raw):
            break
        elements = []
        if os.path.exists(elems):
            with open(elems) as f:
                elements = json.load(f)
        out = {
            "step": step,
            "image": load_image_rgb(raw),
            "elements": elements,
            "action": by_step.get(step, {}).get("action"),
        }
        yield out
        step += 1


def detection_examples(traj_dirs: Sequence[str]) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(image RGB, icon boxes [N, 4] normalized xyxy) weak-label pairs."""
    for d in traj_dirs:
        for step in iter_steps(d):
            boxes = [e["bbox"] for e in step["elements"] if e["type"] == "icon"]
            if boxes:
                yield step["image"], np.asarray(boxes, np.float32)


def caption_examples(
    traj_dirs: Sequence[str], crop_size: int = 64
) -> Iterator[Tuple[np.ndarray, str]]:
    """(icon crop [S, S, 3] uint8, content string) pairs for captioner
    fine-tuning (crop semantics match util/utils.py:87-93)."""
    import cv2

    for d in traj_dirs:
        for step in iter_steps(d):
            img = step["image"]
            h, w = img.shape[:2]
            for e in step["elements"]:
                if e["type"] != "icon" or not e.get("content"):
                    continue
                x1, y1 = int(e["bbox"][0] * w), int(e["bbox"][1] * h)
                x2, y2 = int(e["bbox"][2] * w), int(e["bbox"][3] * h)
                if x2 - x1 < 2 or y2 - y1 < 2:
                    continue
                crop = cv2.resize(img[y1:y2, x1:x2], (crop_size, crop_size))
                yield crop, e["content"]


def make_detection_batch(
    examples: Sequence[Tuple[np.ndarray, np.ndarray]],
    imgsz: int,
    max_gt: int = 32,
) -> Dict[str, np.ndarray]:
    """Stack (image, boxes) pairs into a train_step-compatible batch:
    letterbox-free resize (detector trains on square inputs), padded GT."""
    import cv2

    b = len(examples)
    images = np.zeros((b, imgsz, imgsz, 3), np.float32)
    gt = np.zeros((b, max_gt, 4), np.float32)
    mask = np.zeros((b, max_gt), bool)
    for i, (img, boxes) in enumerate(examples):
        images[i] = cv2.resize(img, (imgsz, imgsz)).astype(np.float32) / 255.0
        n = min(len(boxes), max_gt)
        gt[i, :n] = boxes[:n]
        mask[i, :n] = True
    return {"images": images, "gt_boxes": gt, "gt_mask": mask}


def make_caption_batch(
    examples: Sequence[Tuple[np.ndarray, str]],
    tokenizer,
    max_len: int = 20,
    pad_id: int = 1,
) -> Dict[str, np.ndarray]:
    """Stack (crop, text) pairs: crops [B, S, S, 3] float [0,1] and padded
    caption token ids [B, max_len]."""
    b = len(examples)
    s = examples[0][0].shape[0]
    crops = np.zeros((b, s, s, 3), np.float32)
    ids = np.full((b, max_len), pad_id, np.int32)
    for i, (crop, text) in enumerate(examples):
        crops[i] = crop.astype(np.float32) / 255.0
        toks = tokenizer.encode(text, add_special=True)[:max_len]
        ids[i, : len(toks)] = toks
    return {"crops": crops, "caption_ids": ids}

