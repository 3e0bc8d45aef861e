"""From-scratch icon-detector training on synthetic GUI scenes.

Trains YOLOv8-n with one class (``models/yolov8.YOLOv8``) on procedurally
rendered screens (``train/synth_gui.render_gui_scene``) with the
fixed-shape ``detection_loss`` (``train/losses.py``: BCE + CIoU + DFL,
center-inside assigner), as the JAX package's trainer does: scenes are
rendered once into host memory (cached in the temporary directory), each
step uploads a sampled batch, and per-batch variety comes from photometric
augmentation on the device.  The optimiser is optax's chain
``clip_by_global_norm(5) -> adamw(cosine(lr, steps, alpha=0.05), wd=1e-4)``
(``train/optim.py``); the network starts from flax's default initialiser
and runs under bfloat16 autocast with float32 parameters.

Rendering needs a TTF face on the machine (``synth_text.require_fonts``);
``train_detector(..., data=(images, boxes, mask))`` trains on given arrays.

CLI:
    python -m omniparser_tpu_torch.train.train_detector --steps 3000 \\
        --out omniparser_tpu_torch/weights/exported/det_synth.npz
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from omniparser_tpu_torch.models.yolov8 import YOLOv8, Detector
from omniparser_tpu_torch.train.losses import detection_loss
from omniparser_tpu_torch.train.optim import AdamW, cosine_decay_schedule
from omniparser_tpu_torch.pipeline import EXPORT_DIR
from omniparser_tpu_torch.train.train_step import compute_autocast
from omniparser_tpu_torch.utils.device import resolve_device
from omniparser_tpu_torch.weights.init import flax_init_

IMGSZ = 640
MAX_GT = 64


# ------------------------------ dataset ------------------------------ #


def build_det_dataset(n: int, seed: int, cache: bool = True):
    """(images [n,640,640,3] u8, gt_boxes [n,M,4] normalised xyxy f32,
    gt_mask [n,M] bool).  Rendering is single-core-bound (about 0.3 s a
    scene); cached in the temporary directory for retraining."""
    from omniparser_tpu_torch.train.synth_gui import DATA_VERSION, render_gui_scene

    cache_path = os.path.join(tempfile.gettempdir(),
                              f"det_gui_data_s{seed}_n{n}_{IMGSZ}_v{DATA_VERSION}.npz")
    if cache and os.path.exists(cache_path):
        z = np.load(cache_path)
        return z["images"], z["boxes"], z["mask"]
    rng = np.random.default_rng(seed)
    images = np.zeros((n, IMGSZ, IMGSZ, 3), np.uint8)
    boxes = np.zeros((n, MAX_GT, 4), np.float32)
    mask = np.zeros((n, MAX_GT), bool)
    t0 = time.time()
    for i in range(n):
        img, icons, _tb, _tx = render_gui_scene(rng, size=IMGSZ, max_icons=MAX_GT - 8)
        images[i] = img
        k = min(len(icons), MAX_GT)
        if k:
            boxes[i, :k] = np.asarray(icons[:k], np.float32) / IMGSZ
            mask[i, :k] = True
        if i % 200 == 199:
            print(f"  rendered {i + 1}/{n} ({time.time() - t0:.0f}s)", flush=True)
    if cache:
        np.savez_compressed(cache_path, images=images, boxes=boxes, mask=mask)
    return images, boxes, mask


# ------------------------------ training ------------------------------ #


def augment_draws(generator: torch.Generator, shape) -> Dict[str, torch.Tensor]:
    """The random numbers of one ``_augment`` call for images [B,H,W,3],
    drawn on the generator's device: brightness U(-0.12, 0.12), contrast
    U(0.8, 1.2) per image, noise N(0, 0.015) per value."""
    b, dev = shape[0], generator.device
    u = lambda lo, hi: torch.rand((b, 1, 1, 1), generator=generator, device=dev) * (hi - lo) + lo
    bright = u(-0.12, 0.12)
    contr = u(0.8, 1.2)
    noise = torch.randn(tuple(shape), generator=generator, device=dev) * 0.015
    return {"bright": bright, "contr": contr, "noise": noise}


def apply_augment(imgs_f: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.clamp((imgs_f - 0.5) * draws["contr"] + 0.5 + draws["bright"]
                       + draws["noise"], 0.0, 1.0)


def _augment(generator: torch.Generator, imgs_f: torch.Tensor) -> torch.Tensor:
    """Photometric augmentation on the device: brightness and contrast
    jitter plus noise; images [B,H,W,3] floats in [0,1]."""
    return apply_augment(imgs_f, augment_draws(generator, imgs_f.shape))


def make_detector_trainer(steps: int, seed: int, lr: float = 2e-3, device="cuda",
                          module: Optional[YOLOv8] = None) -> Tuple[YOLOv8, AdamW]:
    """YOLOv8-n (one class) initialised from a generator seeded `seed` on
    the device (or the given `module`), and its optimiser."""
    dev = resolve_device(device)
    if module is None:
        with torch.device(dev):
            module = flax_init_(Detector(variant="n", num_classes=1, imgsz=IMGSZ).make_module(),
                                torch.Generator(dev).manual_seed(seed))
    opt = AdamW(module.parameters(), cosine_decay_schedule(lr, steps, alpha=0.05),
                weight_decay=1e-4, clip_norm=5.0)
    return module, opt


def detector_step(module: YOLOv8, opt: AdamW, imgs_u8: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_mask: torch.Tensor, draws: Optional[Dict[str, torch.Tensor]],
                  dtype: torch.dtype = torch.bfloat16, imgsz: int = IMGSZ) -> torch.Tensor:
    """One step on images [B,imgsz,imgsz,3] u8: augment (``draws``; None
    for none), forward in train mode, loss, clip + AdamW.  Returns the loss
    (a device scalar)."""
    imgs = imgs_u8.float() / 255.0
    if draws is not None:
        imgs = apply_augment(imgs, draws)
    module.train()
    opt.zero_grad()
    with compute_autocast(imgs.device, dtype):
        outs = module(imgs.permute(0, 3, 1, 2))
    loss = detection_loss(outs, gt_boxes, gt_mask, imgsz)
    loss.backward()
    opt.step()
    return loss.detach()


def train_detector(steps: int, batch: int, seed: int, dataset_size: int, lr: float = 2e-3,
                   device="cuda", dtype: torch.dtype = torch.bfloat16, data=None,
                   on_step: Optional[Callable[[int, torch.Tensor], None]] = None) -> YOLOv8:
    """Train and return the detector (in eval mode).  `data`: (images
    [n,S,S,3] u8, boxes, mask) numpy arrays to train on (at their size S)
    instead of rendering `dataset_size` scenes at IMGSZ; `on_step(step,
    loss)` is called after every step with the loss as a device scalar."""
    dev = resolve_device(device)
    images, gt_boxes, gt_mask = data if data is not None else build_det_dataset(
        dataset_size, seed)
    module, opt = make_detector_trainer(steps, seed, lr, dev)
    n, imgsz = len(images), images.shape[1]
    rng = np.random.default_rng(seed + 1)  # the JAX trainer's index stream
    t0 = time.time()
    for s in range(steps):
        idx = rng.integers(0, n, batch)
        gen = torch.Generator(dev).manual_seed(int(rng.integers(1 << 31)))
        imgs = torch.from_numpy(images[idx]).to(dev)
        loss = detector_step(module, opt, imgs, torch.from_numpy(gt_boxes[idx]).to(dev),
                             torch.from_numpy(gt_mask[idx]).to(dev),
                             augment_draws(gen, imgs.shape), dtype, imgsz)
        if on_step is not None:
            on_step(s, loss)
        if s % 200 == 0 or s == steps - 1:
            print(f"  step {s}: loss {float(loss):.4f} ({time.time() - t0:.0f}s)", flush=True)
    return module.eval()


# ------------------------------ evaluation ------------------------------ #


def evaluate_detector(module: YOLOv8, n_scenes: int = 32, seed: int = 9999,
                      conf: float = 0.3, nms_iou: float = 0.1, iou_thr: float = 0.5,
                      device="cuda") -> Dict[str, float]:
    """Greedy-match detections to GT at IoU >= iou_thr on held-out scenes,
    through ``Detector.detect_graph`` (K1's NMS on the card), the network
    in float32."""
    from omniparser_tpu_torch.train.synth_gui import render_gui_scene

    dev = resolve_device(device)
    det = Detector(variant="n", num_classes=1, imgsz=IMGSZ, max_det=256)
    module = module.eval()
    rng = np.random.default_rng(seed)
    tp = fp = fn = 0
    for _ in range(n_scenes):
        img, icons, _tb, _tx = render_gui_scene(rng, size=IMGSZ)
        gt = np.asarray(icons, np.float32).reshape(-1, 4)
        boxes, _scores, valid = det.detect_graph(
            module, torch.from_numpy(img.copy()).to(dev), (IMGSZ, IMGSZ), conf, nms_iou)
        pred = boxes.cpu().numpy()[valid.cpu().numpy()] * IMGSZ
        used = np.zeros(len(gt), bool)
        for p in pred:
            if len(gt) == 0:
                fp += 1
                continue
            ix1 = np.maximum(p[0], gt[:, 0]); iy1 = np.maximum(p[1], gt[:, 1])
            ix2 = np.minimum(p[2], gt[:, 2]); iy2 = np.minimum(p[3], gt[:, 3])
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
            ap = (p[2] - p[0]) * (p[3] - p[1])
            ag = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
            iou = inter / (ap + ag - inter + 1e-9)
            iou[used] = 0.0
            j = int(np.argmax(iou))
            if iou[j] >= iou_thr:
                tp += 1
                used[j] = True
            else:
                fp += 1
        fn += int((~used).sum())
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return {"precision": round(prec, 4), "recall": round(rec, 4),
            "f1": round(2 * prec * rec / max(prec + rec, 1e-9), 4),
            "tp": tp, "fp": fp, "fn": fn}


def main(argv=None):
    p = argparse.ArgumentParser("train the icon detector on synthetic GUIs")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--data", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(EXPORT_DIR, "det_synth.npz"))
    args = p.parse_args(argv)

    from omniparser_tpu_torch.weights.checkpoints import save_checkpoint

    module = train_detector(args.steps, args.batch, args.seed, args.data, device=args.device)
    report = evaluate_detector(module, device=args.device)
    print("det eval:", report, flush=True)
    path = save_checkpoint(args.out, {"det": module})
    with open(path[:-4] + ".eval.json", "w") as f:
        json.dump(report, f)
    print(f"saved {path}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
