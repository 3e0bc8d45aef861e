"""From-scratch OCR training on synthetic GUI text.

Trains the two OCR networks of ``models/ocr.py`` on data from
``train/synth_text.py``, as the JAX package's trainer does:
``TextRecognizer`` with CTC over rendered line crops, and ``TextDetector``
(DBNet-style shrink maps) over rendered screenshots.  The recogniser's
crops go through the inference path's crop geometry
(``synth_text.crops_from_buffers``: K3's line grid on the card), so
training and serving see the same crops.

Datasets are made once and kept resident on the device; each step samples
its indices there from a device generator and augments there
(brightness, contrast, inversion, noise), so no step uploads data.  The
optimiser is optax's ``clip_by_global_norm(1) -> adamw(warmup-cosine,
wd=1e-4)`` (``train/optim.py``); the networks start from flax's default
initialiser and run under bfloat16 autocast with float32 parameters.

Rendering needs a TTF face on the machine; ``train_recognizer(...,
data=(crops, labels))`` and ``train_detector(..., data=(screens, maps))``
train on given arrays.

CLI:
    python -m omniparser_tpu_torch.train.train_ocr --rec-steps 4000 \\
        --det-steps 1500 --out omniparser_tpu_torch/weights/exported/ocr_en_synth.npz
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from omniparser_tpu_torch.models.ocr import (TextDetector, TextRecognizer, ctc_greedy_decode,
                                             extract_text_boxes)
from omniparser_tpu_torch.train.data import (
    apply_augment,
    augment_draws,
    make_step_runner,
    run_logged,
)
from omniparser_tpu_torch.train.ocr_losses import balanced_bce_dice_loss, ctc_loss
from omniparser_tpu_torch.train.optim import AdamW, warmup_cosine_decay_schedule
from omniparser_tpu_torch.train.synth_text import (
    crops_from_buffers,
    render_line_buffers,
    render_screenshot,
    shrink_map,
)
from omniparser_tpu_torch.pipeline import EXPORT_DIR
from omniparser_tpu_torch.train.train_step import compute_autocast
from omniparser_tpu_torch.utils.device import resolve_device
from omniparser_tpu_torch.weights.init import flax_init_

REC_HW = (32, 480)  # OcrConfig.rec_height / rec_max_width defaults
MAX_LABEL = 56


# ------------------------------ datasets ------------------------------ #


def build_rec_dataset(n: int, seed: int, chunk: int = 512, cache: bool = True,
                      device="cuda"):
    """(crops [n,32,480,3] u8, labels [n,56] i32): renders in chunks,
    cropped through ``crops_from_buffers`` on `device`.  Rendering is
    single-core-bound (about 20 min for 120k lines); cached in the
    temporary directory."""
    from omniparser_tpu_torch.train.synth_gui import DATA_VERSION

    cache_path = os.path.join(
        tempfile.gettempdir(), f"ocr_rec_data_s{seed}_n{n}_{REC_HW[1]}_v{2 + DATA_VERSION}.npz")
    if cache and os.path.exists(cache_path):
        z = np.load(cache_path)
        return z["crops"], z["labels"]
    rng = np.random.default_rng(seed)
    crops = np.zeros((n, *REC_HW, 3), np.uint8)
    labels = np.zeros((n, MAX_LABEL), np.int32)
    t0 = time.time()
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        bufs, hws, lab, _ = render_line_buffers(rng, e - s, MAX_LABEL)
        crops[s:e] = crops_from_buffers(bufs, hws, REC_HW, device)
        labels[s:e] = lab
        if s and s % (chunk * 16) == 0:
            print(f"  rec data {e}/{n} ({time.time() - t0:.0f}s)", flush=True)
    if cache:
        np.savez(cache_path, crops=crops, labels=labels)
    return crops, labels


def build_det_dataset(n: int, seed: int, size: int = 640, cache: bool = True):
    """(screens [n,S,S,3] u8, maps [n,S/2,S/2] u8 {0,1}).  30% of screens
    are rendered at 1.5-2x and downscaled (the letterbox shrink a
    high-resolution screenshot sees), 25% rendered small and upscaled; half
    are coloured GUI scenes (``synth_gui``), half grey text screens."""
    import cv2

    from omniparser_tpu_torch.train.synth_gui import DATA_VERSION, render_gui_scene

    cache_path = os.path.join(tempfile.gettempdir(),
                              f"ocr_det_data_s{seed}_n{n}_v{3 + DATA_VERSION}.npz")
    if cache and os.path.exists(cache_path):
        z = np.load(cache_path)
        return z["screens"], z["maps"]
    rng = np.random.default_rng(seed)
    screens = np.zeros((n, size, size, 3), np.uint8)
    maps = np.zeros((n, size // 2, size // 2), np.uint8)
    t0 = time.time()
    for i in range(n):
        def render(sz):
            if rng.random() < 0.5:  # coloured GUI scene; icons are negatives
                img, _icons, tboxes, _texts = render_gui_scene(rng, size=sz, max_texts=28)
                return img, tboxes
            img, boxes, _ = render_screenshot(rng, sz)
            return img, boxes

        roll = rng.random()
        if roll < 0.3:
            big = int(size * rng.uniform(1.5, 2.0))
            img, boxes = render(big)
            s = size / big
            img = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
            boxes = [[int(v * s) for v in b] for b in boxes]
        elif roll < 0.55:
            small = int(size * rng.uniform(0.45, 0.8))
            img, boxes = render(small)
            s = size / small
            img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
            boxes = [[int(v * s) for v in b] for b in boxes]
        else:
            img, boxes = render(size)
        screens[i] = img
        maps[i] = shrink_map(boxes, size)
        if i and i % 200 == 0:
            print(f"  det data {i}/{n} ({time.time() - t0:.0f}s)", flush=True)
    if cache:
        np.savez(cache_path, screens=screens, maps=maps)
    return screens, maps


# ------------------------------ augmentation ------------------------------ #


def _augment(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Per-sample photometric jitter on [B,H,W,3] floats in [0,1]."""
    return apply_augment(x, augment_draws(generator, x.shape))


# ------------------------------ the step ------------------------------ #


def ocr_step(module: torch.nn.Module, opt: AdamW, loss_for: Callable, x: torch.Tensor,
             y: torch.Tensor, draws: Optional[Dict[str, torch.Tensor]],
             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One step: augment (``draws``; None for none), forward in train
    mode (NHWC in, as the JAX modules take it), ``loss_for(out, y)``, clip
    + AdamW.  Returns the loss (a device scalar)."""
    if draws is not None:
        x = apply_augment(x, draws)
    module.train()
    opt.zero_grad()
    with compute_autocast(x.device, dtype):
        out = module(x.permute(0, 3, 1, 2))
    loss = loss_for(out, y)
    loss.backward()
    opt.step()
    return loss.detach()


def make_recognizer_trainer(steps: int, seed: int, lr: float = 1e-3, device="cuda",
                            module: Optional[TextRecognizer] = None):
    """``TextRecognizer()`` initialised from a generator seeded `seed` on
    the device (or the given `module`), and its optimiser (warm-up
    min(300, steps/2))."""
    dev = resolve_device(device)
    rec = module
    if rec is None:
        with torch.device(dev):
            rec = flax_init_(TextRecognizer(seq_len=REC_HW[1] // 4),
                             torch.Generator(dev).manual_seed(seed))
    warmup = min(300, steps // 2)
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.01)
    return rec, AdamW(rec.parameters(), sched, weight_decay=1e-4, clip_norm=1.0)


def gather_lines(data, idx):
    return data[0][idx].float() / 255.0, data[1][idx]


def train_recognizer(steps: int = 4000, batch: int = 256, lr: float = 1e-3, seed: int = 0,
                     dataset_size: int = 120_000, log_every: int = 200, device="cuda",
                     dtype: torch.dtype = torch.bfloat16, data=None,
                     on_step: Optional[Callable[[int, torch.Tensor], None]] = None
                     ) -> TextRecognizer:
    """Train and return the recogniser (eval mode).  `data`: (crops
    [n,32,480,3] u8, labels [n,56]) to train on instead of rendering."""
    dev = resolve_device(device)
    rec, opt = make_recognizer_trainer(steps, seed, lr, dev)
    if data is None:
        print(f"rec: generating {dataset_size} lines ...", flush=True)
        data = build_rec_dataset(dataset_size, seed + 1, device=dev)
    print("rec: training ...", flush=True)
    data_dev = (torch.from_numpy(data[0]).to(dev), torch.from_numpy(data[1]).to(dev))
    run = make_step_runner(
        lambda x, y, draws: ocr_step(rec, opt, ctc_loss, x, y, draws, dtype), batch, data_dev,
        gather_lines, torch.Generator(dev).manual_seed(seed + 3), on_step)
    run_logged(run, steps, log_every, "rec")
    return rec.eval()


def evaluate_recognizer(rec: TextRecognizer, n: int = 512, seed: int = 9000,
                        device="cuda") -> Dict[str, float]:
    """Held-out exact match, character error rate and mean confidence."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bufs, hws, _, texts = render_line_buffers(rng, n, MAX_LABEL)
    crops = crops_from_buffers(bufs, hws, REC_HW, dev)
    rec = rec.eval()
    exact = dist_sum = len_sum = 0
    confs = []
    for s in range(0, n, 128):
        x = torch.from_numpy(crops[s:s + 128]).to(dev).float() / 255.0
        with torch.no_grad():
            logits = rec(x.permute(0, 3, 1, 2)).float().cpu().numpy()
        for j in range(logits.shape[0]):
            pred, conf = ctc_greedy_decode(logits[j])
            want = texts[s + j][:MAX_LABEL]
            exact += pred == want
            dist_sum += _levenshtein(pred, want)
            len_sum += len(want)
            confs.append(conf)
    return {"exact_match": exact / n, "cer": dist_sum / max(len_sum, 1),
            "mean_conf": float(np.mean(confs)), "n": n}


def _levenshtein(a: str, b: str) -> int:
    if not a:
        return len(b)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


# ------------------------------ det training ------------------------------ #


def make_text_detector_trainer(steps: int, seed: int, lr: float = 5e-4, device="cuda",
                               module: Optional[TextDetector] = None):
    """``TextDetector()`` initialised from a generator seeded `seed` on the
    device (or the given `module`), and its optimiser (warm-up min(150,
    steps/2))."""
    dev = resolve_device(device)
    det = module
    if det is None:
        with torch.device(dev):
            det = flax_init_(TextDetector(), torch.Generator(dev).manual_seed(seed))
    warmup = min(150, steps // 2)
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.01)
    return det, AdamW(det.parameters(), sched, weight_decay=1e-4, clip_norm=1.0)


def gather_screens(data, idx):
    return data[0][idx].float() / 255.0, data[1][idx].float()


def train_detector(steps: int = 1500, batch: int = 8, lr: float = 5e-4, seed: int = 100,
                   dataset_size: int = 1500, log_every: int = 100, device="cuda",
                   dtype: torch.dtype = torch.bfloat16, data=None,
                   on_step: Optional[Callable[[int, torch.Tensor], None]] = None
                   ) -> TextDetector:
    """Train and return the text detector (eval mode).  `data`: (screens
    [n,S,S,3] u8, maps [n,S/2,S/2]) to train on instead of rendering."""
    dev = resolve_device(device)
    det, opt = make_text_detector_trainer(steps, seed, lr, dev)
    if data is None:
        print(f"det: generating {dataset_size} screenshots ...", flush=True)
        data = build_det_dataset(dataset_size, seed + 1)
    print("det: training ...", flush=True)
    data_dev = (torch.from_numpy(data[0]).to(dev), torch.from_numpy(data[1]).to(dev))
    run = make_step_runner(
        lambda x, y, draws: ocr_step(det, opt, balanced_bce_dice_loss, x, y, draws, dtype),
        batch, data_dev, gather_screens, torch.Generator(dev).manual_seed(seed + 3), on_step)
    run_logged(run, steps, log_every, "det")
    return det.eval()


def evaluate_detector(det: TextDetector, n: int = 16, seed: int = 9100,
                      device="cuda") -> Dict[str, float]:
    """Box recall and precision of the detector's postprocess (prob map ->
    components -> unclip) against GT rects at IoU 0.5."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    det = det.eval()
    tp = fp = fn_ct = 0
    for _ in range(n):
        img, gts, _ = render_screenshot(rng, 640)
        x = torch.from_numpy(img[None]).to(dev).float() / 255.0
        with torch.no_grad():
            prob = det(x.permute(0, 3, 1, 2))[0, 0].float().cpu().numpy()
        cands = [b for b, _s in extract_text_boxes(prob)]
        matched = [False] * len(cands)
        for g in gts:
            best, best_i = 0.0, -1
            for ci, c in enumerate(cands):
                if matched[ci]:
                    continue
                iou = _iou(g, c)
                if iou > best:
                    best, best_i = iou, ci
            if best >= 0.5:
                matched[best_i] = True
                tp += 1
            else:
                fn_ct += 1
        fp += matched.count(False)
    return {"recall": tp / max(tp + fn_ct, 1), "precision": tp / max(tp + fp, 1),
            "n_screens": n}


def _iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


# ------------------------------ entry point ------------------------------ #


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rec-steps", type=int, default=4000)
    p.add_argument("--det-steps", type=int, default=1500)
    p.add_argument("--rec-batch", type=int, default=256)
    p.add_argument("--det-batch", type=int, default=8)
    p.add_argument("--rec-data", type=int, default=120_000)
    p.add_argument("--det-data", type=int, default=1500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(EXPORT_DIR, "ocr_en_synth.npz"))
    p.add_argument("--skip-det", action="store_true")
    p.add_argument("--skip-rec", action="store_true")
    args = p.parse_args(argv)

    from omniparser_tpu_torch.weights.checkpoints import load_checkpoint, save_checkpoint

    report: Dict[str, Any] = {}
    if not args.skip_rec:
        rec = train_recognizer(args.rec_steps, args.rec_batch, seed=args.seed,
                               dataset_size=args.rec_data, device=args.device)
        report["rec"] = evaluate_recognizer(rec, device=args.device)
        print("rec eval:", report["rec"], flush=True)
    else:
        rec = load_checkpoint(args.out)["rec"]
    if not args.skip_det:
        det = train_detector(args.det_steps, args.det_batch, seed=args.seed + 100,
                             dataset_size=args.det_data, device=args.device)
        report["det"] = evaluate_detector(det, device=args.device)
        print("det eval:", report["det"], flush=True)
    else:
        det = load_checkpoint(args.out)["det"]

    path = save_checkpoint(args.out, {"det": det, "rec": rec})
    print(f"saved {path}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
