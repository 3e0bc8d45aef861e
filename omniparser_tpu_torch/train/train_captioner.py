"""From-scratch icon-captioner training on synthetic GUI glyphs.

Trains a reduced-width Florence-2 (``SYNTH_CAP_DIMS``: the DaViT tower and
BART encoder/decoder of ``models/florence2.py``) to caption the procedural
glyph families the detector trains on (``train/synth_gui.ICON_KINDS``),
one phrase a family (``CAPTIONS``), as the JAX package's trainer does.
Crops go through the inference path's crop geometry
(``ops/preprocess.crop_resize_batch``: K3's resize grid on the card, one
96x96 tile a launch) on the glyph box with detector-style jitter, and
evaluation decodes with the same ``greedy_generate`` the parse uses.

Training: label smoothing 0.1, optax's ``clip_by_global_norm(1) ->
adamw(warmup-cosine, wd=1e-4)`` (``train/optim.py``), the dataset resident
on the device with indices sampled and augmentation drawn there
(``train/data.py``'s runner and augmentation), flax's default
initialiser, bfloat16 autocast over float32 parameters, and a tail
average of the parameters over the last chunks.  Rendering needs a TTF
face on the machine; ``train_captioner(..., data=(crops, kinds))`` trains
on given arrays.

CLI:
    python -m omniparser_tpu_torch.train.train_captioner --steps 3000 \\
        --out omniparser_tpu_torch/weights/exported/cap_synth.npz
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

from omniparser_tpu_torch.models.florence2 import (
    TASK_PROMPTS,
    Florence2,
    FlorenceDims,
    greedy_generate,
)
from omniparser_tpu_torch.pipeline import EXPORT_DIR
from omniparser_tpu_torch.train.data import (
    apply_augment,
    crop_each,
    make_step_runner,
    run_logged,
)

# one caption phrase per glyph family; all fit greedy max_new_tokens=20
# (CaptionerConfig default) with bos/eos under the char-level fallback
# tokenizer
CAPTIONS: Dict[str, str] = {
    "button": "button icon",
    "gear": "settings icon",
    "hamburger": "menu icon",
    "magnifier": "search icon",
    "arrow": "arrow icon",
    "star": "favorite icon",
    "cross": "close icon",
    "plus": "add icon",
    "dots": "more options icon",
    "folder": "folder icon",
    "toggle": "toggle icon",
    "ring": "circle icon",
    "thumbnail": "image icon",
    "chevron": "expand icon",
    # families (train/synth_gui.ICON_KINDS additions, matched to
    # the icons annotated in eval/real_gt.json); every phrase fits MAX_T
    # (<= 18 chars + bos/eos)
    "bell": "notifications icon"[:18],
    "chat": "chat icon",
    "calendar": "calendar icon",
    "phone": "phone icon",
    "cloud": "cloud icon",
    "smiley": "emoji icon",
    "send": "send icon",
    "refresh": "refresh icon",
    "grid": "apps icon",
    "mic": "microphone icon",
    "camera": "camera icon",
    "undo": "undo icon",
    "bold": "bold icon",
    "italic": "italic icon",
    "underline": "underline icon",
    "wifi": "wifi icon",
    "battery": "battery icon",
    "music": "music icon",
    # left arrows are their own family (real back buttons
    # ground against this exact phrase — eval/real_gt.json)
    "back": "back arrow icon",
}


# reduced Florence-2 dims: the graph family of BASE, sized for the
# synthetic glyph task and the fallback tokenizer's id space
SYNTH_CAP_DIMS = FlorenceDims(
    embed_dims=(32, 64, 128, 256),
    num_heads=(1, 2, 4, 8),
    num_groups=(1, 2, 4, 8),
    depths=(1, 1, 3, 1),
    d_model=256,
    encoder_layers=2,
    decoder_layers=2,
    attn_heads=8,
    ffn_dim=1024,
    vocab_size=16512,  # FallbackTokenizer ids: 10 + 0x4000
)

CROP = 64  # CaptionerConfig.crop_size (reference: util/utils.py:92)
MAX_T = 20  # CaptionerConfig.max_new_tokens (util/utils.py:115)
TILE = 96
LABEL_SMOOTHING = 0.1
# CLIP normalisation of FlorenceCaptioner.preprocess
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def caption_tokens(tokenizer) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-kind (decoder inputs [K,T], labels [K,T], mask [K,T])."""
    from omniparser_tpu_torch.train.synth_gui import ICON_KINDS

    d = SYNTH_CAP_DIMS
    k = len(ICON_KINDS)
    labels = np.full((k, MAX_T), d.pad_token_id, np.int32)
    mask = np.zeros((k, MAX_T), np.float32)
    for i, kind in enumerate(ICON_KINDS):
        ids = tokenizer.encode(CAPTIONS[kind])  # [bos, chars..., eos]
        if len(ids) > MAX_T:
            raise ValueError(f"caption of {kind!r} is {len(ids)} tokens, over {MAX_T}")
        labels[i, : len(ids)] = ids
        mask[i, : len(ids)] = 1.0
    dec_in = np.concatenate(
        [np.full((k, 1), d.decoder_start_token_id, np.int32), labels[:, :-1]], axis=1)
    return dec_in, labels, mask


def render_tiles(n: int, seed: int):
    """(tiles [n,96,96,3] u8, boxes [n,4] normalised glyph boxes with
    detector-style jitter of +-10% of the glyph side, kind ids [n] i32)."""
    from omniparser_tpu_torch.train.synth_gui import ICON_KINDS, render_icon_tile

    rng = np.random.default_rng(seed)
    tiles = np.zeros((n, TILE, TILE, 3), np.uint8)
    boxes = np.zeros((n, 4), np.float32)
    kinds = np.zeros((n,), np.int32)
    t0 = time.time()
    for i in range(n):
        img, kind, (x1, y1, x2, y2) = render_icon_tile(rng, tile=TILE)
        tiles[i] = img
        kinds[i] = ICON_KINDS.index(kind)
        j = 0.1 * (x2 - x1)
        boxes[i] = [max(x1 + rng.uniform(-j, j), 0) / TILE,
                    max(y1 + rng.uniform(-j, j), 0) / TILE,
                    min(x2 + rng.uniform(-j, j), TILE) / TILE,
                    min(y2 + rng.uniform(-j, j), TILE) / TILE]
        if i and i % 5000 == 0:
            print(f"  cap data {i}/{n} ({time.time() - t0:.0f}s)", flush=True)
    return tiles, boxes, kinds


def crop_tiles(tiles: np.ndarray, boxes: np.ndarray, device="cuda") -> np.ndarray:
    """Each tile's box through the inference crop-gather
    (``crop_resize_batch``, resize grid) to a CROP x CROP patch: one launch
    of K3 a tile on the card, its plain version on the CPU.  Returns
    [n,64,64,3] u8 (values truncated, as the JAX package's ``astype``)."""
    from omniparser_tpu_torch.ops.preprocess import crop_resize_batch

    boxes = np.asarray(boxes, np.float32)
    return crop_each(tiles, lambda tile, i: crop_resize_batch(
        tile, (TILE, TILE), torch.from_numpy(boxes[i:i + 1]).to(tile.device), CROP), device)


def build_dataset(n: int, seed: int, cache: bool = True, device="cuda"):
    """(crops [n,64,64,3] u8, kind ids [n] i32): rendered tiles cropped
    through ``crop_tiles`` on `device`; cached in the temporary directory."""
    from omniparser_tpu_torch.train.synth_gui import DATA_VERSION

    cache_path = os.path.join(tempfile.gettempdir(), f"cap_data_s{seed}_n{n}_v{DATA_VERSION}.npz")
    if cache and os.path.exists(cache_path):
        z = np.load(cache_path)
        return z["crops"], z["kinds"]
    tiles, boxes, kinds = render_tiles(n, seed)
    crops = crop_tiles(tiles, boxes, device)
    if cache:
        np.savez(cache_path, crops=crops, kinds=kinds)
    return crops, kinds


class CaptionTables:
    """The device-resident pieces of a captioner step: the prompt ids,
    per-kind decoder inputs, labels and masks, the CLIP normalisation."""

    def __init__(self, device, tokenizer=None):
        from omniparser_tpu_torch.models.tokenizer import load_tokenizer

        tokenizer = tokenizer or load_tokenizer(None)
        self.prompt = torch.tensor(tokenizer.encode(TASK_PROMPTS["<CAPTION>"]),
                                   dtype=torch.int64, device=device)
        dec_in, labels, mask = caption_tokens(tokenizer)
        self.dec_in = torch.from_numpy(dec_in).long().to(device)
        self.labels = torch.from_numpy(labels).long().to(device)
        self.mask = torch.from_numpy(mask).to(device)
        self.mean = torch.tensor(_MEAN, dtype=torch.float32, device=device)
        self.std = torch.tensor(_STD, dtype=torch.float32, device=device)


def smoothed_caption_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                          eps: float = LABEL_SMOOTHING) -> torch.Tensor:
    """Masked CE against labels smoothed by `eps` (the one-hot times 1-eps
    plus eps/V).  Smoothing keeps the decode calibrated: trained to zero
    hard-CE the model gives log-prob about 0 to junk and glyph alike, which
    leaves the caption gate (``CaptionerConfig.min_logp``) nothing to read."""
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = (-(1.0 - eps) * torch.gather(logp, -1, labels[..., None])[..., 0]
          - (eps / v) * logp.sum(-1))
    return (ce * mask).sum() / mask.sum()


def captioner_step(model: Florence2, opt, tables: CaptionTables, x: torch.Tensor,
                   kind_ids: torch.Tensor, draws: Optional[Dict[str, torch.Tensor]],
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One step on crops x [B,64,64,3] in [0,1]: augment (``draws``; None
    for none), CLIP-normalise, teacher-forced forward, smoothed CE, clip +
    AdamW.  Returns the loss (a device scalar)."""
    from omniparser_tpu_torch.train.train_step import compute_autocast

    if draws is not None:
        x = apply_augment(x, draws)
    px = (x - tables.mean) / tables.std
    model.train()
    opt.zero_grad()
    with compute_autocast(x.device, dtype):
        logits = model(px, tables.prompt.expand(x.shape[0], -1), tables.dec_in[kind_ids])
    loss = smoothed_caption_loss(logits, tables.labels[kind_ids], tables.mask[kind_ids])
    loss.backward()
    opt.step()
    return loss.detach()


def make_captioner_trainer(steps: int, seed: int, lr: float = 3e-4, device="cuda",
                           module: Optional[Florence2] = None):
    """``Florence2(SYNTH_CAP_DIMS)`` initialised from a generator seeded
    `seed` on the device (or the given `module`), and its optimiser
    (warm-up min(300, steps/2))."""
    from omniparser_tpu_torch.train.optim import AdamW, warmup_cosine_decay_schedule
    from omniparser_tpu_torch.utils.device import resolve_device
    from omniparser_tpu_torch.weights.init import flax_init_

    dev = resolve_device(device)
    model = module
    if model is None:
        with torch.device(dev):
            model = flax_init_(Florence2(SYNTH_CAP_DIMS), torch.Generator(dev).manual_seed(seed))
    warmup = min(300, steps // 2)
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.01)
    return model, AdamW(model.parameters(), sched, weight_decay=1e-4, clip_norm=1.0)


def gather_crops(data, idx):
    return data[0][idx].float() / 255.0, data[1][idx].long()


def train_captioner(steps: int = 3000, batch: int = 128, lr: float = 3e-4, seed: int = 0,
                    dataset_size: int = 40_000, log_every: int = 200, tail_avg: float = 0.3,
                    device="cuda", dtype: torch.dtype = torch.bfloat16, data=None,
                    on_step: Optional[Callable[[int, torch.Tensor], None]] = None
                    ) -> Florence2:
    """Train and return ``Florence2(SYNTH_CAP_DIMS)`` (eval mode).  With
    `tail_avg` > 0 the parameters returned are the mean of the snapshots
    taken at each chunk of `log_every` steps in the last `tail_avg` of the
    run (where there are two or more): the average sits nearer the basin's
    centre than any endpoint.  `data`: (crops [n,64,64,3] u8, kind ids [n])
    to train on instead of rendering."""
    from omniparser_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model, opt = make_captioner_trainer(steps, seed, lr, dev)
    tables = CaptionTables(dev)
    if data is None:
        print(f"cap: generating {dataset_size} icon crops ...", flush=True)
        data = build_dataset(dataset_size, seed + 1, device=dev)
    print("cap: training ...", flush=True)
    data_dev = (torch.from_numpy(data[0]).to(dev), torch.from_numpy(data[1]).to(dev))
    run = make_step_runner(
        lambda x, y, draws: captioner_step(model, opt, tables, x, y, draws, dtype),
        batch, data_dev, gather_crops, torch.Generator(dev).manual_seed(seed + 3), on_step)
    tail = []  # chunk-boundary snapshots of the parameters

    def snapshot(done: int) -> None:
        if tail_avg > 0 and done >= steps * (1.0 - tail_avg):
            tail.append({k: p.detach().clone() for k, p in model.named_parameters()})

    run_logged(run, steps, log_every, "cap", snapshot)
    if len(tail) > 1:
        print(f"cap: tail-averaging {len(tail)} snapshots", flush=True)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(torch.stack([t[k] for t in tail]).mean(0))
    return model.eval()


def evaluate_captioner(model: Florence2, n: int = 256, seed: int = 9200,
                       device="cuda") -> Dict[str, float]:
    """Held-out exact-match caption accuracy through ``greedy_generate``
    (the network in float32)."""
    from omniparser_tpu_torch.models.tokenizer import load_tokenizer
    from omniparser_tpu_torch.train.synth_gui import ICON_KINDS
    from omniparser_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    tokenizer = load_tokenizer(None)
    tables = CaptionTables(dev, tokenizer)
    crops, kinds = build_dataset(n, seed, cache=False, device=dev)
    d = SYNTH_CAP_DIMS
    model = model.eval()
    correct = 0
    for s in range(0, n, 64):
        x = torch.from_numpy(crops[s:s + 64]).to(dev).float() / 255.0
        px = (x - tables.mean) / tables.std
        toks = greedy_generate(model, px, tables.prompt.expand(x.shape[0], -1),
                               max_new_tokens=MAX_T).cpu().numpy()
        for j in range(toks.shape[0]):
            ids = [int(t) for t in toks[j]
                   if t not in (d.pad_token_id, d.eos_token_id, d.bos_token_id)]
            correct += tokenizer.decode(ids).strip() == CAPTIONS[ICON_KINDS[kinds[s + j]]]
    return {"exact_match": correct / n, "n": n}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--data", type=int, default=40_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(EXPORT_DIR, "cap_synth.npz"))
    args = p.parse_args(argv)

    from omniparser_tpu_torch.weights.checkpoints import save_checkpoint

    model = train_captioner(args.steps, args.batch, seed=args.seed, dataset_size=args.data,
                            device=args.device)
    report = evaluate_captioner(model, device=args.device)
    print("cap eval:", report, flush=True)
    path = save_checkpoint(args.out, {"cap": model}, dims=SYNTH_CAP_DIMS)
    print(f"saved {path}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
