"""Data-parallel batched detect and caption over a device mesh.

Same-bucket screenshots stack on the batch dim and split over 'dp'; the
detector (about 3 M parameters) is copied to each distinct row device, the
captioner's large parameters can also split over 'tp'
(``parallel/mesh.shard_params_fsdp_tp``).  One process runs the rows in
turn; their kernels queue on each device's stream.

Where the JAX package vmaps its detector and so takes the plain NMS
(Mosaic kernels do not vmap), each row here runs one network forward over
its images and then each image's NMS through the NMS kernel at the real
window.
"""

from __future__ import annotations

import copy
from typing import List, Sequence

import numpy as np
import torch
from torch.nn.utils import parametrize

from omniparser_tpu_torch.models.yolov8 import Detector
from omniparser_tpu_torch.ops.preprocess import pad_to_bucket
from omniparser_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    module_on,
    same_device,
    shard_params_fsdp_tp,
)


class ShardedDetector:
    """Batched, dp-sharded detect: [B, Hb, Wb, 3] uint8 -> per-image boxes.
    B must be a multiple of the mesh's dp size (pad with zero images)."""

    def __init__(self, detector: Detector, mesh: Mesh):
        self.detector = detector
        self.mesh = mesh
        self._copies = {}  # (id(module), device) -> module there

    def _module_on(self, module, device):
        key = (id(module), str(device))
        if key not in self._copies:
            self._copies[key] = (module, module_on(module, device))
        return self._copies[key][1]

    def __call__(self, module, images_u8, hws, conf: float, iou: float):
        """images_u8 [B, Hb, Wb, 3] uint8 (numpy or tensor); hws [B, 2].
        Returns (boxes [B, max_det, 4], scores [B, max_det], valid
        [B, max_det]) on the first row's device."""
        dp = self.mesh.shape["dp"]
        b = images_u8.shape[0]
        if b % dp:
            raise ValueError(f"batch {b} not a multiple of dp={dp}")
        hws = np.asarray(hws, np.int64)
        step = b // dp
        outs = []
        for row, shard in enumerate(batch_sharding(self.mesh).shard(images_u8)):
            dev = self.mesh.row_device(row)
            outs += self.detector.detect_batch(
                self._module_on(module, dev), shard,
                [tuple(int(v) for v in hw) for hw in hws[row * step:(row + 1) * step]],
                conf, iou)
        first = self.mesh.row_device(0)
        return tuple(torch.stack([o[k].to(first) for o in outs]) for k in range(3))

    def detect_images(self, module, images: Sequence[np.ndarray],
                      conf: float = 0.05, iou: float = 0.1):
        """Pad a list of raw images into one shared bucket of 512-multiples
        and a dp-divisible batch of zero images; returns numpy (boxes,
        scores, valid) for each real image."""
        dp = self.mesh.shape["dp"]
        hb = max(-(-im.shape[0] // 512) * 512 for im in images)
        wb = max(-(-im.shape[1] // 512) * 512 for im in images)
        n = len(images)
        b = -(-n // dp) * dp
        batch = np.zeros((b, hb, wb, 3), np.uint8)
        hws = np.ones((b, 2), np.int32)
        for i, im in enumerate(images):
            batch[i], hws[i] = pad_to_bucket(im, hb, wb)
        boxes, scores, valid = self(module, batch, hws, conf, iou)
        return tuple(t.cpu().numpy()[:n] for t in (boxes, scores, valid))


def captioner_on(captioner, device: torch.device, model: torch.nn.Module):
    """A FlorenceCaptioner that decodes with `model` on `device`."""
    c = copy.copy(captioner)
    c.model, c.device = model, device
    c._mean, c._std = captioner._mean.to(device), captioner._std.to(device)
    return c


def row_captioners(captioner, mesh: Mesh) -> List:
    """One captioner a dp row, its model copied once per distinct row
    device; with tp > 1 each copy's large parameters split over its row's
    tp devices (the caller's captioner is left as it was)."""
    tp = mesh.shape["tp"]
    by_device, rows = {}, []
    for row in range(mesh.shape["dp"]):
        dev = mesh.row_device(row)
        key = next((k for k in by_device if same_device(k, dev)), None)
        if key is None:
            model = captioner.model
            if tp > 1:
                model = copy.deepcopy(model).to(dev)
                shard_params_fsdp_tp(model, mesh, row=row)
            else:
                model = module_on(model, dev)
            key = dev
            by_device[key] = captioner if model is captioner.model else \
                captioner_on(captioner, dev, model)
        rows.append(by_device[key])
    return rows


class ShardedCaptioner:
    """dp-sharded, tensor-parallel Florence-2 caption decode over crop
    batches."""

    def __init__(self, captioner, mesh: Mesh):
        self.captioner = captioner
        self.mesh = mesh
        self.rows = row_captioners(captioner, mesh)

    def generate(self, crops) -> tuple:
        """crops [B, S, S, 3] float [0,255] (numpy or tensor), B % dp == 0
        -> (tokens [B, max_new] int32, mean log-prob [B]) on the first
        row's device: one decode a row."""
        parts = batch_sharding(self.mesh).shard(crops)
        first = self.mesh.row_device(0)
        toks, logps = [], []
        with parametrize.cached():  # each split parameter gathered once a decode
            for cap, part in zip(self.rows, parts):
                t, lp = cap.generate(part)
                toks.append(t.to(first))
                logps.append(lp.to(first))
        return torch.cat(toks), torch.cat(logps)

    def caption(self, crops) -> List[str]:
        """crops [B, S, S, 3] float [0,255], B % dp == 0 -> caption strings,
        as the unsharded ``caption_crops`` gives them."""
        dp = self.mesh.shape["dp"]
        if crops.shape[0] % dp:
            raise ValueError(f"batch {crops.shape[0]} not a multiple of dp={dp}")
        tokens, logp = self.generate(np.asarray(crops, np.float32)
                                     if not torch.is_tensor(crops) else crops)
        tokens, logp = tokens.cpu().numpy(), logp.cpu().numpy()
        cap = self.captioner
        return [cap.gate_caption(cap.tokens_to_text(t), float(lp))
                for t, lp in zip(tokens, logp)]
