"""Batched multi-screenshot parse over a device mesh.

Same-bucket screenshots stack on a dp-sharded batch dim (one upload for
the batch) and each dp row runs, over its images:

  * the OCR detector with device components (one an image), the candidate
    unclip and unmap on the device;
  * one detector forward over the row's images, then each image's top-k
    window and NMS (the NMS kernel, once an image), with the overflow
    counters (no silent caps);
  * block-looped recognition: each block takes ``rec_block`` line slots of
    every image in the row (K3's line grid, once an image) through one
    recogniser forward, and the number of blocks is the BATCH's largest
    real candidate count's, so the cost follows the text density;
  * each image's merge (one merge launch), caption-slot compaction and
    caption crops (K3's caption grid);

then one download an image, and one caption decode a row over the
smallest bucket (8, 16, ... up to K slots) that covers the batch's largest
need.  Host work (strings, overlay) stays per image, through the
pipeline's own finish, so capped images still warn.

One process drives the rows in turn; their kernels queue on each device's
stream.  Relationship to ``SOMPipeline.parse_batch``: that path runs
independent per-image steps, right for mixed buckets on one card; this one
batches a row's images through each network, right for uniform traffic on
a mesh.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.nn.utils import parametrize

from omniparser_tpu_torch.parallel.mesh import Mesh, batch_sharding, module_on, same_device
from omniparser_tpu_torch.parallel.sharded import row_captioners
from omniparser_tpu_torch.pipeline import (
    SOMPipeline,
    caption_slots,
    gate_detections,
    last_valid_slot,
    merge_outputs,
    ocr_candidates,
    recognise_lines,
)
from omniparser_tpu_torch.utils.profiling import recorder

CAP_BUCKETS = (8, 16, 32, 64, 128)


def _bucket(n: int, floor: int, cap: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return min(b, cap)


def _ocr_on(ocr, device: torch.device):
    """A TorchOCR whose networks lie on `device` (itself where they do)."""
    if same_device(ocr.device, device):
        return ocr
    o = copy.copy(ocr)
    o.det, o.rec, o.device = module_on(ocr.det, device), module_on(ocr.rec, device), device
    return o


class ShardedParse:
    """A SOMPipeline's networks as a dp-sharded batched parse.

    Requires the pipeline's OCR to be the device one (TorchOCR) or null,
    and its captioner to be fusable (Florence-2) or absent."""

    def __init__(self, pipeline: SOMPipeline, mesh: Mesh):
        from omniparser_tpu_torch.ocr import NullOCR

        if pipeline._torch_ocr is None and not isinstance(pipeline.ocr, NullOCR):
            raise ValueError(
                "ShardedParse requires the device OCR backend (or null); host "
                "OCR backends would silently produce zero text elements here")
        self.p = pipeline
        self.mesh = mesh
        self.dp = mesh.shape["dp"]
        self.K = pipeline.config.captioner.batch_size
        # device candidates iff the single-image path would use them
        self._fused_ocr = bool(pipeline._fused_ocr)
        rows = [mesh.row_device(r) for r in range(self.dp)]
        self._det = [module_on(pipeline.det_module, d) for d in rows]
        self._ocr = ([_ocr_on(pipeline._torch_ocr, d) for d in rows]
                     if pipeline._torch_ocr is not None else None)
        self._cap = (row_captioners(pipeline._florence, mesh)
                     if pipeline._florence is not None else None)
        self.last_timings: Dict[str, float] = {}
        self.last_trace = None  # as SOMPipeline.last_trace

    @torch.no_grad()
    def parse_images(self, images: Sequence[np.ndarray]) -> List:
        """Same-bucket batched parse.  Returns parse_image tuples."""
        p, cfg, dp = self.p, self.p.config, self.dp
        t: Dict[str, float] = {}
        t0 = time.perf_counter()
        n = len(images)
        b = -(-n // dp) * dp  # a dp-divisible batch, padded with zero images
        step = b // dp

        # a shared bucket and ONE stacked host->device upload
        ctxs, padded_list = [], []
        with recorder.span("upload"):
            for i, img in enumerate(images):
                padded, upload, h, w, uh, uw = p._host_pad(img)
                padded_list.append(padded)
                ctxs.append({"image": img, "index": i, "upload_img": upload, "h": h, "w": w,
                             "uh": uh, "uw": uw})
            hb = max(x.shape[0] for x in padded_list)
            wb = max(x.shape[1] for x in padded_list)
            batch = np.zeros((b, hb, wb, 3), np.uint8)
            hws = [(1, 1)] * b
            true_hws = [(1, 1)] * b
            for i, (ctx, padded) in enumerate(zip(ctxs, padded_list)):
                batch[i, : padded.shape[0], : padded.shape[1]] = padded
                hws[i], true_hws[i] = (ctx["uh"], ctx["uw"]), (ctx["h"], ctx["w"])
            shards = batch_sharding(self.mesh).shard(batch)
        frames = [shards[i // step][i % step] for i in range(b)]
        rows = [range(r * step, (r + 1) * step) for r in range(dp)]
        for i, ctx in enumerate(ctxs):  # the finish's overflow captions crop from it
            ctx["padded_dev"] = frames[i]

        cands = self._candidates(frames, hws, ctxs, rows)
        outs = []
        for r in range(dp):
            det = p.detector.detect_batch(
                self._det[r], shards[r], [hws[i] for i in rows[r]],
                cfg.detector.box_threshold, cfg.detector.nms_iou_threshold, with_stats=True)
            outs += [list(gate_detections(d, true_hws[i])) for d, i in zip(det, rows[r])]
        recs = self._recognise(frames, hws, cands, rows)
        out_dev = []
        for i in range(b):
            boxes, valid, overflow, cc_count = cands[i]
            out = merge_outputs(outs[i], boxes, valid, overflow, recs[i], true_hws[i],
                                cfg.iou_threshold, cfg.ocr.text_threshold, self._fused_ocr)
            if self._cap is not None:
                out.update(caption_slots(cfg, out, frames[i], hws[i]))
            if cc_count is not None:
                out["cc_count"] = cc_count
            out_dev.append(out)
        crops = [o.pop("crops", None) for o in out_dev]
        with recorder.span("download"):
            host = [{k: v.cpu().numpy() for k, v in o.items()} for o in out_dev]
        t["dispatch"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        kb = 0
        if self._cap is not None:
            # the caption bucket: the smallest that covers the batch's
            # largest need; the compaction packed the needed slots first
            max_need = max(int(o["cap_valid"].sum()) for o in host)
            if max_need > 0:
                kb = _bucket(max_need, CAP_BUCKETS[0], self.K)
                self._decode(crops, host, rows, kb)
        t["decode"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        results = []
        for ctx, out in zip(ctxs, host):
            ctx["out"], ctx["kb"] = out, kb
            icon_plain = p._stage_finish(ctx)
            annotated = p._overlay(ctx, None)
            p._fill_captions(ctx, icon_plain)
            results.append((annotated, ctx["label_coordinates"], ctx["elements"]))
        t["finish"] = time.perf_counter() - t0
        self.last_timings = t
        self.last_trace = recorder.take()
        return results

    def _candidates(self, frames, hws, ctxs, rows):
        """Each frame's (OCR boxes [M,4], candidate valid [M], overflow,
        component count or None), M the same for the batch."""
        cfg = self.p.config
        b = len(frames)
        if self._fused_ocr:
            # device candidates: each frame's detector + components on its
            # row, unclip and unmap on the device; no host sync
            out = []
            for r, ocr in enumerate(self._ocr):
                for i in rows[r]:
                    with recorder.span("ocr_detect", frames[i].device, i):
                        cc, lb_r, pads = ocr.dispatch_det(frames[i], hws[i])
                    out.append((*ocr_candidates(cfg, cc["boxes"], cc["count"], lb_r, pads,
                                                hws[i], True), cc["count"]))
            for ctx in ctxs:
                ctx["host_texts"] = None
            return out
        # host candidates: each real image's components on the host, into
        # one OCR slot bucket for the batch (the largest count's, from 32)
        max_ocr = cfg.ocr.max_text_boxes
        boxes_px = [[] for _ in range(b)]
        step = b // len(rows)
        if self._ocr is not None:  # every detector before any candidate download
            futs = []
            for i in range(len(ctxs)):
                with recorder.span("ocr_detect", frames[i].device, i):
                    futs.append(self._ocr[i // step].dispatch_det(frames[i], hws[i]))
            for i, ctx in enumerate(ctxs):
                boxes_px[i] = self._ocr[i // step].candidates_from_prob(
                    *futs[i], ctx["uh"], ctx["uw"])
        slots = _bucket(max((min(len(x), max_ocr) for x in boxes_px[:len(ctxs)]), default=1),
                        32, max_ocr)
        ocr_arr = np.zeros((b, slots, 4), np.float32)
        ocr_valid = np.zeros((b, slots), bool)
        for i, ctx in enumerate(ctxs):
            m = min(len(boxes_px[i]), slots)
            if m:
                uh, uw = ctx["uh"], ctx["uw"]
                ocr_arr[i, :m] = (np.asarray(boxes_px[i][:m], np.float32)
                                  / np.array([uw, uh, uw, uh], np.float32))
                ocr_valid[i, :m] = True
            ctx.update(ocr_arr=ocr_arr[i], n_ocr=m,
                       host_texts=None if self._ocr is not None else [])
        sh = batch_sharding(self.mesh)
        arr_dev, valid_dev = sh.shard(ocr_arr), sh.shard(ocr_valid)
        return [(arr_dev[i // step][i % step], valid_dev[i // step][i % step],
                 torch.zeros((), dtype=torch.int32, device=arr_dev[i // step].device), None)
                for i in range(b)]

    def _recognise(self, frames, hws, cands, rows):
        """Each frame's (rec_ids, rec_conf, n_chars), or None without a
        recogniser: each row's images batched through one forward a block,
        the block count taken from the batch's largest candidate count."""
        if self._ocr is None:
            return [None] * len(frames)
        first = self.mesh.row_device(0)
        n_valid = int(torch.stack([last_valid_slot(c[1]).to(first) for c in cands]).max())
        recs = []
        for r, ocr in enumerate(self._ocr):
            ids, conf, nch = recognise_lines(
                self.p.config, ocr, [(frames[i], hws[i]) for i in rows[r]],
                [cands[i][0] for i in rows[r]], [cands[i][1] for i in rows[r]], n_valid)
            recs += [(ids[j], conf[j], nch[j]) for j in range(len(rows[r]))]
        return recs

    def _decode(self, crops, host, rows, kb: int) -> None:
        """One decode a dp row over its images' first kb caption slots."""
        cs = self.p.config.captioner.crop_size
        with parametrize.cached():  # each split parameter gathered once a decode
            for r, cap in enumerate(self._cap):
                flat = torch.stack([crops[i][:kb] for i in rows[r]]).reshape(-1, cs, cs, 3)
                with recorder.span("caption.batched", flat.device):
                    tokens, logp = cap.generate(flat)
                recorder.count("caption.slots", flat.shape[0])
                recorder.count("caption.served",
                               sum(int(host[i]["cap_valid"].sum()) for i in rows[r]))
                tokens = tokens.cpu().numpy().reshape(len(rows[r]), kb, -1)
                logp = logp.cpu().numpy().reshape(len(rows[r]), kb)
                for j, i in enumerate(rows[r]):
                    host[i]["cap_tokens"], host[i]["cap_logp"] = tokens[j], logp[j]


class ShardedServingPipeline:
    """SOMPipeline-compatible facade for the serving layer: batches route
    into ShardedParse over the mesh; a single parse is a batch of one."""

    def __init__(self, pipeline: SOMPipeline, mesh: Mesh):
        self.inner = pipeline
        self.config = pipeline.config
        self.sharded = ShardedParse(pipeline, mesh)

    @property
    def last_timings(self) -> Dict[str, float]:
        return self.sharded.last_timings

    @property
    def last_trace(self):
        return self.sharded.last_trace

    def parse_batch(self, images: Sequence[np.ndarray]):
        return self.sharded.parse_images(images)

    def parse_image(self, image_rgb: np.ndarray, **kw):
        return self.sharded.parse_images([image_rgb])[0]

    def warmup(self, shapes=((1080, 1920),)) -> None:
        """A batch of dp blank images per shape: builds the kernels at their
        first launch and picks the library's algorithms."""
        for h, w in shapes:
            self.sharded.parse_images([np.zeros((h, w, 3), np.uint8)] * self.sharded.dp)
