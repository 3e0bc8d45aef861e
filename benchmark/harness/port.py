"""The system under test: the measured package's SOMPipeline, built from a
configuration file, with the harness's own wrappers around the calls
whose outputs the comparison judges.  This is the one module of the
harness that imports the measured package.

The wrappers keep references to what the timed path already made (the
detector's and the text detector's outputs, the one download of each
fused step, the caption crops and tokens); they copy nothing and read no
device value, and they keep anything only for the requests sampled for the
comparison.  Counts that every request gives (lines found, captions needed)
are read from the download, which is on the host already."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch


def pipeline_config(cfg: Dict):
    from omniparser_tpu_torch.config import (
        CaptionerConfig,
        DetectorConfig,
        OcrConfig,
        PipelineConfig,
    )

    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    p = dict(cfg["pipeline"])
    return PipelineConfig(detector=DetectorConfig(**tup(p.pop("detector"))),
                          captioner=CaptionerConfig(**tup(p.pop("captioner"))),
                          ocr=OcrConfig(**tup(p.pop("ocr"))), **p)


def captioner_network(cfg: Dict):
    """(backend, dims, make_module, keep_f32) of the configuration's
    captioner, from the reference's copy of its modules."""
    backend = cfg["pipeline"]["captioner"]["backend"]
    raw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["captioner_dims"].items()}
    if backend == "florence":
        from benchmark.reference import florence2 as net

        dims = net.FlorenceDims(**raw)
        return backend, dims, lambda: net.Florence2(dims), ("language_model",
                                                            "language_model.shared")
    if backend == "blip2":
        from benchmark.reference import blip2 as net

        dims = net.Blip2Dims(**raw)
        return backend, dims, lambda: net.Blip2(dims), ("language_model.embed_tokens",)
    raise ValueError(f"captioner backend {backend!r} has no reference")


def port_dims(backend: str, cfg: Dict):
    """The measured package's own dims object for the configuration."""
    raw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["captioner_dims"].items()}
    if backend == "florence":
        from omniparser_tpu_torch.models.florence2 import FlorenceDims

        return FlorenceDims(**raw)
    from omniparser_tpu_torch.models.blip2 import Blip2Dims

    return Blip2Dims(**raw)


def build(cfg: Dict, device, captioner_state: Dict, backend: str):
    from omniparser_tpu_torch.pipeline import SOMPipeline

    return SOMPipeline(pipeline_config(cfg), device, captioner_state=captioner_state,
                       captioner_dims=port_dims(backend, cfg))


def warm(pipe, shape, backend: str, sample_images: List[np.ndarray]) -> None:
    """Every shape this cell's traffic drives: the kernels' first launches
    (they build here on a checkout's first run), each caption decode bucket
    that parse_batch can use, and real screenshots through parse_batch (or,
    for a captioner outside the fused step, one parse with captions)."""
    if backend == "florence":
        k = pipe.config.captioner.batch_size
        buckets = []
        b = 8
        while b <= pipe._DECODE_CHUNK:
            buckets.append(b)
            b *= 2
        pipe.warmup(shapes=(tuple(shape),), cap_buckets=tuple(buckets) + (k,))
        pipe.parse_batch(sample_images)
    else:
        pipe.warmup(shapes=(tuple(shape),), cap_buckets=())
        pipe.parse_batch(sample_images[:1])
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)


class Recorder:
    """Wrappers on one pipeline.  `capture` (set per batch by the process
    wrapper) lists the batch positions whose outputs are kept."""

    def __init__(self, pipe, traced: bool):
        self.pipe = pipe
        self.traced = traced
        self.capture: List[int] = []
        self.batch: Dict = {}
        self.batch_no = -1
        self.counts: List[Dict] = []  # per image, every batch
        self.caption_events = []      # (host end, start event, end event), traced runs
        self.caption_host = []        # (t0, t1) host spans of generate calls
        self.kernel_calls: Dict[str, List] = {"nms_keep": [], "crop_resize": []}
        self._hooks = []
        self._wrap()

    # ------------------------------------------------------------ #
    def begin_batch(self, capture: List[int]) -> None:
        self.batch_no += 1
        self.capture = capture
        self.batch = {"det": [], "ocr_map": [], "rec": [], "out": [], "generate": []}

    def _keep(self, key: str, value) -> None:
        if self.capture:
            self.batch[key].append(value)

    def _wrap(self) -> None:
        pipe = self.pipe
        def on_det(m, i, o):
            self._keep("det", o)
            self._keep("rec", [])  # the recogniser's blocks of this image follow

        def on_rec(m, i, o):
            if self.capture:
                self.batch["rec"][-1].append(o)

        self._hooks.append(pipe.det_module.register_forward_hook(on_det))
        self._hooks.append(pipe.ocr.det.register_forward_hook(
            lambda m, i, o: self._keep("ocr_map", o)))
        self._hooks.append(pipe.ocr.rec.register_forward_hook(on_rec))

        download = pipe._download

        def _download(ctx):
            download(ctx)
            out = ctx["out"]
            need = out["icon_keep"] & ~out["absorb"].any(axis=1)
            self.counts.append({
                "batch": self.batch_no,
                "lines": int(out["ocr_cand_valid"].sum()) if "ocr_cand_valid" in out else 0,
                "captions": int(need.sum()),
                "hw": (int(ctx["h"]), int(ctx["w"])),
            })
            self._keep("out", out)

        pipe._download = _download

        cap = pipe.captioner
        generate = cap.generate

        def _generate(crops):
            t0 = time.perf_counter()
            if self.traced and crops.is_cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                res = generate(crops)
                ev[1].record()
                self.caption_events.append((time.perf_counter(),) + ev)
            else:
                res = generate(crops)
            self.caption_host.append((t0, time.perf_counter()))
            self._keep("generate", (crops, res[0], res[1]))
            return res

        cap.generate = _generate

        if self.traced:
            from omniparser_tpu_torch.ops import hopper_crop, nms

            dispatch_det = pipe.ocr.dispatch_det

            def _dispatch_det(padded, hw):
                sync()
                t0 = time.perf_counter()
                res = dispatch_det(padded, hw)
                sync()
                st = pipe.stage_ms
                st["ocr_detect"] = st.get("ocr_detect", 0.0) + (time.perf_counter() - t0) * 1e3
                return res

            def sync():
                if pipe.device.type == "cuda":
                    torch.cuda.synchronize(pipe.device)

            pipe.ocr.dispatch_det = _dispatch_det

            nms_keep = nms.nms_keep

            def _nms_keep(sorted_boxes, sorted_valid, thr):
                self.kernel_calls["nms_keep"].append(sorted_valid)
                return nms_keep(sorted_boxes, sorted_valid, thr)

            nms.nms_keep = _nms_keep
            crop = hopper_crop.crop_resize

            def _crop(padded, hw, boxes, out_size=64, grid="resize"):
                self.kernel_calls["crop_resize"].append((boxes, out_size, grid,
                                                         tuple(int(v) for v in hw)))
                return crop(padded, hw, boxes, out_size, grid)

            hopper_crop.crop_resize = _crop
            self._restore = (nms, nms_keep, hopper_crop, crop)

    def close(self) -> None:
        for h in self._hooks:
            h.remove()
        if self.traced:
            nms, nms_keep, hopper_crop, crop = self._restore
            nms.nms_keep = nms_keep
            hopper_crop.crop_resize = crop

    def caption_ms(self, until: float) -> Optional[float]:
        """Device milliseconds between the events of the generate calls that
        returned before `until` (host clock)."""
        evs = [(a, b) for t, a, b in self.caption_events if t <= until]
        if not evs:
            return None
        return sum(a.elapsed_time(b) for a, b in evs)
