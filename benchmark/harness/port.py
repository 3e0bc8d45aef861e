"""The system under test: the measured package's SOMPipeline, built from a
configuration file, with the harness's own wrappers around the calls
whose outputs the comparison judges.  Beside the captioner files'
`port_dims` and the kernel files' named functions, this is the one module
of the harness that imports the measured package.

The wrappers keep references to what the timed path already made (the
detector's and the text detector's outputs, the one download of each
fused step, the caption crops and tokens); they copy nothing and read no
device value, and they keep anything only for the requests sampled for the
comparison.  Counts that every request gives (lines found, captions needed)
are read from the download, which is on the host already."""

from __future__ import annotations

import importlib
import time
from typing import Dict, List, Optional

import torch

from benchmark.harness import manifest as mf


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


def build(cfg: Dict, device, captioner_state: Dict, captioner):
    """The pipeline, with the captioner's dims from its own file
    (benchmark/captioners/<backend>.py)."""
    from omniparser_tpu_torch.pipeline import SOMPipeline

    return SOMPipeline(pipeline_config(cfg), device, captioner_state=captioner_state,
                       captioner_dims=captioner.port_dims(cfg))


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
        # kernel name -> what the traced run kept of each call
        # (benchmark/kernels/<name>.py)
        self.kernel_calls: Dict[str, List] = {}
        self._hooks = []
        self._restore = []
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

            for name, k in mf.kernels().items():
                self._wrap_kernel(name, k)

    def _wrap_kernel(self, name: str, k) -> None:
        """Wrap the port's function that launches the kernel: each call
        keeps what `k.keep` takes of it, then runs as it did."""
        mod = importlib.import_module(k.MODULE)
        launch = getattr(mod, k.ATTR)
        calls = self.kernel_calls.setdefault(name, [])

        def wrapped(*args, **kwargs):
            calls.append(k.keep(*args, **kwargs))
            return launch(*args, **kwargs)

        setattr(mod, k.ATTR, wrapped)
        self._restore.append((mod, k.ATTR, launch))

    def close(self) -> None:
        for h in self._hooks:
            h.remove()
        for mod, attr, launch in self._restore:
            setattr(mod, attr, launch)

    def caption_ms(self, until: float) -> Optional[float]:
        """Device milliseconds between the events of the generate calls that
        returned before `until` (host clock)."""
        evs = [(a, b) for t, a, b in self.caption_events if t <= until]
        if not evs:
            return None
        return sum(a.elapsed_time(b) for a, b in evs)
