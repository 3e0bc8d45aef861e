"""Tracing and profiling: per-stage wall timers and torch.profiler traces."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator


class StageTimer:
    """Accumulating per-stage wall timers.

    with timer.stage("detect"): ...
    timer.summary() -> {'detect': {'total_s': ..., 'count': ..., 'mean_s': ...}}
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_s": v / self.counts[k]}
            for k, v in self.totals.items()
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """A torch.profiler trace of the host and, where there is one, the CUDA
    device, written as a Chrome trace (``trace.json`` in `log_dir`; open it
    in chrome://tracing or Perfetto).  No-op when disabled, so it can stay
    in production code paths."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate_trace(name: str) -> Iterator[None]:
    """A named region inside a device trace (torch.profiler.record_function)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
