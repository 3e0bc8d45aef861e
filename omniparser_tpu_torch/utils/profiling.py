"""Tracing and profiling: the process-wide span and counter recorder, and
torch.profiler traces.

``recorder`` is off by default.  Off, ``recorder.span(...)`` returns one
shared null context (it reads no clock, makes no event and makes no CUDA
call) and ``count`` returns at once.  On (``recorder.enable()``):

  * a span records ``time.perf_counter()`` at entry and exit, the host
    clock that a device trace's marker kernel ties to the trace's own;
  * a span given a CUDA device also records a pair of pooled CUDA events on
    that device's current stream.  The recorder never synchronises: `take`
    resolves the events with ``elapsed_time``, and the pipeline calls it
    after a call's own last wait (its final download), when every event it
    recorded has completed;
  * while a torch profiler is active, each span also opens
    ``record_function(name)``, so the program's spans lie over the kernels
    in the profiler's trace.

``take`` hands over everything recorded since the previous take as a
`Trace` and keeps the newest traces in ``recorder.traces``.  The pipeline
takes one after every ``parse_image`` and ``parse_batch`` (its
``last_trace``); the serving batcher's spans fall into the next parse's.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    image: Optional[int]       # the image's index in its call, None for the call's own spans
    t0: float                  # host clock (time.perf_counter), s
    t1: float
    device_ms: Optional[float]  # between the span's CUDA events; None off the card


class Trace(NamedTuple):
    t1: float                  # host clock when taken
    spans: List[Span]
    counts: Dict[str, float]


_NULL = contextlib.nullcontext()


def _launch_totals() -> Dict[str, int]:
    """The hand-written kernels' process-wide launch counters."""
    from omniparser_tpu_torch.ops import beam_attention, hopper_crop, hopper_kernels

    return {**hopper_kernels.launch_counts, **hopper_crop.launch_counts,
            **beam_attention.launch_counts}


class _Span:
    __slots__ = ("rec", "name", "image", "stream", "events", "t0", "fn")

    def __init__(self, rec: "Recorder", name: str, stream, image: Optional[int]):
        self.rec, self.name, self.stream, self.image = rec, name, stream, image
        self.events = self.fn = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        self.t0 = time.perf_counter()
        if self.stream is not None:
            self.events = self.rec._event_pair(self.stream.device)
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        self.rec.record(self.name, self.t0, time.perf_counter(), self.image, self.events)
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


class Recorder:
    """Spans and counters of the program; see the module's docstring."""

    def __init__(self, keep: int = 1024):
        self.on = False
        self.traces: "collections.deque[Trace]" = collections.deque(maxlen=keep)
        self._lock = threading.Lock()
        self._spans: List[tuple] = []   # (name, image, t0, t1, (start, end, device) or None)
        self._counts: Dict[str, float] = {}
        self._launches: Dict[str, int] = {}
        self._free: Dict[torch.device, List] = {}  # pooled CUDA events per device

    def enable(self) -> None:
        if not self.on:
            self._launches = _launch_totals()
            self.on = True

    def disable(self) -> None:
        self.on = False
        with self._lock:
            spans, self._spans, self._counts = self._spans, [], {}
        for s in spans:
            self._release(s[4])

    def span(self, name: str, device: Optional[torch.device] = None,
             image: Optional[int] = None):
        """A context manager timing its body as the span `name`; on a CUDA
        `device` also between two events on its current stream."""
        if not self.on:
            return _NULL
        cuda = device is not None and device.type == "cuda"
        return _Span(self, name, torch.cuda.current_stream(device) if cuda else None, image)

    def record(self, name: str, t0: float, t1: float, image: Optional[int] = None,
               events=None) -> None:
        """A span whose host times the caller took."""
        if self.on:
            with self._lock:
                self._spans.append((name, image, t0, t1, events))
        else:
            self._release(events)

    def count(self, name: str, n: float = 1) -> None:
        if self.on:
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + n

    def take(self) -> Optional[Trace]:
        """Everything recorded since the last take, with each span's device
        milliseconds and the kernels' launches (``launches.<kernel>``) since
        then; None when off.  Call it after the recorded work's last wait."""
        if not self.on:
            return None
        with self._lock:
            raw, counts = self._spans, self._counts
            self._spans, self._counts = [], {}
        spans = []
        for name, image, t0, t1, ev in raw:
            ms = None
            if ev is not None:
                if ev[1].query():
                    ms = ev[0].elapsed_time(ev[1])
                self._release(ev)
            spans.append(Span(name, image, t0, t1, ms))
        now = _launch_totals()
        for k, v in now.items():
            if v != self._launches.get(k, 0):
                counts[f"launches.{k}"] = v - self._launches.get(k, 0)
        self._launches = now
        trace = Trace(time.perf_counter(), spans, counts)
        self.traces.append(trace)
        return trace

    def _event_pair(self, device: torch.device):
        with self._lock:
            free = self._free.setdefault(device, [])
            if len(free) >= 2:
                return free.pop(), free.pop(), device
        return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
                device)

    def _release(self, events) -> None:
        if events is not None:
            with self._lock:
                self._free.setdefault(events[2], []).extend(events[:2])


# the one recorder of the process, as ops/hopper_kernels.launch_counts is
recorder = Recorder()


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """A torch.profiler trace of the host and, where there is one, the CUDA
    device, written as a Chrome trace (``trace.json`` in `log_dir`; open it
    in chrome://tracing or Perfetto).  No-op when disabled, so it can stay
    in production code paths."""
    if not enabled:
        yield
        return
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
