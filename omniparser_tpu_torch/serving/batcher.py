"""Micro-batching scheduler: queue -> batches for one parse_batch call.

Requests arriving within `batch_window_ms` of the first (up to
`max_batch`) are handed to the process function together; callers block on
futures.  With the span recorder on (``utils/profiling.recorder``) each
item's wait from `submit` to the start of its batch is a span
``batcher.wait`` and each batch adds its size to ``batcher.batch_size``.
One worker thread owns the card and runs every parse, so the pipeline
needs no locks of its own:

  * the port's tensors carry an explicit device, so the worker thread
    needs no ``torch.cuda.set_device``;
  * the fused merge's persistent scratch (``ops/hopper_kernels.py``) is
    keyed per (device, stream) and every launch leaves it zeroed; the
    worker thread is its one user on the default stream;
  * the kernels are built under ``ops/cuda_build``'s lock, so a first
    launch on the worker thread and a warm-up elsewhere build once.

The same semantics as the JAX package's ``serving/batcher.py``; this
package keeps its own copy.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Sequence

from omniparser_tpu_torch.utils.profiling import recorder


class MicroBatcher:
    def __init__(
        self,
        process_batch: Callable[[Sequence], List],
        max_batch: int = 8,
        batch_window_ms: float = 5.0,
    ):
        self._process = process_batch
        self._max_batch = max_batch
        self._window_s = batch_window_ms / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        self._queue.put((item, fut, time.perf_counter() if recorder.on else None))
        return fut

    def close(self):
        self._stop.set()
        self._queue.put(None)  # wake the worker
        self._thread.join(timeout=5)
        # fail any requests still queued (or racing close) instead of
        # leaving their callers blocked on .result() forever
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("batcher closed"))

    # ------------------------------------------------------------------ #

    def _collect(self):
        """Block for one item, then drain up to max_batch within the window."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        # absolute deadline from the first item: a steady trickle must not
        # hold the batch open for up to max_batch * window
        deadline = time.monotonic() + self._window_s
        while len(batch) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            items = [b[0] for b in batch]
            futures = [b[1] for b in batch]
            if recorder.on:
                start = time.perf_counter()
                for i, b in enumerate(batch):
                    if b[2] is not None:
                        recorder.record("batcher.wait", b[2], start, i)
                recorder.count("batcher.batch_size", len(items))
            try:
                results = self._process(items)
                if len(results) != len(items):  # silent drops would hang callers
                    raise RuntimeError(
                        f"process_batch returned {len(results)} results for "
                        f"{len(items)} items"
                    )
                for fut, res in zip(futures, results):
                    fut.set_result(res)
            except Exception as e:  # noqa: BLE001 — propagate to all callers
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)
