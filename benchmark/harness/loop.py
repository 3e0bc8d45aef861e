"""The measured window: closed-loop agent clients in front of the
serving stack's MicroBatcher, whose process function is the pipeline's
parse_batch, as the HTTP server sets it up (max_batch and batch_window_ms
from the server's defaults), with the screenshot already decoded.

Each client is a thread that submits its next screenshot as soon as its
reply arrives.  Clients submit until the deadline; every request submitted
before it counts, and the window closes when the last of them has
completed, so a rate covers all the work and all the time of the window."""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


class Window:
    def __init__(self, pipe, recorder, images: Sequence[np.ndarray], clients: int,
                 orders: List[List[int]], sampled: Dict, max_batch: int,
                 batch_window_ms: float):
        from omniparser_tpu_torch.serving.batcher import MicroBatcher

        self.pipe, self.rec, self.images = pipe, recorder, images
        self.clients, self.orders = clients, orders
        # (client, k) -> key of the sampled request
        self.sampled = sampled
        self.requests: List[Dict] = []
        self.batches: List[Dict] = []
        self.captured: Dict = {}
        self._lock = threading.Lock()
        self._marks: Dict[int, object] = {}  # id(item) -> sample key
        self._start: Dict[int, float] = {}   # id(item) -> batch start
        self.batcher = MicroBatcher(self._process, max_batch=max_batch,
                                    batch_window_ms=batch_window_ms)

    def _process(self, items):
        t0 = time.perf_counter()
        for it in items:
            self._start[id(it)] = t0
        capture = [i for i, it in enumerate(items) if id(it) in self._marks]
        self.rec.begin_batch(capture)
        results = self.pipe.parse_batch(items)
        t1 = time.perf_counter()
        lt = dict(self.pipe.last_timings)
        st = dict(self.pipe.stage_ms) if self.pipe.stage_ms is not None else {}
        self.batches.append({"size": len(items), "t0": t0, "t1": t1, "stage_ms": st, **lt})
        if capture:
            batch = self.rec.batch
            batch["keys"] = [self._marks.get(id(it)) for it in items]
            batch["images"] = list(items)
            batch["results"] = results
            for i in capture:
                self.captured[self._marks[id(items[i])]] = (batch, i)
        return results

    def _client(self, c: int, deadline: float) -> None:
        order = self.orders[c]
        k = 0
        while time.perf_counter() < deadline:
            # a view of its own: the batcher's items are told apart by identity
            img = self.images[order[k % len(order)]][...]
            key = self.sampled.get((c, k))
            if key is not None:
                with self._lock:
                    self._marks[id(img)] = key
            t_sub = time.perf_counter()
            fut = self.batcher.submit(img)
            err: Optional[str] = None
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
                err = f"{type(e).__name__}: {e}"
            t_done = time.perf_counter()
            with self._lock:
                self.requests.append({"client": c, "k": k, "submit": t_sub,
                                      "start": self._start.pop(id(img), t_sub),
                                      "end": t_done, "error": err,
                                      "pool_index": order[k % len(order)]})
            k += 1

    def run(self, seconds: float, during=None) -> Dict:
        """Drive the clients for `seconds`; `during(t0)` runs on this thread
        meanwhile (the traced run's profiler).

        The clients' threads are started before the window and released
        together at its start, so that their first requests reach the
        batcher at once: started one by one inside the window, the last of
        them often missed the batcher's window and the first batch went out
        short (2 to 7 of 8 screenshots in half the runs), one launch train
        more for the same work."""
        deadline = [0.0]
        go = threading.Event()

        def client(c):
            go.wait()
            self._client(c, deadline[0])

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(self.clients)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        deadline[0] = t0 + seconds
        go.set()
        if during is not None:
            during(t0)
        for t in threads:
            t.join()
        t1 = time.perf_counter()
        self.batcher.close()
        return {"t0": t0, "t1": t1, "window_s": t1 - t0}
