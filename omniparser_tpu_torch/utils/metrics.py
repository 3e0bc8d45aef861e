"""Serving observability: counters, latency histograms, structured logs.

A thread-safe in-process metrics registry exposed as ``GET /metrics/``
(JSON, or Prometheus text exposition with ``?format=prometheus``) and
one-JSON-line-per-event structured logging to stderr, both stdlib-only.
The same registry as the JAX package's ``utils/metrics.py``; this package
keeps its own copy.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Tuple

# Latency buckets (seconds): from a parse of about 0.1 s up to a tail of
# about 10 s.
DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Metrics:
    """Thread-safe counters + fixed-bucket histograms.

    Names use Prometheus conventions (``snake_case``, ``_total`` suffix for
    counters, ``_seconds`` for time histograms). Labels are encoded in the
    name by the caller (e.g. ``responses_total{code="200"}``) to keep the
    registry a flat dict.  A histogram keeps the buckets of its first
    observation (`buckets`, else the registry's).
    """

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self._buckets = tuple(buckets)
        self._counters: Dict[str, float] = {}
        # name -> (edges, [per-bucket counts..., +Inf count, sum, count])
        self._hists: Dict[str, Tuple[Tuple[float, ...], List[float]]] = {}
        self._started = time.time()

    def count(self, name: str, n: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def observe(self, name: str, value: float, buckets=None) -> None:
        with self._lock:
            if name not in self._hists:
                edges = tuple(buckets or self._buckets)
                self._hists[name] = (edges, [0.0] * (len(edges) + 3))
            edges, h = self._hists[name]
            for i, edge in enumerate(edges):
                if value <= edge:
                    h[i] += 1
            h[len(edges)] += 1  # +Inf
            h[-2] += value  # sum
            h[-1] += 1  # count

    # ------------------------------------------------------------------ #

    def snapshot(self) -> dict:
        with self._lock:
            hists = {}
            for name, (edges, h) in self._hists.items():
                count = h[-1]
                hists[name] = {
                    "count": count,
                    "sum": round(h[-2], 6),
                    "mean": round(h[-2] / count, 6) if count else 0.0,
                    "buckets": {str(edge): h[i] for i, edge in enumerate(edges)},
                }
            return {
                "uptime_s": round(time.time() - self._started, 1),
                "counters": dict(self._counters),
                "histograms": hists,
            }

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        with self._lock:
            for name, v in sorted(self._counters.items()):
                base = name.split("{", 1)[0]
                lines.append(f"# TYPE {base} counter")
                lines.append(f"{name} {v:g}")
            for name, (edges, h) in sorted(self._hists.items()):
                lines.append(f"# TYPE {name} histogram")
                for i, edge in enumerate(edges):
                    lines.append(f'{name}_bucket{{le="{edge}"}} {h[i]:g}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {h[len(edges)]:g}')
                lines.append(f"{name}_sum {h[-2]:g}")
                lines.append(f"{name}_count {h[-1]:g}")
        return "\n".join(lines) + "\n"


def structured_logging_enabled() -> bool:
    return os.environ.get("OMNIPARSER_LOG", "").lower() in ("json", "1", "true")


def jlog(event: str, _stream=None, **fields) -> None:
    """One JSON line per event to stderr when OMNIPARSER_LOG=json."""
    if not structured_logging_enabled():
        return
    rec = {"ts": round(time.time(), 3), "event": event}
    rec.update(fields)
    print(json.dumps(rec, default=str), file=_stream or sys.stderr, flush=True)
