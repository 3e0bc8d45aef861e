"""90th percentile, by nearest rank, of the program's own span
`batcher.wait` (each request's wait in the serving batcher from submit to
the start of its batch), in a cell whose latency tail is host-paced (a
per-layer metric there; traced run)."""

import importlib.util
import math
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_spans", os.path.join(os.path.dirname(__file__), "_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(run):
    xs = sorted((s.t1 - s.t0) * 1e3 for s in _spans.spans(run, "batcher.wait"))
    if not xs:
        return None
    return xs[max(math.ceil(0.9 * len(xs)), 1) - 1]
