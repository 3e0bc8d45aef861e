"""90th percentile, by nearest rank, of each request's wait from submit to
the start of the parse_batch call that carried it, in a cell whose latency
tail is host-paced (a per-layer metric there)."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_tail", os.path.join(os.path.dirname(__file__), "_tail.py"))
_tail = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tail)


def read(run):
    return _tail.p90_ms(run, "queue_wait")
