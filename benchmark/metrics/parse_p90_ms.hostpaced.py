"""90th percentile, by nearest rank, of submit -> result: the tail in a
cell where the host paces it too widely for an end-to-end bound."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_tail", os.path.join(os.path.dirname(__file__), "_tail.py"))
_tail = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tail)


def read(run):
    return _tail.p90_ms(run, "latency")
