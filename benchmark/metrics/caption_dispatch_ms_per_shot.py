"""Host wall of the batched caption decode's dispatch (the program's span
`caption.dispatch`: queueing every chunk's encode and greedy steps, the
launch train that a captured graph would replace), per screenshot (traced
run)."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_spans", os.path.join(os.path.dirname(__file__), "_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(run):
    return _spans.host_ms_per_shot(run, "caption.dispatch")
