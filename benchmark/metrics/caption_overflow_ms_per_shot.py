"""Device time of the caption overflow (the program's device span
`caption.boxes` around each per-screenshot decode of the icons past K),
per screenshot (traced run; 0 where no screenshot overflowed)."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_spans", os.path.join(os.path.dirname(__file__), "_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(run):
    return _spans.device_ms_per_shot(run, "caption.boxes")
