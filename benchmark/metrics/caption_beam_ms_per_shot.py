"""Device time of BLIP-2's beam search (the program's device span
`caption.beam`: the step loop with its cache reorders, after the vision
tower and the prefill), per screenshot (traced run)."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_spans", os.path.join(os.path.dirname(__file__), "_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(run):
    return _spans.device_ms_per_shot(run, "caption.beam")
