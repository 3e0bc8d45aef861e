"""Host wall of element assembly (the program's span `assemble`,
``_stage_finish``: text and icon elements from the download, the merge's
absorbed OCR text, label coordinates), per screenshot (traced run)."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_spans", os.path.join(os.path.dirname(__file__), "_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(run):
    return _spans.host_ms_per_shot(run, "assemble")
