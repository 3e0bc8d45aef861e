"""Key/value cache bytes that BLIP-2's beam decode moves a step, in GB: the
bytes its attention reads (the program's counter `beam.attn_bytes`) plus
those its cache reorders read and write (`beam.reorder_bytes`, where a
program still has them), over its decode steps (`beam.steps`) (traced
run).  None where the program counts no steps."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_spans", os.path.join(os.path.dirname(__file__), "_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(run):
    steps = _spans.count(run, "beam.steps")
    if not steps:
        return None
    moved = _spans.count(run, "beam.attn_bytes") + _spans.count(run, "beam.reorder_bytes")
    return moved / steps / 1e9
