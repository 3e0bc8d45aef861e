"""Caption slots decoded per caption served (the program's counters
`caption.slots`, each decode's padded bucket or batch of K crops, over
`caption.served`): 1.0 where no slot is padding (traced run)."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_spans", os.path.join(os.path.dirname(__file__), "_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(run):
    served = _spans.count(run, "caption.served")
    return _spans.count(run, "caption.slots") / served if served else None
