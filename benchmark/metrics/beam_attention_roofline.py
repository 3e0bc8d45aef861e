"""BLIP-2's beam decode attention (csrc/beam_attention.cu) against its
roofline: per call, the keys and values of the shared prefix and of each
beam's own positions, the ancestry table's rows, the query and the output
moved once (memory rate), or the scores, softmax and weighted sums of
every beam and head (float32 rate), whichever bounds
(benchmark/flops/beam_attention.py)."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_roofline", os.path.join(os.path.dirname(__file__), "_roofline.py"))
_roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roofline)


def read(run):
    return _roofline.share(run, "beam_attention", "fp32_flops")
