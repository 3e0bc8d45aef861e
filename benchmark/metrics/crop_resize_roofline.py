"""The crop-gather (K3, csrc/crop.cu) against its roofline: per call, the
bilinear taps of every output pixel (float32 rate) or the boxes, the
source pixels under the boxes read once and the patches written
(memory rate), whichever bounds."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_roofline", os.path.join(os.path.dirname(__file__), "_roofline.py"))
_roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roofline)


def read(run):
    return _roofline.share(run, "crop_resize", "fp32_flops")
