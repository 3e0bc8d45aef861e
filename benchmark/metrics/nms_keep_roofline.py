"""NMS (K1, csrc/nms.cu: the mask and scan kernels of one call) against its
roofline: per call, the IoU tests that greedy NMS over the valid
candidates needs (float32 rate) or the boxes, validity and keep mask
moved once (memory rate), whichever bounds."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metrics_roofline", os.path.join(os.path.dirname(__file__), "_roofline.py"))
_roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roofline)


def read(run):
    return _roofline.share(run, "nms_keep", "fp32_flops")
