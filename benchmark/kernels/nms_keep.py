"""K1, the greedy NMS keep mask (csrc/nms.cu: a mask kernel and a scan
kernel a call), as a traced run records it.

Each file of benchmark/kernels/ is one hand-written kernel, found by its
file's name (the `<name>` of the metric `<name>_roofline`), and names:

  MODULE, ATTR   the port's function that launches the kernel, by module
                 and attribute: a traced run wraps it there
  keep(...)      what the harness keeps of one call, from the call's own
                 arguments, which it takes by the port function's names
                 (no device value is read in the window)
  work(kept)     (operations, bytes) of that call, by the formula of
                 benchmark/flops/<name>.py
  KERNELS        substrings of the kernel's names in the device trace
  COUNT_BY       the substring of the one launch that each call makes
"""

from benchmark.harness import manifest as mf

MODULE, ATTR = "omniparser_tpu_torch.ops.nms", "nms_keep"
KERNELS = ("nms_mask_kernel", "nms_scan")
COUNT_BY = "nms_mask_kernel"

_flops = mf.load_module("flops", "nms_keep.py")


def keep(sorted_boxes, sorted_valid, iou_threshold):
    return sorted_valid


def work(sorted_valid):
    return _flops.work(int(sorted_valid.numel()), int(sorted_valid.sum()))
