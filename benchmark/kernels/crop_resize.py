"""K3, the bilinear crop-gather (csrc/crop.cu), as a traced run records it.
The interface is the one that ``kernels/nms_keep.py`` writes down."""

from benchmark.harness import manifest as mf

MODULE, ATTR = "omniparser_tpu_torch.ops.hopper_crop", "crop_resize"
KERNELS = ("crop_resize_kernel",)
COUNT_BY = "crop_resize_kernel"

_flops = mf.load_module("flops", "crop_resize.py")


def keep(padded_u8, orig_hw, boxes_norm, out_size=64, grid="resize"):
    return boxes_norm, out_size, grid, tuple(int(v) for v in orig_hw)


def work(kept):
    boxes, out_size, _, hw = kept
    out_hw = (out_size, out_size) if isinstance(out_size, int) else tuple(out_size)
    return _flops.work(boxes.cpu().numpy(), out_hw, hw)
