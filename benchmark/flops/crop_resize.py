"""Work of one crop-gather call (K3, csrc/crop.cu) at its inputs: each
output value is one bilinear blend of four taps (8 float32 operations),
each output value (float32) is written once, each box (16 bytes) read
once, and of the source pixels (3 bytes) under a box, those that the
output samples: the box's own pixels, or four taps per output pixel where
the box is larger than the patch."""

def work(boxes_norm, out_hw, hw):
    """boxes_norm: [K, 4] normalised xyxy (numpy); out_hw (oh, ow); hw (h, w)."""
    import numpy as np

    h, w = hw
    oh, ow = out_hw
    b = np.asarray(boxes_norm, np.float32)
    cw = np.maximum(np.trunc(b[:, 2] * w) - np.trunc(b[:, 0] * w), 1)
    ch = np.maximum(np.trunc(b[:, 3] * h) - np.trunc(b[:, 1] * h), 1)
    src = np.minimum(cw * ch, 4 * oh * ow) * 3
    k = b.shape[0]
    out_vals = k * oh * ow * 3
    return 8 * out_vals, int(4 * out_vals + 16 * k + src.sum())
