"""The CTC line recogniser on one [3, H, W] line: its convolutions, two
transformer layers over W/4 frames and the CTC head.  flops(cfg) -> FLOPs
of one text line."""

NUM_CLASSES = 96


def macs(height: int = 32, width: int = 480, w: int = 64, layers: int = 2) -> int:
    total = 9 * 3 * w * height * width
    total += 9 * w * 2 * w * (height // 2) * (width // 2)
    total += 9 * 2 * w * 4 * w * (height // 4) * (width // 4)
    total += 9 * 4 * w * 4 * w * (height // 8) * (width // 4)
    t, d = width // 4, 4 * w
    per_layer = 4 * d * d + 2 * t * d + 2 * d * 4 * d  # projections, QK and AV, MLP
    return total + layers * t * per_layer + t * d * NUM_CLASSES


def flops(cfg) -> int:
    ocr = cfg["pipeline"]["ocr"]
    return 2 * macs(ocr.get("rec_height", 32), ocr.get("rec_max_width", 480))
