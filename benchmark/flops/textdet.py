"""The DBNet-style text detector at its square letterbox: the
convolutions' multiply-adds ('SAME' padding: outputs ceil(n / stride)).
flops(cfg) -> FLOPs of one screenshot."""


def macs(imgsz: int, width: int = 32) -> int:
    w = width
    size = lambda s: -(-imgsz // s)
    px = lambda s: size(s) * size(s)
    blocks = [(3, w, 2), (w, w, 2), (w, 2 * w, 4), (2 * w, 2 * w, 4), (2 * w, 4 * w, 8),
              (4 * w, 4 * w, 8), (4 * w, 8 * w, 16), (8 * w, 8 * w, 16), (6 * w, 2 * w, 4),
              (2 * w, w, 2)]  # (cin, cout, output stride) of each 3x3 block
    total = sum(9 * cin * cout * px(s) for cin, cout, s in blocks)
    total += 8 * w * 2 * w * px(16) + 4 * w * 2 * w * px(8) + 2 * w * 2 * w * px(4)
    return total + w * 1 * px(2)


def flops(cfg) -> int:
    return 2 * macs(cfg["pipeline"]["ocr"].get("det_imgsz", 1920))
