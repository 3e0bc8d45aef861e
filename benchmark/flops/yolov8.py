"""YOLOv8 at a square letterbox: the convolutions' multiply-adds, from the
published layout (ultralytics yolov8.yaml) and the variant's widths, and
the DFL decode's product.  flops(cfg) -> FLOPs (2 per multiply-add) of one
screenshot."""

VARIANTS = {"n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024), "m": (0.67, 0.75, 768),
            "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512)}
REG_MAX = 16


def _conv(cin, cout, k, s, h, w):
    ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
    return k * k * cin * cout * ho * wo, ho, wo


def macs(imgsz: int, variant: str = "n", nc: int = 1) -> int:
    dm, wm, maxc = VARIANTS[variant]
    ch = lambda b: int(min(b, maxc) * wm + 0.5)
    d = lambda n: max(round(n * dm), 1)
    total = 0

    def conv(cin, cout, k, s, hw):
        nonlocal total
        m, ho, wo = _conv(cin, cout, k, s, *hw)
        total += m
        return ho, wo

    def c2f(cin, cout, n, hw):
        c = cout // 2
        conv(cin, 2 * c, 1, 1, hw)
        for _ in range(n):
            conv(c, c, 3, 1, hw)
            conv(c, c, 3, 1, hw)
        conv((2 + n) * c, cout, 1, 1, hw)

    hw = conv(3, ch(64), 3, 2, (imgsz, imgsz))
    hw = conv(ch(64), ch(128), 3, 2, hw)
    c2f(ch(128), ch(128), d(3), hw)
    p3 = conv(ch(128), ch(256), 3, 2, hw)
    c2f(ch(256), ch(256), d(6), p3)
    p4 = conv(ch(256), ch(512), 3, 2, p3)
    c2f(ch(512), ch(512), d(6), p4)
    p5 = conv(ch(512), ch(1024), 3, 2, p4)
    c2f(ch(1024), ch(1024), d(3), p5)
    conv(ch(1024), ch(1024) // 2, 1, 1, p5)                 # SPPF
    conv(4 * (ch(1024) // 2), ch(1024), 1, 1, p5)
    c2f(ch(1024) + ch(512), ch(512), d(3), p4)              # PAN
    c2f(ch(512) + ch(256), ch(256), d(3), p3)
    conv(ch(256), ch(256), 3, 2, p3)
    c2f(ch(256) + ch(512), ch(512), d(3), p4)
    conv(ch(512), ch(512), 3, 2, p4)
    c2f(ch(512) + ch(1024), ch(1024), d(3), p5)
    c0 = ch(256)
    c2, c3 = max(16, c0 // 4, 4 * REG_MAX), max(c0, min(nc, 100))
    anchors = 0
    for c, hw in zip((ch(256), ch(512), ch(1024)), (p3, p4, p5)):
        conv(c, c2, 3, 1, hw)
        conv(c2, c2, 3, 1, hw)
        conv(c2, 4 * REG_MAX, 1, 1, hw)
        conv(c, c3, 3, 1, hw)
        conv(c3, c3, 3, 1, hw)
        conv(c3, nc, 1, 1, hw)
        anchors += hw[0] * hw[1]
    return total + anchors * 4 * REG_MAX                     # DFL expectation


def flops(cfg) -> int:
    det = cfg["pipeline"]["detector"]
    return 2 * macs(det.get("default_imgsz", 1280), det.get("variant", "n"),
                    det.get("num_classes", 1))
