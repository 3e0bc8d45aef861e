"""YOLOv8 in plain PyTorch: the network and the DFL decode.  A frozen copy
of the measured package's module code, so that the same state_dict loads
into both."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.common import FlaxBatchNorm2d

# depth_multiple, width_multiple, max_channels per published variant
VARIANTS = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}

REG_MAX = 16
STRIDES = (8, 16, 32)


def _ch(base: int, wm: float, maxc: int) -> int:
    return int(min(base, maxc) * wm + 0.5) if base != 3 else 3


def _depth(n: int, dm: float) -> int:
    return max(round(n * dm), 1)


class ConvBNAct(nn.Module):
    """Conv2d + BatchNorm + SiLU (ultralytics 'Conv').  The convolution
    runs in the module's dtype; BatchNorm (eps 1e-3) and SiLU in float32."""

    def __init__(self, cin: int, features: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, kernel // 2, bias=False)
        self.bn = FlaxBatchNorm2d(features, eps=1e-3, flax_momentum=0.97)

    def forward(self, x):
        y = self.bn(self.conv(x).float())
        return F.silu(y).to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBNAct(cin, features, 3)
        self.cv2 = ConvBNAct(features, features, 3)
        self.add = shortcut and cin == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks (ultralytics C2f)."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        self.c = features // 2
        self.n = n
        self.cv1 = ConvBNAct(cin, 2 * self.c, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(self.c, self.c, shortcut))
        self.cv2 = ConvBNAct((2 + n) * self.c, features, 1)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 maxpools."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        c = cin // 2
        self.cv1 = ConvBNAct(cin, c, 1)
        self.cv2 = ConvBNAct(4 * c, features, 1)

    def forward(self, x):
        x = self.cv1(x)
        pools = [x]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.cv2(torch.cat(pools, dim=1))


class DetectHead(nn.Module):
    """Decoupled anchor-free head: per-level box (4*REG_MAX) + cls logits."""

    def __init__(self, num_classes: int, channels: Sequence[int]):
        super().__init__()
        self.levels = len(channels)
        c2 = max(16, channels[0] // 4, 4 * REG_MAX)
        c3 = max(channels[0], min(num_classes, 100))
        for i, c in enumerate(channels):
            setattr(self, f"box{i}_0", ConvBNAct(c, c2, 3))
            setattr(self, f"box{i}_1", ConvBNAct(c2, c2, 3))
            setattr(self, f"box{i}_2", nn.Conv2d(c2, 4 * REG_MAX, 1))
            setattr(self, f"cls{i}_0", ConvBNAct(c, c3, 3))
            setattr(self, f"cls{i}_1", ConvBNAct(c3, c3, 3))
            setattr(self, f"cls{i}_2", nn.Conv2d(c3, num_classes, 1))

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            box = getattr(self, f"box{i}_2")(
                getattr(self, f"box{i}_1")(getattr(self, f"box{i}_0")(x)))
            cls = getattr(self, f"cls{i}_2")(
                getattr(self, f"cls{i}_1")(getattr(self, f"cls{i}_0")(x)))
            outs.append((box, cls))
        return outs


class YOLOv8(nn.Module):
    """Backbone + PAN neck + detect head.  Input: [B, 3, S, S] float in
    [0,1]; output: per level (box [B,64,h,w], cls [B,nc,h,w])."""

    def __init__(self, variant: str = "n", num_classes: int = 1):
        super().__init__()
        dm, wm, maxc = VARIANTS[variant]
        ch = lambda b: _ch(b, wm, maxc)
        d = lambda n: _depth(n, dm)
        self.stem = ConvBNAct(3, ch(64), 3, 2)
        self.down2 = ConvBNAct(ch(64), ch(128), 3, 2)
        self.c2f_2 = C2f(ch(128), ch(128), d(3), True)
        self.down3 = ConvBNAct(ch(128), ch(256), 3, 2)
        self.c2f_3 = C2f(ch(256), ch(256), d(6), True)
        self.down4 = ConvBNAct(ch(256), ch(512), 3, 2)
        self.c2f_4 = C2f(ch(512), ch(512), d(6), True)
        self.down5 = ConvBNAct(ch(512), ch(1024), 3, 2)
        self.c2f_5 = C2f(ch(1024), ch(1024), d(3), True)
        self.sppf = SPPF(ch(1024), ch(1024))
        self.neck_p4 = C2f(ch(1024) + ch(512), ch(512), d(3), False)
        self.neck_p3 = C2f(ch(512) + ch(256), ch(256), d(3), False)
        self.neck_down3 = ConvBNAct(ch(256), ch(256), 3, 2)
        self.neck_p4b = C2f(ch(256) + ch(512), ch(512), d(3), False)
        self.neck_down4 = ConvBNAct(ch(512), ch(512), 3, 2)
        self.neck_p5 = C2f(ch(512) + ch(1024), ch(1024), d(3), False)
        self.head = DetectHead(num_classes, [ch(256), ch(512), ch(1024)])

    def forward(self, x):
        x = x.to(self.stem.conv.weight.dtype)
        x = self.down2(self.stem(x))
        x = self.c2f_2(x)
        p3 = self.c2f_3(self.down3(x))
        p4 = self.c2f_4(self.down4(p3))
        p5 = self.sppf(self.c2f_5(self.down5(p4)))

        up2 = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        n4 = self.neck_p4(torch.cat([up2(p5), p4], dim=1))
        n3 = self.neck_p3(torch.cat([up2(n4), p3], dim=1))
        n4b = self.neck_p4b(torch.cat([self.neck_down3(n3), n4], dim=1))
        n5 = self.neck_p5(torch.cat([self.neck_down4(n4b), p5], dim=1))
        return self.head((n3, n4b, n5))


def decode_predictions(level_outputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """DFL decode: per-level (box_logits [B,64,h,w], cls_logits [B,nc,h,w])
    -> [B, A, 4] xyxy in letterboxed pixels + [B, A, nc] sigmoid scores,
    concatenated over levels."""
    boxes_all: List[torch.Tensor] = []
    scores_all: List[torch.Tensor] = []
    for (box, cls), stride in zip(level_outputs, STRIDES):
        b, _, h, w = box.shape
        dev = box.device
        bins = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
        box = box.float().permute(0, 2, 3, 1).reshape(b, h * w, 4, REG_MAX)
        dist = torch.softmax(box, dim=-1) @ bins  # [B, HW, 4] ltrb in stride units
        cy, cx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij",
        )
        anchors = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)
        lt = anchors[None] - dist[..., :2]
        rb = anchors[None] + dist[..., 2:]
        boxes_all.append(torch.cat([lt, rb], dim=-1) * stride)
        scores_all.append(torch.sigmoid(cls.float().permute(0, 2, 3, 1).reshape(b, h * w, -1)))
    return torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1)
