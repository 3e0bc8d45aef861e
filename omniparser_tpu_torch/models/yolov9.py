"""YOLOv9-class (GELAN) icon detector in PyTorch.

The reference v2's default detector, ``icon_detect_v3/model.pt``, is a
YOLOv9-E TorchScript that the reference drives with a thin wrapper of its
own (letterbox, multi-stride decode, per-class NMS).  This module gives
both halves:

  * the GELAN deploy-form network as NCHW ``nn.Module``s (RepNCSPELAN4,
    ADown, SPPELAN, and for the dual 'e' form the CBLinear taps that
    CBFuse sums into a second backbone), reusing ``models/yolov8``'s
    ``ConvBNAct``, DFL ``DetectHead`` and ``decode_predictions``; the
    attribute names follow the JAX package's parameter tree so that
    ``weights/convert.py`` carries weights over by name;
  * ``YOLOv9Detector``: the fixed-shape ``detect_graph`` of
    ``yolov8.Detector`` (it drops into the pipeline's fused step
    unchanged), and ``predict`` with the reference wrapper's semantics:
    PIL-LANCZOS centred 114-pad letterbox, strict ``>`` confidence filter,
    per-class NMS by the coordinate-offset trick (through the NMS kernel),
    unpad and clamp, an ultralytics-shaped ``Result(Boxes)``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from omniparser_tpu_torch.models.yolov8 import (
    ConvBNAct,
    DetectHead,
    Detector,
    decode_predictions,
)
from omniparser_tpu_torch.ops.nms import nms_fixed_shape

# per backbone stage (out, elan_mid, rep_mid), the SPPELAN (out, mid), per
# neck block (out, elan_mid, rep_mid), ELAN depth and stem widths.  'c' is
# the published gelan-c layout; 'e' (icon_detect_v3) the dual-branch
# gelan-e deploy form; 'test' / 'dualtest' tiny forms of the same graphs.
_TINY = dict(
    stages=((16, 8, 4), (32, 16, 8), (32, 32, 16), (32, 32, 16)),
    sppelan=(32, 16),
    neck=((32, 32, 16), (16, 16, 8), (32, 32, 16), (32, 32, 16)),
    depth=1,
    stem=(8, 16),
)
VARIANTS = {
    "c": dict(
        form="single",
        stages=((256, 128, 64), (512, 256, 128), (512, 512, 256), (512, 512, 256)),
        sppelan=(512, 256),
        neck=((512, 512, 256), (256, 256, 128), (512, 512, 256), (512, 512, 256)),
        depth=1,
        stem=(64, 128),
    ),
    "e": dict(
        form="dual",
        stages=((256, 128, 64), (512, 256, 128), (1024, 512, 256), (1024, 512, 256)),
        sppelan=(512, 256),
        neck=((512, 512, 256), (256, 256, 128), (512, 512, 256), (512, 1024, 512)),
        depth=2,
        stem=(64, 128),
    ),
    "test": dict(form="single", **_TINY),
    "dualtest": dict(form="dual", **_TINY),
}


class RepNBottleneck(nn.Module):
    """Deploy-form RepConvN (a plain 3x3 conv at inference) + 3x3 conv."""

    def __init__(self, cin: int, features: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBNAct(cin, features, 3)
        self.cv2 = ConvBNAct(features, features, 3)
        self.add = shortcut and cin == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepNCSP(nn.Module):
    """CSP over n RepNBottlenecks (e = 0.5)."""

    def __init__(self, cin: int, features: int, n: int = 1):
        super().__init__()
        c = features // 2
        self.n = n
        self.cv1 = ConvBNAct(cin, c, 1)
        self.cv2 = ConvBNAct(cin, c, 1)
        for i in range(n):
            setattr(self, f"m{i}", RepNBottleneck(c, c, True))
        self.cv3 = ConvBNAct(2 * c, features, 1)

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


class RepNCSPELAN4(nn.Module):
    """GELAN block: 1x1 in and split, two chained (RepNCSP -> 3x3 conv)
    branches, all four parts concatenated, 1x1 out."""

    def __init__(self, cin: int, features: int, mid: int, rep_mid: int, n: int = 1):
        super().__init__()
        self.c = mid // 2
        self.cv1 = ConvBNAct(cin, mid, 1)
        self.cv2_csp = RepNCSP(mid - self.c, rep_mid, n)
        self.cv2_conv = ConvBNAct(rep_mid, rep_mid, 3)
        self.cv3_csp = RepNCSP(rep_mid, rep_mid, n)
        self.cv3_conv = ConvBNAct(rep_mid, rep_mid, 3)
        self.cv4 = ConvBNAct(mid + 2 * rep_mid, features, 1)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c:]]
        parts.append(self.cv2_conv(self.cv2_csp(parts[-1])))
        parts.append(self.cv3_conv(self.cv3_csp(parts[-1])))
        return self.cv4(torch.cat(parts, dim=1))


class ADown(nn.Module):
    """Downsample: 2x2 average pool (stride 1), channel split, a 3x3-s2 conv
    branch and a 3x3-s2 max-pool -> 1x1 conv branch, concatenated."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        c = features // 2
        self.half = cin // 2
        self.cv1 = ConvBNAct(self.half, c, 3, 2)
        self.cv2 = ConvBNAct(cin - self.half, c, 1)

    def forward(self, x):
        x = F.avg_pool2d(x, 2, 1)
        x1, x2 = x[:, : self.half], x[:, self.half:]
        return torch.cat([self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))], dim=1)


class SPPELAN(nn.Module):
    """Spatial pyramid: 1x1 in, three chained 5x5 max-pools, 1x1 out."""

    def __init__(self, cin: int, features: int, mid: int):
        super().__init__()
        self.cv1 = ConvBNAct(cin, mid, 1)
        self.cv5 = ConvBNAct(4 * mid, features, 1)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.cv5(torch.cat(pools, dim=1))


class CBLinear(nn.Module):
    """A biased 1x1 conv (no norm, no activation) whose output splits into
    the per-scale chunks that CBFuse sites of the second backbone take."""

    def __init__(self, cin: int, out_channels: Sequence[int]):
        super().__init__()
        self.out_channels = [int(c) for c in out_channels]
        self.conv = nn.Conv2d(cin, sum(self.out_channels), 1, bias=True)

    def forward(self, x):
        return torch.split(self.conv(x), self.out_channels, dim=1)


def cb_fuse(chunks, target: torch.Tensor) -> torch.Tensor:
    """CBFuse: nearest-resize every chunk to the target's spatial size and
    sum them with the target.  'nearest-exact' samples (o + 0.5) * in/out,
    as the JAX package's resize does; at whole upsampling factors it is
    plain 'nearest'."""
    out = target
    for c in chunks:
        out = out + F.interpolate(c, size=target.shape[-2:], mode="nearest-exact").to(
            target.dtype)
    return out


class GELAN(nn.Module):
    """Backbone + PAN neck + DFL detect head.  Input [B, 3, H, W] in [0,1];
    output per level (box [B,64,h,w], cls [B,nc,h,w]).

    form 'single' (gelan-c): one backbone chain.  form 'dual' (gelan-e,
    icon_detect_v3's deploy graph): backbone A feeds five CBLinear taps
    whose chunks CBFuse sums into backbone B at each scale."""

    def __init__(self, variant: str = "e", num_classes: int = 1):
        super().__init__()
        spec = VARIANTS[variant]
        (s3, s4, s5, s5b), (spp, spp_mid) = spec["stages"], spec["sppelan"]
        n = spec["depth"]
        c1, c2 = spec["stem"]
        self.dual = spec["form"] == "dual"
        elan = lambda cin, s: RepNCSPELAN4(cin, *s, n)
        if self.dual:
            self.stemA = ConvBNAct(3, c1, 3, 2)
            self.downA2 = ConvBNAct(c1, c2, 3, 2)
            self.elanA2 = elan(c2, s3)
            self.adownA3 = ADown(s3[0], s3[0])
            self.elanA3 = elan(s3[0], s4)
            self.adownA4 = ADown(s4[0], s4[0])
            self.elanA4 = elan(s4[0], s5)
            self.adownA5 = ADown(s5[0], s5[0])
            self.elanA5 = elan(s5[0], s5b)
            targets = (c1, c2, s3[0], s4[0], s5[0])
            tap_ch = (c1, s3[0], s4[0], s5[0], s5b[0])
            for i in range(5):
                setattr(self, f"cb{i + 1}", CBLinear(tap_ch[i], targets[: i + 1]))
            self.stemB = ConvBNAct(3, c1, 3, 2)
            self.downB2 = ConvBNAct(c1, c2, 3, 2)
            self.elanB2 = elan(c2, s3)
            self.adownB3 = ADown(s3[0], s3[0])
            self.elanB3 = elan(s3[0], s4)
            self.adownB4 = ADown(s4[0], s4[0])
            self.elanB4 = elan(s4[0], s5)
            self.adownB5 = ADown(s5[0], s5[0])
            self.elanB5 = elan(s5[0], s5b)
        else:
            self.stem = ConvBNAct(3, c1, 3, 2)
            self.down2 = ConvBNAct(c1, c2, 3, 2)
            self.elan2 = elan(c2, s3)
            self.adown3 = ADown(s3[0], s3[0])
            self.elan3 = elan(s3[0], s4)
            self.adown4 = ADown(s4[0], s4[0])
            self.elan4 = elan(s4[0], s5)
            self.adown5 = ADown(s5[0], s5[0])
            self.elan5 = elan(s5[0], s5b)
        self.sppelan = SPPELAN(s5b[0], spp, spp_mid)
        n4_s, n3_s, d4_s, d5_s = spec["neck"]
        self.neck_p4 = elan(spp + s5[0], n4_s)
        self.neck_p3 = elan(n4_s[0] + s4[0], n3_s)
        self.neck_down3 = ADown(n3_s[0], n3_s[0])
        self.neck_p4b = elan(n3_s[0] + n4_s[0], d4_s)
        self.neck_down4 = ADown(d4_s[0], d4_s[0])
        self.neck_p5 = elan(d4_s[0] + spp, d5_s)
        self.head = DetectHead(num_classes, [n3_s[0], d4_s[0], d5_s[0]])

    def _backbone_dual(self, x):
        a1 = self.stemA(x)
        a3 = self.elanA2(self.downA2(a1))
        a5 = self.elanA3(self.adownA3(a3))
        a7 = self.elanA4(self.adownA4(a5))
        a9 = self.elanA5(self.adownA5(a7))
        cbs = [getattr(self, f"cb{i + 1}")(t) for i, t in enumerate((a1, a3, a5, a7, a9))]
        b = cb_fuse([cbs[j][0] for j in range(5)], self.stemB(x))
        b = cb_fuse([cbs[j][1] for j in range(1, 5)], self.downB2(b))
        b = cb_fuse([cbs[j][2] for j in range(2, 5)], self.adownB3(self.elanB2(b)))
        p3 = self.elanB3(b)
        b = cb_fuse([cbs[j][3] for j in range(3, 5)], self.adownB4(p3))
        p4 = self.elanB4(b)
        b = cb_fuse([cbs[4][4]], self.adownB5(p4))
        return p3, p4, self.sppelan(self.elanB5(b))

    def _backbone_single(self, x):
        x = self.elan2(self.down2(self.stem(x)))
        p3 = self.elan3(self.adown3(x))
        p4 = self.elan4(self.adown4(p3))
        return p3, p4, self.sppelan(self.elan5(self.adown5(p4)))

    def forward(self, x):
        first = self.stemA if self.dual else self.stem
        x = x.to(first.conv.weight.dtype)
        p3, p4, p5 = self._backbone_dual(x) if self.dual else self._backbone_single(x)
        up2 = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        n4 = self.neck_p4(torch.cat([up2(p5), p4], dim=1))
        n3 = self.neck_p3(torch.cat([up2(n4), p3], dim=1))
        n4b = self.neck_p4b(torch.cat([self.neck_down3(n3), n4], dim=1))
        n5 = self.neck_p5(torch.cat([self.neck_down4(n4b), p5], dim=1))
        return self.head((n3, n4b, n5))


# --------------------------------------------------------------------- #
# The reference wrapper's semantics                                      #
# --------------------------------------------------------------------- #


def normalize_image_size(image_size) -> Tuple[int, int]:
    """(width, height), each rounded up to a multiple of 32 (an int is a
    square, a pair is (H, W))."""
    if isinstance(image_size, int):
        width = height = image_size
    elif len(image_size) == 2:
        height, width = image_size
    else:
        raise ValueError(f"Expected one or two image dimensions, got {image_size}")
    return ((int(width) + 31) // 32) * 32, ((int(height) + 31) // 32) * 32


def preprocess_pil(image, image_size):
    """The reference's preprocessing: LANCZOS resize to int-truncated dims,
    centred integer 114-pad.  Returns (float32 [H, W, 3] in [0,1], scale,
    pad_left, pad_top)."""
    from pathlib import Path

    from PIL import Image

    if isinstance(image, (str, Path)):
        image = Image.open(image)
    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    image = image.convert("RGB")
    tw, th = normalize_image_size(image_size)
    iw, ih = image.size
    scale = min(tw / iw, th / ih)
    rw, rh = int(iw * scale), int(ih * scale)
    pad_left, pad_top = (tw - rw) // 2, (th - rh) // 2
    resized = image.resize((rw, rh), Image.Resampling.LANCZOS)
    padded = Image.new("RGB", (tw, th), (114, 114, 114))
    padded.paste(resized, (pad_left, pad_top))
    arr = np.asarray(padded, dtype=np.float32) / 255.0
    return arr, scale, pad_left, pad_top


class Boxes:
    """Ultralytics-compatible result container."""

    def __init__(self, xyxy: np.ndarray, confidence: np.ndarray):
        self.xyxy = xyxy
        self.conf = confidence


class Result:
    def __init__(self, boxes: Boxes):
        self.boxes = boxes


def class_offset_window(boxes: torch.Tensor, scores_all: torch.Tensor, conf: float, k: int):
    """The per-class NMS window: the top-k of the strict-``>`` confidence
    filter (a stable sort: ties keep the lower index) with each box moved
    by its class times a data-dependent stride (max - min + 1 over the
    window), so that boxes of two classes never overlap.  Returns
    (offset boxes, boxes, scores, valid, overflow)."""
    scores, class_ids = scores_all.max(dim=-1)
    keep = scores > conf
    k = min(k, boxes.shape[0])
    masked = torch.where(keep, scores, torch.full_like(scores, -1.0))
    top_scores, top_idx = torch.sort(masked, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    top_boxes = boxes[top_idx]
    stride = top_boxes.max() - top_boxes.min() + 1.0
    offset = (class_ids[top_idx].to(torch.float32) * stride)[:, None]
    overflow = torch.clamp(keep.sum() - k, min=0)
    return top_boxes + offset, top_boxes, top_scores, top_scores > 0, overflow


@dataclasses.dataclass(frozen=True)
class YOLOv9Detector(Detector):
    """``yolov8.Detector``'s fixed-shape ``detect_graph`` over a GELAN
    network (it drops into the pipeline and ``compat.predict_yolo``), plus
    the reference wrapper's ``predict``."""

    variant: str = "e"

    def make_module(self) -> GELAN:
        return GELAN(self.variant, self.num_classes)

    def predict(self, module: GELAN, source, conf: float = 0.25, imgsz=640,
                iou: float = 0.7, max_det: int = 300):
        """The reference's ``predict``: [Result(Boxes(xyxy px, conf))] on the
        original image's scale, clamped to its bounds."""
        arr, scale, pad_left, pad_top = preprocess_pil(source, imgsz)
        img = torch.from_numpy(arr).to(next(module.parameters()).device)
        with torch.no_grad():
            boxes, scores_all = decode_predictions(module(img.permute(2, 0, 1)[None]))
            offset_boxes, top_boxes, top_scores, top_valid, overflow = class_offset_window(
                boxes[0], scores_all[0], conf, max(self.prefilter, max_det * 2))
            _, ns, idx, nv = nms_fixed_shape(offset_boxes, top_scores, top_valid, iou, max_det)
        # boxes in letterboxed pixels; unpad and clamp on the host
        boxes_lb, scores, valid, overflow = (t.cpu().numpy() for t in (
            top_boxes[idx.to(torch.int64)], ns, nv, overflow))
        if int(overflow) > 0:
            warnings.warn(
                f"yolov9 prefilter overflow: {int(overflow)} above-threshold "
                "candidates beyond the top-k window (raise prefilter)", RuntimeWarning)
        boxes = boxes_lb[valid].astype(np.float32)
        scores = np.asarray(scores[valid], np.float32)
        if hasattr(source, "shape"):  # numpy
            ih, iw = np.asarray(source).shape[:2]
        else:  # PIL
            iw, ih = source.size
        boxes[:, [0, 2]] = np.clip((boxes[:, [0, 2]] - pad_left) / scale, 0, iw)
        boxes[:, [1, 3]] = np.clip((boxes[:, [1, 3]] - pad_top) / scale, 0, ih)
        return [Result(Boxes(boxes, scores))]
