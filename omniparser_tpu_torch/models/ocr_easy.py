"""easyocr's OCR architectures in PyTorch: CRAFT text detection and the
english_g2 VGG-BiLSTM-CTC recogniser.

The reference's OCR is ``easyocr.Reader(['en'])``: CRAFT
(``craft_mlt_25k.pth``) finds text, the english_g2 network reads it.  These
modules restate those public architectures layer for layer (NCHW), with
attribute names that follow the JAX package's parameter tree, so that
``weights/convert.py`` carries the JAX package's trees over by name and
``weights/convert_ocr.py`` maps the upstream checkpoints.  The
bidirectional LSTMs are ``nn.LSTM(bidirectional=True)`` (cuDNN on the
card): torch's own parameter layout (``weight_ih`` [4H, I], gates i, f,
g, o), which the JAX package restates; they, the height pooling and the
CTC head run in float32.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from omniparser_tpu_torch.models.norm import FlaxBatchNorm2d

# easyocr's english charset (number + symbol + en_char, the english_g2
# order); the CTC blank is index 0
EASYOCR_EN_CHARSET = (
    "0123456789!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~ "
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
)


class _ConvBN(nn.Module):
    """Conv + optional BatchNorm (eps 1e-5, float32) + optional ReLU.  The
    input is cast to the conv's dtype, so a module kept float32 computes in
    float32."""

    def __init__(self, cin: int, features: int, kernel: Union[int, Tuple[int, int]] = 3,
                 padding: int = 1, dilation: int = 1, use_bn: bool = True,
                 relu: bool = True, use_bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, 1, padding, dilation, bias=use_bias)
        self.bn = FlaxBatchNorm2d(features, eps=1e-5) if use_bn else None
        self.relu = relu

    def forward(self, x):
        y = self.conv(x.to(self.conv.weight.dtype))
        if self.bn is not None:
            y = self.bn(y.float()).to(self.conv.weight.dtype)
        return F.relu(y) if self.relu else y


class CraftVGG(nn.Module):
    """vgg16_bn sliced as CRAFT uses it: (relu2_2, relu3_2, relu4_3,
    relu5_3, fc7), each slice ending before its ReLU."""

    def __init__(self):
        super().__init__()
        specs = {
            "s1c0": (3, 64), "s1c1": (64, 64), "s1c2": (64, 128), "s1c3": (128, 128),
            "s2c0": (128, 256), "s2c1": (256, 256),
            "s3c0": (256, 256), "s3c1": (256, 512), "s3c2": (512, 512),
            "s4c0": (512, 512), "s4c1": (512, 512), "s4c2": (512, 512),
        }
        slice_ends = ("s1c3", "s2c1", "s3c2", "s4c2")
        for name, (cin, cout) in specs.items():
            setattr(self, name, _ConvBN(cin, cout, relu=name not in slice_ends))
        self.s5c0 = _ConvBN(512, 1024, 3, padding=6, dilation=6, use_bn=False, relu=False)
        self.s5c1 = _ConvBN(1024, 1024, 1, padding=0, use_bn=False, relu=False)

    def forward(self, x):
        pool = lambda t: F.max_pool2d(t, 2, 2)
        x = self.s1c3(self.s1c2(pool(self.s1c1(self.s1c0(x)))))
        relu2_2 = x
        x = self.s2c1(self.s2c0(pool(F.relu(x))))
        relu3_2 = x
        x = self.s3c2(self.s3c1(pool(self.s3c0(F.relu(x)))))
        relu4_3 = x
        x = self.s4c2(self.s4c1(pool(self.s4c0(F.relu(x)))))
        relu5_3 = x
        x = self.s5c1(self.s5c0(F.max_pool2d(relu5_3, 3, 1, 1)))
        return relu2_2, relu3_2, relu4_3, relu5_3, x


class _DoubleConv(nn.Module):
    """CRAFT double_conv: 1x1 (in -> mid) + 3x3 (mid -> out), both BN+ReLU."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.c0 = _ConvBN(cin, mid, 1, padding=0)
        self.c1 = _ConvBN(mid, out, 3, padding=1)

    def forward(self, x):
        return self.c1(self.c0(x))


def _up_to(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Bilinear resize to ref's H, W with half-pixel centres (float32)."""
    return F.interpolate(t.float(), size=ref.shape[-2:], mode="bilinear",
                         align_corners=False).to(ref.dtype)


class Craft(nn.Module):
    """CRAFT: U-Net over vgg16_bn.  [B, 3, H, W] -> [B, 2, H/2, W/2] =
    (region score, affinity score)."""

    def __init__(self):
        super().__init__()
        self.basenet = CraftVGG()
        self.upconv1 = _DoubleConv(1024 + 512, 512, 256)
        self.upconv2 = _DoubleConv(256 + 512, 256, 128)
        self.upconv3 = _DoubleConv(128 + 256, 128, 64)
        self.upconv4 = _DoubleConv(64 + 128, 64, 32)
        self.cls0 = _ConvBN(32, 32, use_bn=False)
        self.cls1 = _ConvBN(32, 32, use_bn=False)
        self.cls2 = _ConvBN(32, 16, use_bn=False)
        self.cls3 = _ConvBN(16, 16, 1, padding=0, use_bn=False)
        self.cls4 = _ConvBN(16, 2, 1, padding=0, use_bn=False, relu=False)

    def forward(self, x):
        relu2_2, relu3_2, relu4_3, relu5_3, fc7 = self.basenet(x)
        y = self.upconv1(torch.cat([fc7, relu5_3], dim=1))
        y = self.upconv2(torch.cat([_up_to(y, relu4_3), relu4_3], dim=1))
        y = self.upconv3(torch.cat([_up_to(y, relu3_2), relu3_2], dim=1))
        feat = self.upconv4(torch.cat([_up_to(y, relu2_2), relu2_2], dim=1))
        return self.cls4(self.cls3(self.cls2(self.cls1(self.cls0(feat)))))


class BidirectionalLSTM(nn.Module):
    """easyocr's BidirectionalLSTM: a bidirectional LSTM and a linear
    projection, in float32."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.rnn = nn.LSTM(cin, hidden, bidirectional=True, batch_first=True)
        self.linear = nn.Linear(2 * hidden, out)

    def forward(self, x):
        h, _ = self.rnn(x.float())
        return self.linear(h)


class VggCtcRecognizer(nn.Module):
    """easyocr's 'generation2' english recogniser: VGG feature extractor ->
    average over the height -> two BidirectionalLSTMs -> CTC linear head.
    Input [B, 1, H, W] grayscale; output [B, W/4 - 1, classes] float32
    logits (blank = class 0)."""

    def __init__(self, output_channel: int = 256, hidden: int = 256,
                 num_classes: int = len(EASYOCR_EN_CHARSET) + 1):
        super().__init__()
        c = [output_channel // 8, output_channel // 4, output_channel // 2, output_channel]
        self.f0 = _ConvBN(1, c[0], use_bn=False)
        self.f1 = _ConvBN(c[0], c[1], use_bn=False)
        self.f2 = _ConvBN(c[1], c[2], use_bn=False)
        self.f3 = _ConvBN(c[2], c[2], use_bn=False)
        self.f4 = _ConvBN(c[2], c[3], use_bias=False)
        self.f5 = _ConvBN(c[3], c[3], use_bias=False)
        self.f6 = _ConvBN(c[3], c[3], 2, padding=0, use_bn=False)
        self.rnn0 = BidirectionalLSTM(c[3], hidden, hidden)
        self.rnn1 = BidirectionalLSTM(hidden, hidden, hidden)
        self.pred = nn.Linear(hidden, num_classes)

    def forward(self, x):
        x = F.max_pool2d(self.f0(x), 2, 2)
        x = F.max_pool2d(self.f1(x), 2, 2)
        x = F.max_pool2d(self.f3(self.f2(x)), (2, 1), (2, 1))
        x = F.max_pool2d(self.f5(self.f4(x)), (2, 1), (2, 1))
        x = self.f6(x)
        seq = x.float().mean(dim=2).transpose(1, 2)  # [B, W', C]: easyocr pools the height
        return self.pred(self.rnn1(self.rnn0(seq)))


# float32 parameters under a bfloat16 build: the LSTMs and heads
RECOGNIZER_F32 = ("rnn0.rnn", "rnn0.linear", "rnn1.rnn", "rnn1.linear", "pred")
CRAFT_F32 = ("cls4.conv",)
