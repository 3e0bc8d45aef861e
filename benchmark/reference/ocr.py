"""The OCR networks in plain PyTorch: the DBNet-style text detector and the
CTC line recogniser.  A frozen copy of the measured package's module code,
so that the same state_dict loads into both."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.common import LN_EPS, FlaxBatchNorm2d, float32_region, layer_norm_f32, same_pad

CHARSET = (
    " 0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
)
NUM_CLASSES = len(CHARSET) + 1  # + blank


class _ConvBlock(nn.Module):
    """3x3 conv ('SAME', no bias) + BatchNorm (float32) + ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.Conv_0 = nn.Conv2d(cin, features, 3, stride, 0, bias=False)
        self.BatchNorm_0 = FlaxBatchNorm2d(features, eps=1e-5)

    def forward(self, x):
        y = self.Conv_0(same_pad(x, 3, self.stride))
        return F.relu(self.BatchNorm_0(y.float())).to(x.dtype)


def _up_to(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Bilinear resize to ref's H, W with half-pixel centres."""
    return F.interpolate(t.float(), size=ref.shape[-2:], mode="bilinear",
                         align_corners=False).to(t.dtype)


class TextDetector(nn.Module):
    """Segmentation net: [B,3,S,S] -> [B,1,S/2,S/2] probability map."""

    def __init__(self, width: int = 32, out_scale: int = 2):
        super().__init__()
        w = width
        self.out_scale = out_scale
        chans = [(3, w, 2), (w, w, 1), (w, 2 * w, 2), (2 * w, 2 * w, 1),
                 (2 * w, 4 * w, 2), (4 * w, 4 * w, 1), (4 * w, 8 * w, 2),
                 (8 * w, 8 * w, 1), (6 * w, 2 * w, 1), (2 * w, w, 1)]
        for i, (cin, cout, s) in enumerate(chans):
            setattr(self, f"_ConvBlock_{i}", _ConvBlock(cin, cout, s))
        self.Conv_0 = nn.Conv2d(8 * w, 2 * w, 1)
        self.Conv_1 = nn.Conv2d(4 * w, 2 * w, 1)
        self.Conv_2 = nn.Conv2d(2 * w, 2 * w, 1)
        self.Conv_3 = nn.Conv2d(w, 1, 1)  # stays float32 (see cast_compute_dtype)

    def forward(self, x):
        blk = lambda i: getattr(self, f"_ConvBlock_{i}")
        x = x.to(self.Conv_0.weight.dtype)
        c1 = blk(1)(blk(0)(x))   # 1/2
        c2 = blk(3)(blk(2)(c1))  # 1/4
        c3 = blk(5)(blk(4)(c2))  # 1/8
        c4 = blk(7)(blk(6)(c3))  # 1/16
        # FPN merge at 1/4
        p4 = self.Conv_0(c4)
        p3 = self.Conv_1(c3) + _up_to(p4, c3)
        p2 = self.Conv_2(c2) + _up_to(p3, c2)
        feat = torch.cat([p2, _up_to(p3, c2), _up_to(p4, c2)], dim=1)
        feat = blk(8)(feat)
        # head at 1/2: upsample fused features, one refining conv
        feat = blk(9)(_up_to(feat, c1))
        with float32_region(feat):
            return torch.sigmoid(self.Conv_3(feat.float()))


class _SelfAttention(nn.Module):
    """Multi-head self-attention with flax MultiHeadDotProductAttention's
    parameters: query/key/value/out projections with bias."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x):
        b, t, d = x.shape
        hd = d // self.heads
        split = lambda y: y.reshape(b, t, self.heads, hd).transpose(1, 2)
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        attn = (q / math.sqrt(hd)) @ k.transpose(-1, -2)
        attn = torch.softmax(attn, dim=-1)
        y = (attn @ v).transpose(1, 2).reshape(b, t, d)
        return self.out(y)


class TextRecognizer(nn.Module):
    """CTC line recogniser: [B, 3, 32, W] -> [B, W/4, NUM_CLASSES] logits.
    `seq_len` (= W/4) sizes the learned position embedding."""

    def __init__(self, width: int = 64, layers: int = 2, heads: int = 4,
                 seq_len: int = 120):
        super().__init__()
        w = width
        self.layers = layers
        self._ConvBlock_0 = _ConvBlock(3, w)
        self._ConvBlock_1 = _ConvBlock(w, 2 * w)
        self._ConvBlock_2 = _ConvBlock(2 * w, 4 * w)
        self._ConvBlock_3 = _ConvBlock(4 * w, 4 * w)
        d = 4 * w
        self.pos_embed = nn.Parameter(torch.zeros(1, seq_len, d))
        for i in range(layers):
            setattr(self, f"ln1_{i}", nn.LayerNorm(d, eps=LN_EPS))
            setattr(self, f"attn_{i}", _SelfAttention(d, heads))
            setattr(self, f"ln2_{i}", nn.LayerNorm(d, eps=LN_EPS))
            setattr(self, f"mlp_in_{i}", nn.Linear(d, 4 * d))
            setattr(self, f"mlp_out_{i}", nn.Linear(4 * d, d))
        self.ln_f = nn.LayerNorm(d, eps=LN_EPS)
        self.ctc_head = nn.Linear(d, NUM_CLASSES)  # stays float32

    def forward(self, x):
        dt = self.pos_embed.dtype
        x = x.to(dt)
        x = F.max_pool2d(self._ConvBlock_0(x), 2, 2)            # 16 x W/2
        x = F.max_pool2d(self._ConvBlock_1(x), 2, 2)            # 8 x W/4
        x = F.max_pool2d(self._ConvBlock_2(x), (2, 1), (2, 1))  # 4 x W/4
        x = F.max_pool2d(self._ConvBlock_3(x), (4, 1), (4, 1))  # 1 x W/4
        h = x.squeeze(2).transpose(1, 2) + self.pos_embed       # [B, T, C]
        for i in range(self.layers):
            a = layer_norm_f32(h, getattr(self, f"ln1_{i}")).to(dt)
            h = h + getattr(self, f"attn_{i}")(a)
            m = layer_norm_f32(h, getattr(self, f"ln2_{i}")).to(dt)
            m = getattr(self, f"mlp_in_{i}")(m)
            m = F.gelu(m, approximate="tanh")
            h = h + getattr(self, f"mlp_out_{i}")(m)
        with float32_region(h):
            return self.ctc_head(layer_norm_f32(h, self.ln_f))

