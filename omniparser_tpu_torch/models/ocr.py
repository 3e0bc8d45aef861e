"""OCR in PyTorch: DBNet-style text detector + CTC line recogniser (and,
with ``OcrConfig.arch='easyocr'``, the networks of ``models/ocr_easy``).

  * detector: 4-stage conv backbone -> FPN merge at 1/4 scale -> 1-channel
    probability map at 1/2 scale (threshold + component boxes);
  * recogniser: conv stack collapsing height, transformer encoder over the
    width axis, CTC head over a 96-char english charset; greedy decode.

Modules are NCHW and their attribute names follow the JAX package's
auto-numbered parameter tree (``_ConvBlock_0``, ``Conv_0``, ``attn_0``
...), so that ``weights/convert.py`` carries weights over by name.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from omniparser_tpu_torch.config import OcrConfig
from omniparser_tpu_torch.ops.components import (
    candidate_boxes_np,
    device_components,
    quantize_u8_parity,
)
from omniparser_tpu_torch.ops.preprocess import (
    crop_lines_batch,
    letterbox,
    pad_to_bucket,
    pick_bucket_2d,
)

# charset: CTC blank at index 0
CHARSET = (
    " 0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
)
NUM_CLASSES = len(CHARSET) + 1  # + blank

LN_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad H and W as XLA's 'SAME' does: total = max((ceil(n/s)-1)*s +
    k - n, 0), the smaller half first — with stride 2 on an even size that
    is nothing before and one after."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad takes the last dim first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def layer_norm_f32(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm over the last dim computed in float32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class _ConvBlock(nn.Module):
    """3x3 conv ('SAME', no bias) + BatchNorm (float32) + ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.Conv_0 = nn.Conv2d(cin, features, 3, stride, 0, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5)

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
        return self.ctc_head(layer_norm_f32(h, self.ln_f))


def ctc_device_stats(logits: torch.Tensor):
    """CTC statistics for a batch: logits [M, T, C] -> (argmax ids [M, T]
    int32, mean char confidence [M], char count [M]).  Repeats and blanks
    are dropped as in a greedy CTC decode, so the confidence threshold can
    gate OCR boxes on the device; the string is assembled on the host."""
    probs = torch.softmax(logits.float(), dim=-1)
    maxp, ids = probs.max(dim=-1)
    ids = ids.to(torch.int32)
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    char_mask = (ids != 0) & (ids != prev)
    n_chars = char_mask.sum(dim=1).to(torch.int32)
    conf = torch.where(
        n_chars > 0,
        (maxp * char_mask).sum(dim=1) / torch.clamp(n_chars, min=1),
        torch.zeros_like(maxp[:, 0]),
    )
    return ids, conf, n_chars


def ids_to_text(ids_row, charset: str = CHARSET) -> str:
    """Host: collapse an argmax id row to its CTC string."""
    chars, prev = [], -1
    for i in np.asarray(ids_row):
        if i != prev and i != 0:
            chars.append(charset[i - 1])
        prev = i
    return "".join(chars)


def ctc_greedy_decode(logits: np.ndarray, charset: str = CHARSET) -> Tuple[str, float]:
    """Greedy CTC: argmax per step, collapse repeats, drop blanks.
    Returns (text, mean char prob)."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = probs.argmax(-1)
    conf = probs.max(-1)
    chars, confs, prev = [], [], -1
    for t, i in enumerate(ids):
        if i != prev and i != 0:
            chars.append(charset[i - 1])
            confs.append(conf[t])
        prev = i
    if not chars:
        return "", 0.0
    return "".join(chars), float(np.mean(confs))


def ctc_beam_decode(logits: np.ndarray, beam_width: int = 10,
                    charset: str = CHARSET) -> Tuple[str, float]:
    """CTC prefix beam search on the host: the analogue of easyocr's
    ``decoder='beamsearch', beamWidth=N``.  Returns (text, conf) where conf
    is the greedy mean char prob (the quantity text_threshold gates)."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    T, C = probs.shape
    # prune each step to the top-k symbols: the cost is T * k * beam
    k = min(beam_width, C)
    NEG = -1e30

    def logaddexp(a, b):
        if a < b:
            a, b = b, a
        if b <= NEG / 2:
            return a
        return a + np.log1p(np.exp(b - a))

    logp = np.log(np.maximum(probs, 1e-12))
    # beams: prefix tuple -> (log p ending in blank, log p ending in non-blank)
    beams = {(): (0.0, NEG)}
    for t in range(T):
        top = np.argpartition(-logp[t], k - 1)[:k]
        nxt = {}
        for prefix, (pb, pnb) in beams.items():
            for c in top:
                lp = logp[t, c]
                if c == 0:  # blank extends both endings, prefix unchanged
                    b, nb = nxt.get(prefix, (NEG, NEG))
                    nxt[prefix] = (logaddexp(b, logaddexp(pb, pnb) + lp), nb)
                    continue
                new_prefix = prefix + (int(c),)
                if prefix and prefix[-1] == c:
                    # a repeat: from a blank it is a new char, from a
                    # non-blank it collapses into the same prefix
                    b, nb = nxt.get(new_prefix, (NEG, NEG))
                    nxt[new_prefix] = (b, logaddexp(nb, pb + lp))
                    b, nb = nxt.get(prefix, (NEG, NEG))
                    nxt[prefix] = (b, logaddexp(nb, pnb + lp))
                else:
                    b, nb = nxt.get(new_prefix, (NEG, NEG))
                    nxt[new_prefix] = (b, logaddexp(nb, logaddexp(pb, pnb) + lp))
        beams = dict(sorted(nxt.items(), key=lambda kv: -logaddexp(*kv[1]))[:beam_width])
    best = max(beams.items(), key=lambda kv: logaddexp(*kv[1]))[0]
    _, conf = ctc_greedy_decode(logits, charset)
    return "".join(charset[i - 1] for i in best), conf


def merge_paragraphs(texts: List[str], boxes: List[List[int]], y_gap: float = 0.7,
                     x_gap: float = 1.5) -> Tuple[List[str], List[List[int]]]:
    """easyocr's ``paragraph=True``: union line boxes whose gaps are within
    (x_gap, y_gap) x line height, then join each group's texts in reading
    order (top to bottom, left to right) under the union box."""
    n = len(boxes)
    if n == 0:
        return texts, boxes
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        x1i, y1i, x2i, y2i = boxes[i]
        hi = max(y2i - y1i, 1)
        for j in range(i + 1, n):
            x1j, y1j, x2j, y2j = boxes[j]
            h = min(hi, max(y2j - y1j, 1))
            dx = max(x1i, x1j) - min(x2i, x2j)  # negative where they overlap
            dy = max(y1i, y1j) - min(y2i, y2j)
            if dx < x_gap * h and dy < y_gap * h:
                parent[find(i)] = find(j)
    groups: dict = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    out_texts, out_boxes = [], []
    for members in groups.values():
        members.sort(key=lambda i: (boxes[i][1], boxes[i][0]))
        out_texts.append(" ".join(texts[i] for i in members))
        out_boxes.append([
            min(boxes[i][0] for i in members), min(boxes[i][1] for i in members),
            max(boxes[i][2] for i in members), max(boxes[i][3] for i in members),
        ])
    order = sorted(range(len(out_boxes)), key=lambda g: (out_boxes[g][1], out_boxes[g][0]))
    return [out_texts[g] for g in order], [out_boxes[g] for g in order]


class TorchOCR:
    """The device OCR backend: both nets, the fused letterbox + detector +
    components step, and the recogniser's preprocessing.

    ``config.arch``: 'native' (``TextDetector`` + ``TextRecognizer``) or
    'easyocr' (``Craft`` + ``VggCtcRecognizer``, the reference's stack, with
    easyocr's charset; weights from ``config.easyocr_craft_pth`` /
    ``easyocr_rec_pth`` where given, ``weights/convert_ocr.py``).  Explicit
    states win over the config's files; None initialises from `generator`."""

    def __init__(self, config: OcrConfig, device="cuda", det_state=None,
                 rec_state=None, generator: Optional[torch.Generator] = None):
        from omniparser_tpu_torch.utils.device import resolve_device
        from omniparser_tpu_torch.weights.init import build_module

        self.config = config
        self.device = resolve_device(device)
        dtype = getattr(torch, config.dtype)
        if config.arch == "easyocr":
            from omniparser_tpu_torch.models import ocr_easy

            if det_state is None and rec_state is None and (
                    config.easyocr_craft_pth or config.easyocr_rec_pth):
                from omniparser_tpu_torch.weights.convert_ocr import load_easyocr_states

                det_state, rec_state = load_easyocr_states(config.easyocr_craft_pth,
                                                           config.easyocr_rec_pth)
            self.charset = ocr_easy.EASYOCR_EN_CHARSET
            self.det = build_module(ocr_easy.Craft(), det_state, generator, dtype,
                                    self.device, keep_f32=ocr_easy.CRAFT_F32)
            self.rec = build_module(ocr_easy.VggCtcRecognizer(), rec_state, generator, dtype,
                                    self.device, keep_f32=ocr_easy.RECOGNIZER_F32)
            # the 2x2 conv without padding after the /4 pools
            self.rec_len = config.rec_max_width // 4 - 1
        elif config.arch == "native":
            self.charset = CHARSET
            self.det = build_module(TextDetector(), det_state, generator, dtype, self.device,
                                    keep_f32=("Conv_3",))
            self.rec = build_module(
                TextRecognizer(seq_len=config.rec_max_width // 4), rec_state, generator,
                dtype, self.device, keep_f32=("ctc_head",))
            self.rec_len = config.rec_max_width // 4
        else:
            raise ValueError(f"OcrConfig.arch must be 'native' or 'easyocr', got {config.arch!r}")

    def rec_preprocess(self, crops_f255: torch.Tensor) -> torch.Tensor:
        """[N,H,W,3] float crops in [0,255] -> recogniser input: native
        [N,3,H,W] RGB/255; easyocr [N,1,H,W] grayscale, (x/255 - 0.5)/0.5."""
        if self.config.arch == "easyocr":
            gray = (crops_f255[..., 0] * 0.299 + crops_f255[..., 1] * 0.587
                    + crops_f255[..., 2] * 0.114)
            return (((gray / 255.0) - 0.5) / 0.5)[:, None]
        return (crops_f255 / 255.0).permute(0, 3, 1, 2)

    def decode_ids(self, ids_row) -> str:
        return ids_to_text(ids_row, self.charset)

    @torch.no_grad()
    def det_cc_full(self, padded: torch.Tensor, hw, max_cc: int = 1024):
        """Letterbox + detector + connected components.  The map is rounded
        to the uint8 grid first so thresholds see k/255 values."""
        img, _r, _pads = letterbox(padded, hw, self.config.det_imgsz)
        prob = torch.clamp(self.det(img.permute(2, 0, 1)[None])[0, 0].float(), 0.0, 1.0)
        return device_components(quantize_u8_parity(prob), 0.3, 0.3, min_area=4,
                                 max_out=max_cc, pre_cap=max_cc)

    @torch.no_grad()
    def det_full(self, padded: torch.Tensor, hw) -> torch.Tensor:
        """Letterbox + detector -> the probability map on the uint8 grid
        ([S/2, S/2] uint8, on the device), for the host components."""
        img, _r, _pads = letterbox(padded, hw, self.config.det_imgsz)
        prob = torch.clamp(self.det(img.permute(2, 0, 1)[None])[0, 0].float(), 0.0, 1.0)
        return (prob * 255.0 + 0.5).to(torch.uint8)

    def dispatch_det(self, padded: torch.Tensor, hw_host):
        """(detector output on the device, r, (pad_y, pad_x)): the component
        dict with ``config.device_components``, else the uint8 map.  The
        letterbox parameters are closed-form host math (Python floats)."""
        if self.config.device_components:
            out = self.det_cc_full(padded, hw_host)
        else:
            out = self.det_full(padded, hw_host)
        s = self.config.det_imgsz
        uh, uw = hw_host
        r = min(s / uh, s / uw)
        pads = ((s - uh * r) / 2.0, (s - uw * r) / 2.0)
        return out, r, pads

    def candidates_from_prob(self, prob, r, pads, h: int, w: int) -> List[List[int]]:
        """Host half: candidate pixel boxes in the (h, w) frame from what
        dispatch_det gave, the component dict (downloaded) or the uint8
        map (components on the host, ``utils/hostops``).  The unclip and
        unmap are ``candidate_boxes_np``, the float32 twin of the device
        path's ``candidate_boxes_from_cc``: both give the same integers."""
        from omniparser_tpu_torch.utils.hostops import extract_components

        if isinstance(prob, dict):
            cc = {k: v.cpu().numpy() for k, v in prob.items()}
            comps = [(tuple(int(v) for v in cc["boxes"][i]), float(cc["scores"][i]))
                     for i in range(int(cc["count"]))]
        else:
            p = prob.cpu().numpy() if isinstance(prob, torch.Tensor) else np.asarray(prob)
            if p.dtype == np.uint8:
                p = p.astype(np.float32) / 255.0
            comps = [(box, score) for box, score, _area in extract_components(p, 0.3, 4, 0.3)]
        # cap before the size filter: the device path slices the same
        # raster-ordered slots
        return candidate_boxes_np(comps[: self.config.max_text_boxes], r, pads, w, h)

    def detect_candidates(self, padded: torch.Tensor, hw, h: int, w: int) -> List[List[int]]:
        """Blocking: dispatch_det, download, candidate boxes."""
        prob, r, pads = self.dispatch_det(padded, (h, w))
        return self.candidates_from_prob(prob, r, pads, h, w)

    @torch.no_grad()
    def recognize(self, image_rgb, padded: Optional[torch.Tensor] = None, hw=None, *,
                  decoder: str = "greedy", beam_width: int = 10, paragraph: bool = False):
        """(texts, boxes xyxy px) with confidence above
        ``config.text_threshold``.  decoder / beam_width / paragraph are
        easyocr's readtext arguments; every line is recognised in one
        batch, padded to a multiple of 32 lines (the crops go through the
        crop-gather kernel's line grid)."""
        cfg = self.config
        h, w = image_rgb.shape[:2]
        if padded is None:
            hb, wb = pick_bucket_2d(h, w)
            padded = torch.from_numpy(pad_to_bucket(np.asarray(image_rgb), hb, wb)[0]).to(
                self.device)
        boxes_px = self.detect_candidates(padded, (h, w), h, w)
        if not boxes_px:
            return [], []
        n = len(boxes_px)
        norm = np.zeros((-(-n // 32) * 32, 4), np.float32)
        norm[:n] = np.asarray(boxes_px, np.float32) / np.array([w, h, w, h], np.float32)
        crops = crop_lines_batch(padded, (h, w), torch.from_numpy(norm).to(self.device),
                                 (cfg.rec_height, cfg.rec_max_width))
        logits = self.rec(self.rec_preprocess(crops)).float().cpu().numpy()
        if decoder == "beamsearch":
            decode = lambda lg: ctc_beam_decode(lg, beam_width, self.charset)
        else:
            decode = lambda lg: ctc_greedy_decode(lg, self.charset)
        texts, out_boxes = [], []
        for i in range(n):
            text, conf = decode(logits[i])
            if text and conf > cfg.text_threshold:
                texts.append(text)
                out_boxes.append(boxes_px[i])
        if paragraph:
            texts, out_boxes = merge_paragraphs(texts, out_boxes)
        return texts, out_boxes
