"""The OCR stage as the reference's ``check_ocr_box`` shows it.

Backends implement ``recognize(image_rgb, padded, hw) -> (texts,
boxes_xyxy_px)`` with the confidence filter already applied:

  'jax'      the first-party DBNet-style detector + CTC recogniser
             (``models/ocr.TorchOCR``; the name is the JAX package's)
  'easyocr'  host EasyOCR where it is installed (a gated import)
  'paddle'   host PaddleOCR where it is installed (a gated import)
  'null'     no text (a detection-only parse)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from omniparser_tpu_torch.config import OcrConfig


class NullOCR:
    """No text: the parse is detection-only."""

    def recognize(self, image_rgb, padded=None, hw=None):
        return [], []


def _quad_to_xyxy(quad):
    xs = [p[0] for p in quad]
    ys = [p[1] for p in quad]
    return [int(min(xs)), int(min(ys)), int(max(xs)), int(max(ys))]


class EasyOCRBackend:
    """Host EasyOCR, the reference server's engine."""

    def __init__(self, config: OcrConfig):
        import easyocr  # gated: raises ImportError where it is not installed

        self.reader = easyocr.Reader(["en"])
        self.config = config

    def recognize(self, image_rgb, padded=None, hw=None):
        results = self.reader.readtext(np.asarray(image_rgb),
                                       text_threshold=self.config.text_threshold)
        return [t for _q, t, _c in results], [_quad_to_xyxy(q) for q, _t, _c in results]


class PaddleOCRBackend:
    """Host PaddleOCR with the reference's filter: keep score > text_threshold."""

    def __init__(self, config: OcrConfig):
        from paddleocr import PaddleOCR  # gated

        self.ocr = PaddleOCR(lang="en", use_angle_cls=False, show_log=False)
        self.config = config

    def recognize(self, image_rgb, padded=None, hw=None):
        result = self.ocr.ocr(np.asarray(image_rgb), cls=False)[0] or []
        kept = [(q, t) for q, (t, score) in result if score > self.config.text_threshold]
        return [t for _q, t in kept], [_quad_to_xyxy(q) for q, _t in kept]


def make_ocr_backend(config: OcrConfig, weights=None, device="cuda"):
    """The backend `config.backend` names.  weights (the 'jax' backend):
    None is a seeded init, 'auto' the committed trained tree ocr_en_synth
    (raises where it is missing), a path an orbax directory or exported .npz."""
    if config.backend == "null":
        return NullOCR()
    if config.backend == "jax":
        from omniparser_tpu_torch.models.ocr import TorchOCR
        from omniparser_tpu_torch.pipeline import ocr_states_from_field

        det_s, rec_s = ocr_states_from_field(weights, config) or (None, None)
        return TorchOCR(config, device, det_s, rec_s)
    if config.backend == "easyocr":
        return EasyOCRBackend(config)
    if config.backend == "paddle":
        return PaddleOCRBackend(config)
    raise ValueError(f"unknown OCR backend {config.backend!r}")


_BACKEND_CACHE: Dict[Tuple[OcrConfig, str], object] = {}


def _default_backend(cfg: OcrConfig, device="cuda"):
    """One default backend per (config, device), with weights 'auto': the
    reference keeps module-level reader singletons, and a TorchOCR per call
    would rebuild its networks every time.  Where easyocr / paddleocr are
    not installed the 'jax' backend reads the text, as in the reference
    package."""
    key = (cfg, str(device))
    backend = _BACKEND_CACHE.get(key)
    if backend is None:
        try:
            backend = make_ocr_backend(cfg, weights="auto", device=device)
        except ImportError:
            backend = make_ocr_backend(
                OcrConfig(backend="jax", text_threshold=cfg.text_threshold), weights="auto",
                device=device)
        _BACKEND_CACHE[key] = backend
    return backend


def check_ocr_box(image_source, display_img: bool = False, output_bb_format: str = "xywh",
                  goal_filtering=None, easyocr_args: dict | None = None,
                  use_paddleocr: bool = False, backend=None, device="cuda"):
    """The reference's entry: ((texts, boxes), goal_filtering) with boxes in
    xywh or xyxy pixels.  easyocr_args: text_threshold (for the default
    backend), decoder ('greedy' | 'beamsearch'), beamWidth and paragraph
    (for the first-party backend); batch_size has no effect (one batch)."""
    from omniparser_tpu_torch.models.ocr import TorchOCR
    from omniparser_tpu_torch.utils.image import load_image_rgb

    if isinstance(image_source, str):
        image_rgb = load_image_rgb(image_source)
    else:
        img = image_source
        if hasattr(img, "convert"):
            img = np.asarray(img.convert("RGB"))
        image_rgb = np.asarray(img)

    args = dict(easyocr_args or {})
    if backend is None:
        cfg = OcrConfig(
            backend="paddle" if use_paddleocr else "jax",
            text_threshold=args.get("text_threshold", 0.5 if use_paddleocr else 0.8))
        backend = _default_backend(cfg, device)

    kwargs = {}
    if isinstance(backend, TorchOCR):
        kwargs = dict(decoder=args.get("decoder", "greedy"),
                      beam_width=args.get("beamWidth", 10),
                      paragraph=args.get("paragraph", False))
    texts, boxes_xyxy = backend.recognize(image_rgb, **kwargs)
    if output_bb_format == "xywh":
        bb = [[x1, y1, x2 - x1, y2 - y1] for x1, y1, x2, y2 in boxes_xyxy]
    else:
        bb = [list(b) for b in boxes_xyxy]
    return (texts, bb), goal_filtering
