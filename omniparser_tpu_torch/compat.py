"""The reference's function API, for a drop-in migration.

Users of the reference import ``check_ocr_box``, ``get_som_labeled_img``,
``get_yolo_model`` and ``get_caption_model_processor`` from ``util.utils``;
this module gives the same names over this package's pipeline, so a call
site ports with an import swap:

    from omniparser_tpu_torch.compat import (
        check_ocr_box, get_caption_model_processor, get_som_labeled_img,
        get_yolo_model)

    model = get_yolo_model("icon_detect/model.pt")            # ultralytics .pt
    caption = get_caption_model_processor("florence2", "icon_caption")  # HF dir
    (texts, boxes), _ = check_ocr_box(image, output_bb_format="xyxy")
    som_b64, label_coordinates, elements = get_som_labeled_img(
        image, model, BOX_TRESHOLD=0.05, ocr_bbox=boxes, ocr_text=texts,
        caption_model_processor=caption)

A model is a ``(Detector, module)`` pair (a ``YOLOv9Detector`` is a
``Detector``).  Every function that computes on a device takes ``device=``
(default the card); a model handed to one must be on that device.  Unlike
the JAX package's, ``get_caption_model_processor`` loads a 'blip2' or
'phi3_v' checkpoint from the path it is given (the JAX package seeds those
whatever the path).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from omniparser_tpu_torch.config import CaptionerConfig, DetectorConfig, PipelineConfig
from omniparser_tpu_torch.ocr import check_ocr_box  # noqa: F401  (the same signature)
from omniparser_tpu_torch.utils.device import resolve_device

# one pipeline per (config, models, device), first in first out
_PIPELINE_CACHE: Dict = {}
_PIPELINE_CACHE_MAX = 4
_compat_lock = threading.Lock()


def get_xywh(input) -> Tuple[int, int, int, int]:
    """Quad (4 corner points) -> int xywh."""
    x, y = input[0][0], input[0][1]
    w, h = input[2][0] - input[0][0], input[2][1] - input[0][1]
    return int(x), int(y), int(w), int(h)


def get_xyxy(input) -> Tuple[int, int, int, int]:
    """Quad -> int xyxy."""
    return int(input[0][0]), int(input[0][1]), int(input[2][0]), int(input[2][1])


def get_xywh_yolo(input) -> Tuple[int, int, int, int]:
    """xyxy list -> int xywh."""
    return (int(input[0]), int(input[1]),
            int(input[2] - input[0]), int(input[3] - input[1]))


def _rgb(image) -> np.ndarray:
    if hasattr(image, "convert"):  # a PIL image
        image = image.convert("RGB")
    return np.asarray(image)


def _model_device(module: torch.nn.Module, device) -> torch.device:
    """`device`, resolved; raises where the module's weights lie elsewhere."""
    dev = resolve_device(device)
    at = next(module.parameters()).device
    if at.type != dev.type or (dev.index is not None and at.index != dev.index):
        raise ValueError(f"the model is on {at}, not on device={str(device)!r}")
    return dev


def _upload(img: np.ndarray, dev: torch.device) -> torch.Tensor:
    from omniparser_tpu_torch.ops.preprocess import pad_to_bucket, pick_bucket_2d

    hb, wb = pick_bucket_2d(*img.shape[:2])
    return torch.from_numpy(pad_to_bucket(img, hb, wb)[0]).to(dev)


def predict_yolo(model: Tuple, image, box_threshold: float, imgsz=None,
                 scale_img: bool = False, iou_threshold: float = 0.7, device="cuda"):
    """One image -> (boxes xyxy in pixels, confidences, phrases).

    imgsz, where given, is snapped to a letterbox bucket (the reference
    forwards it only with scale_img, but its demo's slider expects it to
    act); scale_img needs nothing more: the image is always letterboxed."""
    from omniparser_tpu_torch.models.yolov8 import snap_imgsz

    detector, module = model
    if imgsz is not None:
        detector = dataclasses.replace(detector, imgsz=snap_imgsz(imgsz))
    img = _rgb(image)
    h, w = img.shape[:2]
    dev = _model_device(module, device)
    boxes_norm, scores, valid = detector.detect_graph(
        module, _upload(img, dev), (h, w), box_threshold, iou_threshold)
    boxes_norm, scores, valid = (t.cpu().numpy() for t in (boxes_norm, scores, valid))
    boxes_px = boxes_norm[valid] * np.array([w, h, w, h], np.float32)
    conf = scores[valid]
    return boxes_px, conf, [str(i) for i in range(len(boxes_px))]


def remove_overlap(boxes, iou_threshold: float, ocr_bbox: Optional[List] = None,
                   device="cuda"):
    """The reference's v1 filter, vectorised: drop a box where a smaller box
    overlaps it above the threshold; with ocr_bbox, also drop boxes that
    overlap an OCR box without lying more than 95% inside it.  Returns the
    OCR boxes, then the kept boxes."""
    from omniparser_tpu_torch.ops.boxes import (
        box_area,
        containment_ratio,
        pairwise_max_overlap_ratio,
    )

    dev = resolve_device(device)
    b = torch.from_numpy(np.asarray(boxes, np.float32).reshape(-1, 4)).to(dev)
    n = b.shape[0]
    if n == 0:
        return np.zeros((0, 4), np.float32)
    ratio = pairwise_max_overlap_ratio(b, b)
    area = box_area(b)
    not_self = ~torch.eye(n, dtype=torch.bool, device=dev)
    keep = ~(not_self & (ratio > iou_threshold) & (area[:, None] > area[None, :])).any(1)
    if ocr_bbox:
        o = torch.from_numpy(np.asarray(ocr_bbox, np.float32).reshape(-1, 4)).to(dev)
        overlap = pairwise_max_overlap_ratio(b, o) > iou_threshold
        inside = containment_ratio(b, o) > 0.95
        keep = keep & ~(overlap & ~inside).any(1)
    kept = b[keep].cpu().numpy()
    if ocr_bbox:
        kept = np.concatenate([np.asarray(ocr_bbox, np.float32).reshape(-1, 4), kept])
    return kept


def get_parsed_content_icon(filtered_boxes, starting_idx, image_source,
                            caption_model_processor, prompt=None, batch_size: int = 128,
                            device="cuda") -> List[str]:
    """Captions of the boxes from starting_idx on.  filtered_boxes: [N,4]
    normalised xyxy; caption_model_processor: a captioner (anything with
    ``caption_crops(crops, valid)``).  The crops go through the crop-gather
    kernel, batch_size at a time."""
    from omniparser_tpu_torch.ops.preprocess import crop_resize_batch

    img = _rgb(image_source)
    h, w = img.shape[:2]
    boxes = np.asarray(filtered_boxes, np.float32).reshape(-1, 4)
    if starting_idx:
        boxes = boxes[starting_idx:]
    if len(boxes) == 0:
        return []
    dev = resolve_device(device)
    padded = _upload(img, dev)
    crop_size = getattr(caption_model_processor, "config", CaptionerConfig()).crop_size
    pad_n = -(-len(boxes) // batch_size) * batch_size
    arr = np.zeros((pad_n, 4), np.float32)
    arr[: len(boxes)] = boxes
    valid = np.zeros(pad_n, bool)
    valid[: len(boxes)] = True
    out: List[str] = []
    for s in range(0, pad_n, batch_size):
        crops = crop_resize_batch(padded, (h, w), torch.from_numpy(arr[s:s + batch_size]).to(dev),
                                  crop_size)
        out.extend(caption_model_processor.caption_crops(crops, valid[s:s + batch_size]))
    return out


def load_image(image_path: str):
    """The legacy DINO-style loader: (image RGB uint8, normalised CHW
    float32) with the shorter side resized to 800 px, the longer capped at
    1333, ImageNet mean and std.  The parse path does not use it."""
    from PIL import Image

    src = Image.open(image_path).convert("RGB")
    image = np.asarray(src)
    w, h = src.size
    scale = min(800.0 / min(h, w), 1333.0 / max(h, w))
    tw, th = round(w * scale), round(h * scale)
    resized = np.asarray(src.resize((tw, th), Image.BILINEAR), np.float32) / 255.0
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return image, ((resized - mean) / std).transpose(2, 0, 1)


def predict(model, image, caption: str, box_threshold: float, text_threshold: float,
            device="cuda"):
    """Grounded detection with the reference's signature: (boxes xyxy px,
    logits, phrases).  The reference calls a GroundingDINO-class model;
    here the detector finds boxes, the captioner captions each crop, and a
    caption is grounded on the '.'-separated query phrases by word overlap
    (logit = confidence x overlap).  model: {'model': (Detector, module),
    'processor': captioner} or a bare (Detector, module)."""
    detector_pair = model["model"] if isinstance(model, dict) else model
    captioner = model.get("processor") if isinstance(model, dict) else None
    img = _rgb(image)
    boxes, conf, _ = predict_yolo(detector_pair, img, box_threshold, device=device)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    conf = np.asarray(conf, np.float32).reshape(-1)
    queries = [p.strip().lower() for p in caption.split(".") if p.strip()]
    if not len(boxes) or not queries:
        return boxes[:0], conf[:0], []
    if captioner is not None:
        h, w = img.shape[:2]
        texts = get_parsed_content_icon(boxes / np.array([w, h, w, h], np.float32), 0, img,
                                        captioner, device=device)
    else:  # no captioner: nothing to ground on
        texts = [""] * len(boxes)

    def overlap(text: str, query: str) -> float:
        q = set(query.split())
        return len(set(text.lower().split()) & q) / len(q) if q else 0.0

    keep_boxes, logits, phrases = [], [], []
    for i, text in enumerate(texts):
        scores = [overlap(text, q) for q in queries]
        j = int(np.argmax(scores))
        if scores[j] >= text_threshold:
            keep_boxes.append(boxes[i])
            logits.append(conf[i] * scores[j])
            phrases.append(queries[j])
    return (np.array(keep_boxes, np.float32).reshape(-1, 4),
            np.array(logits, np.float32), phrases)


def get_yolo_model(model_path: Optional[str] = None, variant: str = "n", device="cuda"):
    """(Detector, module): YOLOv8 from an ultralytics ``.pt`` or torch
    state_dict (``weights/convert_yolo.py``); an ``icon_detect_v3`` path or
    a 'v9*' variant builds the GELAN family, as the reference routes any
    ``icon_detect_v3`` path to its YOLOv9-E wrapper (a yolov9 TorchScript
    or state dict, ``weights/convert_yolov9.py``); a seeded init without a
    path.

    Deliberate default, as the JAX package's: with no path and no variant
    this is YOLOv8-n (the reference defaults to YOLOv9-E there); pass
    variant='v9e' for the reference's default."""
    from omniparser_tpu_torch.pipeline import (
        detector_state_from_field,
        detector_variant,
        make_detector,
    )
    from omniparser_tpu_torch.weights.init import build_module

    dev = resolve_device(device)
    det = make_detector(DetectorConfig(variant=detector_variant(variant, model_path)))
    module = build_module(det.make_module(), detector_state_from_field(model_path, det),
                          torch.Generator().manual_seed(0), getattr(torch, DetectorConfig.dtype),
                          dev)
    return det, module


def get_caption_model_processor(model_name: str = "florence2",
                                model_name_or_path: Optional[str] = None, device="cuda"):
    """A captioner (the reference's model + processor pair in one object):
    Florence-2 from an HF checkpoint directory, or a seeded florence-2-base
    without a path; 'blip2' (the reference's beam settings: 5 beams, 100
    new tokens) from an HF blip2-opt-2.7b directory
    (``weights/convert_blip2.py``), or seeded at full width without one;
    'phi3_v' (batches of 5, greedy, 25 new tokens) from an HF
    Phi-3-vision directory (``weights/convert_phi3v.py``), or seeded at
    full width without one."""
    from omniparser_tpu_torch.models.florence2 import FlorenceCaptioner

    if model_name == "blip2":
        from omniparser_tpu_torch.models.blip2 import Blip2Captioner

        cfg = CaptionerConfig(model_name="blip2", backend="blip2", max_new_tokens=100)
        if model_name_or_path:
            return Blip2Captioner.from_checkpoint(model_name_or_path, cfg, device=device)
        return Blip2Captioner(cfg, device=device)
    if "phi3" in model_name:
        from omniparser_tpu_torch.models.phi3v import Phi3VCaptioner

        cfg = CaptionerConfig(model_name="phi3_v", backend="phi3v", max_new_tokens=25)
        if model_name_or_path:
            return Phi3VCaptioner.from_checkpoint(model_name_or_path, cfg, device=device)
        return Phi3VCaptioner(cfg, device=device)
    if model_name != "florence2":
        raise NotImplementedError(
            f"caption model {model_name!r} not implemented (florence2, blip2, phi3_v)")
    cfg = CaptionerConfig()
    if model_name_or_path:
        return FlorenceCaptioner.from_checkpoint(model_name_or_path, cfg, device=device)
    return FlorenceCaptioner(cfg, device=device)


def get_parsed_content_icon_phi3v(filtered_boxes, ocr_bbox, image_source,
                                  caption_model_processor, device="cuda") -> List[str]:
    """The reference's Phi-3-V caption call: the first len(ocr_bbox) boxes
    are OCR and skipped; batches of the captioner's batch_size (5)."""
    n_skip = len(ocr_bbox) if ocr_bbox else 0
    return get_parsed_content_icon(
        filtered_boxes, n_skip, image_source, caption_model_processor,
        batch_size=getattr(caption_model_processor, "batch_size", 5), device=device)


class _ProvidedOCR:
    """The OCR backend of one get_som_labeled_img call: the caller's boxes
    and texts."""

    def __init__(self, texts, boxes):
        self.texts, self.boxes = list(texts), [list(b) for b in (boxes or [])]

    def recognize(self, image_rgb, padded=None, hw=None):
        return self.texts, self.boxes


def get_som_labeled_img(image_source, model: Optional[Tuple] = None,
                        BOX_TRESHOLD: float = 0.01, output_coord_in_ratio: bool = False,
                        ocr_bbox: Optional[List] = None, text_scale: float = 0.4,
                        text_padding: int = 5, draw_bbox_config: Optional[Dict] = None,
                        caption_model_processor=None, ocr_text: List[str] = [],
                        use_local_semantics: bool = True, iou_threshold: float = 0.9,
                        prompt=None, scale_img: bool = False, imgsz=None,
                        batch_size: int = 128, device="cuda"):
    """The reference's call over this package's pipeline -> (SOM image
    base64, label_coordinates, parsed content list).  ocr_bbox: pixel xyxy;
    ocr_text: the strings beside them (what check_ocr_box returned).
    model=None builds the configured detector (weights 'auto')."""
    from omniparser_tpu_torch.models.yolov8 import snap_imgsz
    from omniparser_tpu_torch.pipeline import SOMPipeline
    from omniparser_tpu_torch.utils.image import encode_image_base64, load_image_rgb

    image_rgb = (load_image_rgb(image_source) if isinstance(image_source, str)
                 else _rgb(image_source))
    # thresholds are per call, not part of the key: a sweep reuses one
    # pipeline; imgsz is in the key (it changes the letterbox bucket)
    base = PipelineConfig()
    use_cap = bool(use_local_semantics and caption_model_processor)
    det_cfg = base.detector
    if imgsz is not None:
        det_cfg = dataclasses.replace(det_cfg, default_imgsz=snap_imgsz(imgsz))
    cfg = dataclasses.replace(
        base, detector=det_cfg, use_local_semantics=use_local_semantics,
        output_coord_in_ratio=output_coord_in_ratio,
        captioner=dataclasses.replace(base.captioner, batch_size=batch_size,
                                      backend="florence" if use_cap else "null"),
        ocr=dataclasses.replace(base.ocr, backend="null"))  # the OCR is handed in

    detector = det_module = None
    if model is not None:
        detector, det_module = model
        if imgsz is not None:
            detector = dataclasses.replace(detector, imgsz=snap_imgsz(imgsz))
    ocr = _ProvidedOCR(ocr_text, ocr_bbox)
    som_style = dict(draw_bbox_config) if draw_bbox_config else {
        # the reference annotate()'s fixed defaults, not the server's
        # ratio-scaled style
        "text_scale": text_scale, "text_padding": text_padding,
        "text_thickness": 2, "thickness": 3,
    }
    dev = resolve_device(device)
    # keyed by the caller's objects: the replace above makes a new Detector
    # on every call.  The lock keeps the per-call state (OCR, module) of
    # concurrent callers apart.
    key = (cfg, id(model[0]) if model is not None else None, id(caption_model_processor),
           str(dev))
    with _compat_lock:
        pipeline = _PIPELINE_CACHE.get(key)
        if pipeline is None:
            pipeline = SOMPipeline(
                cfg, dev, detector=detector, det_module=det_module, ocr=ocr,
                # use_local_semantics=False: icons keep content None
                captioner=caption_model_processor if use_cap else None)
            if len(_PIPELINE_CACHE) >= _PIPELINE_CACHE_MAX:
                _PIPELINE_CACHE.pop(next(iter(_PIPELINE_CACHE)))
            _PIPELINE_CACHE[key] = pipeline
        else:
            pipeline.ocr = ocr
            if det_module is not None:
                pipeline.det_module = det_module
        annotated, label_coordinates, elements = pipeline.parse_image(
            image_rgb, box_threshold=BOX_TRESHOLD, iou_threshold=iou_threshold,
            som_style=som_style)
    return encode_image_base64(annotated), label_coordinates, elements
