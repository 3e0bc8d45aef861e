"""The screenshot -> structured-elements pipeline, in PyTorch.

    host:   decode -> pad -> upload (1 host->device transfer)
    device: letterbox -> OCR text-detector -> connected components
            (output STAYS on the device)
    device: [fused step] candidate unclip/unmap -> YOLO detect + NMS ->
            OCR line recogniser + CTC stats -> overlap/merge masks ->
            caption-slot compaction -> crop-gather  (-> ONE download)
    device: Florence greedy decode over the smallest power-of-2 slot
            bucket that covers the content-less icons (with
            ``CaptionerConfig.split_decode`` off, single-step decode: the
            fused step decodes all K slots before the download)
    host:   strings, SOM overlay, JSON

Host-candidate OCR (``OcrConfig.device_components`` or ``fused_candidates``
off, or an OCR backend that reads text on the host, such as the boxes and
texts that ``compat.get_som_labeled_img`` is handed) takes the candidate
boxes to the host between the OCR detector and the fused step
(``_stage_ocr``), in slot buckets of 32, 64, ... up to ``max_text_boxes``.

``parse_batch`` runs the same per-image steps for several screenshots and
packs every image's caption slots into one cross-image decode (chunks of
at most ``_DECODE_CHUNK`` slots), so the decode's launch train is paid once
per batch instead of once per screenshot.

Eager PyTorch has no compiled graph: the fused step is one plain function
whose kernels queue on the current stream; the host reads a device value
only where control flow needs it (the label propagation's fixed point, the
recogniser's block count) and at the download.  Those reads are also why
``parse_batch`` cannot overlap one image's device work with the next
image's dispatch as the JAX package's asynchronous dispatch does: each
image's fused step has run by the time the host reaches the next one.

Element schema and ordering match the reference exactly:
  {'type': 'text'|'icon', 'bbox': [x1,y1,x2,y2] normalised, 'interactivity',
   'content', 'source': 'box_ocr_content_ocr'|'box_yolo_content_ocr'|
   'box_yolo_content_yolo'}
with content-less icons sorted last and captioned in order.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from omniparser_tpu_torch.config import PipelineConfig
from omniparser_tpu_torch.models.ocr import TorchOCR, ctc_device_stats
from omniparser_tpu_torch.models.yolov8 import Detector
from omniparser_tpu_torch.ocr import make_ocr_backend
from omniparser_tpu_torch.ops.boxes import int_box_area
from omniparser_tpu_torch.ops.components import candidate_boxes_from_cc
from omniparser_tpu_torch.ops.overlap import merge_icons_and_ocr
from omniparser_tpu_torch.ops.preprocess import (
    crop_lines_batch,
    crop_resize_batch,
    pad_to_bucket,
    pick_bucket_2d,
)
from omniparser_tpu_torch.utils.device import resolve_device
from omniparser_tpu_torch.utils.profiling import recorder

EXPORT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights", "exported")
# the trained orbax trees the repository ships beside the JAX package
# (det_synth, ocr_en_synth, cap_synth): a data path, read without JAX
TRAINED_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "omniparser_tpu", "weights")


class NullCaptioner:
    """Placeholder captioner: labels every icon 'icon'."""

    fusable = False

    def caption_crops(self, crops, valid) -> List[str]:
        return ["icon" for _ in range(int(np.asarray(valid).sum()))]


def _make_element(typ, bbox, interactivity, content, source) -> Dict:
    return {
        "type": typ,
        "bbox": [float(v) for v in bbox],
        "interactivity": interactivity,
        "content": content,
        "source": source,
    }


class _Stopwatch:
    """Laps of a stage, each a span of the recorder named ``lap.<name>``.
    With a sink (``SOMPipeline.stage_ms``) each lap also adds its
    milliseconds to sink[name] and, on a CUDA device, ends with a
    synchronise, so its span is the lap's device time; without one it is
    the host's dispatch of the lap.  Off when neither asks for laps."""

    def __init__(self, sink: Optional[Dict[str, float]], device: torch.device):
        self.sink, self.device = sink, device
        self.t0 = time.perf_counter() if sink is not None or recorder.on else None

    def lap(self, name: str) -> None:
        if self.t0 is None:
            return
        if self.sink is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        recorder.record("lap." + name, self.t0, now)
        if self.sink is not None:
            self.sink[name] = self.sink.get(name, 0.0) + (now - self.t0) * 1e3
        self.t0 = now


@torch.no_grad()
def fused_parse_step(cfg: PipelineConfig, detector: Detector, det_module,
                     ocr: Optional[TorchOCR], do_cap: bool,
                     padded: torch.Tensor, hw: Tuple[int, int], true_hw: Tuple[int, int],
                     ocr_a: torch.Tensor, ocr_b: torch.Tensor, lb_r, lb_pads,
                     conf_thr: float, nms_iou: float, merge_iou: float, text_thr: float,
                     device_candidates: bool,
                     stage_ms: Optional[Dict[str, float]] = None,
                     decode_with=None) -> Dict[str, torch.Tensor]:
    """The device step between the OCR detector and the caption decode.

    hw: the uploaded (possibly downscaled) frame, drives geometry; true_hw:
    the ORIGINAL dims — the zero-area gate is evaluated at original
    resolution.  ocr_a/ocr_b: with device_candidates the detector's
    component boxes [C,4] and count (still on the device) plus this
    image's letterbox lb_r/lb_pads; otherwise (boxes_norm, valid).
    decode_with: a fusable captioner that decodes all K caption slots in
    the step (single-step decode: ``CaptionerConfig.split_decode`` off);
    its tokens and log-probs join the outputs in place of the crops.
    """
    watch = _Stopwatch(stage_ms, padded.device)
    ocr_boxes_norm, ocr_cand_valid, ocr_overflow = ocr_candidates(
        cfg, ocr_a, ocr_b, lb_r, lb_pads, hw, device_candidates)
    watch.lap("candidates")

    det = detector.detect_graph(det_module, padded, hw, conf_thr, nms_iou, with_stats=True)
    det = gate_detections(det, true_hw)
    watch.lap("detect_nms")

    rec = None
    if ocr is not None:
        rec = [x[0] for x in recognise_lines(cfg, ocr, [(padded, hw)], [ocr_boxes_norm],
                                             [ocr_cand_valid])]
    watch.lap("recognise")

    out = merge_outputs(det, ocr_boxes_norm, ocr_cand_valid, ocr_overflow, rec, true_hw,
                        merge_iou, text_thr, device_candidates)
    watch.lap("merge")

    if do_cap:
        out.update(caption_slots(cfg, out, padded, hw))
        watch.lap("caption_crops")
        if decode_with is not None:
            out["cap_tokens"], out["cap_logp"] = decode_with.generate(out.pop("crops"))
            watch.lap("decode")
    return out


def ocr_candidates(cfg: PipelineConfig, ocr_a, ocr_b, lb_r, lb_pads, hw,
                   device_candidates: bool):
    """(boxes_norm [M,4], candidate valid [M], overflow count): unclip and
    unmap of the detector's components on the device, or the host's boxes
    as given."""
    if device_candidates:
        return candidate_boxes_from_cc(ocr_a, ocr_b, lb_r, lb_pads, hw,
                                       max_boxes=cfg.ocr.max_text_boxes)
    return ocr_a, ocr_b, torch.zeros((), dtype=torch.int32, device=ocr_a.device)


def gate_detections(det, true_hw):
    """detect_graph's (boxes, scores, valid, overflow) with the zero-area
    gate at the ORIGINAL dims applied to valid."""
    boxes, scores, valid, overflow = det
    h, w = true_hw
    return boxes, scores, valid & (int_box_area(boxes, w, h) > 0), overflow


def recognise_lines(cfg: PipelineConfig, ocr: TorchOCR, frames, boxes, cand_valid,
                    n_valid: Optional[int] = None):
    """The recogniser over the OCR candidate slots of one or more frames.

    frames: [(padded, hw)]; boxes: each frame's [M,4] normalised boxes (the
    same M for all); cand_valid: each frame's [M] validity.  Each frame's
    line crops come from its own crop launch; one recogniser forward takes
    the lines of every frame, ``rec_block`` slots of each at a time, and
    the number of blocks run is the largest real candidate count's (one
    host read of a device scalar), so the cost follows the text density,
    not the slot cap; `n_valid` gives that count where the caller took it
    over more frames.  Slots of blocks not run keep all-blank ids (id 0)
    => n_chars 0.  Returns (rec_ids [B,M,T], rec_conf [B,M], n_chars [B,M]).
    """
    b, m = len(frames), boxes[0].shape[0]
    dev = boxes[0].device
    rec_hw = (cfg.ocr.rec_height, cfg.ocr.rec_max_width)
    blk = cfg.ocr.rec_block

    def recognise(s, e):
        crops = [crop_lines_batch(padded, hw, bx[s:e].contiguous(), rec_hw)
                 for (padded, hw), bx in zip(frames, boxes)]
        ids, conf, nch = ctc_device_stats(ocr.rec(ocr.rec_preprocess(
            crops[0] if b == 1 else torch.cat(crops))))
        return ids.reshape(b, e - s, -1), conf.reshape(b, e - s), nch.reshape(b, e - s)

    if not (blk and m % blk == 0 and m // blk > 1):
        return recognise(0, m)
    if n_valid is None:
        n_valid = int(torch.stack([last_valid_slot(v) for v in cand_valid]).max())
    rec_ids = torch.zeros((b, m, ocr.rec_len), dtype=torch.int32, device=dev)
    rec_conf = torch.zeros((b, m), dtype=torch.float32, device=dev)
    n_chars = torch.zeros((b, m), dtype=torch.int32, device=dev)
    for i in range((n_valid + blk - 1) // blk):
        s = i * blk
        rec_ids[:, s:s + blk], rec_conf[:, s:s + blk], n_chars[:, s:s + blk] = \
            recognise(s, s + blk)
    return rec_ids, rec_conf, n_chars


def last_valid_slot(valid: torch.Tensor) -> torch.Tensor:
    """1 + the index of the last True of `valid` [M], 0 where none (a
    device scalar)."""
    slot = torch.arange(valid.shape[0], dtype=torch.int32, device=valid.device) + 1
    return torch.where(valid, slot, torch.zeros((), dtype=torch.int32,
                                                device=valid.device)).max()


def merge_outputs(det, ocr_boxes_norm, ocr_cand_valid, ocr_overflow, rec, true_hw,
                  merge_iou: float, text_thr: float, device_candidates: bool
                  ) -> Dict[str, torch.Tensor]:
    """The OCR validity gates, the icon/OCR merge (one merge launch) and the
    step's outputs.  det: the gated detections; rec: (rec_ids [M,T],
    rec_conf [M], n_chars [M]) or None without a recogniser."""
    det_boxes, det_scores, det_valid, det_overflow = det
    h, w = true_hw
    m, dev = ocr_boxes_norm.shape[0], ocr_boxes_norm.device
    if rec is not None:
        rec_ids, rec_conf, n_chars = rec
        ocr_valid = ocr_cand_valid & (n_chars > 0) & (rec_conf > text_thr)
    else:
        rec_ids = torch.zeros((m, 1), dtype=torch.int32, device=dev)
        rec_conf = torch.zeros((m,), dtype=torch.float32, device=dev)
        ocr_valid = ocr_cand_valid
    ocr_valid = ocr_valid & (int_box_area(ocr_boxes_norm, w, h) > 0)

    res = merge_icons_and_ocr(det_boxes, det_valid, ocr_boxes_norm, ocr_valid, merge_iou)
    out = {
        "det_boxes": det_boxes,
        "det_scores": det_scores,
        "det_valid": det_valid,
        "det_overflow": det_overflow,
        "icon_keep": res.icon_keep,
        "icon_suppressed": res.icon_suppressed,
        "ocr_keep": res.ocr_keep,
        "absorb": res.absorb,
        "ocr_valid": ocr_valid,
        "rec_ids": rec_ids,
        "rec_conf": rec_conf,
    }
    if device_candidates:
        # the host never saw the candidate boxes — ship them in the single
        # download (plus the cap counter: no silent caps)
        out["ocr_boxes"] = ocr_boxes_norm
        out["ocr_cand_valid"] = ocr_cand_valid
        out["ocr_overflow"] = ocr_overflow
    return out


def caption_slots(cfg: PipelineConfig, out: Dict[str, torch.Tensor], padded, hw
                  ) -> Dict[str, torch.Tensor]:
    """Caption-slot compaction (the content-less icons first, at most K)
    and their crops (K3's caption grid)."""
    K = cfg.captioner.batch_size
    det_boxes = out["det_boxes"]
    dev = det_boxes.device
    n = det_boxes.shape[0]
    need = out["icon_keep"] & ~out["absorb"].any(dim=1)
    rank = torch.cumsum(need.to(torch.int64), 0) - 1
    # slots beyond K scatter to a spare last slot that is cut
    dest = torch.where(need & (rank < K), rank, torch.full_like(rank, K))
    cap_boxes = torch.zeros((K + 1, 4), dtype=det_boxes.dtype, device=dev)
    cap_boxes[dest] = det_boxes
    cap_valid = torch.zeros((K + 1,), dtype=torch.bool, device=dev)
    cap_valid[dest] = need
    cap_src = torch.full((K + 1,), -1, dtype=torch.int32, device=dev)
    cap_src[dest] = torch.arange(n, dtype=torch.int32, device=dev)
    cap_valid, cap_src = cap_valid[:K], cap_src[:K]
    return {"crops": crop_resize_batch(padded, hw, cap_boxes[:K].contiguous(),
                                       cfg.captioner.crop_size),
            "cap_valid": cap_valid, "cap_src": cap_src,
            "cap_overflow": need.sum() - cap_valid.sum()}


def trained_tree(name: str) -> str:
    """The committed trained tree `name` under ``TRAINED_DIR``; raises,
    naming it, where it is missing."""
    from omniparser_tpu_torch.weights.orbax_read import is_orbax_dir

    path = os.path.join(TRAINED_DIR, name)
    if not is_orbax_dir(path):
        raise FileNotFoundError(
            f"weights 'auto' read the trained tree {path}, which is missing (an orbax "
            "directory with _METADATA and manifest.ocdbt); give a checkpoint path, or pass "
            "None for this weight field to initialise from a seed")
    return path


def _flat_weights(field: Optional[str], name: str, fits: Optional[str] = None):
    """A config weight field -> flat variable dict; None (and only None)
    asks for the seeded init.  'auto' is the committed trained tree `name`
    (``TRAINED_DIR``), and raises, naming it, where it is missing or where
    `fits` says why the network does not match it: untrained networks are
    never a silent default.  Any other path is an orbax directory or an
    exported .npz (``weights/checkpoints.load_flat``)."""
    from omniparser_tpu_torch.weights.checkpoints import load_flat

    if field is None:
        return None
    if field == "auto":
        path = trained_tree(name)
        if fits:
            raise ValueError(f"weights 'auto' read the trained tree {name}, which does not fit "
                             f"this network: {fits}; give a checkpoint path, or pass None for "
                             "a seeded init")
        return load_flat(path)
    return load_flat(field)


def _sub_tree(flat: Dict, prefix: str) -> Dict:
    p = prefix + "/"
    return {k[len(p):]: v for k, v in flat.items() if k.startswith(p)}


def detector_variant(variant: str, weights: Optional[str]) -> str:
    """The reference routes any ``icon_detect_v3`` weight path to its
    YOLOv9-E: such a path selects 'v9e' unless a 'v9*' variant is named."""
    import pathlib

    if weights and "icon_detect_v3" in pathlib.Path(weights).parts \
            and not variant.startswith("v9"):
        return "v9e"
    return variant


def make_detector(dc) -> Detector:
    """A ``DetectorConfig`` -> its detector: 'v9*' variants select the GELAN
    family ('v9' alone is 'v9e'), plain letters YOLOv8."""
    kw = dict(num_classes=dc.num_classes, imgsz=dc.default_imgsz,
              max_det=dc.max_detections, prefilter=dc.prefilter_topk)
    if dc.variant.startswith("v9"):
        from omniparser_tpu_torch.models.yolov9 import YOLOv9Detector

        return YOLOv9Detector(variant=dc.variant[2:] or "e", **kw)
    return Detector(variant=dc.variant, **kw)


def detector_state_from_field(field: Optional[str], detector: Detector):
    """``PipelineConfig.detector_weights`` -> a state_dict for the
    detector's module, or None for the seeded init: 'auto' (the committed
    det_synth tree), an orbax directory and ``*.npz`` hold Flax variables
    of the YOLOv8 family, any other file an ultralytics
    ``.pt`` or torch state_dict (``weights/convert_yolo.py``), or for a GELAN
    detector a yolov9 TorchScript or state dict (``weights/convert_yolov9.py``)."""
    from omniparser_tpu_torch.models.yolov9 import YOLOv9Detector
    from omniparser_tpu_torch.weights import convert
    from omniparser_tpu_torch.weights.convert_yolo import load_detector_state
    from omniparser_tpu_torch.weights.convert_yolov9 import load_yolov9_state

    if field is None:
        return None
    gelan = isinstance(detector, YOLOv9Detector)
    if field == "auto" or field.endswith(".npz") or os.path.isdir(field):
        if gelan:
            raise ValueError(
                f"detector_weights={field!r}: there is no exported checkpoint of the GELAN "
                "family; give a yolov9 TorchScript or state dict, or None for a seeded init")
        fits = None
        if detector.variant != "n" or detector.num_classes != 1:  # as the JAX default
            fits = (f"it is a YOLOv8-n of 1 class, the detector variant {detector.variant!r} "
                    f"of {detector.num_classes}")
        return convert.convert_yolov8(_sub_tree(_flat_weights(field, "det_synth", fits), "det"),
                                      detector.variant, detector.num_classes)
    return load_yolov9_state(field, detector) if gelan else load_detector_state(field, detector)


def ocr_states_from_field(field: Optional[str], ocr_config):
    """``PipelineConfig.ocr_weights`` -> (detector, recogniser) state_dicts,
    or None for the seeded init.  The 'easyocr' arch has no export: its
    weights are the config's ``easyocr_*_pth`` files (TorchOCR reads them),
    so its field must be None, or 'auto' with those files named."""
    from omniparser_tpu_torch.weights import convert

    if ocr_config.arch == "easyocr":
        named = ocr_config.easyocr_craft_pth or ocr_config.easyocr_rec_pth
        if field is not None and not (field == "auto" and named):
            raise ValueError(
                f"ocr_weights={field!r} with arch='easyocr': there is no exported checkpoint "
                "of this arch; name craft_mlt_25k.pth / english_g2.pth in "
                "OcrConfig.easyocr_craft_pth / easyocr_rec_pth, or pass None for a seeded init")
        return None
    fits = None
    if ocr_config.rec_height != 32 or ocr_config.rec_max_width != 480:  # as the JAX default
        fits = (f"its lines are 32x480, the config's {ocr_config.rec_height}x"
                f"{ocr_config.rec_max_width}")
    flat = _flat_weights(field, "ocr_en_synth", fits)
    if flat is None:
        return None
    return (convert.convert_text_detector(_sub_tree(flat, "det")),
            convert.convert_text_recognizer(_sub_tree(flat, "rec")))


def florence_from_field(field: Optional[str], config, dims, generator, device, state=None):
    """``PipelineConfig.captioner_weights`` -> a FlorenceCaptioner: from
    `state` where given, else an HF Florence-2 directory (model.safetensors;
    at ``dims``, default florence-2-base), Flax variables that carry their
    own dims ('auto', the committed cap_synth tree; an orbax directory with
    dims.json; an exported ``*.npz``), or None for the seeded init at ``dims``."""
    import json

    from omniparser_tpu_torch.models.florence2 import BASE, FlorenceCaptioner, FlorenceDims
    from omniparser_tpu_torch.weights import convert

    if state is not None:
        return FlorenceCaptioner(config, dims or BASE, state, generator=generator,
                                 device=device)
    if field is not None and os.path.isfile(os.path.join(field, "model.safetensors")):
        return FlorenceCaptioner.from_checkpoint(field, config, dims or BASE, device=device)
    fits = None
    if field == "auto" and not os.path.isfile(os.path.join(TRAINED_DIR, "cap_synth", "dims.json")):
        fits = "it has no dims.json beside it"
    flat = _flat_weights(field, "cap_synth", fits)
    if flat is not None:
        if "__dims__" not in flat:
            raise ValueError(f"captioner_weights={field!r}: the checkpoint carries no dims "
                             "(__dims__ in an .npz, dims.json beside an orbax tree)")
        raw = json.loads(str(flat.pop("__dims__")))
        # trees written before the patch_prenorm fix trained with post-norm
        # conv embeds everywhere, as the JAX package's from_synth_checkpoint reads them
        raw.setdefault("patch_prenorm", [False] * 4)
        dims = FlorenceDims(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in raw.items()})
        state = convert.convert_florence2(_sub_tree(flat, "cap"), dims)
    return FlorenceCaptioner(config, dims or BASE, state, generator=generator, device=device)


def blip2_from_field(field: Optional[str], config, dims, device, seed: int = 0, state=None):
    """``PipelineConfig.captioner_weights`` with backend 'blip2' -> a
    Blip2Captioner: from `state` where given, else an HF blip2-opt directory
    (``*.safetensors``, at ``dims``, default blip2-opt-2.7b), or None for the
    seeded init.  There is no exported BLIP-2 checkpoint, so 'auto' raises."""
    from omniparser_tpu_torch.models.blip2 import BLIP2_OPT_2_7B, Blip2Captioner

    dims = dims or BLIP2_OPT_2_7B
    if state is None and field is not None:
        if not os.path.isdir(field):
            raise ValueError(
                f"captioner_weights={field!r} with backend 'blip2': give an HF blip2-opt "
                "directory (*.safetensors), or None for a seeded init")
        return Blip2Captioner.from_checkpoint(field, config, dims, device=device)
    return Blip2Captioner(config, dims, state, seed=seed, device=device)


def phi3v_from_field(field: Optional[str], config, dims, device, seed: int = 0, state=None):
    """``PipelineConfig.captioner_weights`` with backend 'phi3v' -> a
    Phi3VCaptioner: from `state` where given, else an HF Phi-3-vision
    directory (``*.safetensors`` shards, at ``dims``, default the published
    phi-3-vision-128k-instruct dims; a directory's depth is its own), or
    None for the seeded init.  There is no exported Phi-3-V checkpoint, so
    'auto' raises."""
    from omniparser_tpu_torch.models.phi3v import PHI3V_BASE, Phi3VCaptioner

    if state is None and field is not None:
        if not (os.path.isdir(field)
                and any(f.endswith(".safetensors") for f in os.listdir(field))):
            raise ValueError(
                f"captioner_weights={field!r} with backend 'phi3v': give an HF "
                "microsoft/Phi-3-vision-128k-instruct directory (*.safetensors shards), "
                "or None for a seeded init")
        return Phi3VCaptioner.from_checkpoint(field, config, dims, device=device)
    return Phi3VCaptioner(config, dims or PHI3V_BASE, state, seed=seed, device=device)


class SOMPipeline:
    """End-to-end parse: detector, OCR, merge, captioner.

    device: where everything runs; the default is the card, and a caller
    that wants the CPU says device="cpu".  Parts: `detector` (a Detector:
    YOLOv8, or a YOLOv9Detector for 'v9*' variants) with `det_module` (its
    network), `ocr` (any object with ``recognize(image_rgb, padded, hw) ->
    (texts, boxes_px)``; a TorchOCR, either arch, runs on the device) and
    `captioner` (Florence-2, fused into the device step, or BLIP-2 or
    Phi-3-V, which caption after it), each built from the config where not
    given.
    Weights: explicit state_dicts (`detector_state`, `ocr_states=(det,
    rec)`, `captioner_state` with `captioner_dims`), else the config's
    weight fields: an exported .npz ('auto' raises where it is missing), an
    ultralytics .pt or yolov9 TorchScript (detector), an HF Florence-2,
    blip2-opt or Phi-3-vision directory (captioner), the easyocr .pth files
    named in OcrConfig, or None for a seeded random init.
    """

    def __init__(self, config: PipelineConfig, device="cuda", *, detector=None,
                 det_module=None, detector_state=None, ocr=None, ocr_states=None,
                 captioner_state=None, captioner_dims=None, captioner=None, seed: int = 0):
        from omniparser_tpu_torch.weights.init import build_module

        self.config = config
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)

        dc = config.detector
        if detector is None:
            detector = make_detector(dc)
        self.detector = detector
        if det_module is None:
            if detector_state is None:
                detector_state = detector_state_from_field(config.detector_weights, detector)
            det_module = build_module(detector.make_module(), detector_state, gen,
                                      getattr(torch, dc.dtype), self.device)
        self.det_module = det_module

        if ocr is None:
            if config.ocr.backend == "jax":
                if ocr_states is None:
                    ocr_states = ocr_states_from_field(config.ocr_weights, config.ocr)
                det_s, rec_s = ocr_states if ocr_states is not None else (None, None)
                ocr = TorchOCR(config.ocr, self.device, det_s, rec_s, gen)
            else:
                ocr = make_ocr_backend(config.ocr, device=self.device)
        self.ocr = ocr
        # the first-party backend runs on the device; any other reads text
        # on the host and hands over boxes and strings
        self._torch_ocr = ocr if isinstance(ocr, TorchOCR) else None
        # device candidates: the components feed the fused step without
        # returning to the host
        self._fused_ocr = bool(self._torch_ocr is not None and config.ocr.device_components
                               and config.ocr.fused_candidates)

        if captioner is None:
            backend = config.captioner.backend
            if not config.use_local_semantics or backend == "null":
                captioner = NullCaptioner()
            elif backend == "florence":
                captioner = florence_from_field(config.captioner_weights, config.captioner,
                                                captioner_dims, gen, self.device,
                                                state=captioner_state)
            elif backend == "blip2":
                captioner = blip2_from_field(config.captioner_weights, config.captioner,
                                             captioner_dims, self.device, seed,
                                             state=captioner_state)
            elif backend == "phi3v":
                captioner = phi3v_from_field(config.captioner_weights, config.captioner,
                                             captioner_dims, self.device, seed,
                                             state=captioner_state)
            else:
                raise ValueError(f"unknown captioner backend {backend!r}")
        self.captioner = captioner
        self._florence = captioner if getattr(captioner, "fusable", False) else None
        # single-step decode (split_decode off): the fused step decodes all
        # K caption slots itself, so no crops leave it and nothing is left
        # to decode after the download
        self._step_decodes = self._florence is not None and not config.captioner.split_decode
        self.last_timings: Dict[str, float] = {}
        # the last image's counts
        self.last_counts: Dict[str, int] = {}
        # the recorder's spans and counters of the last parse_image or
        # parse_batch (utils/profiling.Trace), None while it is off
        self.last_trace = None
        # parse_batch: the slots of each decode chunk of the last batch
        self.last_decode_chunks: List[int] = []
        self._stage_ms: Optional[Dict[str, float]] = None

    @property
    def stage_ms(self) -> Optional[Dict[str, float]]:
        """Set to a dict to collect per-stage milliseconds (each stage then
        ends with a device synchronise).  Asking for stage times also turns
        the span recorder on, so the synchronised laps and every other span
        land in ``last_trace``; setting None turns both off."""
        return self._stage_ms

    @stage_ms.setter
    def stage_ms(self, sink: Optional[Dict[str, float]]) -> None:
        self._stage_ms = sink
        if sink is None:
            recorder.disable()
        else:
            recorder.enable()

    # ------------------------------------------------------------------ #

    def parse_elements(self, image_rgb: np.ndarray, box_threshold: Optional[float] = None,
                       iou_threshold: Optional[float] = None
                       ) -> Tuple[Dict[str, List[float]], List[Dict]]:
        """np RGB uint8 -> (label_coordinates, element list), no overlay."""
        ctx = self._run(image_rgb, box_threshold, iou_threshold)
        self.last_trace = recorder.take()
        return ctx["label_coordinates"], ctx["elements"]

    def parse_image(self, image_rgb: np.ndarray, box_threshold: Optional[float] = None,
                    iou_threshold: Optional[float] = None, som_style: Optional[Dict] = None
                    ) -> Tuple[np.ndarray, Dict[str, List[float]], List[Dict]]:
        """np RGB uint8 -> (annotated RGB, label_coordinates, element list).

        som_style: optional override of the overlay style, with the
        reference's draw_bbox_config keys (text_scale, text_thickness,
        text_padding, thickness).
        """
        ctx = self._run(image_rgb, box_threshold, iou_threshold)
        t0 = time.perf_counter()
        annotated = self._overlay(ctx, som_style)
        self.last_timings["annotate"] = time.perf_counter() - t0
        self.last_trace = recorder.take()
        return annotated, ctx["label_coordinates"], ctx["elements"]

    def _run(self, image_rgb, box_threshold, iou_threshold) -> Dict:
        t: Dict[str, float] = {}
        t0 = time.perf_counter()
        ctx = self._stage_upload(image_rgb)
        t["upload"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self._fused_ocr:
            watch = _Stopwatch(self.stage_ms, self.device)
            self._stage_ocr_detect(ctx)
            watch.lap("ocr_detect")
        else:
            self._stage_ocr(ctx)
        t["ocr_detect"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        crops_dev = self._stage_dispatch(ctx, box_threshold, iou_threshold)
        self._download(ctx)
        t["device_step"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._dispatch_decode(ctx, crops_dev)
        t["decode"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the element assembly never reads captions, so it runs while the
        # decode executes on the device; the collect below pays the rest
        icon_plain = self._stage_finish(ctx)
        t["assemble"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._collect_decode(ctx)
        self._fill_captions(ctx, icon_plain)
        t["decode"] += time.perf_counter() - t0
        self.last_timings = t
        return ctx

    # ----------------------------- stages ----------------------------- #

    def _host_pad(self, image_rgb: np.ndarray):
        """Host half of upload: optional downscale + bucket pad (numpy)."""
        h, w = image_rgb.shape[:2]
        upload = image_rgb
        cap = self.config.max_upload_side
        if cap and max(h, w) > cap:
            import cv2

            scale = cap / max(h, w)
            upload = cv2.resize(image_rgb, (int(w * scale), int(h * scale)),
                                interpolation=cv2.INTER_AREA)
        uh, uw = upload.shape[:2]
        hb, wb = pick_bucket_2d(uh, uw)
        padded, _ = pad_to_bucket(upload, hb, wb)
        return padded, upload, h, w, uh, uw

    def _stage_upload(self, image_rgb: np.ndarray, index: int = 0) -> Dict:
        """`index`: the image's place in its call, which its spans carry."""
        with recorder.span("upload", image=index):
            padded, upload, h, w, uh, uw = self._host_pad(image_rgb)
            return {
                "image": image_rgb, "index": index, "h": h, "w": w, "uh": uh, "uw": uw,
                "upload_img": upload,
                "padded_dev": torch.from_numpy(padded).to(self.device),  # the one upload
            }

    def _stage_ocr_detect(self, ctx: Dict) -> None:
        """Dispatch the first-party text detector (letterbox, network and,
        with device components, the components); its outputs stay on the
        device in ctx["ocr_fut"]."""
        with recorder.span("ocr_detect", self.device, ctx["index"]):
            ctx["ocr_fut"] = self.ocr.dispatch_det(ctx["padded_dev"], (ctx["uh"], ctx["uw"]))

    def parse_batch(self, images: Sequence[np.ndarray]
                    ) -> List[Tuple[np.ndarray, Dict[str, List[float]], List[Dict]]]:
        """Several screenshots -> a list of parse_image tuples, in order.

        Each image's upload, OCR detector and fused step are dispatched in
        turn (with host-candidate OCR: every upload and OCR detector first,
        so that no image's candidate download waits behind a later upload);
        then the downloads, with one batched caption decode over every
        image's slots dispatched after the last download; each image's
        element assembly and overlay run while that decode is queued, and
        the captions are filled last.  Each image gets what parse_image
        gives it."""
        t: Dict[str, float] = {}
        t0 = time.perf_counter()
        if self._fused_ocr:
            ctxs = []
            for i, img in enumerate(images):
                ctx = self._stage_upload(img, i)
                self._stage_ocr_detect(ctx)
                ctx["crops_dev"] = self._stage_dispatch(ctx, None, None)
                ctxs.append(ctx)
        else:
            ctxs = [self._stage_upload(img, i) for i, img in enumerate(images)]
            if self._torch_ocr is not None:
                for ctx in ctxs:  # every detector before any candidate download
                    self._stage_ocr_detect(ctx)
            for ctx in ctxs:
                self._stage_ocr(ctx)
                ctx["crops_dev"] = self._stage_dispatch(ctx, None, None)
        t["dispatch"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        handle = None
        for i, ctx in enumerate(ctxs):
            self._download(ctx)
            if i == len(ctxs) - 1:
                handle = self._dispatch_decode_batch(ctxs)
            ctx["icon_plain"] = self._stage_finish(ctx)
            ctx["annotated"] = self._overlay(ctx, None)
        t["finish"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._collect_decode_batch(handle)
        results = []
        for ctx in ctxs:
            self._fill_captions(ctx, ctx.pop("icon_plain"))
            results.append((ctx["annotated"], ctx["label_coordinates"], ctx["elements"]))
        t["decode"] = time.perf_counter() - t0
        self.last_timings = t
        self.last_trace = recorder.take()
        return results

    def warmup(self, shapes: Sequence[Tuple[int, int]] = ((1080, 1920), (2160, 3840)),
               cap_buckets: Sequence[int] = (8, 16, 32, 64, 128, 256)) -> None:
        """Run what a first request would otherwise pay for: a parse_image
        of a blank image per shape (builds the CUDA kernels at their first
        launch, picks the library's algorithms), then one caption decode
        per slot bucket that parse_batch can use (blank images need no
        captions, so their parses never decode).  With single-step decode
        every parse decodes its K slots, so there are no buckets."""
        for h, w in shapes:
            self.parse_image(np.zeros((h, w, 3), np.uint8))
        if self._florence is not None and not self._step_decodes:
            cs = self.config.captioner.crop_size
            for kb in cap_buckets:
                if kb <= self._DECODE_CHUNK:
                    tokens, _ = self._florence.generate(
                        torch.zeros((kb, cs, cs, 3), dtype=torch.float32, device=self.device))
                    tokens.cpu()

    def _stage_ocr(self, ctx: Dict) -> None:
        """Host-candidate OCR: candidate boxes (first-party detector and
        host components) or a host backend's boxes and texts, into the
        smallest slot bucket of 32, 64, ... (at most max_text_boxes) that
        holds them; no candidate still takes one bucket, for fixed shapes."""
        uh, uw = ctx["uh"], ctx["uw"]
        max_ocr = self.config.ocr.max_text_boxes
        watch = _Stopwatch(self.stage_ms, self.device)
        host_texts = None
        if self._torch_ocr is not None:
            if "ocr_fut" not in ctx:
                self._stage_ocr_detect(ctx)
            boxes_px = self._torch_ocr.candidates_from_prob(*ctx.pop("ocr_fut"), uh, uw)
            frame_wh = (uw, uh)
        else:
            # host backends see the original image: normalise by its dims
            host_texts, boxes_px = self.ocr.recognize(ctx["image"], ctx["padded_dev"], (uh, uw))
            frame_wh = (ctx["w"], ctx["h"])
        n_ocr = min(len(boxes_px), max_ocr)
        bucket = 32
        while bucket < max(n_ocr, 1):
            bucket *= 2
        bucket = min(bucket, max_ocr)
        ocr_arr = np.zeros((bucket, 4), np.float32)
        ocr_cand_valid = np.zeros(bucket, bool)
        if n_ocr:
            fw, fh = frame_wh
            ocr_arr[:n_ocr] = (np.asarray(boxes_px[:n_ocr], np.float32)
                               / np.array([fw, fh, fw, fh], np.float32))
            ocr_cand_valid[:n_ocr] = True
        ctx.update(ocr_arr=ocr_arr, ocr_cand_valid=ocr_cand_valid, n_ocr=n_ocr,
                   host_texts=host_texts)
        watch.lap("ocr_detect")

    def _stage_dispatch(self, ctx: Dict, box_threshold, iou_threshold):
        """Run the fused step; its outputs stay on the device (in
        ctx["out_dev"]) until _download.  Returns the caption crops."""
        cfg = self.config
        box_threshold = cfg.detector.box_threshold if box_threshold is None else box_threshold
        iou_threshold = cfg.iou_threshold if iou_threshold is None else iou_threshold
        if self._fused_ocr:
            cc, r, pads = ctx.pop("ocr_fut")
            ocr_a, ocr_b = cc["boxes"], cc["count"]
            ctx["cc_count"] = cc["count"]
        else:
            ocr_a = torch.from_numpy(ctx["ocr_arr"]).to(self.device)
            ocr_b = torch.from_numpy(ctx["ocr_cand_valid"]).to(self.device)
            r, pads = 0.0, (0.0, 0.0)
        with recorder.span("fused_step", self.device, ctx["index"]):
            out = fused_parse_step(
                cfg, self.detector, self.det_module, self._torch_ocr, self._florence is not None,
                ctx["padded_dev"], (ctx["uh"], ctx["uw"]), (ctx["h"], ctx["w"]),
                ocr_a, ocr_b, r, pads,
                box_threshold, cfg.detector.nms_iou_threshold, iou_threshold,
                cfg.ocr.text_threshold, self._fused_ocr, self.stage_ms,
                decode_with=self._florence if self._step_decodes else None)
        crops_dev = out.pop("crops", None)  # stays on the device
        if "cc_count" in ctx:
            out["cc_count"] = ctx.pop("cc_count")
        ctx["out_dev"] = out
        return crops_dev

    def _download(self, ctx: Dict) -> None:
        """The one download of a fused step's outputs (all but the crops)."""
        with recorder.span("download", image=ctx["index"]):
            ctx["out"] = {k: v.cpu().numpy() for k, v in ctx.pop("out_dev").items()}

    def _dispatch_decode(self, ctx: Dict, crops_dev) -> None:
        """Greedy-decode only the smallest power-of-2 slot bucket (from 8)
        covering this image's content-less icon count; the compaction in
        the fused step packed them first.  Zero need => no decode.  With
        single-step decode the step has decoded all K slots already."""
        out = ctx["out"]
        ctx["kb"] = self.config.captioner.batch_size if "cap_tokens" in out else 0
        need = int(out["cap_valid"].sum()) if "cap_valid" in out else 0
        if ctx["kb"]:  # the fused step decoded all K slots
            self._count_slots(ctx["kb"], need)
        if crops_dev is None or need == 0:
            return
        kb = 8
        while kb < need:
            kb *= 2
        kb = min(kb, self.config.captioner.batch_size)
        ctx["kb"] = kb
        watch = _Stopwatch(self.stage_ms, self.device)
        with recorder.span("caption.batched", self.device):
            ctx["tokens_fut"] = self._florence.generate(crops_dev[:kb])
        self._count_slots(kb, need)
        watch.lap("decode")

    def _collect_decode(self, ctx: Dict) -> None:
        fut = ctx.pop("tokens_fut", None)
        if fut is not None:
            with recorder.span("caption.collect"):
                ctx["out"]["cap_tokens"] = fut[0].cpu().numpy()
                ctx["out"]["cap_logp"] = fut[1].cpu().numpy()

    @staticmethod
    def _count_slots(slots: int, served: int) -> None:
        """Caption slots decoded (padding included) and captions served."""
        recorder.count("caption.slots", slots)
        recorder.count("caption.served", served)

    # parse_batch's cross-image caption decode: every image's needed slots
    # (the compaction put them first) in one decode per chunk of at most
    # this many slots, each zero-padded to a power-of-2 bucket from 8
    _DECODE_CHUNK = 256

    def _dispatch_decode_batch(self, ctxs: Sequence[Dict]):
        """Dispatch the batched decode -> (per-chunk (tokens, logp, take)
        on the device, per-image (ctx, offset, need)), or None."""
        with recorder.span("caption.dispatch"):
            parts, offs, off = [], [], 0
            for ctx in ctxs:
                crops = ctx.pop("crops_dev", None)
                if crops is None or "cap_valid" not in ctx["out"]:
                    continue
                need = int(ctx["out"]["cap_valid"].sum())
                if need:
                    parts.append(crops[:need])
                    offs.append((ctx, off, need))
                    off += need
            self.last_decode_chunks = []
            if not parts:
                return None
            slots = torch.cat(parts) if len(parts) > 1 else parts[0]
            futs = []
            watch = _Stopwatch(self.stage_ms, self.device)
            with recorder.span("caption.batched", self.device):
                for s in range(0, off, self._DECODE_CHUNK):
                    sel = slots[s:s + self._DECODE_CHUNK]
                    take = sel.shape[0]
                    kb = 8
                    while kb < take:
                        kb *= 2
                    if take < kb:
                        sel = torch.cat([sel, sel.new_zeros((kb - take,) + tuple(sel.shape[1:]))])
                    futs.append((*self._florence.generate(sel), take))
                    self._count_slots(kb, take)
                    self.last_decode_chunks.append(take)
            watch.lap("decode")
            return futs, offs

    def _collect_decode_batch(self, handle) -> None:
        if handle is None:
            return
        futs, offs = handle
        with recorder.span("caption.collect"):
            tokens = np.concatenate([tok.cpu().numpy()[:n] for tok, _, n in futs])
            logp = np.concatenate([lp.cpu().numpy()[:n] for _, lp, n in futs])
        for ctx, off, need in offs:
            ctx["out"]["cap_tokens"] = tokens[off:off + need]
            ctx["out"]["cap_logp"] = logp[off:off + need]

    def _fill_captions(self, ctx: Dict, icon_plain) -> None:
        """Fill content-less icon elements with captions: decoded tokens
        for the first K slots; overflow via extra batches."""
        cfg = self.config
        out = ctx["out"]
        det_boxes = out["det_boxes"]
        plain_elems = [e for _, e in icon_plain]
        if plain_elems and "cap_tokens" in out:
            cap = self._florence
            by_src = {int(s): (tok, lp) for s, tok, lp, v in
                      zip(out["cap_src"], out["cap_tokens"], out["cap_logp"],
                          out["cap_valid"]) if v}
            missing = []
            for i, e in icon_plain:
                hit = by_src.get(int(i))
                if hit is not None:
                    e["content"] = cap.gate_caption(cap.tokens_to_text(hit[0]), float(hit[1]))
                else:
                    missing.append((i, e))
            if missing:  # > K content-less icons: batch the remainder
                boxes_extra = np.stack([det_boxes[i] for i, _ in missing]).astype(np.float32)
                caps = self._caption_boxes(ctx, boxes_extra)
                for (_, e), c in zip(missing, caps):
                    e["content"] = c
        elif plain_elems and cfg.use_local_semantics:
            if isinstance(self.captioner, NullCaptioner):
                for e in plain_elems:
                    e["content"] = "icon"
            else:  # a captioner outside the fused step (BLIP-2's beam decode)
                boxes = np.stack([e["bbox"] for e in plain_elems]).astype(np.float32)
                for e, c in zip(plain_elems, self._caption_boxes(ctx, boxes)):
                    e["content"] = c
        # use_local_semantics=False: icons keep content None

    def _stage_finish(self, ctx: Dict):
        """Element assembly (host).  Returns the content-less icons as
        (detector slot, element) pairs for the caption fill."""
        with recorder.span("assemble", image=ctx["index"]):
            icon_plain = self._assemble(ctx)
        recorder.count("ocr.lines", self.last_counts["ocr_candidates"])
        recorder.count("caption.needed", len(icon_plain))
        return icon_plain

    def _assemble(self, ctx: Dict):
        cfg = self.config
        h, w = ctx["h"], ctx["w"]
        out = ctx["out"]
        if int(out.get("det_overflow", 0)) > 0:
            # no silent caps: the static NMS window dropped above-threshold
            # candidates
            warnings.warn(
                f"detector prefilter overflow: {int(out['det_overflow'])} "
                "above-threshold candidates beyond the top-k window "
                "(raise DetectorConfig.prefilter_topk)", RuntimeWarning)
        host_texts = None
        if "ocr_boxes" in out:  # device-candidate mode: boxes arrive in `out`
            ocr_arr = out["ocr_boxes"]
            n_ocr = ocr_arr.shape[0]
            if int(out.get("ocr_overflow", 0)) > 0:
                warnings.warn(
                    f"OCR candidate overflow: {int(out['ocr_overflow'])} "
                    "text components beyond max_text_boxes slots "
                    "(raise OcrConfig.max_text_boxes)", RuntimeWarning)
        else:  # host candidates: slots past n_ocr are padding
            ocr_arr, n_ocr, host_texts = ctx["ocr_arr"], ctx["n_ocr"], ctx["host_texts"]
        if self._torch_ocr is not None:
            texts = {k: self._torch_ocr.decode_ids(out["rec_ids"][k])
                     for k in range(n_ocr) if out["ocr_valid"][k]}
        else:  # a host backend's strings, by slot
            texts = {k: (host_texts[k] if host_texts else "") for k in range(n_ocr)}

        elements: List[Dict] = []
        for k in range(n_ocr):
            if out["ocr_keep"][k]:
                elements.append(_make_element(
                    "text", ocr_arr[k], False, texts.get(k, ""), "box_ocr_content_ocr"))
        det_boxes = out["det_boxes"]
        icon_labeled, icon_plain = [], []
        for i in np.nonzero(out["icon_keep"])[0]:
            donors = np.nonzero(out["absorb"][i, :n_ocr])[0]
            if len(donors):
                content = "".join(texts.get(k, "") + " " for k in donors)
                icon_labeled.append(_make_element(
                    "icon", det_boxes[i], True, content, "box_yolo_content_ocr"))
            else:
                icon_plain.append((i, _make_element(
                    "icon", det_boxes[i], True, None, "box_yolo_content_yolo")))
        elements.extend(icon_labeled)
        elements.extend(e for _, e in icon_plain)

        cxcywh = self._cxcywh(elements)
        # label_coordinates always refer to the ORIGINAL frame (xywh px),
        # independent of the drawing canvas
        label_coordinates = {
            str(i): [float(cxcywh[i, 0] - cxcywh[i, 2] / 2) * w,
                     float(cxcywh[i, 1] - cxcywh[i, 3] / 2) * h,
                     float(cxcywh[i, 2]) * w, float(cxcywh[i, 3]) * h]
            for i in range(len(cxcywh))
        }
        if cfg.output_coord_in_ratio:
            label_coordinates = {
                k: [v[0] / w, v[1] / h, v[2] / w, v[3] / h]
                for k, v in label_coordinates.items()
            }
        ctx["elements"] = elements
        ctx["label_coordinates"] = label_coordinates
        icon_pass = out["det_valid"] & ~out["icon_suppressed"]
        self.last_counts = {
            "det_keep": int(out["det_valid"].sum()),
            "ocr_components": int(out.get("cc_count", 0)),
            "ocr_candidates": (int(out["ocr_cand_valid"].sum()) if "ocr_cand_valid" in out
                               else int(ctx["n_ocr"])),
            "ocr_valid": int(out["ocr_valid"].sum()),
            # OCR boxes whose text joined an icon (and left the output);
            # icons dropped because an OCR box contains them
            "ocr_absorbed": int(out["absorb"].any(axis=0).sum()),
            "icons_inside_ocr": int((icon_pass & ~out["icon_keep"]).sum()),
            "cap_need": int(out["cap_valid"].sum()) if "cap_valid" in out else 0,
            "kb": int(ctx.get("kb", 0)),
            "elements": len(elements),
        }
        return icon_plain

    @staticmethod
    def _cxcywh(elements: List[Dict]) -> np.ndarray:
        b = np.array([e["bbox"] for e in elements], np.float32).reshape(-1, 4)
        return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                         b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1)

    def _overlay(self, ctx: Dict, som_style: Optional[Dict]) -> np.ndarray:
        """The SOM overlay (cv2 drawing) on top of a finished parse."""
        with recorder.span("overlay", image=ctx["index"]):
            return self._draw(ctx, som_style)

    def _draw(self, ctx: Dict, som_style: Optional[Dict]) -> np.ndarray:
        from omniparser_tpu_torch.annotate import annotate

        cfg = self.config
        image_rgb = ctx["image"]
        h, w = ctx["h"], ctx["w"]
        canvas = image_rgb
        if cfg.max_som_side and max(h, w) > cfg.max_som_side:
            # draw on a downscaled copy; coordinates stay in the original
            # frame, so only overlay pixels are affected
            import cv2

            src = image_rgb
            up = ctx.get("upload_img")
            if up is not None and max(up.shape[:2]) >= cfg.max_som_side:
                src = up
            sh, sw = src.shape[:2]
            s = cfg.max_som_side / max(sh, sw)
            canvas = (cv2.resize(src, (int(sw * s), int(sh * s)),
                                 interpolation=cv2.INTER_AREA) if s < 1.0 else src)
        ch_, cw_ = canvas.shape[:2]
        ratio = max(ch_, cw_) / cfg.som_base_resolution
        style = {
            "text_scale": cfg.som_text_scale * ratio,
            "text_thickness": max(int(cfg.som_text_thickness * ratio), 1),
            "text_padding": max(int(cfg.som_text_padding * ratio), 1),
            "thickness": max(int(cfg.som_thickness * ratio), 1),
        }
        if som_style:
            style.update(som_style)
        annotated, _ = annotate(canvas, self._cxcywh(ctx["elements"]), **style)
        return annotated

    def _caption_boxes(self, ctx: Dict, boxes_norm: np.ndarray) -> List[str]:
        """Captions of boxes in batches of batch_size crops (K3's caption
        grid): the fused step's overflow (> batch_size content-less icons),
        or every content-less icon for a captioner outside the fused step."""
        cfg = self.config.captioner
        bs = cfg.batch_size
        pad_n = -(-len(boxes_norm) // bs) * bs
        arr = np.zeros((pad_n, 4), np.float32)
        arr[: len(boxes_norm)] = boxes_norm
        valid = np.zeros(pad_n, bool)
        valid[: len(boxes_norm)] = True
        out: List[str] = []
        with recorder.span("caption.boxes", self.device, ctx["index"]):
            for s in range(0, pad_n, bs):
                crops = crop_resize_batch(
                    ctx["padded_dev"], (ctx["uh"], ctx["uw"]),
                    torch.from_numpy(arr[s: s + bs]).to(ctx["padded_dev"].device), cfg.crop_size)
                out.extend(self.captioner.caption_crops(crops.to(self.device), valid[s: s + bs]))
        self._count_slots(pad_n, len(boxes_norm))
        return out

    def content_lines(self, elements) -> List[str]:
        """'Text Box ID i: ...' / 'Icon Box ID j: ...' lines."""
        return [f"{'Text' if e['type'] == 'text' else 'Icon'} Box ID {i}: {e['content']}"
                for i, e in enumerate(elements)]


class Omniparser:
    """Drop-in facade matching the reference: base64 in, (SOM image base64,
    parsed content list) out."""

    def __init__(self, config, device="cuda", **pipeline_kwargs):
        if isinstance(config, dict):
            # the reference's config-dict shape: som_model_path /
            # caption_model_name / caption_model_path / BOX_TRESHOLD
            pc = PipelineConfig()
            name = config.get("caption_model_name", "florence2")
            backends = {"florence2": "florence", "blip2": "blip2", "phi3_v": "phi3v"}
            if name not in backends:
                raise NotImplementedError(f"caption model {name!r} is not ported")
            som = config.get("som_model_path")
            config = dataclasses.replace(
                pc,
                detector=dataclasses.replace(
                    pc.detector, variant=detector_variant(pc.detector.variant, som),
                    box_threshold=config.get("BOX_TRESHOLD", pc.detector.box_threshold)),
                captioner=dataclasses.replace(pc.captioner, backend=backends[name]),
                detector_weights=som,
                captioner_weights=config.get("caption_model_path"),
            )
        self.config = config
        self.pipeline = SOMPipeline(config, device, **pipeline_kwargs)

    def parse(self, image_base64: str):
        from omniparser_tpu_torch.utils.image import decode_base64_image, encode_image_base64

        image = decode_base64_image(image_base64)
        annotated, _, elements = self.pipeline.parse_image(image)
        return encode_image_base64(annotated), elements
