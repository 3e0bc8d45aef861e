"""Configuration dataclasses for the omniparser_tpu_torch pipeline.

The same parse-side and serving dataclasses, fields and defaults as the
JAX package's ``config.py`` (this package keeps its own copy and imports
nothing of that package), so one set of settings describes a parse in
either.
Defaults mirror the reference server's hardcoded values:
box_threshold=0.05, iou_threshold=0.7, caption batch 128, text_threshold=0.8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Icon detector settings."""

    # YOLOv8: 'n' / 's' / 'm' / 'l' / 'x'; the GELAN family (YOLOv9, the
    # reference v2's icon_detect_v3 is a YOLOv9-E): 'v9e' / 'v9c', and the
    # tiny test forms 'v9test' / 'v9dualtest'
    variant: str = "n"
    num_classes: int = 1
    # static letterbox sizes (longest side); input is letterboxed to a square
    imgsz_buckets: Tuple[int, ...] = (640, 960, 1280, 1920)
    default_imgsz: int = 1280
    box_threshold: float = 0.05
    nms_iou_threshold: float = 0.1
    max_detections: int = 512  # fixed-shape NMS output slots
    # top-k window between the confidence filter and NMS; it must cover the
    # above-threshold candidates for the keep set to equal an unbounded
    # NMS's.  Overflow beyond it is counted and warned about.
    prefilter_topk: int = 4096
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class CaptionerConfig:
    """Florence-2-class captioner settings: 64x64 crops, batch 128, greedy
    decode of 20 new tokens."""

    model_name: str = "florence2"
    # 'florence' | 'blip2' (beam search, not fused into the device step) |
    # 'null'; 'phi3v' is not ported (ROADMAP A.8)
    backend: str = "florence"
    crop_size: int = 64
    batch_size: int = 128
    max_new_tokens: int = 20
    prompt: str = "<CAPTION>"
    dtype: str = "bfloat16"
    # 'none' = floating-point decode; 'int8' = weight-only int8 decoder and
    # LM head with per-channel float32 scales (models/quant.py)
    quant: str = "none"
    # decode captions in a second step over only the smallest power-of-2
    # slot bucket that covers this image's content-less icons (compaction
    # packs the needed crops first, so slicing [:kb] loses nothing)
    split_decode: bool = True
    # captions whose mean chosen-token log-prob falls below this become
    # 'image icon'; None = off
    min_logp: Optional[float] = None
    # model dims (florence-2-base); overridden by loaded checkpoints
    d_model: int = 768
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 12
    vocab_size: int = 51289


@dataclasses.dataclass(frozen=True)
class OcrConfig:
    """OCR stage settings.

    backend: 'jax' keeps its name from the JAX package and selects the
    device OCR (here in PyTorch); 'null' = no OCR (detection-only parse).
    arch, for that backend: 'native' = the first-party DBNet-style detector
    + CTC recogniser; 'easyocr' = CRAFT + the english_g2 VGG-BiLSTM-CTC
    recogniser (the reference's OCR stack; set rec_height=64), seeded or
    loaded from craft_mlt_25k.pth / english_g2.pth.
    """

    backend: str = "jax"
    arch: str = "native"
    easyocr_craft_pth: Optional[str] = None
    easyocr_rec_pth: Optional[str] = None
    text_threshold: float = 0.8
    max_text_boxes: int = 256
    det_imgsz: int = 1920
    rec_height: int = 32
    rec_max_width: int = 480
    dtype: str = "bfloat16"
    # recognise line crops in fixed-size blocks; the number of blocks run
    # is the real candidate count's, so a 20-line screenshot pays for one
    # block of 32, not all max_text_boxes slots.  0 = one full-width batch.
    rec_block: int = 32
    # feed the detector's components into the fused parse step on device
    fused_candidates: bool = True
    # run the connected-components postprocess on device
    device_components: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end parse() configuration."""

    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    captioner: CaptionerConfig = dataclasses.field(default_factory=CaptionerConfig)
    ocr: OcrConfig = dataclasses.field(default_factory=OcrConfig)

    iou_threshold: float = 0.7  # overlap/merge pass
    use_local_semantics: bool = True  # caption icons
    output_coord_in_ratio: bool = True

    # SOM overlay scaling
    som_base_resolution: float = 3200.0
    som_text_scale: float = 0.8
    som_text_thickness: int = 2
    som_text_padding: int = 3
    som_thickness: int = 3

    max_batch_size: int = 8

    # optional cap on the SOM overlay canvas (longest side, pixels)
    max_som_side: Optional[int] = None
    # optional host downscale cap before upload (longest side, pixels)
    max_upload_side: Optional[int] = None

    # kept for parity of settings; this package has one crop path (the
    # gather kernel on the card, its plain version on the CPU)
    crop_impl: str = "gather"

    # weight sources: None => seeded random init; 'auto' => the exported
    # .npz of the shipped checkpoint (scripts/export_torch_weights.py writes
    # it; the pipeline raises where it is missing); any other string => path
    # of an exported .npz
    detector_weights: Optional[str] = "auto"
    captioner_weights: Optional[str] = "auto"
    ocr_weights: Optional[str] = "auto"


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving layer: the REST server's address and its micro-batcher."""

    host: str = "0.0.0.0"
    port: int = 8000
    # micro-batching scheduler: collect up to max_batch requests within
    # batch_window_ms of the first before one parse_batch call
    batch_window_ms: float = 5.0
    max_batch: int = 8
