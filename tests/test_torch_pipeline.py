"""The slice as a whole: one synthetic GUI scene through ``parse_image`` of
the JAX package and of the port, with the same (shipped, trained) weights
carried through ``weights/convert.py``, on the CPU in float32.

The JAX pipeline builds its networks in bfloat16; here it gets float32
modules injected (its own constructor arguments and attributes — nothing
in the package changes), so that both sides compute in float32.
"""

import base64
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu import config as jcfg
from omniparser_tpu.models import florence2 as jflo
from omniparser_tpu.models import ocr as jocr
from omniparser_tpu.models import yolov8 as jyolo
from omniparser_tpu.pipeline import SOMPipeline as JaxPipeline
from omniparser_tpu.train.synth_gui import render_gui_scene
from omniparser_tpu_torch import config as tcfg
from omniparser_tpu_torch.models.florence2 import FlorenceCaptioner, FlorenceDims
from omniparser_tpu_torch.pipeline import Omniparser, SOMPipeline
from omniparser_tpu_torch.weights import convert

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)

SIZE = 320
SMALL = dict(
    detector=dict(default_imgsz=SIZE, max_detections=64),
    captioner=dict(batch_size=16),
    ocr=dict(det_imgsz=SIZE, max_text_boxes=64),
)


class F32Detector(jyolo.Detector):
    @property
    def module(self):
        return jyolo.YOLOv8(variant=self.variant, num_classes=self.num_classes,
                            dtype=jnp.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pipelines():
    jc = jcfg.PipelineConfig(
        detector=jcfg.DetectorConfig(**SMALL["detector"]),
        captioner=jcfg.CaptionerConfig(**SMALL["captioner"]),
        ocr=jcfg.OcrConfig(**SMALL["ocr"]))
    det = F32Detector(imgsz=SIZE, max_det=64, prefilter=jc.detector.prefilter_topk)
    ocr = jocr.JaxOCR(jc.ocr, weights=jocr.default_ocr_weights(jc.ocr))
    ocr.det = jocr.TextDetector(dtype=jnp.float32)
    ocr.rec = jocr.TextRecognizer(dtype=jnp.float32)
    cap = jflo.FlorenceCaptioner.from_synth_checkpoint(
        jflo.default_captioner_weights(), jc.captioner)
    cap.model = jflo.Florence2(dims=cap.dims, dtype=jnp.float32)
    jp = JaxPipeline(jc, detector=det, captioner=cap, ocr=ocr)  # shipped det_synth ('auto')

    tc = tcfg.PipelineConfig(
        detector=tcfg.DetectorConfig(dtype="float32", **SMALL["detector"]),
        captioner=tcfg.CaptionerConfig(dtype="float32", **SMALL["captioner"]),
        ocr=tcfg.OcrConfig(dtype="float32", **SMALL["ocr"]))
    flat = convert.flatten_variables
    dims = FlorenceDims(**{f: getattr(cap.dims, f) for f in FlorenceDims.__dataclass_fields__})
    tp = SOMPipeline(
        tc, device="cpu",
        detector_state=convert.convert_yolov8(flat(_np(jp.detector_params))),
        ocr_states=(convert.convert_text_detector(flat(_np(ocr.det_params))),
                    convert.convert_text_recognizer(flat(_np(ocr.rec_params)))),
        captioner_state=convert.convert_florence2(flat(_np(cap.params)), dims),
        captioner_dims=dims)
    return jp, tp


def _scene(seed):
    return np.asarray(render_gui_scene(np.random.default_rng(seed), size=SIZE)[0])


@pytest.mark.parametrize("seed", [3, 11])
def test_parse_image_matches_jax(pipelines, seed):
    jp, tp = pipelines
    img = _scene(seed)
    h, w = img.shape[:2]
    j_ann, j_labels, j_el = jp.parse_image(img)
    t_ann, t_labels, t_el = tp.parse_image(img)
    assert len(j_el) >= 4, "the scene should give the pipeline something to do"
    assert len(t_el) == len(j_el)
    for a, b in zip(t_el, j_el):
        assert (a["type"], a["source"], a["interactivity"]) == \
               (b["type"], b["source"], b["interactivity"])
        # OCR strings and greedy captions are argmax outputs: exact
        assert a["content"] == b["content"]
        # bbox within one pixel of the frame
        scale = np.array([w, h, w, h], np.float32)
        assert np.abs((np.array(a["bbox"]) - np.array(b["bbox"])) * scale).max() <= 1.0
    assert {e["type"] for e in t_el} == {"text", "icon"}
    assert any(e["source"] == "box_yolo_content_yolo" for e in t_el)
    assert set(t_labels) == set(j_labels)
    for k in t_labels:
        np.testing.assert_allclose(t_labels[k], j_labels[k], atol=1.0 / min(h, w))
    # the overlay is drawn by the same cv2 code from boxes within a pixel
    assert t_ann.shape == j_ann.shape == img.shape and t_ann.dtype == np.uint8
    assert tp.last_counts["kb"] >= 8 and tp.last_counts["ocr_valid"] >= 1


def test_parse_elements_is_parse_image_without_the_overlay(pipelines):
    _, tp = pipelines
    img = _scene(3)
    labels, elements = tp.parse_elements(img)
    _, labels2, elements2 = tp.parse_image(img)
    assert elements == elements2 and labels == labels2
    lines = tp.content_lines(elements)
    assert len(lines) == len(elements) and lines[0].startswith(("Text Box ID 0:", "Icon Box ID 0:"))


def test_omniparser_facade_round_trip(pipelines):
    from omniparser_tpu_torch.utils.image import decode_base64_image, encode_image_base64

    _, tp = pipelines
    parser = Omniparser.__new__(Omniparser)
    parser.config, parser.pipeline = tp.config, tp
    img = _scene(3)
    som_b64, elements = parser.parse(encode_image_base64(img))
    assert decode_base64_image(som_b64).shape == img.shape
    assert base64.b64decode(som_b64)[:4] == b"\x89PNG"
    assert elements == tp.parse_elements(img)[1]


def _same_elements(got, want, atol):
    """Boxes within atol (normalised units); every other field exact."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["type"], a["source"], a["interactivity"], a["content"]) == \
               (b["type"], b["source"], b["interactivity"], b["content"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=atol)


def test_parse_batch_matches_jax(pipelines):
    """parse_batch of the JAX package and of the port on three scenes of
    two sizes, shipped weights, float32: boxes to 1e-5, types, sources,
    interactivity, OCR texts and captions exact."""
    jp, tp = pipelines
    images = [_scene(3), _scene(11),
              np.asarray(render_gui_scene(np.random.default_rng(5), size=288)[0])]
    want = jp.parse_batch(images)
    got = tp.parse_batch(images)
    assert len(got) == len(want) == 3
    for (t_ann, t_labels, t_el), (j_ann, j_labels, j_el) in zip(got, want):
        _same_elements(t_el, j_el, 1e-5)
        assert set(t_labels) == set(j_labels) and t_ann.shape == j_ann.shape
    assert sum(len(e) for _, _, e in got) >= 12
    # one decode for the batch's slots, over every image's captions
    assert len(tp.last_decode_chunks) == 1
    assert tp.last_decode_chunks[0] == sum(
        e["source"] == "box_yolo_content_yolo" for _, _, el in got for e in el)


def test_parse_batch_equals_parse_image_per_image(rng):
    """The port's own invariant (its twin of tests/test_pipeline.py's
    batched-decode test, at tiny dims): parse_batch gives each image
    exactly what parse_image gives it, overlay included, with the decode
    chunk lowered to 4 slots so that the batch decodes in several chunks."""
    tiny = FlorenceDims(embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8),
                        num_groups=(1, 2, 4, 8), depths=(1, 1, 1, 1), window_size=4,
                        d_model=32, encoder_layers=1, decoder_layers=2, attn_heads=4,
                        ffn_dim=64, vocab_size=160, max_positions=64)
    cfg = tcfg.PipelineConfig(
        detector=tcfg.DetectorConfig(default_imgsz=128, max_detections=16, box_threshold=0.01,
                                     dtype="float32"),
        captioner=tcfg.CaptionerConfig(batch_size=8, crop_size=32, max_new_tokens=4,
                                       dtype="float32"),
        ocr=tcfg.OcrConfig(backend="null"), detector_weights=None)
    cap = FlorenceCaptioner(cfg.captioner, tiny, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    with torch.no_grad():  # a wide embedding: captions that differ between crops
        cap.model.language_model.shared.weight.normal_(
            0, 1.0, generator=torch.Generator().manual_seed(2))
    p = SOMPipeline(cfg, device="cpu", captioner=cap)
    p._DECODE_CHUNK = 4
    images = [rng.integers(0, 255, (100, 120, 3), dtype=np.uint8) for _ in range(3)]
    images.append(rng.integers(0, 255, (90, 200, 3), dtype=np.uint8))
    calls = cap.generate_calls
    batched = p.parse_batch(images)
    assert cap.generate_calls - calls == len(p.last_decode_chunks) >= 2
    assert max(p.last_decode_chunks) == 4
    captions = []
    for img, (ann_b, labels_b, el_b) in zip(images, batched):
        ann_s, labels_s, el_s = p.parse_image(img)
        assert el_b == el_s and labels_b == labels_s
        np.testing.assert_array_equal(ann_b, ann_s)
        captions += [e["content"] for e in el_s if e["source"] == "box_yolo_content_yolo"]
    assert sum(p.last_decode_chunks) == len(captions) and len(set(captions)) >= 2


def test_auto_weights_raise_where_the_export_is_missing(tmp_path, monkeypatch):
    """'auto' never falls back to untrained networks, to the export or to a
    seed: where TRAINED_DIR lacks the committed tree it raises naming it;
    only None asks for a seed."""
    from omniparser_tpu_torch import pipeline as tpipe

    committed = tpipe.TRAINED_DIR
    monkeypatch.setattr(tpipe, "TRAINED_DIR", str(tmp_path))
    cfg = tcfg.PipelineConfig(captioner=tcfg.CaptionerConfig(backend="null"),
                              ocr=tcfg.OcrConfig(backend="null"))
    assert cfg.detector_weights == "auto"
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "det_synth")):
        SOMPipeline(cfg, device="cpu")
    cfg = tcfg.PipelineConfig(captioner=tcfg.CaptionerConfig(backend="null"),
                              detector_weights=None)
    with pytest.raises(FileNotFoundError, match="trained tree .*ocr_en_synth"):
        SOMPipeline(cfg, device="cpu")
    cfg = tcfg.PipelineConfig(ocr=tcfg.OcrConfig(backend="null"), detector_weights=None)
    (tmp_path / "cap_synth").mkdir()  # a directory, but no orbax tree in it
    with pytest.raises(FileNotFoundError, match="trained tree .*cap_synth"):
        SOMPipeline(cfg, device="cpu")
    (tmp_path / "cap_synth").rmdir()  # an orbax tree without dims.json beside it
    shutil.copytree(os.path.join(committed, "det_synth"), tmp_path / "cap_synth")
    with pytest.raises(ValueError, match="cap_synth, which does not fit .*dims.json"):
        SOMPipeline(cfg, device="cpu")


@pytest.mark.parametrize("case", ["detector_variant", "detector_classes", "ocr_lines"])
def test_auto_weights_raise_where_the_tree_does_not_fit(case):
    """The JAX defaults' own conditions: det_synth is a YOLOv8-n of one
    class, ocr_en_synth reads 32x480 lines; elsewhere 'auto' raises naming
    the tree."""
    null = dict(captioner=tcfg.CaptionerConfig(backend="null"))
    if case == "detector_variant":
        cfg = tcfg.PipelineConfig(detector=tcfg.DetectorConfig(variant="s"),
                                  ocr=tcfg.OcrConfig(backend="null"), **null)
        name = "det_synth"
    elif case == "detector_classes":
        cfg = tcfg.PipelineConfig(detector=tcfg.DetectorConfig(num_classes=3),
                                  ocr=tcfg.OcrConfig(backend="null"), **null)
        name = "det_synth"
    else:
        cfg = tcfg.PipelineConfig(ocr=tcfg.OcrConfig(rec_max_width=320), detector_weights=None,
                                  **null)
        name = "ocr_en_synth"
    with pytest.raises(ValueError, match=f"trained tree {name}, which does not fit"):
        SOMPipeline(cfg, device="cpu")


def test_overflow_warnings_and_null_backends(rng):
    """The two no-silent-caps warnings, and the detection-only parse."""
    cfg = tcfg.PipelineConfig(
        detector=tcfg.DetectorConfig(default_imgsz=160, max_detections=8, prefilter_topk=16,
                                     dtype="float32"),
        captioner=tcfg.CaptionerConfig(backend="null"),
        ocr=tcfg.OcrConfig(backend="null"),
        detector_weights=None)
    pipe = SOMPipeline(cfg, device="cpu")
    img = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    with pytest.warns(RuntimeWarning, match="detector prefilter overflow"):
        labels, elements = pipe.parse_elements(img, box_threshold=0.0)
    assert elements and all(e["content"] == "icon" for e in elements)
    assert all(e["source"] == "box_yolo_content_yolo" for e in elements)
    assert set(labels) == {str(i) for i in range(len(elements))}


class _OneParsePerImage:
    """A pipeline whose parse_image runs once per image object: the
    benchmark parses a scene again for every row of it."""

    def __init__(self, pipeline):
        self.pipeline, self.seen = pipeline, {}

    def parse_image(self, image_rgb):
        if id(image_rgb) not in self.seen:  # the image is kept, so its id stays its own
            self.seen[id(image_rgb)] = (image_rgb, self.pipeline.parse_image(image_rgb))
        return self.seen[id(image_rgb)][1]


def test_synth_bench_run_matches_jax(pipelines, tmp_path):
    """eval/synth_bench.run over one held-out 640 scene through both
    pipelines: the same scores and, row for row, the same instruction,
    correctness and predicted point (within a pixel)."""
    import json

    from omniparser_tpu.eval import synth_bench as jsb
    from omniparser_tpu_torch.eval import synth_bench as tsb

    jp, tp = pipelines
    got = tsb.run(n_scenes=1, seed=777555, pipeline=_OneParsePerImage(tp),
                  log_path=str(tmp_path / "t.jsonl"))
    want = jsb.run(n_scenes=1, seed=777555, pipeline=_OneParsePerImage(jp),
                   log_path=str(tmp_path / "j.jsonl"))
    assert got == want and got["n"] >= 5
    rows = [[json.loads(line) for line in open(tmp_path / f)] for f in ("t.jsonl", "j.jsonl")]
    assert len(rows[0]) == len(rows[1]) == got["n"]
    for a, b in zip(*rows):
        assert (a["instruction"], a["correctness"]) == (b["instruction"], b["correctness"])
        assert (a["pred"] is None) == (b["pred"] is None)
        if a["pred"] is not None:
            np.testing.assert_allclose(a["pred"], b["pred"], rtol=0, atol=1.0 / 640)
    assert sum(r["pred"] is not None for r in rows[0]) >= 3, "too few rows grounded"


def test_single_step_decode_matches_jax(rng):
    """split_decode=False: the fused step decodes all K caption slots before
    the download, as the JAX package's FusedParseStep does inside its graph
    (its own tests never run this path).  Against the JAX SOMPipeline with
    the same weights at tiny widths, float32: caption tokens exact, mean
    log-probs within 1e-5, then parse_image's elements; the port's split
    path gives the same elements, and warm-up decodes no bucket."""
    import dataclasses

    from tests.test_torch_sharded_parse import same_elements, tiny_pair

    jp, tp = tiny_pair(split_decode=False)
    k = tp.config.captioner.batch_size
    split = SOMPipeline(dataclasses.replace(tp.config, captioner=dataclasses.replace(
        tp.config.captioner, split_decode=True)), device="cpu", det_module=tp.det_module,
        captioner=tp.captioner)
    captions = []
    for img in [rng.integers(0, 255, (100, 120, 3), dtype=np.uint8) for _ in range(2)]:
        jctx = jp._stage_upload(img)
        jp._stage_ocr(jctx)
        jp._stage_dispatch(jctx, None, None)
        want = jax.device_get(jctx["out"])
        ctx = tp._stage_upload(img)
        tp._stage_ocr(ctx)
        assert tp._stage_dispatch(ctx, None, None) is None  # no crops leave the step
        tp._download(ctx)
        got = ctx["out"]
        assert got["cap_tokens"].shape == (k, tp.config.captioner.max_new_tokens)
        for key in ("cap_valid", "cap_src", "cap_tokens"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        np.testing.assert_allclose(got["cap_logp"], np.asarray(want["cap_logp"]), rtol=0, atol=1e-5)
        _, _, j_el = jp.parse_image(img)
        _, _, t_el = tp.parse_image(img)
        same_elements(t_el, j_el)
        assert tp.last_counts["kb"] == k
        assert split.parse_image(img)[2] == t_el
        captions += [e["content"] for e in t_el if e["source"] == "box_yolo_content_yolo"]
    assert len(captions) >= 4 and len(set(captions)) >= 2
    calls = tp.captioner.generate_calls
    tp.warmup(shapes=((100, 120),))
    assert tp.captioner.generate_calls - calls == 1  # the blank parse's own decode
