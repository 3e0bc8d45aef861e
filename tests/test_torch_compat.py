"""The port's reference-signature API (``omniparser_tpu_torch.compat``)
against the JAX package's (``omniparser_tpu.compat``): one counterpart of
each test in tests/test_compat.py, with the same numpy-seeded inputs and
the same detector weights (carried through ``weights/convert.py``) on both
sides, on the CPU in float32.  Integers, texts and element lists are
exact; boxes, confidences and crops agree to 1e-5 (boxes normalised)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu import compat as jcompat
from omniparser_tpu.models import yolov8 as jyolo
from omniparser_tpu_torch import compat as tcompat
from omniparser_tpu_torch.models import yolov8 as tyolo
from omniparser_tpu_torch.ocr import NullOCR as TNullOCR
from omniparser_tpu_torch.weights import convert
from omniparser_tpu_torch.weights.init import build_module
from tests import oracles
from tests.conftest import random_boxes

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)

CPU = dict(device="cpu")


class F32Detector(jyolo.Detector):
    """The JAX detector with a float32 module (its own builds bfloat16)."""

    @property
    def module(self):
        return jyolo.YOLOv8(variant=self.variant, num_classes=self.num_classes,
                            dtype=jnp.float32)


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model): YOLOv8-n at 320 with the shipped trained
    detector weights (what the JAX tests' model=None loads) on both."""
    from omniparser_tpu.config import DetectorConfig
    from omniparser_tpu.weights.checkpoints import load_checkpoint

    jdet = F32Detector(imgsz=320, max_det=64)
    like = {"det": jax.eval_shape(lambda: jdet.init_params(jax.random.PRNGKey(0)))}
    params = jax.tree.map(np.asarray, load_checkpoint(
        jyolo.default_detector_weights(DetectorConfig()), like=like)["det"])
    tdet = tyolo.Detector(imgsz=320, max_det=64)
    module = build_module(tdet.make_module(),
                          convert.convert_yolov8(convert.flatten_variables(params)),
                          None, torch.float32, "cpu")
    return (jdet, params), (tdet, module)


def _same_elements(got, want, atol=1e-5):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["type"], a["source"], a["interactivity"], a["content"]) == \
               (b["type"], b["source"], b["interactivity"], b["content"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=atol)


def test_get_som_labeled_img_reference_signature(models, rng):
    """The reference call shape, against JAX's parse of the same call."""
    jm, tm = models
    img = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    kw = dict(BOX_TRESHOLD=0.05, output_coord_in_ratio=True, ocr_bbox=[[10, 10, 60, 25]],
              ocr_text=["File"], use_local_semantics=False, iou_threshold=0.7)
    _, j_labels, j_el = jcompat.get_som_labeled_img(img, model=jm, **kw)
    encoded, label_coords, elements = tcompat.get_som_labeled_img(img, model=tm, **kw, **CPU)
    assert isinstance(encoded, str) and len(encoded) > 100
    _same_elements(elements, j_el)
    assert set(label_coords) == set(j_labels)
    for k in label_coords:
        np.testing.assert_allclose(label_coords[k], j_labels[k], rtol=0, atol=1e-5)
    texts = [e for e in elements if e["type"] == "text"]
    assert texts and texts[0]["content"] == "File"
    assert texts[0]["source"] == "box_ocr_content_ocr"
    icons = [e for e in elements if e["type"] == "icon"]
    assert icons and all(e["content"] is None for e in icons)


def test_check_ocr_box_compat_import():
    from omniparser_tpu.ocr import NullOCR as JNullOCR

    img = np.zeros((32, 32, 3), np.uint8)
    want = jcompat.check_ocr_box(img, output_bb_format="xyxy", backend=JNullOCR())
    (texts, bb), goal = tcompat.check_ocr_box(img, output_bb_format="xyxy",
                                              backend=TNullOCR(), **CPU)
    assert ((texts, bb), goal) == want and texts == [] and bb == []


@pytest.mark.parametrize("call", [
    lambda m: m.get_caption_model_processor("llava"),
    lambda m: m.get_caption_model_processor("blip2"),
    lambda m: m.get_caption_model_processor("phi3_v"),
    lambda m: m.get_yolo_model(variant="v9e"),
    lambda m: m.get_yolo_model("weights/icon_detect_v3/model.pt"),
], ids=["unknown", "blip2", "phi3_v", "v9", "icon_detect_v3"])
def test_get_caption_model_processor_rejects_unknown(call, request):
    """Unknown models raise as in JAX.  The YOLOv9, BLIP-2 and Phi-3-V
    routes are ported: they reach their families, which build on the card
    by default and so stop at the device check on a host without one (their
    CPU builds are tests/test_torch_yolov9.py's, test_torch_blip2.py's and
    test_torch_phi3v.py's)."""
    if request.node.callspec.id in ("blip2", "phi3_v", "v9", "icon_detect_v3"):
        if torch.cuda.is_available():
            pytest.skip("builds a full-width network on the card; chip_smoke.py runs it")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(tcompat)
        return
    with pytest.raises(NotImplementedError) as err:
        call(tcompat)
    if "llava" not in str(err.value):
        assert "ROADMAP A." in str(err.value)


def test_box_format_helpers():
    quad = [[10.2, 20.7], [50, 20.7], [50.9, 40.1], [10.2, 40.1]]
    for name, arg in (("get_xywh", quad), ("get_xyxy", quad),
                      ("get_xywh_yolo", [10.2, 20.7, 50.9, 40.1])):
        assert getattr(tcompat, name)(arg) == getattr(jcompat, name)(arg)
    assert tcompat.get_xywh(quad) == (10, 20, 40, 19)
    assert tcompat.get_xyxy(quad) == (10, 20, 50, 40)
    assert tcompat.get_xywh_yolo([10.2, 20.7, 50.9, 40.1]) == (10, 20, 40, 19)


def test_remove_overlap_v1_matches_oracle(rng):
    for trial in range(6):
        boxes = [list(map(float, b)) for b in random_boxes(rng, 12, max_size=0.3)]
        ocr = [list(map(float, b)) for b in random_boxes(rng, 4, max_size=0.15)]
        for ob in (None, ocr):
            got = tcompat.remove_overlap(boxes, 0.5, ocr_bbox=ob, **CPU)
            np.testing.assert_array_equal(
                got, np.asarray(jcompat.remove_overlap(boxes, 0.5, ocr_bbox=ob)),
                err_msg=f"trial {trial} ocr={ob is not None}")
            want = oracles.remove_overlap_v1_oracle(boxes, 0.5, ocr_bbox=ob)
            got_r = [tuple(round(float(x), 5) for x in b)
                     for b in np.asarray(got, np.float64).reshape(-1, 4)]
            want_r = [tuple(round(float(x), 5) for x in b)
                      for b in np.asarray(want, np.float64).reshape(-1, 4)]
            assert got_r == want_r, f"trial {trial} ocr={ob is not None}"


def test_predict_yolo_compat(models, rng):
    jm, tm = models
    img = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
    j_boxes, j_conf, j_phrases = jcompat.predict_yolo(jm, img, box_threshold=0.05,
                                                      iou_threshold=0.1)
    boxes, conf, phrases = tcompat.predict_yolo(tm, img, box_threshold=0.05,
                                                iou_threshold=0.1, **CPU)
    assert boxes.shape[1] == 4 and len(conf) == len(boxes) == len(phrases) >= 2
    assert phrases == j_phrases == [str(i) for i in range(len(boxes))]
    np.testing.assert_allclose(boxes / 128.0, np.asarray(j_boxes) / 128.0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(conf, np.asarray(j_conf), rtol=0, atol=1e-5)
    assert (boxes[:, 0] <= 128).all() and (boxes[:, 1] <= 96).all()
    # the port's model must lie on the device the call names
    with pytest.raises(RuntimeError if not torch.cuda.is_available() else ValueError):
        tcompat.predict_yolo(tm, img, box_threshold=0.05)


def test_get_som_labeled_img_reuses_pipeline(models, rng):
    """Repeated calls reuse the cached pipeline, and parse as JAX does."""
    jm, tm = models
    img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    kw = dict(BOX_TRESHOLD=0.05, ocr_bbox=[[5, 5, 30, 15]], ocr_text=["x"],
              use_local_semantics=False, iou_threshold=0.7)
    first = tcompat.get_som_labeled_img(img, model=tm, **kw, **CPU)
    n_pipelines = len(tcompat._PIPELINE_CACHE)
    again = tcompat.get_som_labeled_img(img, model=tm, **kw, **CPU)
    assert len(tcompat._PIPELINE_CACHE) == n_pipelines
    assert again[1:] == first[1:]
    _same_elements(again[2], jcompat.get_som_labeled_img(img, model=jm, **kw)[2])


def test_threshold_sweep_reuses_pipeline(models, rng):
    """Thresholds are per-call values, not part of the cache key."""
    jm, tm = models
    tcompat._PIPELINE_CACHE.clear()
    img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    for thr in (0.01, 0.03, 0.05):
        kw = dict(BOX_TRESHOLD=thr, ocr_bbox=[[5, 5, 30, 15]], ocr_text=["x"],
                  use_local_semantics=False, iou_threshold=0.5 + thr)
        got = tcompat.get_som_labeled_img(img, model=tm, **kw, **CPU)[2]
        _same_elements(got, jcompat.get_som_labeled_img(img, model=jm, **kw)[2])
    assert len(tcompat._PIPELINE_CACHE) == 1


class _StubCaptioner:
    """caption_crops protocol; keeps the crops it was given."""

    def __init__(self):
        self.crops = []

    def caption_crops(self, crops, valid):
        self.crops.append(np.asarray(crops))
        return [f"cap{i}" for i in range(int(valid.sum()))]


def test_get_parsed_content_icon_compat(rng):
    img = rng.integers(0, 255, (100, 120, 3), dtype=np.uint8)
    boxes = np.array([[0.1, 0.1, 0.3, 0.3], [0.4, 0.4, 0.6, 0.6],
                      [0.7, 0.7, 0.9, 0.9]], np.float32)
    tstub, jstub = _StubCaptioner(), _StubCaptioner()
    caps = tcompat.get_parsed_content_icon(boxes, starting_idx=1, image_source=img,
                                           caption_model_processor=tstub, batch_size=2, **CPU)
    want = jcompat.get_parsed_content_icon(boxes, starting_idx=1, image_source=img,
                                           caption_model_processor=jstub, batch_size=2)
    assert caps == want == ["cap0", "cap1"]  # 2 boxes after starting_idx, one batch of 2
    assert len(tstub.crops) == len(jstub.crops) == 1
    np.testing.assert_allclose(tstub.crops[0], jstub.crops[0], rtol=0, atol=1e-3)
    assert tcompat.get_parsed_content_icon(boxes[:0], 0, img, _StubCaptioner(), **CPU) == []


def test_load_image_legacy(tmp_path, rng):
    from PIL import Image

    img = rng.integers(0, 255, (90, 160, 3), dtype=np.uint8)
    p = tmp_path / "x.png"
    Image.fromarray(img).save(p)
    src, transformed = tcompat.load_image(str(p))
    j_src, j_transformed = jcompat.load_image(str(p))
    np.testing.assert_array_equal(src, img)
    np.testing.assert_array_equal(transformed, j_transformed)
    c, th, tw = transformed.shape
    assert c == 3 and transformed.dtype == np.float32
    assert tw == 1333 and th == round(90 * 1333 / 160)


def test_predict_grounded(models, rng):
    """Boxes from the detector, phrases grounded on the query by caption
    word overlap, logits = conf x overlap: the same as JAX's."""
    jm, tm = models

    class FakeCaptioner:
        def caption_crops(self, crops, valid):
            return ["a save button icon" if i % 2 == 0 else "blue banner"
                    for i in range(int(np.sum(valid)))]

    img = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
    boxes, logits, phrases = tcompat.predict(
        {"model": tm, "processor": FakeCaptioner()}, img, "save button . search bar",
        box_threshold=0.01, text_threshold=0.5, **CPU)
    jb, jl, jp = jcompat.predict({"model": jm, "processor": FakeCaptioner()}, img,
                                 "save button . search bar", 0.01, 0.5)
    assert phrases == jp and len(phrases) >= 1
    assert all(p == "save button" for p in phrases)
    np.testing.assert_allclose(boxes / 128.0, np.asarray(jb) / 128.0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(logits, np.asarray(jl), rtol=0, atol=1e-5)
    assert all(0 <= v <= 1 for v in logits)
    b2, _, p2 = tcompat.predict({"model": tm, "processor": FakeCaptioner()}, img,
                                "save button", 0.01, 1.1, **CPU)
    assert len(b2) == 0 and len(p2) == 0


def test_compat_has_every_public_name():
    public = {n for n in dir(jcompat) if not n.startswith("_")
              and callable(getattr(jcompat, n)) and getattr(jcompat, n).__module__ in (
                  "omniparser_tpu.compat", "omniparser_tpu.ocr")}
    assert public <= set(dir(tcompat)), sorted(public - set(dir(tcompat)))
