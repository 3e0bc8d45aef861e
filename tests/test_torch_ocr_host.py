"""The port's host-candidate OCR against the JAX package's, on the CPU in
float32 with the same seeded inputs and the same (shipped, trained)
weights carried through ``weights/convert.py``:

  * ``utils/hostops.extract_components`` (the native library, built by the
    port into its own build directory) and ``ops/components.candidate_boxes_np``;
  * the host CTC decoders and ``merge_paragraphs``;
  * ``TorchOCR.recognize`` (the ``check_ocr_box`` backend) against
    ``JaxOCR.recognize``, with the components on the device and on the host;
  * ``parse_image`` / ``parse_batch`` with ``device_components=False`` and
    with ``fused_candidates=False``, against JAX and against the port's
    fused path.

Integers, texts and element lists are exact; boxes agree to 1e-5
(normalised), scores to 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu import config as jcfg
from omniparser_tpu.models import ocr as jocr
from omniparser_tpu.models import yolov8 as jyolo
from omniparser_tpu.ops import components as jcomp
from omniparser_tpu.pipeline import SOMPipeline as JaxPipeline
from omniparser_tpu.train.synth_gui import render_gui_scene
from omniparser_tpu.utils import hostops as jhostops
from omniparser_tpu_torch import config as tcfg
from omniparser_tpu_torch.models import ocr as tocr
from omniparser_tpu_torch.ops import components as tcomp
from omniparser_tpu_torch.pipeline import SOMPipeline
from omniparser_tpu_torch.utils import hostops as thostops
from omniparser_tpu_torch.weights import convert

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)

SIZE = 320


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------- host components --------------------------- #

def test_extract_components_native_matches_jax(rng):
    """The port's build of native/hostops.cpp against the JAX package's
    binding of the same source: equal lists; the cv2 form equal in boxes
    and areas, scores to 1e-5 (OpenCV's mean sums in float32)."""
    import os

    assert os.path.dirname(thostops._lib_path()) == thostops.cuda_build.BUILD_DIR
    for trial in range(5):
        prob = (rng.random((64, 96)) ** 3).astype(np.float32)
        prob[rng.integers(0, 64), :] = 0.9  # a component across the whole row
        for thr, min_area, min_score, max_out in ((0.7, 2, 0.0, 1024), (0.3, 4, 0.3, 1024),
                                                  (0.5, 1, 0.0, 7)):
            got = thostops.extract_components(prob, thr, min_area, min_score, max_out)
            want = jhostops.extract_components(prob, thr, min_area, min_score, max_out)
            assert got == want, (trial, thr)
            cv = thostops.extract_components(prob, thr, min_area, min_score, max_out,
                                             impl="cv2")
            assert [(b, a) for b, _, a in cv] == [(b, a) for b, _, a in got]
            np.testing.assert_allclose([s for _, s, _ in cv], [s for _, s, _ in got],
                                       rtol=0, atol=1e-5)
        assert len(got) <= 7
    with pytest.raises(ValueError):
        thostops.extract_components(prob, 0.5, 1, 0.0, impl="other")


def test_candidate_boxes_np_matches_jax_and_the_device_twin(rng):
    """Host unclip + unmap against JAX's, and against the port's device
    twin ``candidate_boxes_from_cc``: the same integer boxes."""
    for _ in range(4):
        n = 40
        x1 = rng.integers(0, 150, n)
        y1 = rng.integers(0, 150, n)
        boxes = np.stack([x1, y1, x1 + rng.integers(1, 30, n), y1 + rng.integers(1, 8, n)], 1)
        comps = [(tuple(int(v) for v in b), 0.5) for b in boxes]
        h, w = int(rng.integers(100, 400)), int(rng.integers(100, 400))
        s = 320
        r = min(s / h, s / w)
        pads = ((s - h * r) / 2.0, (s - w * r) / 2.0)
        got = tcomp.candidate_boxes_np(comps, r, pads, w, h)
        assert got == jcomp.candidate_boxes_np(comps, r, pads, w, h)
        slots = np.zeros((64, 4), np.int32)  # the component slots past the count
        slots[:n] = boxes
        norm, ok, over = tcomp.candidate_boxes_from_cc(
            torch.from_numpy(slots), torch.tensor(n, dtype=torch.int32), r, pads, (h, w),
            max_boxes=64)
        dev = np.rint(norm[ok].numpy() * np.array([w, h, w, h], np.float32)).astype(np.int64)
        assert dev.tolist() == got and int(over) == 0
    assert tcomp.candidate_boxes_np([], 1.0, (0.0, 0.0), 10, 10) == []


def test_ctc_decoders_and_paragraphs_match_jax(rng):
    for t in range(6):
        logits = rng.normal(0, 3, (30, tocr.NUM_CLASSES)).astype(np.float32)
        logits[::4, 0] += 6.0  # blanks between characters
        assert tocr.ctc_greedy_decode(logits) == jocr.ctc_greedy_decode(logits)
        for beam in (1, 5, 10):
            assert tocr.ctc_beam_decode(logits, beam) == jocr.ctc_beam_decode(logits, beam)
    assert tocr.ctc_greedy_decode(np.zeros((4, 3), np.float32) + [[9, 0, 0]]) == ("", 0.0)
    for _ in range(6):
        n = int(rng.integers(0, 12))
        x, y = rng.integers(0, 300, n), rng.integers(0, 300, n)
        boxes = [[int(a), int(b), int(a + rng.integers(10, 80)), int(b + rng.integers(8, 20))]
                 for a, b in zip(x, y)]
        texts = [f"t{i}" for i in range(n)]
        assert tocr.merge_paragraphs(texts, boxes) == jocr.merge_paragraphs(texts, boxes)


# ------------------------------ recognise ------------------------------ #

class F32Detector(jyolo.Detector):
    """The JAX detector with a float32 module (its own builds bfloat16)."""

    @property
    def module(self):
        return jyolo.YOLOv8(variant=self.variant, num_classes=self.num_classes,
                            dtype=jnp.float32)


def _scene(seed, size=SIZE):
    return np.asarray(render_gui_scene(np.random.default_rng(seed), size=size)[0])


@pytest.fixture(scope="module")
def trained():
    """The shipped trained OCR and detector trees, read once."""
    from omniparser_tpu.weights.checkpoints import load_checkpoint

    key, cfg = jax.random.PRNGKey(0), jcfg.OcrConfig()
    shapes = {  # abstract trees: the restore needs shapes, not an init
        "det": jax.eval_shape(lambda: jocr.TextDetector().init(
            key, jnp.zeros((1, 64, 64, 3)), train=False)),
        "rec": jax.eval_shape(lambda: jocr.TextRecognizer().init(
            key, jnp.zeros((1, cfg.rec_height, cfg.rec_max_width, 3)), train=False))}
    ocr = _np(load_checkpoint(jocr.default_ocr_weights(cfg), like=shapes))
    like = {"det": jax.eval_shape(lambda: F32Detector(imgsz=SIZE).init_params(key))}
    det_params = _np(load_checkpoint(jyolo.default_detector_weights(jcfg.DetectorConfig()),
                                     like=like)["det"])
    states = dict(
        det=convert.convert_yolov8(convert.flatten_variables(det_params)),
        ocr=(convert.convert_text_detector(convert.flatten_variables(ocr["det"])),
             convert.convert_text_recognizer(convert.flatten_variables(ocr["rec"]))))
    return dict(ocr=(ocr["det"], ocr["rec"]), det=det_params, states=states)


def _jax_ocr(ocr_cfg, trained):
    det_params, rec_params = trained["ocr"]
    ocr = jocr.JaxOCR(ocr_cfg, det_params=det_params, rec_params=rec_params)
    ocr.det = jocr.TextDetector(dtype=jnp.float32)  # before any trace
    ocr.rec = jocr.TextRecognizer(dtype=jnp.float32)
    return ocr


@pytest.fixture(scope="module")
def ocr_pairs(trained):
    """{device_components: (JaxOCR, TorchOCR)} with the trained weights,
    text threshold 0."""
    out = {}
    for dc in (True, False):
        jo = _jax_ocr(jcfg.OcrConfig(det_imgsz=SIZE, text_threshold=0.0, device_components=dc),
                      trained)
        to = tocr.TorchOCR(tcfg.OcrConfig(det_imgsz=SIZE, text_threshold=0.0, dtype="float32",
                                          device_components=dc), "cpu", *trained["states"]["ocr"])
        out[dc] = (jo, to)
    return out


@pytest.mark.parametrize("device_components", [True, False])
@pytest.mark.parametrize("decoder,paragraph", [("greedy", False), ("beamsearch", False),
                                               ("greedy", True)])
def test_recognize_matches_jax(ocr_pairs, device_components, decoder, paragraph):
    from omniparser_tpu.ocr import check_ocr_box as j_check
    from omniparser_tpu_torch.ocr import check_ocr_box as t_check

    jo, to = ocr_pairs[device_components]
    img = _scene(3)
    args = {"decoder": decoder, "paragraph": paragraph, "beamWidth": 5}
    want = j_check(img, output_bb_format="xyxy", easyocr_args=args, backend=jo)
    got = t_check(img, output_bb_format="xyxy", easyocr_args=args, backend=to, device="cpu")
    (texts, boxes), _ = got
    assert got == want
    assert len(texts) >= 3 and all(texts)
    if not paragraph:
        xywh = t_check(img, easyocr_args=args, backend=to, device="cpu")[0][1]
        assert xywh == [[x1, y1, x2 - x1, y2 - y1] for x1, y1, x2, y2 in boxes]


def test_host_and_device_components_give_the_same_candidates(ocr_pairs):
    img = _scene(11)
    h, w = img.shape[:2]
    padded = torch.from_numpy(img.copy())
    cands = [ocr_pairs[dc][1].detect_candidates(padded, (h, w), h, w) for dc in (True, False)]
    assert cands[0] == cands[1] and len(cands[0]) >= 3


# --------------------------- host-candidate parse --------------------------- #

VARIANTS = {"host_components": dict(device_components=False),
            "host_candidates": dict(fused_candidates=False)}


@pytest.fixture(scope="module")
def parse_pipelines(trained):
    """{variant: (JAX pipeline, port pipeline)} plus the port's fused
    pipeline, the trained detector and OCR, no captioner."""
    small = dict(detector=dict(default_imgsz=SIZE, max_detections=64),
                 ocr=dict(det_imgsz=SIZE, max_text_boxes=64, text_threshold=0.5))
    out = {}
    for name, flags in (("fused", {}), *VARIANTS.items()):
        jp = None
        if name != "fused":
            jc = jcfg.PipelineConfig(detector=jcfg.DetectorConfig(**small["detector"]),
                                     captioner=jcfg.CaptionerConfig(backend="null"),
                                     ocr=jcfg.OcrConfig(**small["ocr"], **flags))
            jp = JaxPipeline(jc, detector=F32Detector(imgsz=SIZE, max_det=64),
                             detector_params=trained["det"], ocr=_jax_ocr(jc.ocr, trained))
        tc = tcfg.PipelineConfig(
            detector=tcfg.DetectorConfig(dtype="float32", **small["detector"]),
            captioner=tcfg.CaptionerConfig(backend="null"),
            ocr=tcfg.OcrConfig(dtype="float32", **small["ocr"], **flags))
        out[name] = (jp, SOMPipeline(tc, device="cpu", detector_state=trained["states"]["det"],
                                     ocr_states=trained["states"]["ocr"]))
    return out


def _same_elements(got, want, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["type"], a["source"], a["interactivity"], a["content"]) == \
               (b["type"], b["source"], b["interactivity"], b["content"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=atol)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_host_candidate_parse_image_matches_jax_and_the_fused_path(parse_pipelines, variant):
    jp, tp = parse_pipelines[variant]
    fused = parse_pipelines["fused"][1]
    assert not tp._fused_ocr and fused._fused_ocr
    for seed in (11,):
        img = _scene(seed)
        _, j_labels, j_el = jp.parse_image(img)
        _, t_labels, t_el = tp.parse_image(img)
        _same_elements(t_el, j_el, 1e-5)
        assert set(t_labels) == set(j_labels)
        assert sum(e["type"] == "text" for e in t_el) >= 2
        # the same parse as the fused device-candidate path, exactly
        _, f_labels, f_el = fused.parse_image(img)
        assert t_el == f_el and t_labels == f_labels
        assert tp.last_counts["ocr_candidates"] == fused.last_counts["ocr_candidates"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_host_candidate_parse_batch(parse_pipelines, variant):
    """parse_batch in the two-phase order: each image gets what JAX's
    parse_batch and the port's own parse_image give it."""
    jp, tp = parse_pipelines[variant]
    images = [_scene(3), _scene(5, size=288), _scene(11)]
    got = tp.parse_batch(images)
    want = jp.parse_batch(images)
    for img, (_, t_labels, t_el), (_, j_labels, j_el) in zip(images, got, want):
        _same_elements(t_el, j_el, 1e-5)
        _, s_labels, s_el = tp.parse_image(img)
        assert t_el == s_el and t_labels == s_labels


class _Boxes:
    """A host OCR backend that returns n boxes."""

    def __init__(self, n):
        self.n = n

    def recognize(self, image_rgb, padded=None, hw=None):
        boxes = [[i % 20, i // 20, i % 20 + 5, i // 20 + 3] for i in range(self.n)]
        return [f"w{i}" for i in range(self.n)], boxes


@pytest.mark.parametrize("n,bucket", [(0, 32), (1, 32), (33, 64), (130, 256), (300, 256)])
def test_host_ocr_slot_buckets(n, bucket):
    """The OCR slot bucket: the smallest of 32, 64, ... (at most
    max_text_boxes) that holds the boxes, one for none; the same slots
    and values as JAX's _stage_ocr; the parse runs the merge at that M."""
    cfg = tcfg.PipelineConfig(
        detector=tcfg.DetectorConfig(default_imgsz=64, max_detections=8, dtype="float32"),
        captioner=tcfg.CaptionerConfig(backend="null"), detector_weights=None)
    tp = SOMPipeline(cfg, device="cpu", ocr=_Boxes(n))
    jp = JaxPipeline(jcfg.PipelineConfig(captioner=jcfg.CaptionerConfig(backend="null")),
                     detector=F32Detector(imgsz=64, max_det=8), detector_params=0,
                     ocr=_Boxes(n))
    img = np.zeros((40, 60, 3), np.uint8)
    tctx, jctx = tp._stage_upload(img), jp._stage_upload(img)
    tp._stage_ocr(tctx)
    jp._stage_ocr(jctx)
    assert tctx["ocr_arr"].shape == (bucket, 4) and tctx["n_ocr"] == min(n, 256)
    np.testing.assert_array_equal(tctx["ocr_arr"], jctx["ocr_arr"])
    np.testing.assert_array_equal(tctx["ocr_cand_valid"], jctx["ocr_cand_valid"])
    assert tctx["host_texts"] == jctx["host_texts"]
    _, elements = tp.parse_elements(img)
    texts = [e["content"] for e in elements if e["type"] == "text"]
    assert set(texts) <= {f"w{i}" for i in range(min(n, 256))}
    assert all(e["source"] == "box_ocr_content_ocr" for e in elements if e["type"] == "text")
