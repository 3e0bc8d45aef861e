"""The port's easyocr arch (``models/ocr_easy.py``, ``weights/convert_ocr.py``,
``TorchOCR(arch='easyocr')``) against the JAX package's, on the CPU in
float32: the same numpy-seeded weights (carried through ``weights/convert.py``)
and inputs on both sides.  Texts, boxes and element lists are exact; maps and
logits agree to 1e-4 of their largest magnitude."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu.config import OcrConfig as JOcrConfig
from omniparser_tpu.models import ocr_easy as je
from omniparser_tpu.models.ocr import JaxOCR
from omniparser_tpu_torch.config import OcrConfig
from omniparser_tpu_torch.models import ocr_easy as te
from omniparser_tpu_torch.models.ocr import TorchOCR
from omniparser_tpu_torch.weights import convert
from omniparser_tpu_torch.weights.init import build_module
from tests.test_torch_yolov9 import seeded_tree

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)

OCR = dict(arch="easyocr", det_imgsz=128, rec_height=64, rec_max_width=128,
           text_threshold=0.0, max_text_boxes=64)


def _craft_tree(seed=0):
    """Seeded CRAFT variables whose region head is scaled so that a seeded
    network draws components along dark text bars (at 0.3, the detector's
    threshold)."""
    shapes = jax.eval_shape(lambda: je.Craft().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    tree = seeded_tree(shapes, np.random.default_rng(seed))
    head = tree["params"]["cls4"]["conv"]
    head["kernel"][..., 0] *= 20.0
    head["bias"][0] = -0.13
    return tree


def _rec_tree(seed=1):
    shapes = jax.eval_shape(lambda: je.VggCtcRecognizer().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 1)), train=False))
    return seeded_tree(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def trees():
    return _craft_tree(), _rec_tree()


def _lines_image(rng, h=100, w=120):
    """A light screen with dark text bars of several lengths."""
    img = np.full((h, w, 3), 230, np.uint8)
    for k in range(5):
        y = 8 + 18 * k
        img[y:y + 8, 8:8 + int(rng.integers(30, w - 20))] = rng.integers(0, 60, 3)
    return img


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def test_craft_matches_jax_at_odd_level_sizes(trees):
    """50x70: the levels are 25x35, 12x17, 6x8, 3x4, so the U-Net's bilinear
    upsampling runs at ratios that are not whole."""
    tree, _ = trees
    m = build_module(te.Craft(), convert.convert_craft(convert.flatten_variables(tree)),
                     None, torch.float32, "cpu").requires_grad_(False)
    x = np.random.default_rng(0).random((1, 50, 70, 3), np.float32)
    want = np.asarray(jax.jit(lambda v, x: je.Craft().apply(v, x, train=False))(
        tree, jnp.asarray(x)))
    got = m(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 25, 35, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_recognizer_matches_jax(trees):
    _, tree = trees
    m = build_module(te.VggCtcRecognizer(),
                     convert.convert_easyocr_recognizer(convert.flatten_variables(tree)),
                     None, torch.float32, "cpu").requires_grad_(False)
    x = np.random.default_rng(1).standard_normal((2, 64, 128, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: je.VggCtcRecognizer().apply(v, x, train=False))(
        tree, jnp.asarray(x)))
    got = m(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 31, len(te.EASYOCR_EN_CHARSET) + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert te.EASYOCR_EN_CHARSET == je.EASYOCR_EN_CHARSET


def test_bidirectional_lstm_matches_jax_scan():
    """nn.LSTM(bidirectional=True) against the JAX package's TorchLSTM scan
    pair, carried by the converter (gates i, f, g, o in torch's layout on
    both sides), in a narrow recogniser: its first block, then the whole."""
    jrec = je.VggCtcRecognizer(output_channel=16, hidden=6, num_classes=10)
    shapes = jax.eval_shape(lambda: jrec.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 24, 1)),
                                              train=False))
    tree = seeded_tree(shapes, np.random.default_rng(2))
    m = build_module(te.VggCtcRecognizer(16, 6, 10),
                     convert.convert_easyocr_recognizer(convert.flatten_variables(tree)),
                     None, torch.float32, "cpu").requires_grad_(False)
    seq = np.random.default_rng(3).standard_normal((2, 7, 16)).astype(np.float32)
    want = np.asarray(je.BidirectionalLSTM(6, 6).apply(
        {"params": tree["params"]["rnn0"]}, jnp.asarray(seq)))
    got = m.rnn0(torch.from_numpy(seq)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    x = np.random.default_rng(4).standard_normal((2, 32, 24, 1)).astype(np.float32)
    want = np.asarray(jrec.apply(tree, jnp.asarray(x), train=False))
    got = m(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 5, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_convert_ocr_reads_easyocr_checkpoints(tmp_path):
    """craft_mlt_25k.pth (DataParallel 'module.' keys) and english_g2.pth
    written from torch restatements of the public architectures load
    through torch.load(weights_only=True), and the port's modules compute
    what the restatements compute."""
    from omniparser_tpu_torch.pipeline import SOMPipeline
    from omniparser_tpu_torch.config import PipelineConfig
    from omniparser_tpu_torch.weights.convert_ocr import load_easyocr_states
    from tests.test_convert_ocr import _TorchCraft, _TorchRec

    torch.manual_seed(0)
    craft, rec = _TorchCraft().eval(), _TorchRec(len(te.EASYOCR_EN_CHARSET) + 1).eval()
    with torch.no_grad():
        for m in list(craft.modules()) + list(rec.modules()):
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.6, 1.4)
    torch.save({f"module.{k}": v for k, v in craft.state_dict().items()},
               tmp_path / "craft_mlt_25k.pth")
    torch.save(rec.state_dict(), tmp_path / "english_g2.pth")
    cfg = OcrConfig(**OCR, dtype="float32", easyocr_craft_pth=str(tmp_path / "craft_mlt_25k.pth"),
                    easyocr_rec_pth=str(tmp_path / "english_g2.pth"))
    ocr = TorchOCR(cfg, "cpu")
    det_s, rec_s = load_easyocr_states(cfg.easyocr_craft_pth, cfg.easyocr_rec_pth)
    for k, v in det_s.items():
        torch.testing.assert_close(ocr.det.state_dict()[k], v, rtol=0, atol=0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 3, 64, 96)).astype(np.float32)
    xr = rng.standard_normal((2, 1, 64, 128)).astype(np.float32)
    with torch.no_grad():
        got = ocr.det(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
        # upstream CRAFT opens slices 2-4 with an in-place ReLU, which also
        # rectifies the skip features relu2_2 / relu3_2 / relu4_3 it keeps;
        # the JAX package (and so the port) takes them before the ReLU
        # (ROADMAP C.12): equal once those ReLUs do not write in place
        upstream = craft(torch.from_numpy(x)).numpy()  # NHWC
        for m in craft.modules():
            if isinstance(m, torch.nn.ReLU):
                m.inplace = False
        want = craft(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
        assert np.abs(upstream - want).max() > 1e-4 * np.abs(want).max()
        want = rec(torch.from_numpy(xr)).numpy()
        got = ocr.rec(torch.from_numpy(xr)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # the arch has no export: 'auto' needs the .pth files named
    bare = PipelineConfig(ocr=OcrConfig(**OCR), detector_weights=None,
                          captioner_weights=None, use_local_semantics=False)
    with pytest.raises(ValueError, match="no exported checkpoint of this arch"):
        SOMPipeline(bare, device="cpu")


@pytest.fixture(scope="module")
def ocr_pair(trees):
    craft, rec = trees
    jocr = JaxOCR(JOcrConfig(**OCR), det_params=craft, rec_params=rec)
    flat = convert.flatten_variables
    tocr = TorchOCR(OcrConfig(**OCR, dtype="float32"), "cpu",
                    convert.convert_craft(flat(craft)),
                    convert.convert_easyocr_recognizer(flat(rec)))
    return jocr, tocr


def test_easyocr_arch_end_to_end(ocr_pair, rng):
    """OcrConfig.arch='easyocr' through recognize(): CRAFT, the 64-row line
    grid, grayscale preprocessing, easyocr's charset; boxes and texts equal
    to the JAX package's."""
    jocr, tocr = ocr_pair
    assert tocr.charset == jocr.charset == je.EASYOCR_EN_CHARSET
    assert tocr.rec_len == OCR["rec_max_width"] // 4 - 1
    img = _lines_image(rng)
    texts, boxes = tocr.recognize(img)
    j_texts, j_boxes = jocr.recognize(img)
    assert len(boxes) >= 3 and (texts, boxes) == (j_texts, [list(b) for b in j_boxes])
    for x1, y1, x2, y2 in boxes:
        assert 0 <= x1 < x2 <= 120 and 0 <= y1 < y2 <= 100


def test_check_ocr_box_with_the_easyocr_arch(ocr_pair, rng):
    from omniparser_tpu.ocr import check_ocr_box as jcheck
    from omniparser_tpu_torch.ocr import check_ocr_box

    jocr, tocr = ocr_pair
    img = _lines_image(rng)
    for args in ({}, {"decoder": "beamsearch", "beamWidth": 4}, {"paragraph": True}):
        got = check_ocr_box(img, output_bb_format="xywh", easyocr_args=args, backend=tocr,
                            device="cpu")
        want = jcheck(img, output_bb_format="xywh", easyocr_args=args, backend=jocr)
        assert got[0][0] == want[0][0] and [list(b) for b in got[0][1]] == \
            [list(b) for b in want[0][1]]
        assert got[0][0]


def test_fused_parse_with_the_easyocr_arch_matches_jax(ocr_pair, trees, rng):
    """The fused step with CRAFT's components and the recogniser's W/4 - 1
    steps in its block loop (64 slots in blocks of 32): elements equal to
    the JAX package's parse_image."""
    from omniparser_tpu import config as jcfg
    from omniparser_tpu.models import yolov8 as jyolo
    from omniparser_tpu.pipeline import SOMPipeline as JaxPipeline
    from omniparser_tpu_torch import config as tcfg
    from omniparser_tpu_torch.pipeline import SOMPipeline

    jocr, tocr = ocr_pair

    @dataclasses.dataclass(frozen=True)
    class F32Detector(jyolo.Detector):
        @property
        def module(self):
            return jyolo.YOLOv8(variant=self.variant, num_classes=self.num_classes,
                                dtype=jnp.float32)

    jdet = F32Detector(imgsz=128, max_det=32)
    det_tree = seeded_tree(jax.eval_shape(lambda: jdet.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)),
        np.random.default_rng(6))
    det = dict(default_imgsz=128, max_detections=32, box_threshold=0.3)
    kw = dict(use_local_semantics=True, ocr_weights=None, detector_weights=None)
    jp = JaxPipeline(jcfg.PipelineConfig(detector=jcfg.DetectorConfig(**det),
                                         captioner=jcfg.CaptionerConfig(backend="null"),
                                         ocr=jcfg.OcrConfig(**OCR), **kw),
                     detector=jdet, detector_params=det_tree, ocr=jocr)
    tp = SOMPipeline(tcfg.PipelineConfig(detector=tcfg.DetectorConfig(dtype="float32", **det),
                                         captioner=tcfg.CaptionerConfig(backend="null"),
                                         ocr=tcfg.OcrConfig(dtype="float32", **OCR), **kw),
                     device="cpu", ocr=tocr,
                     detector_state=convert.convert_yolov8(convert.flatten_variables(det_tree)))
    assert tp._fused_ocr
    img = _lines_image(rng)
    _, _, j_el = jp.parse_image(img)
    _, _, t_el = tp.parse_image(img)
    assert sum(e["type"] == "text" for e in t_el) >= 3
    assert len(t_el) == len(j_el)
    for a, b in zip(t_el, j_el):
        assert (a["type"], a["source"], a["content"]) == (b["type"], b["source"], b["content"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=1e-4)
