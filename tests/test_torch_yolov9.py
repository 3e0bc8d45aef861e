"""The port's YOLOv9 (GELAN) detector (``omniparser_tpu_torch.models.yolov9``,
``weights/convert_yolov9.py``) against the JAX package's: one counterpart of
each test in tests/test_yolov9.py, with the same numpy-seeded inputs and the
same weights (carried through ``weights/convert.py``) on both sides, on the
CPU in float32.  Keep sets, counts and element lists are exact; boxes agree
to 1e-4 of the largest magnitude (letterboxed pixels or normalised units),
scores to 1e-5."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu.models import yolov9 as jy9
from omniparser_tpu.weights import convert_yolov9 as jcvt
from omniparser_tpu_torch.models import yolov9 as ty9
from omniparser_tpu_torch.weights import convert
from omniparser_tpu_torch.weights import convert_yolov9 as tcvt
from omniparser_tpu_torch.weights.init import build_module
from tests.test_yolov9 import _assert_trees_equal, _oracle_decode, _synth_sd

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)

# prefilter 96 (not tests/test_yolov9.py's 64): the JAX package caches
# predict graphs by (variant, classes, prefilter) across instances, and this
# file's float32 graphs must not meet its bfloat16 ones in one worker
TINY = dict(variant="test", num_classes=3, imgsz=64, max_det=16, prefilter=96)


@dataclasses.dataclass(frozen=True)
class F32Detector(jy9.YOLOv9Detector):
    """The JAX detector with a float32 GELAN (its own builds bfloat16)."""

    @property
    def module(self):
        return jy9.GELAN(variant=self.variant, num_classes=self.num_classes,
                         dtype=jnp.float32)


def seeded_tree(shapes, rng):
    """Numpy variables of a Flax tree's shapes (``jax.eval_shape`` of its
    init: no init compile): kernels normal at 1/sqrt(fan_in), biases and
    BatchNorm means small, scales and variances around 1."""
    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            a = rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, x.shape)
        else:
            a = rng.uniform(-0.2, 0.2, x.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(seed=0, **kw):
    """(JAX detector, its float32 variables as numpy, port detector, module)
    with the same weights."""
    kw = {**TINY, **kw}
    jdet = F32Detector(**kw)
    shapes = jax.eval_shape(lambda: jdet.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    params = seeded_tree(shapes, np.random.default_rng(seed))
    tdet = ty9.YOLOv9Detector(**kw)
    state = convert.convert_yolov9(convert.flatten_variables(params), tdet.variant,
                                   tdet.num_classes)
    module = build_module(tdet.make_module(), state, None, torch.float32, "cpu")
    return jdet, params, tdet, module.requires_grad_(False)


@pytest.fixture(scope="module")
def tiny():
    return _pair(0)


@pytest.fixture(scope="module")
def tiny_dual():
    return _pair(1, variant="dualtest", num_classes=2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("fixture", ["tiny", "tiny_dual"])
def test_decode_matches_reference_oracle(request, fixture):
    """The GELAN's levels through the port's decode against the numpy
    restatement of the reference loop, on a non-square input (the network
    itself is held to JAX's in test_detect_graph_matches_jax)."""
    from omniparser_tpu_torch.models.yolov8 import decode_predictions

    _, _, _, module = request.getfixturevalue(fixture)
    img = np.random.default_rng(0).random((1, 64, 96, 3), np.float32)
    outs = module(_nchw(img))
    ours_b, ours_s = (t.numpy() for t in decode_predictions(outs))
    ref_b, ref_s = _oracle_decode([(b.permute(0, 2, 3, 1).numpy(), c.permute(0, 2, 3, 1).numpy())
                                   for b, c in outs])
    np.testing.assert_allclose(ours_b, ref_b, atol=2e-3)
    np.testing.assert_allclose(ours_s, ref_s, atol=1e-5)


def test_normalize_image_size():
    for size in (640, 100, (96, 100), (33, 65)):
        assert ty9.normalize_image_size(size) == jy9.normalize_image_size(size)
    with pytest.raises(ValueError):
        ty9.normalize_image_size((1, 2, 3))


def test_preprocess_matches_jax(rng):
    img = rng.integers(0, 255, (80, 100, 3), dtype=np.uint8)
    for size in (96, (64, 128)):
        arr, *geom = ty9.preprocess_pil(img, size)
        j_arr, *j_geom = jy9.preprocess_pil(img, size)
        np.testing.assert_array_equal(arr, j_arr)
        assert geom == j_geom
    np.testing.assert_allclose(ty9.preprocess_pil(img, 96)[0][0, 0], 114 / 255.0, atol=1e-6)


def test_predict_matches_jax(tiny, rng):
    """The reference wrapper's predict: same boxes (class-offset NMS over 3
    classes), same confidences, clamped to the image, score-sorted."""
    jdet, params, tdet, module = tiny
    img = (rng.random((80, 100, 3)) * 255).astype(np.uint8)
    for conf, iou in ((0.01, 0.7), (0.3, 0.5)):
        (got,) = tdet.predict(module, img, conf=conf, imgsz=64, iou=iou, max_det=16)
        (want,) = jdet.predict(params, img, conf=conf, imgsz=64, iou=iou, max_det=16)
        assert got.boxes.xyxy.shape == want.boxes.xyxy.shape
        assert len(got.boxes.conf) > 0
        np.testing.assert_allclose(got.boxes.xyxy, want.boxes.xyxy, rtol=0, atol=1e-4 * 100)
        np.testing.assert_allclose(got.boxes.conf, want.boxes.conf, rtol=0, atol=1e-5)
        b = got.boxes.xyxy
        assert (b[:, [0, 2]] >= 0).all() and (b[:, [0, 2]] <= 100).all()
        assert (b[:, [1, 3]] >= 0).all() and (b[:, [1, 3]] <= 80).all()
        assert (np.diff(got.boxes.conf) <= 1e-6).all()
    (none,) = tdet.predict(module, img, conf=0.9999, imgsz=64)
    assert len(none.boxes.conf) == 0


def test_per_class_nms_offset_keeps_overlapping_classes():
    """batched_nms semantics through the class-offset window: identical boxes
    of two classes both survive, of one class only the first."""
    from omniparser_tpu_torch.ops.nms import nms_fixed_shape

    boxes = torch.tensor([[10, 10, 50, 50], [10, 10, 50, 50]], dtype=torch.float32)
    scores_all = torch.tensor([[0.9, 0.1], [0.1, 0.8]])  # class 0, class 1
    offset_boxes, top_boxes, top_scores, valid, overflow = ty9.class_offset_window(
        boxes, scores_all, 0.05, 4)
    assert torch.equal(top_boxes, boxes) and int(overflow) == 0
    np.testing.assert_allclose(offset_boxes[1].numpy(), boxes[1].numpy() + 41.0)
    assert int(nms_fixed_shape(offset_boxes, top_scores, valid, 0.5, 4)[3].sum()) == 2
    assert int(nms_fixed_shape(top_boxes, top_scores, valid, 0.5, 4)[3].sum()) == 1


@pytest.mark.parametrize("fixture", ["tiny", "tiny_dual"])
def test_detect_graph_matches_jax(request, fixture, rng):
    """The fused step's detector contract, against JAX detect_graph."""
    jdet, params, tdet, module = request.getfixturevalue(fixture)
    padded = np.zeros((128, 128, 3), np.uint8)
    padded[:90, :110] = rng.integers(0, 255, (90, 110, 3), dtype=np.uint8)
    nb, ns, nv, over = tdet.detect_graph(module, torch.from_numpy(padded), (90, 110), 0.01,
                                         0.7, with_stats=True)
    detect = jax.jit(lambda p, x, hw: jdet.detect_graph(
        p, x, hw, jnp.float32(0.01), jnp.float32(0.7), allow_pallas=False, with_stats=True))
    jb, js, jv, jover = (np.asarray(t) for t in detect(
        params, jnp.asarray(padded), jnp.asarray([90, 110], jnp.int32)))
    assert nb.shape == (16, 4) and ns.shape == (16,) and nv.shape == (16,)
    np.testing.assert_array_equal(nv.numpy(), jv)
    assert int(over) == int(jover) and int(nv.sum()) > 0
    np.testing.assert_allclose(nb.numpy()[jv], jb[jv], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ns.numpy()[jv], js[jv], rtol=0, atol=1e-5)
    b = nb.numpy()[jv]
    assert (b >= -1e-5).all() and (b <= 1 + 1e-5).all()


def _traced_archive(sd, path):
    """A TorchScript archive whose state dict has the yolov9 spellings of
    `sd` (the reference's icon_detect_v3/model.pt is such an archive)."""
    root = torch.nn.Module()
    for k, v in sd.items():
        parts, m = k.split("."), root
        for p in parts[:-1]:
            if p not in m._modules:
                m.add_module(p, torch.nn.Module())
            m = m._modules[p]
        m.register_buffer(parts[-1], torch.as_tensor(np.asarray(v)))

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = root.model

        def forward(self, x):
            return x

    torch.jit.trace(Holder(), torch.zeros(1)).save(str(path))


def test_compat_routes_icon_detect_v3(tiny_dual, tmp_path, monkeypatch):
    """get_yolo_model: an icon_detect_v3 path builds YOLOv9-E and reads a
    yolov9 TorchScript archive; 'v9*' variants without a path are seeded
    GELANs; no path and no variant stays YOLOv8-n (the JAX package's
    deliberate default)."""
    from omniparser_tpu_torch import compat as tcompat

    seen = {}

    def fake_load(path, det):
        seen["path"], seen["det"] = path, det
        return None  # seeded

    monkeypatch.setattr(tcvt, "load_yolov9_state", fake_load)
    det, module = tcompat.get_yolo_model("weights/icon_detect_v3/model.pt", device="cpu")
    assert type(det).__name__ == "YOLOv9Detector" and det.variant == "e"
    assert seen["path"].endswith("model.pt") and isinstance(module, ty9.GELAN)
    monkeypatch.undo()
    det2, module2 = tcompat.get_yolo_model(variant="v9test", device="cpu")
    assert type(det2).__name__ == "YOLOv9Detector" and det2.variant == "test"
    assert type(tcompat.get_yolo_model(device="cpu")[0]).__name__ == "Detector"

    # a real archive of the tiny dual form, under an icon_detect_v3 directory
    jdet, params, tdet, module = tiny_dual
    path = tmp_path / "icon_detect_v3" / "model.pt"
    path.parent.mkdir()
    _traced_archive(_synth_sd(params), path)
    state = tcvt.load_yolov9_state(str(path), tdet)
    want = module.state_dict()
    assert set(state) == {k for k in want if not k.endswith("num_batches_tracked")}
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)


def test_converter_roundtrip_unfused(tiny):
    _, params, _, _ = tiny
    got = tcvt.convert_yolov9_state_dict(_synth_sd(params, fuse_rep=False))
    _assert_trees_equal(params["params"], got["params"])
    _assert_trees_equal(params["batch_stats"], got["batch_stats"])
    _assert_trees_equal(jcvt.convert_yolov9_state_dict(_synth_sd(params))["params"],
                        got["params"])


def test_converter_roundtrip_fused_repconv(tiny):
    """Deploy-fused RepConvN convs load as an identity BatchNorm carrying
    the bias, as the JAX converter loads them; the module computes the same."""
    _, params, tdet, _ = tiny
    sd = _synth_sd(params, fuse_rep=True)
    got = tcvt.convert_yolov9_state_dict(sd)
    _assert_trees_equal(jcvt.convert_yolov9_state_dict(sd)["params"], got["params"])
    _assert_trees_equal(jcvt.convert_yolov9_state_dict(sd)["batch_stats"], got["batch_stats"])
    site_p = got["params"]["elan2"]["cv2_csp"]["m0"]["cv1"]
    site_s = got["batch_stats"]["elan2"]["cv2_csp"]["m0"]["cv1"]
    np.testing.assert_allclose(site_p["bn"]["scale"], 1.0)
    np.testing.assert_allclose(site_s["bn"]["mean"], 0.0)
    np.testing.assert_allclose(site_s["bn"]["var"], 1.0 - 1e-3)
    m = build_module(tdet.make_module(), convert.convert_yolov9(
        convert.flatten_variables(got), "test", 3), None, torch.float32, "cpu")
    bn = m.elan2.cv2_csp.m0.cv1.bn
    x = torch.randn(1, bn.num_features, 3, 3)
    torch.testing.assert_close(bn(x), x + bn.bias[:, None, None], rtol=0, atol=1e-6)


def test_converter_rejects_partial(tiny):
    _, params, _, _ = tiny
    sd = _synth_sd(params)
    sd["model.3.cv1.bogus.weight"] = np.zeros((4, 4, 3, 3), np.float32)
    with pytest.raises(ValueError, match="unmatched"):
        tcvt.convert_yolov9_state_dict(sd)
    sd = _synth_sd(params)
    del sd["model.4.cv4.conv.weight"]  # a leaf the module still needs
    with pytest.raises(KeyError, match="missing"):
        convert.convert_yolov9(convert.flatten_variables(tcvt.convert_yolov9_state_dict(sd)),
                               "test", 3)


def _v9_configs(weights=None, variant="v9test", num_classes=TINY["num_classes"]):
    from omniparser_tpu import config as jcfg
    from omniparser_tpu_torch import config as tcfg

    det = dict(variant=variant, num_classes=num_classes, default_imgsz=64,
               max_detections=16, prefilter_topk=96)
    kw = dict(use_local_semantics=False, detector_weights=weights)
    jc = jcfg.PipelineConfig(detector=jcfg.DetectorConfig(**det),
                             captioner=jcfg.CaptionerConfig(backend="null"),
                             ocr=jcfg.OcrConfig(backend="null"), **kw)
    tc = tcfg.PipelineConfig(detector=tcfg.DetectorConfig(dtype="float32", **det),
                             captioner=tcfg.CaptionerConfig(backend="null"),
                             ocr=tcfg.OcrConfig(backend="null"), **kw)
    return jc, tc


@pytest.mark.parametrize("fixture", ["tiny", "tiny_dual"])
def test_pipeline_v9_variant_matches_jax(request, fixture, rng):
    """config.detector.variant='v9test' / 'v9dualtest' builds a GELAN
    pipeline; its parse_image equals the JAX package's element for element."""
    from omniparser_tpu.pipeline import SOMPipeline as JaxPipeline
    from omniparser_tpu_torch.pipeline import SOMPipeline

    jdet, params, tdet, module = request.getfixturevalue(fixture)
    jc, tc = _v9_configs(variant="v9" + tdet.variant, num_classes=tdet.num_classes)
    jp = JaxPipeline(jc, detector=jdet, detector_params=params)
    tp = SOMPipeline(tc, device="cpu", detector_state=module.state_dict())
    assert type(tp.detector).__name__ == "YOLOv9Detector"
    assert tp.detector.variant == tdet.variant
    img = rng.integers(0, 255, (60, 70, 3), dtype=np.uint8)
    _, j_labels, j_el = jp.parse_image(img)
    _, t_labels, t_el = tp.parse_image(img)
    assert len(t_el) == len(j_el) > 0
    for a, b in zip(t_el, j_el):
        assert (a["type"], a["source"], a["content"]) == (b["type"], b["source"], b["content"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=1e-4)
    assert set(t_labels) == set(j_labels)


def test_pipeline_routes_v9_pt_weights(tiny, tmp_path, monkeypatch):
    """detector_weights='*.pt' with a 'v9*' variant reads yolov9 spellings
    (the v8 converter would reject them); Omniparser(dict) routes an
    icon_detect_v3 path to YOLOv9-E as the reference does."""
    from omniparser_tpu_torch.pipeline import Omniparser, SOMPipeline

    _, params, _, module = tiny
    pt = tmp_path / "model.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in _synth_sd(params).items()}, pt)
    _, tc = _v9_configs(str(pt))
    tp = SOMPipeline(tc, device="cpu")
    for k, v in module.state_dict().items():
        torch.testing.assert_close(tp.det_module.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no exported checkpoint of the GELAN"):
        SOMPipeline(dataclasses.replace(tc, detector_weights="auto"), device="cpu")

    seen = {}
    monkeypatch.setattr("omniparser_tpu_torch.pipeline.SOMPipeline",
                        lambda config, device, **kw: seen.setdefault("config", config))
    Omniparser({"som_model_path": "weights/icon_detect_v3/model.pt",
                "caption_model_name": "blip2"}, device="cpu")
    assert seen["config"].detector.variant == "v9e"
    assert seen["config"].captioner.backend == "blip2"


def test_dual_form_forward_and_converter_roundtrip(tiny_dual):
    """The 'e' family's dual deploy form (CBLinear taps, CBFuse sites, a
    second backbone): three levels, and a 31-layer source-spelled state
    dict round-trips exactly."""
    _, params, _, module = tiny_dual
    assert len(module(torch.zeros(1, 3, 64, 64))) == 3
    assert hasattr(module, "stemA") and hasattr(module, "cb5")
    sd = _synth_sd(params)
    assert len({k.split(".")[1] for k in sd}) == len(tcvt._MODULE_ORDER_DUAL)
    got = tcvt.convert_yolov9_state_dict(sd)
    _assert_trees_equal(params["params"], got["params"])
    _assert_trees_equal(params["batch_stats"], got["batch_stats"])


def test_dual_form_converter_rejects_partial(tiny_dual):
    _, params, _, _ = tiny_dual
    sd = _synth_sd(params)
    sd["model.10.bogus.weight"] = np.zeros((4, 4, 1, 1), np.float32)
    with pytest.raises(ValueError, match="unmatched"):
        tcvt.convert_yolov9_state_dict(sd)


def test_cb_fuse_matches_jax_at_odd_sizes(rng):
    """CBFuse's nearest resize where the level sizes do not divide."""
    from omniparser_tpu.models.yolov9 import cb_fuse as jfuse

    target = rng.standard_normal((1, 7, 5, 4)).astype(np.float32)
    chunks = [rng.standard_normal((1, h, w, 4)).astype(np.float32)
              for h, w in ((4, 3), (2, 2), (7, 5))]
    want = np.asarray(jfuse([jnp.asarray(c) for c in chunks], jnp.asarray(target)))
    got = ty9.cb_fuse([_nchw(c) for c in chunks], _nchw(target)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
