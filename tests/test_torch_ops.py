"""The port's tensor ops vs the JAX package's, same numpy-seeded inputs, on
the CPU in float32.  Integer and boolean outputs are compared exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu.ops import boxes as jboxes
from omniparser_tpu.ops import components as jcomp
from omniparser_tpu.ops import preprocess as jpre
from omniparser_tpu.ops.nms import nms_fixed_shape as j_nms_fixed_shape
from omniparser_tpu.ops.overlap import merge_icons_and_ocr as j_merge
from omniparser_tpu.utils.hostops import extract_components
from omniparser_tpu_torch.ops import boxes as tboxes
from omniparser_tpu_torch.ops import components as tcomp
from omniparser_tpu_torch.ops import preprocess as tpre
from omniparser_tpu_torch.ops.nms import nms_fixed_shape
from omniparser_tpu_torch.ops.overlap import merge_icons_and_ocr
from chip_smoke import MERGE_CASES
from tests.conftest import random_boxes

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)

T = torch.from_numpy


def test_box_geometry_matches(rng):
    a = random_boxes(rng, 40, max_size=0.4)
    b = random_boxes(rng, 30, max_size=0.3)
    a[3, 2] = a[3, 0]  # zero-area
    b[5] = a[7]        # identical pair
    for name in ("pairwise_intersection", "pairwise_max_overlap_ratio", "containment_ratio"):
        want = np.asarray(getattr(jboxes, name)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(tboxes, name)(T(a), T(b)).numpy()
        # same float32 formula; a division may round differently in the last bit
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tboxes.box_area(T(a)).numpy(),
                                  np.asarray(jboxes.box_area(jnp.asarray(a))))
    neg = np.array([[0.5, 0.5, 0.2, 0.9], [0.999, 0.1, 1.0, 0.3], [0.1, 0.1, 0.35, 0.35]],
                   np.float32)
    np.testing.assert_array_equal(
        tboxes.int_box_area(T(neg), 157, 93).numpy(),
        np.asarray(jboxes.int_box_area(jnp.asarray(neg), 157, 93)))


@pytest.mark.parametrize("h,w,hb,wb,target", [
    (100, 150, 128, 256, 96),    # downscale, width-bound, zero padding beside the image
    (131, 77, 256, 128, 160),    # upscale, odd sizes, height-bound
    (128, 128, 128, 128, 64),    # bucket == image: the source edge renormalises
    (97, 203, 128, 256, 203),    # r == 1 along the width
])
def test_letterbox_matches(rng, h, w, hb, wb, target):
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    padded, _ = jpre.pad_to_bucket(img, hb, wb)
    want, wr, (wpy, wpx) = jpre.letterbox(jnp.asarray(padded),
                                          jnp.asarray([h, w], jnp.int32), target)
    got, r, (py, px) = tpre.letterbox(T(padded), (h, w), target)
    assert float(r) == float(wr)
    # XLA's CPU backend contracts `target - w * r` into one fused multiply-add,
    # which keeps the rounding error of r (about 1e-6 px); the port rounds the
    # product first, as IEEE float32 without contraction does
    assert abs(float(py) - float(wpy)) <= 1e-5 and abs(float(px) - float(wpx)) <= 1e-5
    # float32 two-tap sums in another order: 1e-4 on [0,1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    boxes = (random_boxes(rng, 16, max_size=0.4) * target).astype(np.float32)
    wb_ = jpre.boxes_letterboxed_to_image(jnp.asarray(boxes), wr, (wpy, wpx),
                                          jnp.asarray([h, w], jnp.int32))
    gb = tpre.boxes_letterboxed_to_image(T(boxes), wr, (float(wpy), float(wpx)), (h, w))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb_), rtol=1e-6, atol=1e-4)


def test_host_bucket_helpers_match():
    for h, w in [(1, 1), (128, 129), (1080, 1920), (2160, 3840)]:
        assert tpre.pick_bucket_2d(h, w) == jpre.pick_bucket_2d(h, w)
    img = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    a, ahw = tpre.pad_to_bucket(img, 8, 8)
    b, bhw = jpre.pad_to_bucket(img, 8, 8)
    np.testing.assert_array_equal(a, b)
    assert ahw == bhw
    with pytest.raises(ValueError):
        tpre.pad_to_bucket(img, 4, 8)


@pytest.mark.parametrize("n,max_out,thr", [(64, 16, 0.3), (200, 32, 0.1), (200, 256, 0.5)])
def test_nms_fixed_shape_matches(rng, n, max_out, thr):
    boxes = random_boxes(rng, n, max_size=0.4)
    boxes[10:13] = boxes[0:3]  # duplicates
    scores = rng.uniform(0.05, 1.0, n).astype(np.float32)
    scores[20] = scores[21]    # a score tie: the lower index must come first
    valid = rng.uniform(size=n) > 0.15
    want = j_nms_fixed_shape(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                             thr, max_out)
    got = nms_fixed_shape(T(boxes), T(scores), T(valid), thr, max_out)
    for g, w_, name in zip(got, want, ("boxes", "scores", "idx", "valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=name)


@pytest.mark.parametrize("n,m,case", [
    pytest.param(48, 24, None, id="48-24"), pytest.param(16, 40, None, id="16-40"),
    *(pytest.param(0, 0, name, id=name) for name in sorted(MERGE_CASES))])
def test_merge_icons_and_ocr_matches(rng, n, m, case):
    """The port's merge (merge_masks; on CPU tensors its plain version)
    against JAX's, exact on all four masks; `case` names one of
    chip_smoke.MERGE_CASES, the cases the fused kernel is held to on the
    card and, replayed, in tests/test_torch_merge.py."""
    if case is None:
        icons = random_boxes(rng, n, max_size=0.35)
        ocr = random_boxes(rng, m, max_size=0.12)
        c = (icons[:6, :2] + icons[:6, 2:]) / 2
        half = (icons[:6, 2:] - icons[:6, :2]) / 2
        ocr[:6] = np.concatenate([c - 0.4 * half, c + 0.4 * half], axis=1)    # inside icons
        ocr[6:9] = np.concatenate([c[:3] - 1.4 * half[:3], c[:3] + 1.4 * half[:3]], axis=1)
        icons[n - 4:] = icons[:4] * 0.98 + 0.01                                # near-duplicates
        icon_valid = rng.uniform(size=n) > 0.1
        ocr_valid = rng.uniform(size=m) > 0.1
    else:
        icons, icon_valid, ocr, ocr_valid = MERGE_CASES[case](rng)
    want = j_merge(jnp.asarray(icons), jnp.asarray(icon_valid), jnp.asarray(ocr),
                   jnp.asarray(ocr_valid), 0.7)
    got = merge_icons_and_ocr(T(icons), T(icon_valid), T(ocr), T(ocr_valid), 0.7)
    for name in ("icon_keep", "ocr_keep", "absorb", "icon_suppressed"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    if case is None:
        assert got.absorb.any() and got.icon_suppressed.any()


def test_crop_lines_and_resize_match(rng):
    h, w, hb, wb = 90, 200, 128, 256
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    padded, _ = jpre.pad_to_bucket(img, hb, wb)
    boxes = np.array([[0.05, 0.1, 0.9, 0.2], [0.3, 0.5, 0.4, 0.9], [0.0, 0.0, 1.0, 1.0],
                      [0.5, 0.5, 0.5, 0.5], [0.97, 0.95, 1.0, 1.0]], np.float32)
    hw = jnp.asarray([h, w], jnp.int32)
    want = np.asarray(jpre.crop_lines_batch(jnp.asarray(padded), hw, jnp.asarray(boxes), (16, 64)))
    got = tpre.crop_lines_batch(T(padded), (h, w), T(boxes), (16, 64)).numpy()
    # same float32 sampling on [0,255]; a fused multiply-add on either side
    # moves a coordinate by an ulp
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    want = np.asarray(jpre.crop_resize_batch(jnp.asarray(padded), hw, jnp.asarray(boxes), (8, 24)))
    got = tpre.crop_resize_batch(T(padded), (h, w), T(boxes), (8, 24)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


def _blob_map(rng, h, w):
    """A probability map with rectangles, an L, a staircase and a spiral
    (several propagation rounds), quantised to the uint8 grid."""
    prob = rng.uniform(0.0, 0.25, (h, w)).astype(np.float32)
    prob[3:9, 4:30] = 0.9
    prob[12:30, 40:44] = 0.8
    prob[26:30, 40:70] = 0.7
    for k in range(10):  # staircase
        prob[34 + k, 2 + 2 * k: 5 + 2 * k] = 0.6
    sp = np.zeros((15, 15), bool)  # spiral
    sp[0, :] = sp[:, 14] = sp[14, 2:] = sp[4:, 2] = sp[4, 2:12] = sp[4:11, 11] = True
    prob[46:61, 30:45][sp] = 0.95
    prob[50, 70] = 0.99   # below min_area
    prob[2:6, 60:64] = 0.31  # low score, above the binarisation threshold
    return np.floor(prob * 255 + 0.5).astype(np.float32) / np.float32(255.0)


@pytest.mark.parametrize("max_out,pre_cap", [(64, 64), (3, 64), (64, 4)])
def test_device_components_match(rng, max_out, pre_cap):
    prob = _blob_map(rng, 64, 80)
    want = jcomp.device_components(jnp.asarray(prob), 0.3, 0.3, min_area=4,
                                   max_out=max_out, pre_cap=pre_cap)
    got = tcomp.device_components(T(prob), 0.3, 0.3, min_area=4, max_out=max_out,
                                  pre_cap=pre_cap)
    for name in ("boxes", "areas", "count", "overflow"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    # mean of k/255 values: float64 accumulation here, float32 there
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-5, atol=1e-6)
    if max_out == 64 and pre_cap == 64:
        # second oracle: the host union-find
        comps = extract_components(prob, 0.3, 4, 0.3)
        n = int(got["count"])
        assert n == len(comps) and n >= 5
        for i, (box, score, area) in enumerate(comps):
            assert tuple(got["boxes"][i].tolist()) == tuple(box)
            assert int(got["areas"][i]) == area


def test_quantize_and_candidate_boxes_match(rng):
    p = rng.uniform(-0.1, 1.1, (32, 32)).astype(np.float32)
    np.testing.assert_array_equal(tcomp.quantize_u8_parity(T(p)).numpy(),
                                  np.asarray(jcomp.quantize_u8_parity(jnp.asarray(p))))
    n = 40
    x1 = rng.integers(0, 400, n)
    y1 = rng.integers(0, 400, n)
    cc = np.stack([x1, y1, x1 + rng.integers(1, 80, n), y1 + rng.integers(1, 20, n)],
                  axis=1).astype(np.int32)
    uh, uw, s = 613, 1000, 960
    r = min(s / uh, s / uw)
    pads = ((s - uh * r) / 2.0, (s - uw * r) / 2.0)
    for count, max_boxes in [(30, 32), (40, 32), (0, 32)]:
        want = jcomp.candidate_boxes_from_cc(
            jnp.asarray(cc), jnp.asarray(count, jnp.int32), r, jnp.asarray(pads, jnp.float32),
            jnp.asarray([uh, uw], jnp.int32), max_boxes)
        got = tcomp.candidate_boxes_from_cc(
            T(cc), torch.tensor(count, dtype=torch.int32), r, pads, (uh, uw), max_boxes)
        for g, w_, name in zip(got, want, ("boxes", "valid", "overflow")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=name)
