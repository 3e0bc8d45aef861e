"""The port's plain kernel versions vs the JAX package's Pallas kernels
(interpret mode on CPU) and XLA references.  Masks are compared exactly;
float maps within the stated tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu.ops.nms import _select_max_keep
from omniparser_tpu.ops.pallas_crop import pallas_crop_resize
from omniparser_tpu.ops.pallas_kernels import pallas_nms_keep, pallas_overlap_matrices
from omniparser_tpu.ops.preprocess import crop_resize_batch, pad_to_bucket
from omniparser_tpu_torch.ops import hopper_crop, hopper_kernels
from omniparser_tpu_torch.ops.hopper_crop import crop_resize, crop_resize_plain
from omniparser_tpu_torch.ops.hopper_kernels import (
    nms_keep,
    nms_keep_plain,
    overlap_matrices,
    overlap_matrices_plain,
)
from tests.conftest import random_boxes

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)


def _sorted_case(rng, n, n_invalid=0, dup=0, zero=0):
    boxes = random_boxes(rng, n, max_size=0.5)
    if dup:
        boxes[n // 2: n // 2 + dup] = boxes[:dup]
    if zero:
        boxes[5: 5 + zero, 2] = boxes[5: 5 + zero, 0]
    scores = rng.uniform(0.1, 1.0, n).astype(np.float32)
    order = np.argsort(-scores, kind="stable")
    valid = np.ones(n, bool)
    if n_invalid:
        valid[n - n_invalid:] = False
    return boxes[order], valid


@pytest.mark.parametrize("n,thr", [(64, 0.3), (64, 0.1), (300, 0.3), (300, 0.5)])
def test_nms_keep_plain_matches_pallas_interpret(rng, n, thr):
    sboxes, svalid = _sorted_case(rng, n, n_invalid=n // 8, dup=3, zero=2)
    want = np.asarray(pallas_nms_keep(jnp.asarray(sboxes), jnp.asarray(svalid), thr,
                                      interpret=True))
    got = nms_keep_plain(torch.from_numpy(sboxes), torch.from_numpy(svalid), thr).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for CPU tensors (and counts no launch)
    before = dict(hopper_kernels.launch_counts)
    got2 = nms_keep(torch.from_numpy(sboxes), torch.from_numpy(svalid), thr).numpy()
    np.testing.assert_array_equal(got2, want)
    assert hopper_kernels.launch_counts == before


@pytest.mark.parametrize("n,max_out", [(64, 16), (300, 32), (300, 512)])
def test_nms_keep_plain_first_max_out_is_select_max_set(rng, n, max_out):
    """The full greedy mask cut to its first max_out survivors is the
    select-max loop's keep set."""
    sboxes, svalid = _sorted_case(rng, n, n_invalid=n // 10, dup=2)
    want = np.asarray(_select_max_keep(jnp.asarray(sboxes), jnp.asarray(svalid),
                                       0.3, max_out))
    full = nms_keep_plain(torch.from_numpy(sboxes), torch.from_numpy(svalid), 0.3).numpy()
    cut = full & (np.cumsum(full) <= max_out)
    np.testing.assert_array_equal(cut, want)


@pytest.mark.parametrize("n,m", [(48, 32), (20, 40)])
def test_overlap_matrices_plain_matches_pallas_interpret(rng, n, m):
    icons = random_boxes(rng, n, max_size=0.3)
    ocr = random_boxes(rng, m, max_size=0.15)
    # some OCR boxes well inside an icon, some icons well inside an OCR box
    c = (icons[:4, :2] + icons[:4, 2:]) / 2
    half = (icons[:4, 2:] - icons[:4, :2]) / 2
    ocr[:4] = np.concatenate([c - 0.5 * half, c + 0.5 * half], axis=1)
    ocr[4:6] = np.concatenate([c[:2] - 1.5 * half[:2], c[:2] + 1.5 * half[:2]], axis=1)
    r, a, b = pallas_overlap_matrices(jnp.asarray(icons), jnp.asarray(ocr), interpret=True)
    gr, ga, gb = overlap_matrices_plain(torch.from_numpy(icons), torch.from_numpy(ocr))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(a))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(b))
    assert ga.any() and gb.any()
    # ratio: same float32 formula, division rounding may differ in the last bit
    np.testing.assert_allclose(gr.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    before = dict(hopper_kernels.launch_counts)
    wr, wa, wb = overlap_matrices(torch.from_numpy(icons), torch.from_numpy(ocr))
    assert torch.equal(wa, ga) and torch.equal(wb, gb) and torch.equal(wr, gr)
    assert hopper_kernels.launch_counts == before


def test_overlap_matrices_plain_zero_area(rng):
    icons = np.array([[0.1, 0.1, 0.1, 0.5], [0.2, 0.2, 0.4, 0.4]], np.float32)
    ocr = np.array([[0.25, 0.25, 0.3, 0.3], [0.3, 0.3, 0.3, 0.35]], np.float32)
    r, a, b = pallas_overlap_matrices(jnp.asarray(icons), jnp.asarray(ocr), interpret=True)
    gr, ga, gb = overlap_matrices_plain(torch.from_numpy(icons), torch.from_numpy(ocr))
    assert np.isfinite(gr.numpy()).all()
    assert not ga.numpy()[0].any()  # a zero-area icon contains nothing
    np.testing.assert_array_equal(ga.numpy(), np.asarray(a))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(b))
    np.testing.assert_allclose(gr.numpy(), np.asarray(r), rtol=0, atol=1e-6)


_CROP_CASES = {
    "random": (100, 150, 128, 256, 32, [[0.1, 0.1, 0.5, 0.6], [0.0, 0.0, 0.3, 0.2],
                                        [0.55, 0.3, 0.95, 0.9], [0.2, 0.7, 0.9, 0.99]]),
    "edges": (64, 80, 64, 128, 16, [[0.0, 0.0, 1.0, 1.0], [0.9, 0.9, 1.0, 1.0],
                                    [0.0, 0.5, 0.05, 0.55]]),
    "upscale_small": (100, 100, 128, 128, 32, [[0.50, 0.50, 0.53, 0.53]]),
    "degenerate": (100, 100, 128, 128, 32, [[0.3, 0.3, 0.3, 0.3], [0.999, 0.999, 1.0, 1.0]]),
}


@pytest.mark.parametrize("case", sorted(_CROP_CASES))
def test_crop_resize_plain_matches_pallas_and_xla(rng, case):
    h, w, hb, wb, out, boxes = _CROP_CASES[case]
    boxes = np.asarray(boxes, np.float32)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    padded, _ = pad_to_bucket(img, hb, wb)
    hw = jnp.asarray([h, w], jnp.int32)
    want_xla = np.asarray(crop_resize_batch(jnp.asarray(padded), hw, jnp.asarray(boxes), out))
    got = crop_resize_plain(torch.from_numpy(padded), (h, w), torch.from_numpy(boxes), out)
    # same float32 sampling; the bound of tests/test_pallas_crop.py
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=1e-4, atol=1e-2)
    if case != "degenerate":  # the Pallas kernel's fixtures have positive extent
        want_pl = np.asarray(pallas_crop_resize(jnp.asarray(padded), hw, jnp.asarray(boxes),
                                                out, interpret=True))
        np.testing.assert_allclose(got.numpy(), want_pl, rtol=1e-4, atol=1e-2)
    before = dict(hopper_crop.launch_counts)
    got2 = crop_resize(torch.from_numpy(padded), (h, w), torch.from_numpy(boxes), out)
    assert torch.equal(got2, got)
    assert hopper_crop.launch_counts == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    boxes = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        nms_keep(boxes, torch.ones(4, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError):
        nms_keep(torch.zeros((4, 4)), torch.ones(4, dtype=torch.int32), 0.5)
    with pytest.raises(ValueError):
        overlap_matrices(torch.zeros((4, 4)).t(), torch.zeros((2, 4)))
    with pytest.raises(ValueError):
        crop_resize(torch.zeros((8, 8, 3)), (8, 8), torch.zeros((1, 4)), 4)
    with pytest.raises(ValueError):
        crop_resize(torch.zeros((8, 8, 3), dtype=torch.uint8), (8, 8), torch.zeros((1, 4)), 4,
                    grid="nearest")
