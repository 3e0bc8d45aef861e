"""The port's ``ops`` package names against the JAX package's: the box
conversions and IoU of ``ops/boxes.py``, ``ops/preprocess.pick_bucket``,
the twelve names ``ops/__init__.py`` exports, ``models/ocr``'s host
postprocess (``extract_text_boxes``, ``unclip_component_boxes``) and
``utils/hostops.native_available``; the same numpy inputs go to both."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniparser_tpu import ops as jops
from omniparser_tpu.models import ocr as jocr
from omniparser_tpu.ops import boxes as JB
from omniparser_tpu.ops import preprocess as jpre
from omniparser_tpu.utils import hostops as jhostops
from omniparser_tpu_torch import ops as tops
from omniparser_tpu_torch.models import ocr as tocr
from omniparser_tpu_torch.ops import boxes as TB
from omniparser_tpu_torch.ops import preprocess as tpre
from omniparser_tpu_torch.utils import hostops as thostops
from tests.conftest import random_boxes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONVERSIONS = ("box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_xyxy_to_xywh",
               "box_xywh_to_xyxy", "box_cxcywh_to_xywh")


def _boxes(rng, n):
    """xyxy boxes in pixels with a zero-width, a zero-height and an
    inverted one among them."""
    b = random_boxes(rng, n, scale=640.0)
    b[0, 2] = b[0, 0]
    b[1, 3] = b[1, 1]
    b[2] = b[2, [2, 3, 0, 1]]
    return b


@pytest.mark.parametrize("name", CONVERSIONS)
def test_box_conversion_matches_jax(name, rng):
    b = _boxes(rng, 48).reshape(4, 12, 4)  # leading dims pass through
    got = getattr(TB, name)(torch.from_numpy(b)).numpy()
    want = np.asarray(getattr(JB, name)(jnp.asarray(b)))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_box_conversions_roundtrip(rng):
    """The twin of tests/test_boxes.py's round trips and composition."""
    b = torch.from_numpy(random_boxes(rng, 64))
    np.testing.assert_allclose(TB.box_cxcywh_to_xyxy(TB.box_xyxy_to_cxcywh(b)), b, atol=1e-6)
    np.testing.assert_allclose(TB.box_xywh_to_xyxy(TB.box_xyxy_to_xywh(b)), b, atol=1e-6)
    c = TB.box_xyxy_to_cxcywh(b)
    np.testing.assert_allclose(TB.box_cxcywh_to_xywh(c),
                               TB.box_xyxy_to_xywh(TB.box_cxcywh_to_xyxy(c)), atol=1e-6)


def test_pairwise_iou_matches_jax(rng):
    a, b = _boxes(rng, 20), _boxes(rng, 15)
    b[3] = a[3]  # an identical pair: IoU just under 1 (the +1e-6 union)
    got = TB.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(JB.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (20, 15)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the union epsilon: two zero-area boxes at one point have IoU 0, not nan
    z = torch.zeros((1, 4))
    assert TB.pairwise_iou(z, z).item() == 0.0


def test_pick_bucket_matches_jax():
    for buckets in ((640,), (640, 1280), (1280, 640, 960), (320, 640, 1280, 1920)):
        for h in (1, 319, 320, 321, 639, 640, 641, 1080, 1280, 1440, 1920, 1921, 4000):
            for w in (1, 320, 640, 1000, 1366, 1920, 2560):
                assert tpre.pick_bucket(h, w, buckets) == jpre.pick_bucket(h, w, buckets), \
                    (h, w, buckets)


def test_ops_package_exports_the_jax_names():
    from omniparser_tpu_torch.ops import (  # noqa: F401
        OverlapResult, box_area, box_cxcywh_to_xyxy, box_xywh_to_xyxy,
        box_xyxy_to_cxcywh, box_xyxy_to_xywh, int_box_area, merge_icons_and_ocr,
        nms_fixed_shape, pairwise_intersection, pairwise_iou, pairwise_max_overlap_ratio)

    assert sorted(tops.__all__) == sorted(jops.__all__) and len(tops.__all__) == 12
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name


def test_importing_ops_builds_and_loads_nothing():
    """Importing the package and calling its names on CPU tensors builds
    no library and loads none for the card."""
    code = (
        "import torch\n"
        "from omniparser_tpu_torch import ops\n"
        "from omniparser_tpu_torch.ops import cuda_build, hopper_kernels\n"
        "b = torch.tensor([[0., 0., 1., 1.], [0., 0., .9, .9]])\n"
        "v = torch.ones(2, dtype=torch.bool)\n"
        "ops.nms_fixed_shape(b, torch.tensor([.9, .8]), v, .5, 2)\n"
        "ops.merge_icons_and_ocr(b, v, b, v, .7)\n"
        "print(len(cuda_build._libs), sum(hopper_kernels.launch_counts.values()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "0"]


def test_extract_text_boxes_matches_jax(rng):
    for trial in range(4):
        prob = (rng.random((96, 128)) ** 4).astype(np.float32)
        for _ in range(6):  # text-line blobs of several heights
            y, x = rng.integers(0, 88), rng.integers(0, 100)
            prob[y:y + rng.integers(1, 8), x:x + rng.integers(2, 28)] = rng.uniform(0.2, 1.0)
        assert tocr.extract_text_boxes(prob) == jocr.extract_text_boxes(prob)
        kw = dict(bin_threshold=0.5, min_score=0.1, unclip=1.5, min_area=1, scale=4)
        got = tocr.extract_text_boxes(prob, **kw)
        assert got == jocr.extract_text_boxes(prob, **kw) and got, trial


def test_unclip_component_boxes_matches_jax(rng):
    comps = [((int(x), int(y), int(x + w), int(y + h)), float(s)) for x, y, w, h, s in zip(
        rng.integers(0, 300, 40), rng.integers(0, 300, 40), rng.integers(1, 60, 40),
        rng.integers(1, 20, 40), rng.random(40))]
    for unclip, scale in ((2.0, 2), (1.0, 2), (1.7, 4)):
        assert tocr.unclip_component_boxes(comps, unclip, scale) == \
            jocr.unclip_component_boxes(comps, unclip, scale)


def test_native_available_matches_jax(monkeypatch):
    assert thostops.native_available() is jhostops.native_available() is True

    def broken():
        raise RuntimeError("building native/hostops.cpp failed")

    monkeypatch.setattr(thostops, "load", broken)
    assert thostops.native_available() is False
