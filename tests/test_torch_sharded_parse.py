"""The port's batched parse over a device mesh (``parallel/sharded_parse.py``)
against the JAX package's ``ShardedParse`` and against its own
``parse_image``, on the CPU in float32 at tiny widths; and the ``--mesh``
server route.

Both packages get the same weights: the port's seeded networks, carried
to the JAX package through ``weights/convert.unconvert_state``.  The
detector's class convolutions are scaled up so that its scores spread
over (0, 1): the float32 noise between the two frameworks then cannot
swap two neighbours in the NMS order.
"""

import dataclasses
import http.server
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu import config as jcfg
from omniparser_tpu.models import florence2 as jflo
from omniparser_tpu.models import yolov8 as jyolo
from omniparser_tpu.parallel.mesh import make_mesh as jax_make_mesh
from omniparser_tpu.parallel.sharded_parse import ShardedParse as JaxShardedParse
from omniparser_tpu.pipeline import SOMPipeline as JaxPipeline
from omniparser_tpu_torch import config as tcfg
from omniparser_tpu_torch.models import florence2 as tflo
from omniparser_tpu_torch.models.yolov8 import YOLOv8
from omniparser_tpu_torch.parallel.mesh import make_mesh
from omniparser_tpu_torch.parallel.sharded_parse import ShardedParse, ShardedServingPipeline
from omniparser_tpu_torch.pipeline import SOMPipeline
from omniparser_tpu_torch.weights import convert
from omniparser_tpu_torch.weights.init import build_module

torch.set_num_threads(2)

# tests/test_sharded_parse.py's tiny pipeline, with a vocabulary that holds
# the fallback tokenizer's prompt ids (ROADMAP C.4)
TINY = dict(embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8), num_groups=(1, 2, 4, 8),
            depths=(1, 1, 1, 1), window_size=4, d_model=32, encoder_layers=2,
            decoder_layers=2, attn_heads=4, ffn_dim=64, vocab_size=160, max_positions=64)
WIDTHS = dict(detector=dict(default_imgsz=128, max_detections=16, box_threshold=0.3),
              captioner=dict(batch_size=8, crop_size=32, max_new_tokens=4))


class F32Detector(jyolo.Detector):
    """The JAX detector with a float32 module (its own builds bfloat16)."""

    @property
    def module(self):
        return jyolo.YOLOv8(variant=self.variant, num_classes=self.num_classes,
                            dtype=jnp.float32)


def _nest(flat):
    out = {}
    for path, arr in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return out


def seeded_states(seed=0):
    """The port's seeded detector (class convolutions x20) and tiny
    Florence-2 (a wide token table, so that captions differ between
    crops)."""
    det = build_module(YOLOv8("n", 1), None, torch.Generator().manual_seed(seed),
                       torch.float32, "cpu")
    cap = build_module(tflo.Florence2(tflo.FlorenceDims(**TINY)), None,
                       torch.Generator().manual_seed(seed + 1), torch.float32, "cpu")
    with torch.no_grad():
        for i in range(3):
            getattr(det.head, f"cls{i}_2").weight.mul_(20.0)
        cap.language_model.shared.weight.normal_(
            0, 1.0, generator=torch.Generator().manual_seed(seed + 11))
    return det, cap


def tiny_pair(split_decode=True, seed=0):
    """(JAX SOMPipeline, port SOMPipeline) at the tiny widths, null OCR,
    float32, the same weights."""
    det, cap = seeded_states(seed)
    jc = jcfg.PipelineConfig(
        detector=jcfg.DetectorConfig(**WIDTHS["detector"]),
        captioner=jcfg.CaptionerConfig(split_decode=split_decode, **WIDTHS["captioner"]),
        ocr=jcfg.OcrConfig(backend="null"), detector_weights=None)
    jdet = F32Detector(imgsz=128, max_det=16, prefilter=jc.detector.prefilter_topk)
    jd = jflo.FlorenceDims(**TINY)
    jcap = jflo.FlorenceCaptioner(jc.captioner, dims=jd,
                                  params=_nest(convert.unconvert_state(cap.state_dict(), cap)))
    jcap.model = jflo.Florence2(dims=jd, dtype=jnp.float32)
    jp = JaxPipeline(jc, detector=jdet, captioner=jcap,
                     detector_params=_nest(convert.unconvert_state(det.state_dict(), det)))
    tc = tcfg.PipelineConfig(
        detector=tcfg.DetectorConfig(dtype="float32", **WIDTHS["detector"]),
        captioner=tcfg.CaptionerConfig(dtype="float32", split_decode=split_decode,
                                       **WIDTHS["captioner"]),
        ocr=tcfg.OcrConfig(backend="null"), detector_weights=None)
    tp = SOMPipeline(tc, device="cpu", det_module=det, captioner_state=cap.state_dict(),
                     captioner_dims=tflo.FlorenceDims(**TINY))
    return jp, tp


def same_elements(got, want, atol=1e-5):
    """Boxes within atol (normalised units); every other field exact."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["type"], a["source"], a["interactivity"], a["content"]) == \
               (b["type"], b["source"], b["interactivity"], b["content"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=atol)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def _images(rng, n, h=100, w=120):
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def test_sharded_parse_matches_jax_and_parse_image(pair, rng):
    """(2, 1): the port's ShardedParse against the JAX package's on the same
    tiny pipeline (boxes to 1e-5, every other field exact), and against the
    port's own parse_image of each image."""
    jp, tp = pair
    images = _images(rng, 4)
    want = JaxShardedParse(jp, jax_make_mesh(jax.devices()[:2], dp=2, tp=1)).parse_images(images)
    got = ShardedParse(tp, make_mesh(["cpu"] * 2, dp=2)).parse_images(images)
    assert len(got) == len(want) == 4
    captions = []
    for img, (_, t_labels, t_el), (_, j_labels, j_el) in zip(images, got, want):
        same_elements(t_el, j_el)
        assert set(t_labels) == set(j_labels)
        _, _, single = tp.parse_image(img)
        same_elements(t_el, single)
        captions += [e["content"] for e in t_el if e["source"] == "box_yolo_content_yolo"]
    assert len(captions) >= 8 and len(set(captions)) >= 2


def test_sharded_parse_pads_to_dp_and_warns(pair, rng):
    """Three images over dp = 2 (padded to four inside, three results), with
    tp = 2 splitting the captioner; every image as its parse_image gives it.
    Then the no-silent-caps warning on the mesh route, and the refusal of a
    host OCR backend."""
    _, tp = pair
    images = _images(rng, 3)
    got = ShardedParse(tp, make_mesh(["cpu"] * 4, dp=2, tp=2)).parse_images(images)
    assert len(got) == 3
    for img, (ann, _, el) in zip(images, got):
        ann_s, _, single = tp.parse_image(img)
        same_elements(el, single)
        assert ann.shape == ann_s.shape == img.shape
    cfg = tp.config
    small = SOMPipeline(dataclasses.replace(cfg, detector=dataclasses.replace(
        cfg.detector, max_detections=8, prefilter_topk=16, box_threshold=0.05)),
        device="cpu", det_module=tp.det_module, captioner=tp.captioner)
    with pytest.warns(RuntimeWarning, match="prefilter overflow"):
        ShardedParse(small, make_mesh(["cpu"] * 2, dp=2)).parse_images(images[:2])

    class HostOCR:
        def recognize(self, image_rgb, padded=None, hw=None):
            return ["x"], [[0, 0, 4, 4]]

    host = SOMPipeline(cfg, device="cpu", det_module=tp.det_module, captioner=tp.captioner,
                       ocr=HostOCR())
    with pytest.raises(ValueError, match="device OCR backend"):
        ShardedParse(host, make_mesh(["cpu"] * 2, dp=2))


@pytest.mark.parametrize("fused", [True, False])
def test_sharded_parse_with_ocr_matches_parse_image(pair, rng, fused):
    """The OCR stages on the mesh: device candidates (fused) or host ones
    (components on the host, one slot bucket for the batch), the recogniser
    batched over both images of a row; equal to parse_image of each."""
    _, tp = pair
    cfg = dataclasses.replace(tp.config, ocr=tcfg.OcrConfig(
        det_imgsz=128, max_text_boxes=64, rec_max_width=128, dtype="float32",
        text_threshold=0.0, fused_candidates=fused))
    p = SOMPipeline(dataclasses.replace(cfg, ocr_weights=None), device="cpu",
                    det_module=tp.det_module, captioner=tp.captioner)
    images = _images(rng, 2, 96, 128)
    got = ShardedParse(p, make_mesh(["cpu"] * 2, dp=1, tp=2)).parse_images(images)
    n_text = 0
    for img, (_, _, el) in zip(images, got):
        _, _, single = p.parse_image(img)
        same_elements(el, single)
        n_text += sum(e["type"] == "text" for e in el)
    assert n_text >= 1, "the OCR stages found no text to compare"


def test_mesh_server_matches_direct_sharded_parses(pair, rng):
    """The --mesh serving route: HTTP -> batcher -> ShardedServingPipeline
    at (4, 2) over eight CPU entries, eight concurrent requests, each answer
    equal to the direct sharded parse of its image (JAX
    tests/test_serving.py's mesh test)."""
    import json
    import urllib.request

    from omniparser_tpu_torch.config import ServerConfig
    from omniparser_tpu_torch.serving import OmniparserServer
    from omniparser_tpu_torch.utils.image import encode_image_base64

    _, tp = pair
    served = ShardedServingPipeline(tp, make_mesh(["cpu"] * 8, dp=4, tp=2))
    served.warmup(shapes=((100, 120),))
    images = _images(rng, 8)
    expected = [e for _, _, e in served.parse_batch(images)]
    srv = OmniparserServer(tp.config, ServerConfig(port=0, max_batch=8), pipeline=served)
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler())
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    results = [None] * 8

    def post(i):
        body = json.dumps({"base64_image": encode_image_base64(images[i])}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/parse/", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            results[i] = json.loads(r.read())["parsed_content_list"]

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        httpd.shutdown()
        srv.batcher.close()
    for want, got in zip(expected, results):
        assert got is not None, "a POST failed"
        same_elements(got, want, atol=1e-4)
