"""The port's serving layer (``omniparser_tpu_torch/serving/``): the same REST
contract and micro-batcher semantics as ``tests/test_serving.py`` holds for
the JAX package, with a stand-in pipeline, and once over the real port
pipeline on the CPU at tiny dims.  Also the kernels' build lock, which the
server's threads rely on."""

import concurrent.futures
import http.server
import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from omniparser_tpu_torch.config import (
    CaptionerConfig, DetectorConfig, OcrConfig, PipelineConfig, ServerConfig)
from omniparser_tpu_torch.serving import MicroBatcher, OmniparserServer
from omniparser_tpu_torch.utils.image import encode_image_base64
from omniparser_tpu_torch.utils.profiling import recorder

torch.set_num_threads(2)


class FakePipeline:
    """Stands in for SOMPipeline: echoes the image size as one element."""

    last_timings = {}
    last_trace = None

    def parse_image(self, image_rgb):
        h, w = image_rgb.shape[:2]
        if (h, w) == (13, 13):
            raise RuntimeError("the pipeline broke")
        elem = {"type": "icon", "bbox": [0, 0, 1, 1], "interactivity": True,
                "content": f"{w}x{h}", "source": "box_yolo_content_yolo"}
        return image_rgb, {"0": [0, 0, 1, 1]}, [elem]

    def parse_batch(self, images):
        out = [self.parse_image(i) for i in images]
        self.last_trace = recorder.take()
        return out


def _serve(srv):
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


@pytest.fixture()
def server():
    srv = OmniparserServer(PipelineConfig(), ServerConfig(port=0), pipeline=FakePipeline())
    httpd, port = _serve(srv)
    yield srv, port
    httpd.shutdown()
    srv.batcher.close()


def _req(port, path, payload=None, raw=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"})
    r = urllib.request.urlopen(req, timeout=30)
    body = r.read()
    return r.status, (json.loads(body) if r.headers["Content-Type"] == "application/json"
                      else body.decode())


def _status(port, path, payload=None, raw=None):
    try:
        return _req(port, path, payload, raw)[0]
    except urllib.error.HTTPError as e:
        return e.code


# ------------------------------ the contract ------------------------------ #


def test_probe_and_demo(server):
    _, port = server
    status, body = _req(port, "/probe/")
    assert status == 200 and body == {"message": "Omniparser API ready"}
    for path in ("/", "/demo"):
        status, page = _req(port, path)
        assert status == 200 and "<h2>omniparser_tpu_torch demo</h2>" in page


def test_parse_contract(server, rng):
    _, port = server
    img = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
    status, body = _req(port, "/parse/", {"base64_image": encode_image_base64(img)})
    assert status == 200
    assert set(body) == {"som_image_base64", "parsed_content_list", "latency"}
    assert body["parsed_content_list"][0]["content"] == "48x32"
    assert isinstance(body["latency"], float)


def test_errors_400_404_500(server):
    _, port = server
    assert _status(port, "/parse/", {"wrong_key": "x"}) == 400
    assert _status(port, "/parse/", raw=b"not json") == 400
    assert _status(port, "/parse/", raw=b"[1, 2]") == 400
    assert _status(port, "/parse/", {"base64_image": "aGVsbG8="}) == 400  # not an image
    assert _status(port, "/nope") == 404
    assert _status(port, "/nope", {"base64_image": ""}) == 404
    broken = encode_image_base64(np.zeros((13, 13, 3), np.uint8))
    assert _status(port, "/parse/", {"base64_image": broken}) == 500


def test_metrics_endpoint(server, rng):
    _, port = server
    img = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
    _req(port, "/parse/", {"base64_image": encode_image_base64(img)})
    status, snap = _req(port, "/metrics/")
    assert status == 200
    assert snap["counters"]['responses_total{code="200"}'] >= 1
    hist = snap["histograms"]["parse_latency_seconds"]
    assert hist["count"] == 1 and hist["sum"] > 0
    assert snap["histograms"]["parse_batch_size"]["count"] == 1
    assert set(snap["histograms"]["parse_batch_size"]["buckets"]) == {
        "1", "2", "4", "8", "16", "32"}  # screenshots
    assert not any(n.startswith("span_") for n in snap["histograms"])
    status, text = _req(port, "/metrics?format=prometheus")
    assert status == 200
    assert "# TYPE parse_latency_seconds histogram" in text
    assert 'parse_latency_seconds_bucket{le="+Inf"} 1' in text
    assert 'parse_batch_size_bucket{le="1"} 1' in text
    # with --trace: the recorder's spans and counters of each batch
    recorder.disable()  # drops anything an earlier test left pending
    srv = OmniparserServer(PipelineConfig(), ServerConfig(port=0), pipeline=FakePipeline(),
                           trace=True)
    httpd, port = _serve(srv)
    try:
        _req(port, "/parse/", {"base64_image": encode_image_base64(img)})
        _, snap = _req(port, "/metrics/")
    finally:
        httpd.shutdown()
        srv.shutdown()
    assert snap["histograms"]["span_batcher_wait_seconds"]["count"] == 1
    assert snap["counters"]["batcher_batch_size_total"] == 1
    assert not recorder.on


def test_structured_logging(monkeypatch):
    from omniparser_tpu_torch.utils.metrics import jlog

    monkeypatch.setenv("OMNIPARSER_LOG", "json")
    buf = io.StringIO()
    jlog("parse", _stream=buf, latency_s=0.12, elements=7)
    rec = json.loads(buf.getvalue())
    assert rec["event"] == "parse" and rec["elements"] == 7 and "ts" in rec
    monkeypatch.delenv("OMNIPARSER_LOG")
    buf2 = io.StringIO()
    jlog("parse", _stream=buf2)
    assert buf2.getvalue() == ""  # off by default


def test_concurrent_clients_no_cross_talk(server, rng):
    """24 concurrent clients with distinct images: every response carries
    its own request's payload."""
    _, port = server

    def one(i):
        w, h = 32 + i, 24 + i
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        code, payload = _req(port, "/parse/", {"base64_image": encode_image_base64(img)})
        assert code == 200
        return i, payload["parsed_content_list"][0]["content"], f"{w}x{h}"

    with concurrent.futures.ThreadPoolExecutor(max_workers=12) as ex:
        for i, got, want in ex.map(one, range(24)):
            assert got == want, f"request {i}: got {got}, want {want}"


# ------------------------------ the batcher ------------------------------- #


def test_microbatcher_groups_requests():
    batches = []

    def process(items):
        batches.append(list(items))
        return [i * 2 for i in items]

    mb = MicroBatcher(process, max_batch=4, batch_window_ms=50)
    futs = [mb.submit(i) for i in range(4)]
    assert [f.result(timeout=5) for f in futs] == [0, 2, 4, 6]
    mb.close()
    assert any(len(b) > 1 for b in batches), f"no batching happened: {batches}"


def test_microbatcher_propagates_errors_to_every_caller():
    release = threading.Event()

    def process(items):
        release.wait(5)
        raise RuntimeError("boom")

    mb = MicroBatcher(process, max_batch=4, batch_window_ms=200)
    futs = [mb.submit(i) for i in range(3)]
    release.set()
    for f in futs:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=5)
    mb.close()


def test_microbatcher_result_count_must_match():
    mb = MicroBatcher(lambda items: items[:1], max_batch=2, batch_window_ms=200)
    futs = [mb.submit(i) for i in range(2)]
    for f in futs:
        with pytest.raises(RuntimeError, match="returned 1 results for 2 items"):
            f.result(timeout=5)
    mb.close()


def test_microbatcher_respects_max_batch():
    sizes = []

    def process(items):
        sizes.append(len(items))
        time.sleep(0.02)
        return items

    mb = MicroBatcher(process, max_batch=2, batch_window_ms=100)
    futs = [mb.submit(i) for i in range(6)]
    assert [f.result(timeout=5) for f in futs] == list(range(6))
    mb.close()
    assert max(sizes) <= 2


def test_microbatcher_deadline_is_absolute():
    """Items 60 ms apart with a 100 ms window: a window that restarted at
    each item would take all six; the deadline from the first item closes
    the first batch early."""
    sizes = []

    def process(items):
        sizes.append(len(items))
        return items

    mb = MicroBatcher(process, max_batch=8, batch_window_ms=100)
    futs = []
    for i in range(6):
        futs.append(mb.submit(i))
        time.sleep(0.06)
    assert [f.result(timeout=5) for f in futs] == list(range(6))
    mb.close()
    assert sizes[0] < 6 and sum(sizes) == 6


def test_microbatcher_close_fails_queued_requests():
    started, release = threading.Event(), threading.Event()

    def process(items):
        started.set()
        release.wait(5)
        return items

    mb = MicroBatcher(process, max_batch=1, batch_window_ms=1)
    first = mb.submit(0)
    assert started.wait(5)
    queued = [mb.submit(i) for i in (1, 2)]
    closer = threading.Thread(target=mb.close)
    closer.start()
    while not mb._stop.is_set():
        time.sleep(0.001)
    release.set()
    closer.join(10)
    assert not closer.is_alive() and not mb._thread.is_alive()
    assert first.result(timeout=5) == 0
    for f in queued:
        with pytest.raises(RuntimeError, match="batcher closed"):
            f.result(timeout=5)


# ------------------------- the real port pipeline -------------------------- #


def test_real_port_pipeline_serves_two_requests(rng):
    """The port's SOMPipeline on the CPU at tiny dims behind the server: two
    concurrent requests, each answered with what parse_image gives its image."""
    from omniparser_tpu_torch.models.florence2 import FlorenceCaptioner, FlorenceDims
    from omniparser_tpu_torch.pipeline import SOMPipeline
    from omniparser_tpu_torch.utils.image import decode_base64_image

    tiny = FlorenceDims(embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8),
                        num_groups=(1, 2, 4, 8), depths=(1, 1, 1, 1), window_size=4,
                        d_model=32, encoder_layers=1, decoder_layers=2, attn_heads=4,
                        ffn_dim=64, vocab_size=160, max_positions=64)
    cfg = PipelineConfig(
        detector=DetectorConfig(default_imgsz=128, max_detections=16, box_threshold=0.01,
                                dtype="float32"),
        captioner=CaptionerConfig(batch_size=8, crop_size=32, max_new_tokens=4,
                                  dtype="float32"),
        ocr=OcrConfig(backend="null"), detector_weights=None)
    cap = FlorenceCaptioner(cfg.captioner, tiny, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    pipe = SOMPipeline(cfg, device="cpu", captioner=cap)
    srv = OmniparserServer(cfg, ServerConfig(port=0, batch_window_ms=300, max_batch=8),
                           pipeline=pipe)
    httpd, port = _serve(srv)
    images = [rng.integers(0, 255, (100, 120, 3), dtype=np.uint8),
              rng.integers(0, 255, (90, 150, 3), dtype=np.uint8)]
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
            bodies = list(ex.map(lambda im: _req(port, "/parse/", {
                "base64_image": encode_image_base64(im)}), images))
        _, snap = _req(port, "/metrics")
    finally:
        httpd.shutdown()
        srv.batcher.close()
    for img, (status, body) in zip(images, bodies):
        assert status == 200
        ann, _, elements = pipe.parse_image(img)
        assert elements and body["parsed_content_list"] == elements
        np.testing.assert_array_equal(decode_base64_image(body["som_image_base64"]), ann)
    assert snap["histograms"]["parse_batch_size"]["sum"] == 2
    assert snap["counters"]['responses_total{code="200"}'] == 2


# ---------------------------- the build lock ------------------------------ #


def test_cuda_build_lock_builds_once_for_many_threads(tmp_path, monkeypatch):
    """Sixteen threads (more than this host's cores, with a short switch
    interval) reach cuda_build.load() together: the first builds every
    source once (a stubbed nvcc), the others wait and load its result."""
    from omniparser_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    launched = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            launched.append(cmd[-1])
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            time.sleep(0.2)  # both threads are inside load() by now
            with open(self.out, "w") as f:
                f.write("built")
            return "ok", None

    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: ("lib", path))
    n = 16
    gate = threading.Barrier(n)
    got = []

    def worker():
        gate.wait()
        got.append(cuda_build.load("overlap.cu"))

    threads = [threading.Thread(target=worker) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(launched) == len(cuda_build.SOURCES)  # each source built once
    assert got == [("lib", cuda_build._lib_path("overlap.cu"))] * n
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        os.path.basename(cuda_build._lib_path(n)) for n in cuda_build.SOURCES)
