"""The port's span and counter recorder (``utils/profiling.recorder``) and
the spans the pipeline, the serving batcher and BLIP-2's beam decode put in
it, on the CPU at tiny dims: off it costs nothing, on it never synchronises,
and each parse's spans and counters land in the pipeline's ``last_trace``."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from omniparser_tpu_torch.config import CaptionerConfig, DetectorConfig, OcrConfig, PipelineConfig
from omniparser_tpu_torch.models.florence2 import FlorenceCaptioner, FlorenceDims
from omniparser_tpu_torch.pipeline import SOMPipeline
from omniparser_tpu_torch.serving import MicroBatcher
from omniparser_tpu_torch.utils import profiling
from omniparser_tpu_torch.utils.profiling import device_trace, recorder

torch.set_num_threads(2)

TINY = FlorenceDims(embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8),
                    num_groups=(1, 2, 4, 8), depths=(1, 1, 1, 1), window_size=4,
                    d_model=32, encoder_layers=1, decoder_layers=2, attn_heads=4,
                    ffn_dim=64, vocab_size=160, max_positions=64)
# K = 2 caption slots a screenshot, so that the tiny screens' icons overflow it
CFG = PipelineConfig(
    detector=DetectorConfig(default_imgsz=128, max_detections=16, box_threshold=0.01,
                            dtype="float32"),
    captioner=CaptionerConfig(batch_size=2, crop_size=32, max_new_tokens=4, dtype="float32"),
    ocr=OcrConfig(det_imgsz=128, max_text_boxes=32, rec_max_width=64, dtype="float32"),
    detector_weights=None, ocr_weights=None)
DISPATCH = ("upload", "ocr_detect", "fused_step")
FINISH = ("download", "caption.dispatch", "assemble", "overlay")


@pytest.fixture(autouse=True)
def recorder_off():
    recorder.disable()
    yield
    recorder.disable()


@pytest.fixture(scope="module")
def pipe():
    cap = FlorenceCaptioner(CFG.captioner, TINY, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    return SOMPipeline(CFG, device="cpu", captioner=cap)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (100, 120, 3), dtype=np.uint8) for _ in range(2)]


class _Calls:
    def __init__(self, real=None):
        self.n, self.real = 0, real

    def __call__(self, *a, **k):
        self.n += 1
        return self.real(*a, **k) if self.real else None


def test_off_a_span_reads_no_clock_and_makes_no_event(monkeypatch):
    clock, event, fn = _Calls(time.perf_counter), _Calls(), _Calls()
    monkeypatch.setattr(profiling.time, "perf_counter", clock)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.profiler, "record_function", fn)
    spans = [recorder.span("fused_step", torch.device("cuda:0"), 0), recorder.span("overlay")]
    assert spans[0] is spans[1]  # one shared null context
    with spans[0]:
        recorder.count("caption.slots", 8)
        recorder.record("batcher.wait", 0.0, 1.0, 0)
    assert (clock.n, event.n, fn.n) == (0, 0, 0)
    assert recorder.take() is None


class _Event:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.at = None

    def record(self, stream):
        self.at = time.perf_counter()

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


def test_on_device_spans_pool_their_events_and_never_synchronise(monkeypatch):
    """A CUDA span's events (stand-ins here) are resolved by take, without a
    synchronise, and go back to the pool for the next span."""
    sync = _Calls()
    stream = type("Stream", (), {"device": torch.device("cuda:0")})()
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.made = 0
    recorder.enable()
    for _ in range(3):
        with recorder.span("caption.boxes", torch.device("cuda:0"), 1):
            time.sleep(0.002)
        trace = recorder.take()
        (span,) = trace.spans
        assert span.name == "caption.boxes" and span.image == 1
        assert 1.5 <= span.device_ms <= (span.t1 - span.t0) * 1e3 + 1e-6
    assert _Event.made == 2 and sync.n == 0


def test_parse_batch_records_every_stage_in_its_phase(pipe, images, monkeypatch):
    sync = _Calls()
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    pipe.parse_batch(images)  # warm
    assert pipe.last_trace is None  # off
    recorder.enable()
    t_before = time.perf_counter()
    got = pipe.parse_batch(images)
    t_after = time.perf_counter()
    trace, lt = pipe.last_trace, pipe.last_timings
    assert sync.n == 0 and trace is recorder.traces[-1]
    names = {s.name for s in trace.spans}
    assert set(DISPATCH + FINISH) | {"caption.batched", "caption.collect", "caption.boxes",
                                     "lap.recognise", "lap.merge"} <= names
    for n in DISPATCH + ("download", "assemble", "overlay"):
        assert sorted(s.image for s in trace.spans if s.name == n) == [0, 1], n
    assert all(t_before <= s.t0 <= s.t1 <= t_after for s in trace.spans)
    # the dispatch phase's spans end before the finish phase's begin, and
    # each phase's spans fit in its duration from last_timings
    dispatch = [s for s in trace.spans if s.name in DISPATCH]
    finish = [s for s in trace.spans if s.name in FINISH]
    assert max(s.t1 for s in dispatch) <= min(s.t0 for s in finish)
    assert max(s.t1 for s in dispatch) - min(s.t0 for s in dispatch) <= lt["dispatch"]
    assert max(s.t1 for s in finish) - min(s.t0 for s in finish) <= lt["finish"]
    # counters from host values: captions served by the batched decode (the
    # first K an image) and the overflow past K, over padded slots
    c = trace.counts
    captioned = sum(e["source"] == "box_yolo_content_yolo" for _, _, el in got for e in el)
    assert c["caption.served"] == c["caption.needed"] == captioned
    assert c["caption.slots"] >= c["caption.served"] and "ocr.lines" in c
    assert not any(k.startswith("launches.") for k in c)  # plain versions on the CPU


def test_stage_ms_turns_the_recorder_on_and_keeps_its_laps(pipe, images):
    pipe.stage_ms = {}
    try:
        assert recorder.on
        _, _, elements = pipe.parse_image(images[0])
        laps = {s.name[4:] for s in pipe.last_trace.spans if s.name.startswith("lap.")}
        assert {"candidates", "detect_nms", "recognise", "merge", "caption_crops",
                "ocr_detect", "decode"} <= set(pipe.stage_ms) == laps
        c = pipe.last_trace.counts
        assert c["ocr.lines"] == pipe.last_counts["ocr_candidates"]
        assert c["caption.needed"] == sum(e["source"] == "box_yolo_content_yolo"
                                          for e in elements)
    finally:
        pipe.stage_ms = None
    assert not recorder.on


def test_batcher_wait_is_one_span_per_item():
    recorder.enable()
    traces = []

    def process(items):
        traces.append(recorder.take())
        return items

    mb = MicroBatcher(process, max_batch=4, batch_window_ms=100)
    futs = [mb.submit(i) for i in range(3)]
    assert [f.result(timeout=10) for f in futs] == [0, 1, 2]
    mb.close()
    waits = [s for t in traces for s in t.spans if s.name == "batcher.wait"]
    assert len(waits) == 3 and all(s.t1 >= s.t0 for s in waits)
    assert sum(t.counts["batcher.batch_size"] for t in traces) == 3
    assert sorted(s.image for s in waits) == sorted(
        i for t in traces for i in range(int(t.counts["batcher.batch_size"])))


def test_blip2_decode_spans_and_cache_bytes(images):
    """BLIP-2's decode moves no cache (no ``beam.reorder_bytes``), counts
    its steps and the key/value bytes its attention reads: the prefix once
    a crop and each beam's own positions 0..s, a layer a step."""
    from omniparser_tpu_torch.models.blip2 import TINY_BLIP2

    dims = dataclasses.replace(TINY_BLIP2, vocab_size=160, eos_token_id=159)
    cfg = dataclasses.replace(CFG, captioner=dataclasses.replace(
        CFG.captioner, backend="blip2", batch_size=4), captioner_weights=None)
    p = SOMPipeline(cfg, device="cpu", captioner_dims=dims)
    recorder.enable()
    p.parse_batch(images[:1])
    trace = p.last_trace
    (boxes,) = [s for s in trace.spans if s.name == "caption.boxes"]
    inner = [s for s in trace.spans if s.name in ("caption.vision", "caption.beam")]
    assert [s.name for s in inner] == ["caption.vision", "caption.beam"]
    assert all(boxes.t0 <= s.t0 <= s.t1 <= boxes.t1 for s in inner)
    c = trace.counts
    assert c["caption.slots"] == 4 > c["caption.served"] > 0  # padded to K crops
    calls = p.captioner.generate_calls
    steps = p.captioner.max_new_tokens - 1
    assert calls == 1 and c["beam.steps"] == calls * steps
    assert "beam.reorder_bytes" not in c
    crops, beams, heads = 4, p.captioner.num_beams, dims.lm_heads
    hd = dims.lm_width // heads
    prefix = dims.num_query_tokens + len(p.captioner.prompt_ids)
    row = heads * hd * 4  # float32: one position of one layer's keys (or values)
    want = sum(2 * row * (crops * prefix + crops * beams * (s + 1))
               for s in range(steps)) * dims.lm_layers * calls
    assert c["beam.attn_bytes"] == want


def test_span_names_reach_the_device_trace(pipe, images, tmp_path):
    recorder.enable()
    with device_trace(str(tmp_path)):
        pipe.parse_batch(images[:1])
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert set(DISPATCH + FINISH) <= names
