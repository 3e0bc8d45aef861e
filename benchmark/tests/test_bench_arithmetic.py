"""The yardstick's arithmetic: the same seed gives the same screens, the
rate covers the whole window, percentiles by nearest rank, spreads, and
the analytic work formulas against torch's FlopCounterMode on tiny
reference networks (gaps stated)."""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import manifest as mf
from benchmark.harness import stats
from benchmark.tests.helpers import TINY


def test_same_seed_same_screens_and_the_same_work_for_every_seed():
    gen = mf.load_module("generators", "screens.py")
    params = dict(mf.read_json("traffic", "dense1080-agents16.json"), pool=6)
    a, b = gen.make_pool(params, 2 ** 31 + 99), gen.make_pool(params, 2 ** 31 + 99)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (1080, 1920, 3) and a[0].dtype == np.uint8
    # the screens come from the traffic's content seed: every seed serves them
    c = gen.make_pool(params, 2 ** 33 + 5)
    assert all(np.array_equal(x, y) for x, y in zip(a, c))
    other = dict(params, content_seed=7)
    d = gen.make_pool(other, 2 ** 31 + 99)
    assert not all(np.array_equal(x, y) for x, y in zip(a, d))
    # every content seed draws the same multiset of icon-block counts
    assert sorted(gen.work(params, 1)) == sorted(gen.work(other, 1))
    with pytest.raises(KeyError):
        gen.make_pool({k: v for k, v in params.items() if k != "content_seed"}, 1)


def test_nearest_rank():
    xs = list(range(1, 101))
    assert stats.nearest_rank(xs, 50) == 50 and stats.nearest_rank(xs, 90) == 90
    assert stats.nearest_rank([5.0], 90) == 5.0
    assert stats.nearest_rank([3, 1, 2], 50) == 2
    assert stats.nearest_rank(list(range(10)), 95) == 9


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


class _SlowPipe:
    """parse_batch of a fixed wall per batch; counts what it saw."""

    def __init__(self, per_batch_s):
        self.per_batch_s = per_batch_s
        self.last_timings = {}
        self.stage_ms = None

    def parse_batch(self, images):
        time.sleep(self.per_batch_s)
        return [(None, {}, []) for _ in images]


class _NoRecorder:
    batch = {}

    def begin_batch(self, capture):
        pass


def test_the_rate_covers_every_request_and_the_whole_window():
    from benchmark.harness.loop import Window

    pipe = _SlowPipe(0.05)
    images = [np.zeros((4, 4, 3), np.uint8) for _ in range(3)]
    win = Window(pipe, _NoRecorder(), images, clients=4, orders=[[0, 1, 2]] * 4, sampled={},
                 max_batch=2, batch_window_ms=1.0)
    w = win.run(0.5)
    done = win.requests
    # every request submitted before the deadline completed, inside the window
    assert all(r["error"] is None for r in done)
    assert max(r["end"] for r in done) <= w["t1"] and min(r["submit"] for r in done) >= w["t0"]
    assert max(r["submit"] for r in done) <= w["t0"] + 0.5
    rate = stats.rate(len(done), w["window_s"])
    assert rate == pytest.approx(len(done) / (w["t1"] - w["t0"]))
    assert sum(b["size"] for b in win.batches) == len(done)
    assert threading.active_count() >= 1


def test_the_first_batch_gathers_every_client_released_at_the_start(monkeypatch):
    """Clients are released together at the window's start: with 16 of them
    and batches of 8, the first two batches are full, however slowly the
    host starts a thread (here 2 ms each, well over the batcher's 5 ms for
    the first eight)."""
    from benchmark.harness.loop import Window

    start = threading.Thread.start

    def slow_start(self):
        start(self)
        time.sleep(0.002)

    monkeypatch.setattr(threading.Thread, "start", slow_start)
    pipe = _SlowPipe(0.2)
    images = [np.zeros((4, 4, 3), np.uint8) for _ in range(4)]
    win = Window(pipe, _NoRecorder(), images, clients=16, orders=[[0, 1, 2, 3]] * 16,
                 sampled={}, max_batch=8, batch_window_ms=5.0)
    w = win.run(0.3)
    assert [b["size"] for b in win.batches[:2]] == [8, 8]
    assert min(r["submit"] for r in win.requests) >= w["t0"]


def _count(fn):
    with FlopCounterMode(display=False) as m, torch.no_grad():
        fn()
    return m.get_total_flops()


def _tiny_dims(config):
    with open(TINY) as f:
        return json.load(f)["configs"][config]["captioner_dims"]


def test_detector_formulas_against_the_flop_counter():
    from benchmark.reference.ocr import TextDetector, TextRecognizer
    from benchmark.reference.yolov8 import YOLOv8

    y = mf.load_module("flops", "yolov8.py")
    net = YOLOv8("n", 1).eval()
    anchors = 8 * 8 + 4 * 4 + 2 * 2
    # the formula adds the DFL expectation (anchors x 4 x 16), which the
    # network's forward leaves to the decode
    assert _count(lambda: net(torch.zeros(1, 3, 64, 64))) == 2 * y.macs(64) - 2 * anchors * 64
    t = mf.load_module("flops", "textdet.py")
    assert _count(lambda: TextDetector().eval()(torch.zeros(1, 3, 96, 96))) == 2 * t.macs(96)
    r = mf.load_module("flops", "textrec.py")
    rec = TextRecognizer(seq_len=120).eval()
    assert _count(lambda: rec(torch.zeros(1, 3, 32, 480))) == 2 * r.macs()


def test_florence_formula_against_the_flop_counter():
    from benchmark.reference import florence2 as fl

    raw = dict(dataclasses.asdict(fl.BASE), **_tiny_dims("omniparser-v2-florence2-base"))
    dims = fl.FlorenceDims(**{k: tuple(v) if isinstance(v, list) else v for k, v in raw.items()})
    net = fl.Florence2(dims).eval()
    p, t, hd = 31, 4, dims.d_model // dims.attn_heads

    def caption():
        ckv, mask = net.encode_inputs(torch.zeros(1, 32, 32, 3), torch.full((1, p), 20))
        caches = [(torch.zeros(1, t, dims.attn_heads, hd), torch.zeros(1, t, dims.attn_heads, hd))
                  for _ in range(dims.decoder_layers)]
        for s in range(t):
            net.language_model.decode_step(torch.full((1, 1), 2), s, mask, caches, ckv)

    f = mf.load_module("flops", "florence2.py")
    got, want = _count(caption), 2 * f.macs(raw, 32, p, t)
    # the formula counts 64 multiply-adds more than the counter sees: below
    # a millionth of a full-width caption's
    assert abs(got - want) <= 128


def test_blip2_formula_against_the_flop_counter():
    from benchmark.reference import blip2 as bl

    raw = dict(dataclasses.asdict(bl.BLIP2_OPT_2_7B), **_tiny_dims("omniparser-v1-blip2-opt-2.7b"))
    d = bl.Blip2Dims(**raw)
    net = bl.Blip2(d).eval()
    p, t, k = 16, 4, 5
    length = d.num_query_tokens + p + t

    def caption():
        _, caches, prefix = net.encode_and_prefill(torch.zeros(1, 3, 28, 28),
                                                   torch.full((1, p), 20), length)
        for e in caches:
            for j, c in enumerate(e):
                e[j] = c.repeat_interleave(k, 0)
        for s in range(t - 1):
            net.decode_one(torch.zeros(k, 1, dtype=torch.long), s, prefix, caches)

    f = mf.load_module("flops", "blip2.py")
    got, want = _count(caption), 2 * f.macs(raw, p, t, k)
    # the stated gap: the measured code attends over its whole static cache
    # under a mask; the formula counts the causal attention the tokens need
    prefix, lw, layers = d.num_query_tokens + p, d.lm_width, d.lm_layers
    padded = layers * (2 * prefix * length * lw - prefix * (prefix + 1) * lw)
    padded += k * layers * sum(2 * (length - (prefix + s + 1)) * lw for s in range(1, t))
    assert got - want == 2 * padded


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_components_agree_with_the_measured_ones(seed):
    """The reference's components and line candidates over a map of blobs,
    lines and speckle equal the measured package's device form, slot for
    slot; a map of its own is the reference's only input."""
    from benchmark.reference import components as cc
    from omniparser_tpu_torch.ops.components import (
        candidate_boxes_from_cc,
        device_components,
        quantize_u8_parity,
    )

    g = torch.Generator().manual_seed(seed)
    raw = torch.rand(1, 1, 96, 128, generator=g) * 0.35
    for _ in range(12):
        y, x = (int(v) for v in torch.randint(0, 90, (2,), generator=g))
        hh, ww = (int(v) for v in torch.randint(1, 9, (2,), generator=g))
        raw[0, 0, y:y + hh, x:x + 4 * ww] = 0.3 + 0.7 * torch.rand(1, generator=g)
    raw[0, 0, 40:44, 10:12] = 0.9   # a U shape: two runs joined below
    raw[0, 0, 40:44, 14:16] = 0.9
    raw[0, 0, 44:46, 10:16] = 0.9
    hw, imgsz, m = (270, 480), 192, 32
    prob = quantize_u8_parity(torch.clamp(raw[0, 0].float(), 0.0, 1.0))
    got = device_components(prob, 0.3, 0.3, min_area=4, max_out=1024, pre_cap=1024)
    r = min(imgsz / hw[0], imgsz / hw[1])
    pads = ((imgsz - hw[0] * r) / 2.0, (imgsz - hw[1] * r) / 2.0)
    boxes, valid, _ = candidate_boxes_from_cc(got["boxes"], got["count"], r, pads, hw, m)
    want = cc.components(cc.quantized_map(raw))
    n = int(got["count"])
    assert n == len(want["boxes"]) and n > 3
    assert np.array_equal(got["boxes"][:n].numpy(), want["boxes"])
    assert np.array_equal(got["scores"][:n].numpy(), want["scores"])
    ref_boxes, ref_valid = cc.candidates(want["boxes"], hw, imgsz, m)
    assert np.array_equal(valid.numpy(), ref_valid)
    assert np.array_equal(boxes.numpy(), ref_boxes)
