"""The per-layer metrics read from the program's own spans and counters
(``benchmark/metrics/_spans.py``): a traced rehearsal prints those that a
CPU run can read; on known traces each reader gives its arithmetic; and a
program without the span recorder gives nothing to read."""

import pytest

from benchmark.harness import manifest as mf
from benchmark.tests.helpers import manifest, rehearse

CELLS = [w["name"] for w in manifest()["workloads"]]
SPAN_METRICS = ("overlay_ms_per_shot", "assemble_ms_per_shot", "caption_dispatch_ms_per_shot",
                "caption_overflow_ms_per_shot", "caption_beam_ms_per_shot",
                "caption_slots_per_caption", "ocr_detect_device_ms_per_shot",
                "batcher_wait_ms.p90.hostpaced")
# the others need a device time: read on the card only
ON_THE_CPU = {"overlay_ms_per_shot", "assemble_ms_per_shot", "caption_dispatch_ms_per_shot",
              "caption_slots_per_caption", "batcher_wait_ms.p90.hostpaced"}


def test_traced_rehearsal_reads_the_program_spans():
    rc, line, err = rehearse(CELLS[0], trace=1)
    assert rc == 0, err[-3000:]
    assert ON_THE_CPU <= set(line["metrics"]), sorted(line["metrics"])
    assert line["metrics"]["caption_slots_per_caption"]["value"] >= 1.0
    assert "ocr_detect_device_ms_per_shot" not in line["metrics"]


def _run(shots=4):
    return {"batches": [{"t0": 10.0, "t1": 11.0}, {"t0": 11.0, "t1": 12.0}], "shots": shots}


def test_readers_on_known_traces(monkeypatch):
    from omniparser_tpu_torch.utils import profiling
    from omniparser_tpu_torch.utils.profiling import Recorder, Span, Trace

    rec = Recorder()
    monkeypatch.setattr(profiling, "recorder", rec)
    read = {n: mf.metric_reader(n) for n in SPAN_METRICS}
    assert all(r(_run()) is None for r in read.values())
    waits = [Span("batcher.wait", i, 10.0, 10.0 + 0.001 * (i + 1), None) for i in range(10)]
    rec.traces.append(Trace(9.0, [Span("overlay", 0, 0.0, 1.0, None)], {}))  # before the run
    rec.traces.append(Trace(10.5, waits + [
        Span("overlay", 0, 10.1, 10.102, None), Span("overlay", 1, 10.2, 10.206, None),
        Span("caption.dispatch", None, 10.3, 10.304, None),
        Span("ocr_detect", 0, 10.0, 10.01, 3.0), Span("caption.boxes", 0, 10.4, 10.5, 20.0)],
        {"caption.slots": 16, "caption.served": 10}))
    rec.traces.append(Trace(11.5, [Span("ocr_detect", 0, 11.0, 11.01, 5.0)],
                            {"caption.slots": 8, "caption.served": 2}))
    rec.traces.append(Trace(12.5, [Span("overlay", 0, 12.1, 13.1, None)], {}))  # after the cut
    got = {n: r(_run()) for n, r in read.items()}
    assert got["overlay_ms_per_shot"] == pytest.approx(8.0 / 4)
    assert got["caption_dispatch_ms_per_shot"] == pytest.approx(4.0 / 4)
    assert got["ocr_detect_device_ms_per_shot"] == pytest.approx(8.0 / 4)
    assert got["caption_overflow_ms_per_shot"] == pytest.approx(20.0 / 4)
    assert got["caption_beam_ms_per_shot"] == 0.0  # device times, and no beam span
    assert got["caption_slots_per_caption"] == pytest.approx(24 / 12)
    assert got["batcher_wait_ms.p90.hostpaced"] == pytest.approx(9.0)  # 9th of 10
    assert got["assemble_ms_per_shot"] is None


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    from omniparser_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorder")
    for n in SPAN_METRICS:
        assert mf.metric_reader(n)(_run()) is None
