"""The port's ``utils/profiling`` (``StageTimer``, ``device_trace``,
``annotate_trace``), as ``tests/test_utils.py`` holds the JAX package's."""

import json
import time

import torch

from omniparser_tpu_torch.utils.profiling import StageTimer, annotate_trace, device_trace


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_s"] >= 0.01
    assert s["b"]["count"] == 1
    t.reset()
    assert t.summary() == {}


def test_annotate_trace_noop():
    with annotate_trace("x"):
        pass


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """The annotated region and the operator inside it land in the trace
    (on the CPU: host events only); disabled, nothing is written."""
    with device_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    with device_trace(str(tmp_path / "on")):
        with annotate_trace("stage_x"):
            torch.ones(8).add_(1)
    events = json.loads((tmp_path / "on" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "stage_x" in names and any("add" in str(n) for n in names)
