"""The port's ``utils/profiling`` trace helpers (``device_trace``,
``annotate_trace``), as ``tests/test_utils.py`` holds the JAX package's; its
span recorder is ``tests/test_torch_tracing.py``'s."""

import json

import torch

from omniparser_tpu_torch.utils.profiling import annotate_trace, device_trace


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
