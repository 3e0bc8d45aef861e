"""The reader of `beam_cache_gb_per_step` on known traces: nothing where the
program counts no beam steps (a program whose decode does not count them),
the cache bytes over the steps where it does."""

import pytest

from benchmark.harness import manifest as mf


def _run():
    return {"batches": [{"t0": 10.0, "t1": 12.0}], "shots": 2}


@pytest.fixture
def rec(monkeypatch):
    from omniparser_tpu_torch.utils import profiling
    from omniparser_tpu_torch.utils.profiling import Recorder

    r = Recorder()
    monkeypatch.setattr(profiling, "recorder", r)
    return r


def test_nothing_without_beam_steps(rec):
    from omniparser_tpu_torch.utils.profiling import Trace

    read = mf.metric_reader("beam_cache_gb_per_step")
    assert read(_run()) is None  # no traces at all
    rec.traces.append(Trace(11.0, [], {"beam.reorder_bytes": 6e10, "caption.slots": 8}))
    assert read(_run()) is None  # traces, but no step counted


@pytest.mark.parametrize("counts,want", [
    ({"beam.steps": 4, "beam.attn_bytes": 5e10}, 12.5),
    ({"beam.steps": 4, "beam.reorder_bytes": 2e11, "beam.attn_bytes": 1.2e11}, 80.0),
])
def test_the_bytes_over_the_steps(rec, counts, want):
    from omniparser_tpu_torch.utils.profiling import Trace

    rec.traces.append(Trace(9.0, [], {"beam.steps": 99, "beam.attn_bytes": 1e12}))  # before
    half = {k: v / 2 for k, v in counts.items()}
    rec.traces.append(Trace(10.5, [], half))
    rec.traces.append(Trace(11.5, [], half))
    assert mf.metric_reader("beam_cache_gb_per_step")(_run()) == pytest.approx(want)
