"""Shared by the span readers: the traces that the program's own span and
counter recorder (``omniparser_tpu_torch.utils.profiling.recorder``, on in
a traced run) took of the parse calls inside the run's batches, those that
ended before the traced slice.  A program without that recorder gives
nothing to read, and each reader then returns None."""


def traces(run):
    from omniparser_tpu_torch.utils import profiling

    rec = getattr(profiling, "recorder", None)
    batches = run["batches"]
    if rec is None or not batches:
        return []
    t0, t1 = batches[0]["t0"], batches[-1]["t1"]
    return [t for t in rec.traces if t0 <= t.t1 <= t1]


def spans(run, name):
    return [s for t in traces(run) for s in t.spans if s.name == name]


def host_ms_per_shot(run, name):
    """Host wall of every span `name`, per screenshot."""
    got = spans(run, name)
    if not got or not run["shots"]:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in got) / run["shots"]


def device_ms_per_shot(run, name):
    """Device milliseconds between the CUDA events of every span `name`,
    per screenshot: 0 where the traces hold device times but no such span
    (the path did not run), None where they hold no device time at all."""
    ts = traces(run)
    if not run["shots"] or not any(s.device_ms is not None for t in ts for s in t.spans):
        return None
    return sum(s.device_ms or 0.0 for t in ts for s in t.spans if s.name == name) / run["shots"]


def count(run, name):
    ts = traces(run)
    return sum(t.counts.get(name, 0) for t in ts) if ts else None
