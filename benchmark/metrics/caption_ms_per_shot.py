"""Device time between CUDA events recorded around every call of the
captioner's generate (the batched decode and the per-image overflow, or
the beam decode), per screenshot (traced run)."""


def read(run):
    ms = run["caption_ms"]
    return ms / run["shots"] if ms is not None and run["shots"] else None
