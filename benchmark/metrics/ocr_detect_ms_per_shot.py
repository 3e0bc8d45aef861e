"""The text detector's letterbox, network and components, timed by the
harness between two synchronisations around each dispatch, per screenshot
(traced run)."""


def read(run):
    ms = run["stage_ms"].get("ocr_detect")
    return ms / run["shots"] if ms is not None and run["shots"] else None
