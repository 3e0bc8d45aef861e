"""Host wall of parse_batch's dispatch phase (uploads, OCR detector and
fused steps queued and run), summed over the window, per screenshot."""


def read(run):
    if not run["shots"]:
        return None
    return 1e3 * sum(b.get("dispatch", 0.0) for b in run["batches"]) / run["shots"]
