"""Host wall of parse_batch's finish phase (downloads, element assembly,
the SOM overlay), summed over the window, per screenshot."""


def read(run):
    if not run["shots"]:
        return None
    return 1e3 * sum(b.get("finish", 0.0) for b in run["batches"]) / run["shots"]
