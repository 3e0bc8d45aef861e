"""Share of the traced slice of the window in which no kernel ran on the
device: 100 * (1 - union of kernel intervals / slice)."""


def read(run):
    tr = run["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
