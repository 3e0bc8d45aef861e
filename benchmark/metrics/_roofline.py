"""Shared by the kernels' roofline readers: the least time the card could
take for the window's calls of one kernel (the larger of operations over
the peak rate and bytes over the memory rate, per call, from the
benchmark's own work formulas), over the kernel's device time.  Both are
means per call: the least time over every call the window made, the device
time over the calls in the traced slice."""


def share(run, kernel: str, rate_key: str):
    calls = run["kernel_work"].get(kernel) or []
    dev = run["trace"]["kernels"].get(kernel) if run["trace"] else None
    if not calls or not dev or dev["count"] == 0 or dev["seconds"] <= 0:
        return None
    peaks = run["peaks"]
    least = sum(max(ops / peaks[rate_key], nbytes / peaks["hbm_bytes"]) for ops, nbytes in calls)
    return 100.0 * (least / len(calls)) / (dev["seconds"] / dev["count"])
