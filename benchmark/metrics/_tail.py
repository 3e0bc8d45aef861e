"""Shared by the tail readers: the 90th percentile, by nearest rank, of a
per-request span (ms) over the requests that ended before the traced slice:
'latency' is submit -> result, 'queue_wait' submit -> start of the
parse_batch call that carried the request."""

import math

SPANS = {"latency": ("submit", "end"), "queue_wait": ("submit", "start")}


def p90_ms(run, span: str):
    a, b = SPANS[span]
    xs = sorted((r[b] - r[a]) * 1e3 for r in run["requests"])
    if not xs:
        return None
    return xs[max(math.ceil(0.9 * len(xs)), 1) - 1]
