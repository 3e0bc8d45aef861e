"""The arithmetic of the end-to-end numbers: nearest-rank percentiles, a
rate over the whole window, and the spread of a set of runs."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value with at least
    q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    k = max(math.ceil(q / 100.0 * len(xs)), 1)
    return xs[k - 1]


def rate(count: int, window_s: float) -> float:
    """Work completed over the whole window, per second."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return count / window_s


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of the
    median (statistics.quantiles' default method)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
