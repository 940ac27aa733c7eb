"""Tails and rates over all the work of a window."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile: the smallest value with at least p % of
    the values at or below it, over every value given."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    return v[max(math.ceil(p / 100.0 * len(v)), 1) - 1]


def open_loop_latencies(due: Sequence[float], done: Sequence[float],
                        missing_at: float) -> list:
    """Each request's latency from the time it was due; a request that
    never completed (done None) or failed counts as done at
    `missing_at`, the end of the wait, so it lies in the tail."""
    return [(d if d is not None else missing_at) - s
            for s, d in zip(due, done)]

