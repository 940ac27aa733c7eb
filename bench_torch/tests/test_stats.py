"""Tail and rate arithmetic over all the work of a window."""

import math

from bench_torch import stats


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(list(range(1, 21)), 95) == 19


def test_missing_requests_sit_in_the_tail():
    due = [0.0] * 20
    done = [0.1] * 18 + [None, None]
    lat = stats.open_loop_latencies(due, done, missing_at=61.0)
    assert stats.percentile(lat, 95) == 61.0
    assert stats.percentile(lat, 50) == 0.1


def test_open_loop_counts_the_wait_a_stall_imposes():
    # a 1 s stall at t = 1: every request due during it finishes after it
    due = [0.5, 1.0, 1.2, 1.4, 2.5]
    done = [0.6, 2.05, 2.1, 2.15, 2.6]
    lat = stats.open_loop_latencies(due, done, missing_at=10.0)
    assert math.isclose(max(lat), 1.05)
    assert math.isclose(lat[3], 0.75)

