"""Shared arithmetic of the per-layer metric readers
(bench_torch/metrics/<metric>.py).  Each returns None where the run has
nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

from typing import Optional

from bench_torch import work


def idle_share(run) -> Optional[float]:
    """The share of the traced stretch, host start to host end, in which
    no kernel, copy or set ran on the device, in %."""
    t = run.traced
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(run) -> Optional[float]:
    """Model FLOPs the window's completed inputs need over what the
    chips' dense peak could do in the window, in %."""
    flops = run.work.get("flops")
    if not flops or not run.window_s:
        return None
    return 100.0 * flops / (run.window_s * run.chips * run.work["peak"])


def span_mean_ms(run, name: str) -> Optional[float]:
    rows = run.spans.get(name)
    if not rows:
        return None
    return 1e3 * sum(r[0] for r in rows) / len(rows)


def ms_per_step(run, name: str) -> Optional[float]:
    """Total wall ms of the spans over the decoder steps they ran."""
    rows = run.spans.get(name)
    if not rows:
        return None
    steps = sum(r[1] for r in rows)
    return 1e3 * sum(r[0] for r in rows) / steps if steps else None


def frontend_roofline(run) -> Optional[float]:
    """The frontend kernels' least time over their traced device time, in
    %: least time from work.frontend_least_s of each call the traced
    stretch held (the driver records their shapes as 'frontend.traced')."""
    t = run.traced
    calls = run.spans.get("frontend.traced")
    if t is None or not calls:
        return None
    kernel_s = sum(t["kernel_s"].values())
    if kernel_s <= 0:
        return None
    least = sum(work.frontend_least_s(run.values, B, S, T)
                for B, S, T in calls)
    return 100.0 * least / kernel_s
