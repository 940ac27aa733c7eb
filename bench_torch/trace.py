"""A short traced stretch of a run and its reduction: device busy time,
device time by operation, idle gaps by what the host was doing, and the
device time of named kernels.

The stretch runs from its host start to its host end (a record_function
range opened right after the profiler starts and closed right before it
stops); the device's kernels, copies and sets are clipped to it."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import torch

SPAN = "bench.trace"
NAME_CHARS = 120       # a kernel's C++ signature cut to this many characters


class Stretch:
    """with Stretch() as s: ...work...; then s.result (a dict)."""

    def __init__(self, kernels: Sequence[str] = ()):
        self.kernels = tuple(kernels)
        self.result: Optional[dict] = None

    def _sync(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def __enter__(self) -> "Stretch":
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        try:        # the host ranges of every thread, where torch offers it
            cfg = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            cfg = None
        self.prof = torch.profiler.profile(activities=acts,
                                           experimental_config=cfg)
        self.prof.start()
        self.span = torch.profiler.record_function(SPAN)
        self.span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._sync()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        if exc[0] is None:
            self.result = reduce(self.prof.events(), self.kernels)


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce(events, kernels: Sequence[str] = (), top: int = 10) -> dict:
    """busy_s and window_s (seconds), device_ops and idle_gaps (the `top`
    largest, [name, seconds]), and kernel_s: device seconds of the
    kernels whose names contain each of `kernels`."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    marks = [e for e in cpu if e.name == SPAN]
    if not marks:
        raise RuntimeError("the trace holds no stretch mark")
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    dev = [e for e in events if _is_device(e)]
    spans = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
             for e in dev]
    merged = _union([(s, e) for s, e in spans if e > s])
    busy = sum(e - s for s, e in merged)
    by_op: Dict[str, float] = {}
    for e in dev:
        by_op[e.name] = by_op.get(e.name, 0.0) + e.time_range.elapsed_us()
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    hosts = sorted((e for e in cpu if e.name != SPAN),
                   key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in hosts]
    by_host: Dict[str, float] = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        name = _host_at((s + e) / 2, hosts, starts)
        by_host[name] = by_host.get(name, 0.0) + (e - s)
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    kernel_s = {k: sum(e.time_range.elapsed_us() for e in dev if k in e.name)
                / 1e6 for k in kernels}
    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n[:NAME_CHARS], v / 1e6] for n, v in ops],
            "idle_gaps": [[n, v / 1e6] for n, v in idle],
            "kernel_s": kernel_s}


def _host_at(t: float, hosts, starts, look: int = 4000) -> str:
    """The innermost host range open at time t, with the outermost
    benchmark span around it ('span > op'), or 'host: no traced range'."""
    i = bisect.bisect_right(starts, t)
    inner, outer = None, None
    for e in reversed(hosts[max(i - look, 0):i]):
        if e.time_range.end >= t:
            d = e.time_range.end - e.time_range.start
            if inner is None or d < inner[0]:
                inner = (d, e.name)
            if e.name.startswith("bench.") and (outer is None or d > outer[0]):
                outer = (d, e.name)
    if inner is None:
        return "host: no traced range"
    if outer is not None and outer[1] != inner[1]:
        return f"{outer[1]} > {inner[1]}"
    return inner[1]
