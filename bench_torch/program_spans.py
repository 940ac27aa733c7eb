"""The program's own spans over a training run's window, read from its
span ring (automatic_speech_recognition_torch/utils/spans.py) in the
process that ran the cell, once the run is over.

The window's steps are the first N `train.step` records that start at or
after the end of set-up (run.t_start + run.setup_s, on time.perf_counter,
the ring's clock), N being the harness's own count of window steps
(its `loader.next` spans).  A step's children are the records of its thread
that lie inside it.  `window(run)` is None where the program keeps no
ring (a checkout before it), the ring dropped records, or fewer than N
steps are there: the readers then read nothing."""

from __future__ import annotations

from typing import Dict, Optional

# the train step's phases (the five spans the unspanned share leaves out)
PHASES = ("train.featurize", "las.listener", "las.speller",
          "train.backward", "train.optimizer")
COUNTERS = ("las.speller.steps",)


def window(run) -> Optional[Dict]:
    """{'steps': N, 'step_ns': total of the steps, 'ns': {phase: total},
    'calls': {phase: spans}, 'counts': {counter: sum}, 'covered_ns': the
    part of the steps some phase covers}."""
    try:
        from automatic_speech_recognition_torch.utils import spans
    except ImportError:
        return None
    n = len(run.spans.get("loader.next", []))
    if not n or run.setup_s is None:
        return None
    records, dropped = spans.snapshot()
    if dropped:
        return None
    t0 = round((run.t_start + run.setup_s) * 1e9)
    steps = sorted((r for r in records
                    if r.name == "train.step" and r.start_ns >= t0),
                   key=lambda r: r.start_ns)[:n]
    if len(steps) < n:
        return None
    out = {"steps": n, "step_ns": sum(s.end_ns - s.start_ns for s in steps),
           "ns": dict.fromkeys(PHASES, 0), "calls": dict.fromkeys(PHASES, 0),
           "counts": dict.fromkeys(COUNTERS, 0), "covered_ns": 0}
    for step in steps:
        inside = [r for r in records
                  if r.thread == step.thread and r is not step
                  and step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns]
        phases = []
        for r in inside:
            if r.name in PHASES:
                out["ns"][r.name] += r.end_ns - r.start_ns
                out["calls"][r.name] += 1
                phases.append((r.start_ns, r.end_ns))
            elif r.name in COUNTERS:
                out["counts"][r.name] += r.n
        out["covered_ns"] += _union_ns(phases)
    return out


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def phase_ms(run, name: str) -> Optional[float]:
    """Mean ms of a phase's spans a window step; None without any."""
    w = window(run)
    if w is None or not w["calls"][name]:
        return None
    return w["ns"][name] / w["steps"] / 1e6
