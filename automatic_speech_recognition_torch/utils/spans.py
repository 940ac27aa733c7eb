"""The port's span recorder: host wall time of the hot paths, by name.

Three kinds of record, all keyed by a dotted name ("train.backward"):

- Coarse spans, `with spans.span("train.step"):`, a few a training step
  or a served batch and never one a decoder step.  Each appends
  (name, start_ns, end_ns, thread id, 1) to a bounded ring
  (collections.deque, RING records; the oldest drop out) on
  time.perf_counter_ns, and adds its duration to the name's total and
  call count.  Recording is always on: about a microsecond a span.
  While a torch profiler runs, the span also opens a
  torch.profiler.record_function range of the same name.  `record(name,
  start_ns)` is a coarse span whose start another thread took (a served
  batch: dispatched on the batcher's thread, finished where its replica
  finishes); it opens no profiler range.
- Fine spans, `with spans.fine("las.speller.step"):`, one a decoder or
  beam step.  A profiler range while a profiler runs, otherwise a shared
  no-op context: they never touch the ring or the totals.
- Counters, `spans.count("las.speller.steps", n)`, once a loop and never
  inside one: the name's count grows by n, and the ring keeps
  (name, t_ns, t_ns, thread id, n), so that a stretch's counts can be
  summed as its spans are.

No record reads a device tensor: a span is host time, which is what
paces a host-bound loop, and on a device-bound one it is the time to
enqueue the work, unless the code inside waits for the device itself.

The shared clock.  The first coarse span that finds a profiler running
(after one that found none) first opens and closes a `spans.clock` range
and keeps in `clock_marks` the perf_counter_ns time taken just inside
it, as a span takes its start.  For a trace of that profiler session:

    offset_us = ts(spans.clock) - clock_marks[i] / 1e3
    trace time of a record (us) = start_ns / 1e3 + offset_us

where ts is the range's start in the trace (a chrome trace's "ts", or a
profiler event's time_range.start) and i the session's mark (train.py
logs it beside the trace it writes).  Each ring record then lies over
the kernels of that trace.

Readers: train.py's logging-step and end-of-run lines, serve.py's
GET /stats, and the benchmark (bench_torch/program_spans.py), which
reads `snapshot()` in the process that ran the program.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 65536
CLOCK = "spans.clock"


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    n: int          # 1 for a span; a counter's increment


_ring: Deque[tuple] = collections.deque(maxlen=RING)
_appended = 0                           # records ever appended
_totals: Dict[str, List[int]] = {}      # name -> [total_ns, count]
_counters: set = set()                  # names that count() has taken
_lock = threading.Lock()
_marked = False                         # this profiler session has its mark
clock_marks: Deque[int] = collections.deque(maxlen=64)
_NOOP = contextlib.nullcontext()


def profiling() -> bool:
    """A torch profiler is recording (a module global: no C++ call)."""
    return _autograd_profiler._is_profiler_enabled


def _add(name: str, start_ns: int, end_ns: int, n: int) -> None:
    global _appended
    with _lock:
        _ring.append((name, start_ns, end_ns, threading.get_ident(), n))
        _appended += 1
        total = _totals.get(name)
        if total is None:
            _totals[name] = [end_ns - start_ns, n]
        else:
            total[0] += end_ns - start_ns
            total[1] += n


def _mark_clock() -> None:
    global _marked
    _marked = True
    # a session's first range pays the profiler's set-up for the thread
    # after its start is stamped (about a millisecond on a CPU), which
    # would shift the mark: a throwaway range takes that first
    with torch.profiler.record_function(CLOCK + ".warm"):
        pass
    with torch.profiler.record_function(CLOCK):
        clock_marks.append(time.perf_counter_ns())


class _Span:
    __slots__ = ("name", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        global _marked
        self.range = None
        if profiling():
            if not _marked:
                _mark_clock()
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        else:
            _marked = False
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _add(self.name, self.start, end, 1)


def span(name: str) -> _Span:
    """A coarse span: `with span(name): ...`."""
    return _Span(name)


def fine(name: str):
    """A fine span: a profiler range while a profiler runs, else a no-op."""
    if profiling():
        return torch.profiler.record_function(name)
    return _NOOP


def record(name: str, start_ns: int) -> None:
    """A coarse span from start_ns (perf_counter_ns, taken on any thread)
    to now, kept in the ring and the totals (no profiler range)."""
    _add(name, start_ns, time.perf_counter_ns(), 1)


def count(name: str, n: int = 1) -> None:
    """Add n to a counter."""
    t = time.perf_counter_ns()
    _counters.add(name)
    _add(name, t, t, int(n))


def snapshot() -> Tuple[List[Record], int]:
    """(the ring's records, oldest first; how many dropped out of it)."""
    with _lock:
        return [Record(*r) for r in _ring], max(_appended - RING, 0)


def totals() -> Dict[str, Tuple[int, int]]:
    """name -> (total ns, count): spans' durations and calls, counters'
    sums (0 ns)."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _totals.items()}


def report(before: Optional[Dict[str, Tuple[int, int]]] = None,
           prefixes: Tuple[str, ...] = ("",)) -> Dict[str, Dict]:
    """Totals since `before` (a totals() reading) of the names under
    `prefixes`: a span's {total_s, calls, mean_s}, a counter's {count}."""
    before = before or {}
    out = {}
    for name, (ns, n) in sorted(totals().items()):
        ns0, n0 = before.get(name, (0, 0))
        ns, n = ns - ns0, n - n0
        if not n or not name.startswith(prefixes):
            continue
        out[name] = ({"count": n} if name in _counters else
                     {"total_s": ns / 1e9, "calls": n,
                      "mean_s": ns / 1e9 / n})
    return out


def reset() -> None:
    """Empty the ring, the totals and the clock marks (tests)."""
    global _appended, _marked
    with _lock:
        _ring.clear()
        _totals.clear()
        _counters.clear()
        clock_marks.clear()
        _appended, _marked = 0, False
