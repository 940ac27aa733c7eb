"""Training throughput as train_loader measures it, and beside it what the
listener's recurrences did: the window's real frame-steps, the frame-steps
the program ran, and in a traced run the device time of the kernels that
cuDNN's RNN forward and backward ops launched.

train_loader.run runs as it is, with two observers put in for the run:
the loader's prefetcher notes each batch's lengths in feed order and the
time the step took it, and the traced stretch also reads, for each op of
RNN_OPS, the device time of the kernels it and the ops under it launched
(op_device_s).  After the run:

- run.counters['listener.real_frames']: the window's batches' real
  frame-steps, from the lengths fed through the reference module's frame
  arithmetic (its `rnn_frames`);
- run.counters['listener.rnn_frames']: the program's
  `las.listener.rnn_frames` counter summed over the window's `train.step`
  spans (absent where the program has no such counter);
- run.traced['op_device_s']: {op: device seconds} in the traced steps."""

from __future__ import annotations

import time
from collections import deque

import numpy as np
from torch.autograd import DeviceType

from bench_torch import harness
from bench_torch.drivers import train_loader
from bench_torch.reference.las import num_frames
from bench_torch.trace import Stretch, _is_device, _union

RNN_OPS = ("aten::_cudnn_rnn", "aten::_cudnn_rnn_backward")
COUNTER = "las.listener.rnn_frames"


def op_device_s(prof, ops) -> dict:
    """Device seconds, for each op of `ops` (the outermost where one holds
    another), of the kernels that it and the ops under it launched in the
    profile `prof`: the union of their intervals, as cuDNN runs a
    bidirectional layer's two directions side by side.  A kernel is tied
    to the op that launched it by the profiler's correlation ids (the
    kernel's linked id is its op's id)."""
    owner = {}

    def mark(e, op):
        owner[e.id] = op
        for child in e.cpu_children:
            mark(child, op)

    for e in prof.events():
        if e.name not in ops or _is_device(e):
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in ops:
            parent = parent.cpu_parent
        if parent is None:
            mark(e, e.name)
    spans = {op: [] for op in ops}
    for k in prof.profiler.kineto_results.events():
        op = owner.get(k.linked_correlation_id())
        if (op is not None and k.device_type() != DeviceType.CPU
                and not k.is_user_annotation()):
            spans[op].append((k.start_ns(), k.end_ns()))
    return {op: sum(b - a for a, b in _union(s)) / 1e9
            for op, s in spans.items()}


class RnnStretch(Stretch):
    """trace.Stretch, its result holding 'op_device_s' for RNN_OPS."""

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        if self.result is not None:
            self.result["op_device_s"] = op_device_s(self.prof, RNN_OPS)


def noting_prefetcher(base, fed: list):
    """A DevicePrefetcher class whose instances append (time taken, the
    batch's host lengths) to `fed` as the consumer takes each batch."""

    class Noting(base):
        def __init__(self, it, put_fn, depth: int = 2):
            lens = deque()

            def put(batch):
                lens.append(np.asarray(batch[1]).copy())
                return put_fn(batch)

            self._lens = lens
            super().__init__(it, put, depth)

        def __next__(self):
            item = super().__next__()
            fed.append((time.perf_counter(), self._lens.popleft()))
            return item

    return Noting


def window_count(run, name: str):
    """The program counter `name` summed over the window's `train.step`
    spans (program_spans.window's steps), or None."""
    try:
        from automatic_speech_recognition_torch.utils import spans
    except ImportError:
        return None
    n = len(run.spans.get("loader.next", []))
    records, dropped = spans.snapshot()
    if not n or run.setup_s is None or dropped:
        return None
    t0 = round((run.t_start + run.setup_s) * 1e9)
    steps = sorted((r for r in records
                    if r.name == "train.step" and r.start_ns >= t0),
                   key=lambda r: r.start_ns)[:n]
    if len(steps) < n:
        return None
    total = sum(r.n for s in steps for r in records
                if r.name == name and r.thread == s.thread
                and s.start_ns <= r.start_ns <= s.end_ns)
    return total or None


def run(run: harness.Run) -> None:
    from automatic_speech_recognition_torch.data import pipeline

    fed: list = []
    base = pipeline.DevicePrefetcher
    pipeline.DevicePrefetcher = noting_prefetcher(base, fed)
    train_loader.Stretch = RnnStretch
    try:
        train_loader.run(run)
    finally:
        pipeline.DevicePrefetcher = base
        train_loader.Stretch = Stretch
    plain = harness.reference(run.config)
    n = len(run.spans.get("loader.next", []))
    t0 = run.t_start + run.setup_s
    window = [lens for t, lens in fed if t >= t0][:n]
    if len(window) == n and hasattr(plain, "rnn_frames"):
        run.counters["listener.real_frames"] = float(sum(
            plain.rnn_frames(run.values, num_frames(int(k), run.values))
            for lens in window for k in lens))
    counted = window_count(run, COUNTER)
    if counted:
        run.counters["listener.rnn_frames"] = float(counted)
