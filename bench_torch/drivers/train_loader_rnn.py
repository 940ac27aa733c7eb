"""Training throughput as train_loader measures it, and beside it what the
listener's recurrences did: the window's real frame-steps, the frame-steps
the program ran, and in a traced run the device time of the recurrences
the program ran, whatever implements them.

train_loader.run runs as it is, with two observers put in for the run:
the loader's prefetcher notes each batch's lengths in feed order and the
time the step took it, and the traced stretch also reads the device time
of the recurrences' forward and backward (rnn_device_s).  After the run:

- run.counters['listener.real_frames']: the window's batches' real
  frame-steps, from the lengths fed through the reference module's frame
  arithmetic (its `rnn_frames`);
- run.counters['listener.rnn_frames']: the program's
  `las.listener.rnn_frames` counter summed over the window's `train.step`
  spans (absent where the program has no such counter);
- run.traced['rnn_device_s']: {'forward': s, 'backward': s}, device
  seconds in the traced steps.

Which host ops are the recurrences' (recurrence_owners).  The program
opens a profiler range named RANGE around each recurrence call, from its
(B, T, D) input to its (B, T, 2U) output, both directions and the input
projections inside and nothing else.  The forward is every op under such
a range.  The backward is every autograd node that an op under a range
made, found by the link the profiler keeps: a node's
`autograd::engine::evaluate_function: <node>` op carries the thread and
sequence number of the forward op that made it (fwd_thread_id,
sequence_nr), and every op under it.  A cuDNN RNN, a custom
autograd.Function or a loop of cell ops reads alike.  A profile with no
such range (a program older than the range) is read by cuDNN's two RNN
ops instead, each with the ops under it.

The reading works on the profiler's raw events.  A host op is a CPU
event linked to no other (the runtime's calls, cudaLaunchKernel and the
like, are linked to the op that made them, and carry the runtime's own
correlation ids, which may equal an op's); "under" is the interval on
the op's thread; a kernel is tied to the op that launched it by its
linked correlation id, which is that op's correlation id."""

from __future__ import annotations

import bisect
import time
from collections import deque

import numpy as np
from torch.autograd import DeviceType

from bench_torch import harness
from bench_torch.drivers import train_loader
from bench_torch.reference.las import num_frames
from bench_torch.trace import Stretch, _union

RANGE = "las.listener.rnn"
BACKWARD = "autograd::engine::evaluate_function: "
CUDNN_OPS = {"aten::_cudnn_rnn": "forward",
             "aten::_cudnn_rnn_backward": "backward"}
COUNTER = "las.listener.rnn_frames"


def _host_ops(events) -> list:
    """The profile's host ops, ranges and autograd nodes among `events`,
    by start."""
    return sorted((e for e in events if e.device_type() == DeviceType.CPU
                   and e.linked_correlation_id() == 0
                   and e.correlation_id() > 0 and not e.is_async()),
                  key=lambda e: e.start_ns())


def _under(host: list, roots) -> dict:
    """{correlation id: root} of each op of `host` (by start) that lies in
    the interval of a root on the root's thread, the roots included; an
    op in two roots goes to the outer."""
    starts = [e.start_ns() for e in host]
    out: dict = {}
    for r in sorted(roots, key=lambda e: e.end_ns() - e.start_ns(),
                    reverse=True):
        thread, end = r.start_thread_id(), r.end_ns()
        for e in host[bisect.bisect_left(starts, r.start_ns()):
                      bisect.bisect_right(starts, end)]:
            if e.start_thread_id() == thread and e.end_ns() <= end:
                out.setdefault(e.correlation_id(), r)
    return out


def range_owners(events) -> dict:
    """{correlation id: 'forward' or 'backward'}: the host ops among the
    profiler's raw `events` under RANGE ranges, and under the autograd
    nodes that ops under those ranges made."""
    host = _host_ops(events)
    forward = _under(host, [e for e in host if e.name() == RANGE])
    nodes = [e for e in host if e.name().startswith(BACKWARD)]
    in_backward = _under(host, nodes)
    # An op records the number the next node on its thread will take, so
    # an op that makes no node shares its number with the next op that
    # does: a number belongs to the last forward op to record it.
    made_by = {(e.start_thread_id(), e.sequence_nr()): e.correlation_id()
               for e in host if e.sequence_nr() >= 0
               and e.correlation_id() not in in_backward}
    linked = [n for n in nodes if n.sequence_nr() >= 0 and made_by.get(
        (n.fwd_thread_id(), n.sequence_nr())) in forward]
    backward = _under(host, linked)
    return {**{i: "forward" for i in forward},
            **{i: "backward" for i in backward}}


def cudnn_owners(events) -> dict:
    """{correlation id: 'forward' or 'backward'}: the host ops among the
    profiler's raw `events` under cuDNN's RNN forward and backward ops."""
    host = _host_ops(events)
    under = _under(host, [e for e in host if e.name() in CUDNN_OPS])
    return {i: CUDNN_OPS[r.name()] for i, r in under.items()}


def recurrence_owners(events) -> dict:
    """The recurrences' host ops among the profiler's raw `events`: by the
    program's ranges, or by cuDNN's ops in a profile that holds no range."""
    if any(e.name() == RANGE for e in events):
        return range_owners(events)
    return cudnn_owners(events)


def rnn_device_s(events, owner=None) -> dict:
    """{'forward': s, 'backward': s}: device seconds of the kernels that
    the recurrences' host ops (`owner`, by default recurrence_owners)
    launched among the profiler's raw `events`, each the union of their
    intervals (a bidirectional layer runs its two directions side by
    side).  Range annotations on the device are left out."""
    if owner is None:
        owner = recurrence_owners(events)
    spans = {"forward": [], "backward": []}
    for k in events:
        key = owner.get(k.linked_correlation_id())
        if (key is not None and k.device_type() != DeviceType.CPU
                and not k.is_user_annotation()):
            spans[key].append((k.start_ns(), k.end_ns()))
    return {key: sum(b - a for a, b in _union(s)) / 1e9
            for key, s in spans.items()}


class RnnStretch(Stretch):
    """trace.Stretch, its result holding 'rnn_device_s'."""

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        if self.result is not None:
            self.result["rnn_device_s"] = rnn_device_s(
                list(self.prof.profiler.kineto_results.events()))


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
