"""Serving: dynamic batching over the Recognizer (counterpart of
automatic_speech_recognition_tpu/serving.py, typed against the port's
Recognizer; the logic is the same).

- `BatchingRecognizer.submit(signal)` returns a `concurrent.futures.Future`
  immediately; a single dispatcher thread collects requests for at most
  `max_wait_ms` (or until `max_batch` are waiting) and runs them together.
- Shapes stay bounded: the padded signal length is pinned to a fixed
  bucket ladder (`bucket_seconds`), and every batch is padded UP to
  `max_batch` by repeating the last signal (extra outputs dropped).  The
  number of distinct shapes is len(bucket_seconds), all run once by
  `warmup()`.
- A batch never mixes buckets: the dispatcher groups waiting requests by
  bucket and flushes the largest group; stragglers stay queued (their
  deadline still holds, checked every loop).

- Up to one batch is in flight per replica of the recognizer
  (`Recognizer.pool.size`): each batch goes to the next free replica
  through `Recognizer.submit_signals`, and its requests' futures resolve
  when it is done, in whatever order the batches finish.  With one
  replica the batch runs on the dispatcher thread, as it always did.

Each batch is one `serve.batch` span (utils/spans.py) from its dispatch
to its finish, which serve.py's GET /stats reports.

Thread-safety: device work happens only on the dispatcher thread or in
the recognizer's worker processes (and in `warmup()` before `start()`);
callers only touch queues and futures.
"""

from __future__ import annotations

import bisect
import collections
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .api import Recognizer
from .utils import spans


class ServingStats:
    """Counters + latency reservoir; cheap enough to update per request."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.batched_signals = 0       # real (non-padding) signals dispatched
        self.errors = 0
        self.queue_wait_s = 0.0        # submit -> dispatch, summed
        self._lat = collections.deque(maxlen=4096)  # seconds, per request

    def record_batch(self, n_real: int, queue_wait_s: float = 0.0) -> None:
        with self._lock:
            self.batches += 1
            self.batched_signals += n_real
            self.queue_wait_s += queue_wait_s

    def record_request(self, latency_s: float, error: bool = False) -> None:
        with self._lock:
            self.requests += 1
            if error:
                self.errors += 1
            else:
                self._lat.append(latency_s)

    def snapshot(self) -> Dict:
        with self._lock:
            lat = sorted(self._lat)
            n = len(lat)
            pct = lambda p: lat[min(n - 1, int(p * n))] if n else 0.0
            return {
                "requests": self.requests,
                "batches": self.batches,
                "errors": self.errors,
                "mean_batch_occupancy": (self.batched_signals /
                                         max(self.batches, 1)),
                "mean_queue_wait_ms": (1e3 * self.queue_wait_s /
                                       max(self.batched_signals, 1)),
                "latency_p50_ms": pct(0.50) * 1e3,
                "latency_p90_ms": pct(0.90) * 1e3,
                "latency_p99_ms": pct(0.99) * 1e3,
            }


class _Request:
    __slots__ = ("signal", "future", "t_submit", "bucket")

    def __init__(self, signal: np.ndarray, bucket: int):
        self.signal = signal
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.bucket = bucket


class BatchingRecognizer:
    """Dynamic-batching front for a `Recognizer`.

    Args:
      recognizer: an `api.Recognizer` (or anything with its cfg,
        pool.size and submit_signals): one batch in flight per replica.
      max_batch: batch size per device dispatch (one shape).
      max_wait_ms: longest a request waits for co-riders before its
        bucket is flushed anyway.
      beam_size: 0/1 greedy, > 1 beam search (passed through).
      bucket_seconds: ascending padded-length ladder; a signal rides the
        smallest bucket that fits it.  Defaults to powers of two up to
        cfg.max_audio_seconds.
    """

    def __init__(self, recognizer: Recognizer, max_batch: int = 8,
                 max_wait_ms: float = 20.0, beam_size: int = 0,
                 bucket_seconds: Optional[Sequence[int]] = None):
        self.rec = recognizer
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.beam_size = int(beam_size)
        if bucket_seconds is None:
            top = int(np.ceil(recognizer.cfg.max_audio_seconds))
            bucket_seconds, b = [], 1
            while b < top:
                bucket_seconds.append(b)
                b *= 2
            bucket_seconds.append(top)
        self.bucket_seconds: List[int] = sorted(int(b) for b in bucket_seconds)
        self.stats = ServingStats()
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._accepting = False  # guarded by _lock; closed before the drain
        self.replicas = recognizer.pool.size
        # one slot per replica: a batch in flight holds one
        self._slots = threading.BoundedSemaphore(self.replicas)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "BatchingRecognizer":
        if self._thread is not None:
            raise RuntimeError("already started")
        self._stop.clear()
        self._accepting = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="asr-batcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        # close the door first — submit() enqueues under the same lock, so
        # after this no request can slip in behind the drain and hang
        with self._lock:
            self._accepting = False
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # the batches in flight finish (or fail) before stop returns
        for _ in range(self.replicas):
            self._slots.acquire()
        for _ in range(self.replicas):
            self._slots.release()
        # fail whatever is still queued rather than hanging callers
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
        for r in pending:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(RuntimeError("server stopped"))

    def __enter__(self) -> "BatchingRecognizer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def warmup(self) -> None:
        """Run every (bucket, max_batch) shape once up front on every
        replica, so the first real request never pays kernel builds or
        cuDNN/cuBLAS setup.  Warmup bypasses the stats reservoir — set-up
        latencies and occupancy-1 batches would otherwise skew the stats
        until real traffic dilutes them."""
        sr = self.rec.cfg.sample_rate
        for b in self.bucket_seconds:
            sig = np.zeros((b * sr,), np.float32)
            sig[0] = 1e-3  # non-silent so CMVN variance is sane
            signals = [sig] * self.max_batch
            futures = [self._submit(signals, b, worker=i)
                       for i in range(self.replicas)]
            for f in futures:
                f.result()

    # -- request path --------------------------------------------------

    def _bucket_of(self, signal: np.ndarray) -> int:
        secs = len(signal) / self.rec.cfg.sample_rate
        i = bisect.bisect_left(self.bucket_seconds, secs)
        if i == len(self.bucket_seconds):
            raise ValueError(
                f"signal of {secs:.1f}s exceeds the largest bucket "
                f"({self.bucket_seconds[-1]}s = cfg.max_audio_seconds)")
        return self.bucket_seconds[i]

    def submit(self, signal: np.ndarray) -> Future:
        """Enqueue one waveform (float, cfg.sample_rate). Returns a Future
        resolving to the transcript string."""
        req = _Request(np.asarray(signal, np.float32), self._bucket_of(signal))
        with self._lock:
            if not self._accepting:
                raise RuntimeError("not started")
            self._queue.append(req)
        self._wake.set()
        return req.future

    def transcribe(self, signal: np.ndarray,
                   timeout: Optional[float] = None) -> str:
        """Blocking convenience wrapper around submit()."""
        return self.submit(signal).result(timeout=timeout)

    # -- dispatcher ----------------------------------------------------

    def _take_batch(self) -> Tuple[List[_Request], float]:
        """Pop the batch to run now, or ([], sleep_hint_seconds).

        Flush rule: the bucket of the OLDEST request once it has waited
        max_wait_s takes priority (so sustained load on other buckets can
        never starve it past its deadline); otherwise any bucket with
        >= max_batch waiting."""
        now = time.monotonic()
        with self._lock:
            if not self._queue:
                return [], self.max_wait_s
            by_bucket: Dict[int, List[_Request]] = {}
            for r in self._queue:
                by_bucket.setdefault(r.bucket, []).append(r)
            full = [b for b, rs in by_bucket.items()
                    if len(rs) >= self.max_batch]
            oldest = self._queue[0]
            if now - oldest.t_submit >= self.max_wait_s:
                bucket = oldest.bucket
            elif full:
                bucket = full[0]
            else:
                return [], self.max_wait_s - (now - oldest.t_submit)
            take = by_bucket[bucket][:self.max_batch]
            taken = set(id(r) for r in take)
            self._queue = collections.deque(
                r for r in self._queue if id(r) not in taken)
            return take, 0.0

    def _submit(self, signals: List[np.ndarray], bucket: int,
                worker: Optional[int] = None) -> Future:
        """The texts of one padded batch, as a Future: on the next free
        replica (or `worker`); an inline replica runs it here."""
        return self.rec.submit_signals(signals, beam_size=self.beam_size,
                                       pad_seconds=bucket, worker=worker)

    def _dispatch(self, batch: List[_Request]) -> None:
        """Send one batch (holding a slot, released when it is done)."""
        n = len(batch)
        # a request cancelled while queued is dropped here; the call also
        # marks live futures RUNNING so set_result below cannot race a
        # late cancel (concurrent.futures state machine)
        live = [r for r in batch if r.future.set_running_or_notify_cancel()]
        if not live:
            self._slots.release()
            return
        signals = [r.signal for r in batch]
        # pad the batch up to max_batch by repetition: batch size stays one
        # shape; the duplicate outputs are sliced off below
        while len(signals) < self.max_batch:
            signals.append(signals[-1])
        bucket = max(r.bucket for r in batch)
        t_dispatch = time.monotonic()
        span_start = time.perf_counter_ns()
        try:
            fut = self._submit(signals, bucket)
        except Exception as e:  # pragma: no cover - a closed pool
            fut = Future()
            fut.set_exception(e)
        fut.add_done_callback(
            lambda f: self._finish(batch, live, n, t_dispatch, f,
                                   span_start))

    def _finish(self, batch: List[_Request], live: List[_Request], n: int,
                t_dispatch: float, fut: Future, span_start: int) -> None:
        # the batch's span: dispatched on the batcher's thread, finished
        # here (the same thread for an inline replica)
        spans.record("serve.batch", span_start)
        try:
            if fut.exception() is not None:  # pragma: no cover - device
                for r in live:
                    if not r.future.done():
                        r.future.set_exception(fut.exception())
                        self.stats.record_request(0.0, error=True)
                return
            texts = fut.result()
            self.stats.record_batch(n, sum(t_dispatch - r.t_submit
                                           for r in batch))
            now = time.monotonic()
            by_req = dict(zip(map(id, batch), texts[:n]))
            for r in live:
                r.future.set_result(by_req[id(r)])
                self.stats.record_request(now - r.t_submit)
        finally:
            self._slots.release()

    def _run(self) -> None:
        while not self._stop.is_set():
            # a free replica first, so requests keep gathering into the
            # next batch while every replica is busy
            if not self._slots.acquire(timeout=0.05):
                continue
            batch, sleep_hint = self._take_batch()
            if batch:
                self._dispatch(batch)
                continue
            self._slots.release()
            self._wake.wait(timeout=sleep_hint)
            self._wake.clear()
