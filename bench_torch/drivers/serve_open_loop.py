"""Open-loop serving: requests sent through BatchingRecognizer.submit at
the mix's scheduled times, whatever the server's state, each timed from
when it was due.

Set-up: the yardstick's weights into the program's LAS, a Recognizer on
one GPU (one inline replica, as `serve --device cuda:0` runs it), the
batcher with the mix's settings, and one batch of every bucket the
requests use.  Window: the generator thread sends on schedule; with
--trace 1 a short stretch in the middle is profiled.  After it: every
request due in the window is waited for (a minute past the close at the
most), the latencies and counters are read, the program is freed, and a
sample of served requests, the longest among them, is run through the
plain reference teacher-forced on the served tokens: the widest gap by
which a served token's logit lies below the reference's best."""

from __future__ import annotations

import bisect
import gc
import threading
import time
from functools import partial

import numpy as np
import torch
from automatic_speech_recognition_torch.api import Recognizer

from bench_torch import harness, stats, synth, traffic, weights, work
from bench_torch.reference.las import num_frames
from bench_torch.trace import Stretch

GRACE_S = 60.0
FRONTEND_KERNELS = ("features_kernel", "cmvn_stats_kernel",
                    "cmvn_deltas_kernel")


class Served(Recognizer):
    """The program's Recognizer with the harness's span around each
    dispatched batch; a request resolves to its served token ids,
    and the served logits of the requests in `keep` (id of the
    signal -> request) are kept on the device for the check."""

    def __init__(self, *args, run: harness.Run):
        super().__init__(*args)
        self.run = run
        self.recording = False
        self.keep, self.kept = {}, {}
        self._width, self._rows = 0, []

    def _audio(self, signals, pad_seconds=0):
        audio, lens = super()._audio(signals, pad_seconds)
        self._width = audio.shape[1]
        return audio, lens

    def _raw_op(self, beam_size):
        op, kw = super()._raw_op(beam_size)
        return op, {**kw, "logits": True}

    def submit_signals(self, signals, beam_size=0, pad_seconds=0,
                       worker=None):
        t = time.perf_counter()
        self._rows = [id(s) for s in signals]
        with torch.profiler.record_function("bench.greedy_batch"):
            fut = super().submit_signals(signals, beam_size,
                                         pad_seconds, worker)
            fut.result()
        if self.recording:
            frames = num_frames(self._width, self.run.values)
            steps = max(int(self.cfg.convert_rate * max(frames, 1)), 1)
            self.run.span("greedy.batch", time.perf_counter() - t, steps)
        return fut

    def _texts(self, out, n, beam_size):
        ids = out[1].cpu().numpy()
        if "alter_token" in self.run.faults:
            ids = ids.copy()
            mid = ids.shape[1] // 2
            ids[:, mid] = (ids[:, mid] + 1) % self.cfg.vocab_size
        for r in range(n):
            i = self.keep.get(self._rows[r])
            if i is not None:
                self.kept[i] = out[0][r].clone()
        return [(ids[i], self._width) for i in range(n)]


def setup_phases(t_start: float, phases) -> str:
    """'set-up: name s, ...': the seconds each phase of set-up took."""
    marks = [t_start] + [t for _, t in phases]
    return "set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, _), a, b in
        zip(phases, marks, marks[1:]))


def bucket_of(buckets, samples: int, sr: int) -> int:
    return buckets[bisect.bisect_left(buckets, samples / sr)]


def run(run: harness.Run) -> None:
    from automatic_speech_recognition_torch.ops import cuda_frontend
    from automatic_speech_recognition_torch.serving import BatchingRecognizer
    from automatic_speech_recognition_torch.utils.device import disable_tf32

    dev, mix, values = run.device, run.mix, run.values
    cuda = dev.type == "cuda"
    if cuda:
        disable_tf32()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases = [("imports", time.perf_counter())]
    cfg = harness.program_config(values)
    plain = harness.reference(run.config)
    w = weights.make(plain.param_spec(values), run.seed, dev)
    model = harness.build_model(cfg, w, dev).eval()
    rec = Served(model, cfg, None, str(dev), run=run)
    b = mix["batcher"]
    srv = BatchingRecognizer(rec, b["max_batch"], b["max_wait_ms"],
                             beam_size=mix["beam_size"],
                             bucket_seconds=b["bucket_seconds"])
    sr = values["sample_rate"]
    due = traffic.arrivals(mix, run.seconds)
    n = len(due)
    lengths = traffic.sizes(mix, values, n)
    source = synth.stretch(run.seed, mix["stretch_s"], sr)
    offs = traffic.offsets(run.seed, lengths, len(source))
    signals = [source[o:o + k] for o, k in zip(offs, lengths)]
    phases.append(("weights, model, requests", time.perf_counter()))
    buckets = sorted(srv.bucket_seconds)
    for sec in sorted({bucket_of(buckets, k, sr) for k in lengths}):
        warm = [source[:sec * sr]] * srv.max_batch
        rec.submit_signals(warm, mix["beam_size"], sec).result()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    st = srv.stats
    base = (st.batches, st.batched_signals, st.queue_wait_s)

    done = [None] * n
    out = [None] * n
    lag = [0.0] * n
    errors = []

    def finish(i, fut):
        if fut.exception() is not None:
            errors.append(repr(fut.exception()))
            return
        done[i] = time.perf_counter()
        out[i] = fut.result()

    order = sample_order(run, lengths)
    rec.keep = {id(signals[i]): i
                for i in order[:2 * mix["check"]["requests"]]}
    run.setup_s = time.perf_counter() - run.t_start
    phases.append(("warm-up", time.perf_counter()))
    run.note(setup_phases(run.t_start, phases))
    launches = cuda_frontend.fused_frontend.launches
    srv.start()
    rec.recording = True
    t0 = time.perf_counter()

    def generate():
        for i in range(n):
            target = t0 + due[i]
            wait = target - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            lag[i] = time.perf_counter() - target
            try:
                srv.submit(signals[i]).add_done_callback(partial(finish, i))
            except RuntimeError as e:  # the server refused it: missing
                errors.append(repr(e))

    gen = threading.Thread(target=generate, name="bench-generator")
    gen.start()
    # a traced run profiles the window's last trace_s seconds; its spans,
    # counters and work are read over the untraced part before them
    traced_s = mix["trace_s"] if run.trace else 0.0
    time.sleep(max(t0 + run.seconds - traced_s - time.perf_counter(), 0))
    cut = time.perf_counter()
    rec.recording = False
    end = (st.batches, st.batched_signals, st.queue_wait_s)
    if run.trace:
        with Stretch(FRONTEND_KERNELS) as s:
            time.sleep(max(t0 + run.seconds - time.perf_counter(), 0))
        run.traced = s.result
    time.sleep(max(t0 + run.seconds - time.perf_counter(), 0))
    t1 = time.perf_counter()
    run.window_s = cut - t0
    gen.join()
    deadline = t1 + GRACE_S
    while (time.perf_counter() < deadline
           and sum(d is not None for d in done) + len(errors) < n):
        time.sleep(0.01)
    srv.stop()
    sync()
    missing_at = time.perf_counter()

    lat = stats.open_loop_latencies([t0 + d for d in due], done, missing_at)
    run.attempted, run.failed = n, sum(d is None for d in done)
    run.e2e["serve_p95_ms"] = 1e3 * stats.percentile(lat, 95)
    for x in lat:
        run.span("latency", x)
    run.counters.update(
        batches=end[0] - base[0], rows=end[1] - base[1],
        queue_wait_s=end[2] - base[2], max_batch=srv.max_batch)
    flops = 0.0
    for i in range(n):
        if done[i] is not None and done[i] <= cut:
            frames = num_frames(int(lengths[i]), values)
            flops += work.forward_flops(plain, values, frames,
                                        work.step_budget(values, frames))
    run.work.update(flops=flops, peak=work.peak(values))
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if cuda else 0)
    run.note(f"requests due {n}, completed {n - run.failed}, failed "
             f"{len(errors)}; generator lag mean {1e3 * np.mean(lag):.3f} ms"
             f" max {1e3 * max(lag):.3f} ms; p50 "
             f"{1e3 * stats.percentile(lat, 50):.1f} ms")
    run.note(f"peak device memory {run.memory_peak_bytes} bytes; "
             f"fused_frontend launches in the window "
             f"{cuda_frontend.fused_frontend.launches - launches}")
    if errors:
        run.note(f"first error: {errors[0]}")

    kept = rec.kept
    del srv, rec, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check(run, plain, w, signals, out, kept, order)


def sample_order(run: harness.Run, lengths) -> list:
    """The requests the check reads, in the order it takes the finished
    ones: the longest first, then a seeded draw of the rest."""
    longest = int(np.argmax(lengths))
    rest = [i for i in np.random.default_rng([run.seed, 6]).permutation(
        len(lengths)) if i != longest]
    return [longest] + [int(i) for i in rest]


def check(run: harness.Run, plain, w, signals, out, kept, order) -> None:
    """The reference over a seeded sample of finished requests, the
    longest among them, teacher-forced on their served tokens: the widest
    gap by which a served token's logit lies below the reference's best,
    and the widest difference between the served logits and the
    reference's."""
    values, dev = run.values, run.device
    sample = [i for i in order if i in kept][:run.mix["check"]["requests"]]
    if not sample:
        run.check("served_gap", float("inf"))
        run.check("logit_gap", float("inf"))
        return
    by_width = {}
    for i in sample:
        by_width.setdefault(out[i][1], []).append(i)
    gap = gap_c = diff = diff_c = 0.0
    tokens_seen = 0
    for width, rows in by_width.items():
        audio = torch.zeros((len(rows), width), device=dev)
        lens = torch.zeros((len(rows),), dtype=torch.long, device=dev)
        for r, i in enumerate(rows):
            audio[r, :len(signals[i])] = torch.from_numpy(signals[i])
            lens[r] = len(signals[i])
        toks = torch.from_numpy(np.stack([out[i][0] for i in rows])).to(dev)
        tokens_seen += toks.numel()
        with torch.no_grad(), plain.precision(False):
            lg = plain.forced_logits(w, values, audio, lens, toks)
        best = lg.max(-1).values
        gap = max(gap, float((best - lg.gather(-1, toks[..., None].long())
                              [..., 0]).max()))
        served = torch.stack([kept[i] for i in rows])
        diff = max(diff, float((served - lg).abs().max()))
        if run.control:
            with torch.no_grad(), plain.precision(True):
                lc = plain.forced_logits(w, values, audio, lens, toks)
            pick = lc.argmax(-1)
            gap_c = max(gap_c, float((best - lg.gather(-1, pick[..., None])
                                      [..., 0]).max()))
            diff_c = max(diff_c, float((lc - lg).abs().max()))
    run.note(f"reference over {len(sample)} served requests, {tokens_seen} "
             f"tokens")
    run.check("served_gap", gap, gap_c if run.control else None)
    run.check("logit_gap", diff, diff_c if run.control else None)
