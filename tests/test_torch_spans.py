"""The port's span recorder (automatic_speech_recognition_torch/utils/
spans.py) and its sites: nesting and threads, the ring's bound, fine spans
without a profiler, coarse spans as profiler ranges on the documented
clock, one train step's and one greedy Recognizer call's spans, and the
beam's per-step scores rebuilding its final scores."""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import json
import threading
import time

import numpy as np
import pytest
import torch

from automatic_speech_recognition_torch import train as train_cli
from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.decoding import beam
from automatic_speech_recognition_torch.models import las
from automatic_speech_recognition_torch.training import trainer
from automatic_speech_recognition_torch.utils import spans
from automatic_speech_recognition_torch.utils.tokenizer import CharEncoder

from test_torch_train_cli import _args as cli_args
from test_torch_train_cli import _shards as cli_shards

CPU = torch.device("cpu")


def tiny_cfg(**kw):
    base = dict(unit="char", vocab_size=30, feat_dim=8, enc_type="cnn",
                enc_units=16, num_enc_channels=4, num_enc_layers=1,
                dec_units=16, num_dec_layers=1, embedding_size=8,
                attention_size=8, mode="loc", dropout_rate=0.0,
                scheduled_sampling=False, convert_rate=0.12)
    base.update(kw)
    return Config(**base)


@pytest.fixture(autouse=True)
def fresh_ring():
    spans.reset()
    yield
    spans.reset()


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_nesting_threads_and_counters():
    with spans.span("outer"):
        with spans.span("inner"):
            time.sleep(0.001)
        spans.count("things", 3)
    t = threading.Thread(target=lambda: spans.span("other").__enter__()
                         .__exit__(None, None, None))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    recs, dropped = spans.snapshot()
    assert dropped == 0
    got = by_name(recs)
    (outer,), (inner,), (things,), (other,) = (
        got["outer"], got["inner"], got["things"], got["other"])
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.end_ns - inner.start_ns >= 1_000_000
    assert outer.start_ns <= things.start_ns == things.end_ns <= outer.end_ns
    assert (outer.n, things.n) == (1, 3)
    assert outer.thread == inner.thread == threading.get_ident()
    assert other.thread != outer.thread
    assert spans.totals()["things"] == (0, 3)
    report = spans.report()
    assert report["things"] == {"count": 3}
    assert report["outer"]["calls"] == 1
    assert report["outer"]["total_s"] >= report["inner"]["total_s"] > 0


def test_ring_keeps_the_newest_and_says_how_many_dropped():
    for i in range(spans.RING + 5):
        spans.count("c")
    recs, dropped = spans.snapshot()
    assert len(recs) == spans.RING and dropped == 5
    assert spans.totals()["c"] == (0, spans.RING + 5)


def test_fine_spans_are_shared_no_ops_without_a_profiler():
    assert not spans.profiling()
    a, b = spans.fine("a"), spans.fine("b")
    assert a is b
    with a:
        with b:
            pass
    assert spans.snapshot() == ([], 0) and spans.totals() == {}


def test_coarse_spans_are_profiler_ranges_on_the_documented_clock():
    with spans.span("before"):           # no profiler: no mark
        pass
    assert not spans.clock_marks
    for session in range(2):
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
        assert spans.profiling()
        for _ in range(5):
            with spans.span("coarse"):
                time.sleep(0.002)
                with spans.fine("fine"):
                    pass
        prof.stop()
        # one mark a session, the next taken after a span without one
        with spans.span("between"):
            pass
        assert len(spans.clock_marks) == session + 1
        events = by_name(prof.events())
        assert len(events["fine"]) == 5
        offset = (events[spans.CLOCK][0].time_range.start
                  - spans.clock_marks[-1] / 1e3)
        ring = by_name(spans.snapshot()[0])["coarse"][-5:]
        assert len(events["coarse"]) == 5
        durations, starts = [], []
        for rec, ev in zip(ring, sorted(events["coarse"],
                                        key=lambda e: e.time_range.start)):
            durations.append(abs(ev.time_range.elapsed_us()
                                 - (rec.end_ns - rec.start_ns) / 1e3))
            starts.append(abs(ev.time_range.start
                              - (rec.start_ns / 1e3 + offset)))
        # the median: a busy host may preempt one span between its two
        # clocks' readings
        assert np.median(durations) < 50 and np.median(starts) < 50


def _raw_batch(rng, B=3, S=4800, L=6):
    lens = np.asarray([S, S - 700, S - 1500][:B], np.int32)
    sig = np.zeros((B, S), np.float32)
    for i, n in enumerate(lens):
        sig[i, :n] = 0.1 * rng.standard_normal(n)
    ys = rng.integers(3, 29, (B, L)).astype(np.int32)
    ys[:, -1] = 2
    return tuple(map(torch.from_numpy, (sig, lens, ys,
                                        np.full((B,), L, np.int32))))


PHASES = ("train.step", "train.featurize", "las.listener", "las.speller",
          "train.backward", "train.optimizer")


def test_one_train_step_records_each_phase_once(rng):
    cfg = tiny_cfg(audio_shards=True)
    ts = trainer.create_train_state(cfg, CPU)
    batch = _raw_batch(rng)
    spans.reset()
    trainer.train_step(ts, batch, cfg)
    got = by_name(spans.snapshot()[0])
    assert all(len(got[name]) == 1 for name in PHASES), sorted(got)
    assert "train.allreduce" not in got          # one process: no group
    (steps,) = got["las.speller.steps"]
    assert steps.n == batch[2].shape[1]
    # rows x padded encoder frames x 2 directions a BiRNN layer, from the
    # shapes: the cnn listener's layers run at time / 4
    (frames,) = got["las.listener.rnn_frames"]
    half = lambda n: (n + 1) // 2
    T = (batch[0].shape[1] - 400) // 160
    assert frames.n == 2 * 3 * half(half(T)) * cfg.num_enc_layers
    (lis,) = got["las.listener"]
    assert lis.start_ns <= frames.start_ns <= lis.end_ns
    (step,) = got["train.step"]
    for name in PHASES[1:] + ("las.speller.steps",
                              "las.listener.rnn_frames"):
        (r,) = got[name]
        assert step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns
    # the five phases do not overlap
    inner = sorted((got[n][0].start_ns, got[n][0].end_ns)
                   for n in PHASES[1:])
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))


def test_train_cli_traces_and_logs_the_spans(tmp_path, rng, capsys):
    """--profile_dir's trace holds the coarse spans as ranges, the fine
    decoder steps and the clock mark the log line names; the logging
    steps' lines give the phases' ms a step, the last line their totals."""
    d = str(tmp_path)
    cli_shards(d, rng)
    ts, _ = train_cli.main(cli_args(d) + ["--epoch", "1",
                                          "--steps_per_epoch", "11",
                                          "--profile_dir", d + "/prof"])
    assert ts.step == 11
    trace = json.load(open(d + "/prof/trace.json"))["traceEvents"]
    names = {e.get("name") for e in trace}
    assert set(PHASES) | {"las.speller.step", spans.CLOCK} <= names
    out = capsys.readouterr().out
    mark = spans.clock_marks[-1]
    assert f"spans clock mark {mark} ns" in out
    step10 = next(line for line in out.splitlines() if "step 10/11" in line)
    assert "steps/s) ms a step: " in step10
    assert all(f"{name} " in step10 for name in PHASES)
    last = out.splitlines()[-1]
    assert "done at step 11; timers:" in last and "'train.step': {" in last
    assert "'train.checkpoint': {'total_s'" in last
    # the CPU runs the eager loop: no decoder step of a graph replay
    assert "speller graphs replayed 0 of " in last
    assert "decoder steps (0.0 %), 0 captures" in last
    frames = int(last.rsplit("listener BiRNN frame-steps ", 1)[1].split()[0])
    assert frames > 0
    # the CPU's BiRNNs run no LSTM kernel
    assert f"frame-steps {frames} (0 through the LSTM kernels, 0.0 %)" in last


def test_a_greedy_recognizer_call_records_its_layers():
    cfg = tiny_cfg()
    model = las.init(cfg, torch.Generator().manual_seed(0), CPU)
    with Recognizer(model, cfg, CharEncoder(), "cpu") as rec:
        spans.reset()
        sig = (np.random.default_rng(1).standard_normal(6000) * 0.1
               ).astype(np.float32)
        rec.transcribe_signals([sig, sig[:4000]])
    got = by_name(spans.snapshot()[0])
    for name in ("recognizer.featurize", "las.listener", "las.speller"):
        assert len(got[name]) == 1, sorted(got)
    assert got["las.speller.steps"][0].n >= 1


def _beam_inputs(cfg, seed=4, T=32, lens=(32, 23)):
    model = las.init(cfg, torch.Generator().manual_seed(seed), CPU)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lens), T, cfg.feat_dim, 3)).astype(
        np.float32)
    return (model, torch.from_numpy(x), torch.tensor(lens, dtype=torch.int32),
            cfg, max(int(0.3 * T), 1), 4)


@pytest.mark.parametrize("ctc_weight", [0.0, 0.5])
def test_beam_step_scores_rebuild_the_final_scores(ctc_weight):
    cfg = tiny_cfg(ctc=True, ctc_beam_weight=ctc_weight, beam_logprob=True,
                   convert_rate=0.3)
    args = _beam_inputs(cfg)
    plain = beam.beam_search(*args, logprob=True)
    got = beam.beam_search(*args, logprob=True, step_scores=True)
    assert plain.step_scores is None
    assert torch.equal(got.tokens, plain.tokens)
    assert torch.equal(got.lengths, plain.lengths)
    assert torch.equal(got.scores, plain.scores) and got.steps == plain.steps
    terms = got.step_scores
    assert terms.attention.shape == got.tokens.shape
    assert (terms.ctc_prefix is None) == (ctc_weight == 0)
    att = terms.attention.double()
    ctc = (terms.ctc_prefix.double() if terms.ctc_prefix is not None
           else torch.zeros_like(att))
    real = got.scores > beam.NEG / 2
    assert real[:, 0].all()
    w = cfg.ctc_beam_weight
    for b, k in real.nonzero().tolist():
        n = int(got.lengths[b, k])
        total = ((1 - w) * att[b, k, :n] + w * ctc[b, k, :n]).sum()
        want = float(got.scores[b, k])
        assert abs(float(total) / n - want) <= 1e-5 * abs(want), (b, k)
