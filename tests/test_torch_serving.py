"""Port serving (automatic_speech_recognition_torch/serving.py, api.py):
the batcher's routing/bucketing/flush/stop logic on a fake recognizer
(mirroring the CPU-only cases of tests/test_serving.py), and the whole
slice — waveforms -> Recognizer.transcribe_signals — against the JAX
package's extract_features_cfg + eval_forward + convert_idx_to_string,
which must give identical text.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import threading
import time
import types

import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.ops import frontend as jfe
from automatic_speech_recognition_tpu.training import trainer as jtrainer
from automatic_speech_recognition_tpu.utils.formant_synth import synth_phones
from automatic_speech_recognition_tpu.utils.text import convert_idx_to_string
from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.models import las as tlas
from automatic_speech_recognition_torch.parallel import workers
from automatic_speech_recognition_torch.serving import (BatchingRecognizer,
                                                        _Request)
from automatic_speech_recognition_torch.utils.tokenizer import CharEncoder
from test_torch_las import jax_cfg, jax_model, small_cfg

SR = 16000
CPU = torch.device("cpu")


class FakeRecognizer:
    """Routing/batching test double: echoes signal lengths."""

    class _Cfg:
        sample_rate = SR
        max_audio_seconds = 8.0

    cfg = _Cfg()
    pool = types.SimpleNamespace(size=1)     # one inline replica

    def __init__(self):
        self.calls = []  # (n_signals, pad_seconds)
        self.lock = threading.Lock()

    def transcribe_signals(self, signals, beam_size=0, pad_seconds=0):
        with self.lock:
            self.calls.append((len(signals), pad_seconds))
        return [f"len={len(s)}" for s in signals]

    def submit_signals(self, signals, beam_size=0, pad_seconds=0,
                       worker=None):
        return workers.done(lambda: self.transcribe_signals(
            signals, beam_size, pad_seconds))


def test_batcher_routes_results_to_the_right_futures():
    fake = FakeRecognizer()
    with BatchingRecognizer(fake, max_batch=4, max_wait_ms=5) as srv:
        sigs = [np.zeros(SR // 2 + i, np.float32) for i in range(16)]
        futs = [srv.submit(s) for s in sigs]
        texts = [f.result(timeout=10) for f in futs]
    assert texts == [f"len={SR // 2 + i}" for i in range(16)]
    assert all(n == 4 for n, _ in fake.calls)


def test_batcher_buckets_by_length_and_pins_pad_seconds():
    fake = FakeRecognizer()
    with BatchingRecognizer(fake, max_batch=2, max_wait_ms=5,
                            bucket_seconds=(1, 2, 4, 8)) as srv:
        short = [srv.submit(np.zeros(SR // 2, np.float32)) for _ in range(2)]
        long = [srv.submit(np.zeros(3 * SR, np.float32)) for _ in range(2)]
        [f.result(timeout=10) for f in short + long]
    assert sorted(p for _, p in fake.calls) == [1, 4]


def test_batcher_flushes_a_partial_batch_after_max_wait():
    fake = FakeRecognizer()
    with BatchingRecognizer(fake, max_batch=8, max_wait_ms=30) as srv:
        t0 = time.monotonic()
        fut = srv.submit(np.zeros(SR, np.float32))
        assert fut.result(timeout=10) == f"len={SR}"
        waited = time.monotonic() - t0
    assert waited >= 0.02
    assert fake.calls[0][0] == 8


def test_oversize_signal_is_rejected():
    srv = BatchingRecognizer(FakeRecognizer(), bucket_seconds=(1, 2)).start()
    try:
        with pytest.raises(ValueError, match="exceeds the largest bucket"):
            srv.submit(np.zeros(5 * SR, np.float32))
    finally:
        srv.stop()


def test_stop_fails_pending_requests_instead_of_hanging():
    class Slow(FakeRecognizer):
        def transcribe_signals(self, signals, beam_size=0, pad_seconds=0):
            time.sleep(0.2)
            return super().transcribe_signals(signals, beam_size, pad_seconds)

    srv = BatchingRecognizer(Slow(), max_batch=1, max_wait_ms=1).start()
    futs = [srv.submit(np.zeros(SR, np.float32)) for _ in range(4)]
    srv.stop()
    outcomes = []
    for f in futs:
        try:
            outcomes.append(f.result(timeout=5))
        except RuntimeError as e:
            outcomes.append(str(e))
    assert len(outcomes) == 4
    assert all("server stopped" in o or o == f"len={SR}" for o in outcomes)


def test_cancelled_future_does_not_poison_co_riders():
    srv = BatchingRecognizer(FakeRecognizer(), max_batch=4,
                             max_wait_ms=60).start()
    try:
        f_cancel = srv.submit(np.zeros(SR // 2, np.float32))
        assert f_cancel.cancel()
        riders = [srv.submit(np.zeros(SR // 2 + 1 + i, np.float32))
                  for i in range(2)]
        assert [f.result(timeout=10) for f in riders] == \
            [f"len={SR // 2 + 1 + i}" for i in range(2)]
    finally:
        srv.stop()


def test_submit_after_stop_raises_instead_of_hanging():
    srv = BatchingRecognizer(FakeRecognizer()).start()
    srv.stop()
    with pytest.raises(RuntimeError, match="not started"):
        srv.submit(np.zeros(SR, np.float32))


def test_expired_request_beats_a_full_bucket():
    flushed = []

    class Recording(FakeRecognizer):
        def transcribe_signals(self, signals, beam_size=0, pad_seconds=0):
            flushed.append(pad_seconds)
            time.sleep(0.01)
            return super().transcribe_signals(signals, beam_size,
                                              pad_seconds)

    srv = BatchingRecognizer(Recording(), max_batch=2, max_wait_ms=40,
                             bucket_seconds=(1, 4))
    lone = _Request(np.zeros(2 * SR, np.float32), 4)   # oldest, 4 s bucket
    srv._queue.append(lone)
    srv.start()
    try:
        stop_feeding = time.monotonic() + 0.5
        fast = []
        while time.monotonic() < stop_feeding and not lone.future.done():
            fast.append(srv.submit(np.zeros(SR // 2, np.float32)))
            time.sleep(0.002)
        assert lone.future.result(timeout=10) == f"len={2 * SR}"
        for f in fast:
            f.result(timeout=10)
    finally:
        srv.stop()
    assert 4 in flushed


def test_warmup_runs_every_bucket_without_polluting_stats():
    fake = FakeRecognizer()
    srv = BatchingRecognizer(fake, max_batch=2, bucket_seconds=(1, 2))
    srv.warmup()
    assert sorted(fake.calls) == [(2, 1), (2, 2)]
    snap = srv.stats.snapshot()
    assert snap["batches"] == 0 and snap["requests"] == 0


def _signals():
    rng = np.random.default_rng(7)
    words = [["HH", "AH", "L", "OW"], ["S", "IY", "D", "AA", "T", "AH"],
             ["W", "ER", "L", "D"]]
    sigs = [synth_phones(w, rng=rng) for w in words]
    sigs.append((rng.standard_normal(int(SR * 1.7)) * 0.1).astype(np.float32))
    return sigs


def test_slice_matches_jax_end_to_end(rng):
    """Identical transcripts from the port and from JAX on converted
    weights: frontend -> CNN listener -> location speller -> greedy ->
    detokenization."""
    cfg = small_cfg(greedy_eos_margin=0.3)
    params, state = jax_model(cfg, rng)
    tok = CharEncoder()
    sigs = _signals()
    rec = Recognizer(convert.from_jax_params(params, state, cfg, CPU), cfg,
                     tok, CPU)
    got = rec.transcribe_signals(sigs, pad_seconds=2)

    S = 2 * SR
    audio = np.zeros((len(sigs), S), np.float32)
    for i, s in enumerate(sigs):
        audio[i, :len(s)] = s
    lens = np.array([len(s) for s in sigs], np.int32)
    feats, featlen = jfe.extract_features_cfg(audio, lens, jax_cfg(cfg))
    steps = max(int(cfg.convert_rate * feats.shape[1]), 1)
    _, y_hat = jtrainer.eval_forward(params, state, feats, featlen, jax_cfg(cfg),
                                     steps)
    want = [convert_idx_to_string(y, tok.id_to_token, cfg.unit)
            for y in np.asarray(y_hat)]
    assert got == want
    assert any(got)                    # not all empty: the text is compared


def test_real_model_end_to_end_through_the_batcher():
    cfg = small_cfg()
    rec = Recognizer(tlas.init(cfg, torch.Generator().manual_seed(0), CPU),
                     cfg, CharEncoder(), CPU)
    sigs = _signals()[:3]
    with BatchingRecognizer(rec, max_batch=2, max_wait_ms=10,
                            bucket_seconds=(1, 2, 4)) as srv:
        served = [f.result(timeout=120) for f in map(srv.submit, sigs)]
    buckets = [srv._bucket_of(s) for s in sigs]
    for s, b, text in zip(sigs, buckets, served):
        assert text == rec.transcribe_signals([s, s], pad_seconds=b)[0]
    snap = srv.stats.snapshot()
    assert snap["requests"] == 3 and snap["errors"] == 0
    assert snap["batches"] >= 2
