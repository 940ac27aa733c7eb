"""The traffic generator: seeded, reproducible, the same set of sizes and
arrivals for every run seed, and the lengths the mixes describe."""

import numpy as np

from bench_torch import synth, traffic
from bench_torch.harness import ROOT, load_json

CNN = load_json(ROOT / "bench_torch/configs/las_cnn_bpe5k.json")["values"]
PBL = load_json(ROOT / "bench_torch/configs/las_pblstm_chan2016.json")["values"]


def test_sizes_and_arrivals_reproduce():
    mix = traffic.load("serve_greedy")
    a = traffic.arrivals(mix, 30)
    assert np.array_equal(a, traffic.arrivals(mix, 30))
    assert len(a) == round(mix["arrivals"]["rate_per_s"] * 30)
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 30
    s = traffic.sizes(mix, CNN, len(a))
    assert np.array_equal(s, traffic.sizes(mix, CNN, len(a)))


def test_seeds_change_content_not_work():
    mix = traffic.load("train_chars")
    n = traffic.sizes(mix, PBL)
    a = traffic.labels(1, n, mix, PBL)
    b = traffic.labels(2 ** 31 + 5, n, mix, PBL)
    assert [len(x) for x in a] == [len(x) for x in b]
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(traffic.offsets(1, n, 64 * 16000),
                              traffic.offsets(2 ** 31 + 5, n, 64 * 16000))


def test_lognormal_moments():
    mix = traffic.load("serve_greedy")
    secs = traffic.sizes(mix, CNN, 20000) / CNN["sample_rate"]
    assert secs.min() >= 1.3 and secs.max() <= 35.0
    assert abs(np.median(secs) - 5.9) < 0.15
    assert 6.8 < secs.mean() < 7.6          # test-clean: 7.4 s mean


def test_bucket_moments():
    mix = traffic.load("train_chars")
    n = traffic.sizes(mix, PBL)
    per = mix["durations"]["per_bucket"]
    assert len(n) == per * len(PBL["bucket_boundaries_train"])
    assert n.min() >= 1.5 * 16000
    assert abs(n.mean() / 16000 - 12.3) < 0.4
    for i, b in enumerate(PBL["bucket_boundaries_train"]):
        chunk = n[i * per:(i + 1) * per]
        frames = (chunk - 400) // 160
        assert np.all(frames < b)


def test_labels_rate_and_cap():
    mix = traffic.load("train_chars")
    n = traffic.sizes(mix, PBL)
    labels = traffic.labels(9, n, mix, PBL)
    assert all(np.array_equal(a, b)
               for a, b in zip(labels, traffic.labels(9, n, mix, PBL)))
    for ids, k in zip(labels, n):
        assert ids[-1] == 2 and np.all(ids[:-1] > 2)
        assert np.all(ids < PBL["vocab_size"])
        assert len(ids) <= PBL["max_tokenlen_train"]
        if k < 15 * 16000:
            rate = (len(ids) - 1) / (k / 16000)
            assert 10.5 < rate < 13.5


def test_stretch_is_seeded_speech_like():
    a = synth.stretch(5, 4.0)
    assert np.array_equal(a, synth.stretch(5, 4.0))
    assert not np.array_equal(a, synth.stretch(6, 4.0))
    assert a.dtype == np.float32 and len(a) == 64000
    assert 0.4 < np.abs(a).max() <= 0.5 + 1e-6 and a.std() > 0.01
    offs = traffic.offsets(3, np.array([16000, 64000]), len(a))
    assert offs[0] + 16000 <= len(a) and offs[1] == 0
