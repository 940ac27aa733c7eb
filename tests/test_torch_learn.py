"""The port learns to a WER: tests/test_end_to_end_learn.py's gates on the
port's own path -- frontend (the plain version on the CPU) -> trainer.
train_step -> trainer.eval_forward (greedy) and decoding/beam.beam_search
-> WER -- and tests/test_edge_cases.py's five cases on the port.

Same corpora, configurations, step counts and limits as the JAX tests:
the tone language must reach greedy and beam WER < 0.30 after 400 steps
with the loss under 0.15x its first value; the formant-synthesized speech
loss must fall to 0.35x its first in 70 steps.  The port's weights come
from its own init (the JAX distributions, not JAX's draws), so the runs
are the same experiment, not the same numbers.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import numpy as np
import torch

from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.decoding import beam as beam_lib
from automatic_speech_recognition_torch.models import las
from automatic_speech_recognition_torch.ops import frontend
from automatic_speech_recognition_torch.training import trainer
from automatic_speech_recognition_torch.utils import formant_synth as fsyn
from automatic_speech_recognition_torch.utils.text import (corpus_wer,
                                                          edit_distance)
from automatic_speech_recognition_torch.utils.tokenizer import CharEncoder

from test_end_to_end_learn import CHARS, synth
from test_edge_cases import TINY

CPU = torch.device("cpu")


def _labels(texts, width):
    tok = CharEncoder()
    ys = np.zeros((len(texts), width), np.int32)
    yslen = np.zeros((len(texts),), np.int32)
    for i, t in enumerate(texts):
        ids = tok.encode(t, with_eos=True)
        ys[i, :len(ids)] = ids
        yslen[i] = len(ids)
    return torch.from_numpy(ys), torch.from_numpy(yslen)


def _pad(sigs):
    audio = np.zeros((len(sigs), max(map(len, sigs))), np.float32)
    for i, s in enumerate(sigs):
        audio[i, :len(s)] = s
    return (torch.from_numpy(audio),
            torch.tensor([len(s) for s in sigs], dtype=torch.int32))


def test_pipeline_learns_tone_language():
    rng = np.random.default_rng(7)
    texts, sigs = [], []
    for _ in range(24):
        text = " ".join(rng.choice(CHARS, int(rng.integers(2, 5))))
        texts.append(text)
        sigs.append(synth(text, rng))
    tok = CharEncoder()
    cfg = Config(unit="char", vocab_size=30, feat_dim=13, feat_type="mfcc",
                 cmvn=True, enc_type="cnn", enc_units=32,
                 num_enc_channels=8, num_enc_layers=1, dec_units=32,
                 num_dec_layers=1, embedding_size=16, attention_size=16,
                 mode="add", dropout_rate=0.0, label_smoothing=False,
                 lr=3e-3, scheduled_sampling=True, warmup_step=100,
                 max_step=250, min_rate=0.5)
    feats, featlen = frontend.extract_features_cfg(*_pad(sigs), cfg)
    L = 12
    batch = (feats, featlen, *_labels(texts, L))

    ts = trainer.create_train_state(cfg, CPU)
    losses = [trainer.train_step(ts, batch, cfg)["loss"].item()
              for _ in range(400)]
    assert losses[-1] < 0.15 * losses[0], (losses[0], losses[-1])

    _, y_hat = trainer.eval_forward(ts.model, feats, featlen, cfg, L)
    hyps = [tok.decode(list(y.numpy())) for y in y_hat]
    wer_greedy = corpus_wer(texts, hyps)

    res = beam_lib.beam_search(
        ts.model, feats, featlen,
        cfg.replace(convert_rate=float(L) / feats.shape[1]), max_steps=L,
        beam_size=3)
    hyps_beam = [tok.decode(list(res.tokens[i, 0, :res.lengths[i, 0]]
                                 .numpy())) for i in range(len(texts))]
    wer_beam = corpus_wer(texts, hyps_beam)
    assert wer_greedy < 0.30, (wer_greedy, hyps[:5], texts[:5])
    assert wer_beam < 0.30, (wer_beam, hyps_beam[:5], texts[:5])


def test_synth_speech_learnability():
    words = {"GO": "G OW", "UP": "AH P", "RED": "R EH D", "SEA": "S IY"}
    names = list(words)
    g = np.random.default_rng(0)
    texts, sigs = [], []
    for i in range(12):
        pair = (names[i % 4], names[(i // 4 + 1) % 4])
        texts.append(" ".join(pair))
        phones = words[pair[0]].split() + ["SP"] + words[pair[1]].split()
        sigs.append(fsyn.synth_phones(phones, fsyn.Speaker(), g))
    feats, featlen = frontend.extract_features(*_pad(sigs), feat_dim=8)
    cfg = Config(unit="char", vocab_size=30, feat_dim=8, enc_type="cnn",
                 enc_units=16, num_enc_channels=4, num_enc_layers=1,
                 dec_units=16, num_dec_layers=1, embedding_size=8,
                 attention_size=8, mode="add", dropout_rate=0.0,
                 scheduled_sampling=False, label_smoothing=False, lr=5e-3)
    batch = (feats, featlen, *_labels(texts, 10))
    ts = trainer.create_train_state(cfg, CPU)
    losses = [trainer.train_step(ts, batch, cfg)["loss"].item()
              for _ in range(70)]
    assert losses[-1] < 0.35 * losses[0], (losses[0], losses[-1])


# ---- tests/test_edge_cases.py on the port


def test_zero_length_utterance_stays_finite(rng):
    cfg = Config(**TINY)
    model = las.init(cfg, torch.Generator().manual_seed(0), CPU)
    audio = torch.from_numpy(rng.standard_normal((2, 16, 8, 3))
                             .astype(np.float32))
    logits, _ = trainer.eval_forward(model, audio, torch.tensor([16, 0]),
                                     cfg, 4)
    assert torch.isfinite(logits).all()


def test_frontend_shorter_than_frame(rng):
    audio = torch.from_numpy(rng.standard_normal((1, 1000))
                             .astype(np.float32))
    feats, featlen = frontend.extract_features(audio, torch.tensor([200]),
                                               feat_dim=8)
    assert int(featlen[0]) == 0
    assert torch.isfinite(feats).all()


def test_beam_single_step(rng):
    cfg = Config(**TINY, convert_rate=0.001)   # the step budget clamps to 1
    model = las.init(cfg, torch.Generator().manual_seed(0), CPU)
    audio = torch.from_numpy(rng.standard_normal((1, 16, 8, 3))
                             .astype(np.float32))
    res = beam_lib.beam_search(model, audio, torch.tensor([16]), cfg,
                               max_steps=3, beam_size=2)
    assert int(res.lengths[0, 0]) >= 1
    assert np.isfinite(float(res.scores[0, 0]))


def test_empty_hypothesis_wer():
    d, n = edit_distance(["A", "B"], [""])
    assert n == 2 and d >= 1
    assert corpus_wer(["A B"], [""]) > 0


def test_tokenizer_empty_string():
    tok = CharEncoder()
    assert tok.encode("", with_eos=True) == [2]
    assert tok.decode([2]) == ""
