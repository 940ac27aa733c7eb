"""The port's beam-decoding entry points on the CPU: the decode module over
raw-audio shards and over feature dumps (with and without LM fusion and
joint CTC), the transcribe module over WAV files,
Recognizer.from_checkpoint with an LM directory, BatchingRecognizer with
beam search, and the whole slice -- waveforms -> Recognizer.transcribe_
signals(beam_size > 1) -- against the JAX package on converted weights.
The LAS checkpoint is written by the port's trainer, the LM directory by
models/char_rnn.save_lm_dir."""

import os

import jax
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.data import audio_io, shards
from automatic_speech_recognition_tpu.decoding import beam as jbeam
from automatic_speech_recognition_tpu.models import char_rnn as jcr
from automatic_speech_recognition_tpu.ops import frontend as jfe
from automatic_speech_recognition_tpu.utils.text import convert_idx_to_string
from automatic_speech_recognition_torch import decode as decode_cli
from automatic_speech_recognition_torch import train as train_cli
from automatic_speech_recognition_torch import transcribe as transcribe_cli
from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.models import char_rnn as tcr
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.ops import frontend
from automatic_speech_recognition_torch.serving import BatchingRecognizer
from automatic_speech_recognition_torch.utils.tokenizer import CharEncoder

from test_torch_las import jax_cfg, jax_model, small_cfg

SR = 16000
CPU = torch.device("cpu")
TEXTS = ["AB CD", "HELLO", "A B", "SPEECH", "HI", "OK GO"]
MODEL_FLAGS = ["--unit", "char", "--feat_dim", "13", "--audio_shards",
               "True", "--enc_units", "16", "--num_enc_channels", "4",
               "--num_enc_layers", "1", "--dec_units", "16",
               "--num_dec_layers", "1", "--embedding_size", "8",
               "--attention_size", "8", "--mode", "loc",
               "--loc_kernel_size", "5", "--loc_num_channels", "2",
               "--ctc", "True", "--convert_rate", "0.12"]


def _records(rng, n):
    tok = CharEncoder()
    sigs = [(rng.standard_normal(int(rng.integers(int(0.3 * SR),
                                                  int(0.7 * SR)))) * 0.1)
            .astype(np.float32) for _ in range(n)]
    ids = [np.asarray(tok.encode(TEXTS[i % len(TEXTS)], with_eos=True),
                      np.int32) for i in range(n)]
    return sigs, ids


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Raw-audio train and dev shards, a port checkpoint after 2 steps of
    the port's trainer, and an LM directory (lstm 2 x 16, one-hot, the
    28-token char vocabulary)."""
    d = str(tmp_path_factory.mktemp("decode"))
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("dev", 6)):
        sigs, ids = _records(rng, n)
        shards.write_shard(os.path.join(d, f"{split}-0.arsh"),
                           [s[:, None, None] for s in sigs], ids)
    train_cli.main(["--device", "cpu"] + MODEL_FLAGS + [
        "--dropout_rate", "0.0", "--scheduled_sampling", "False",
        "--shard_dir", d, "--save_dir", d + "/model",
        "--summary_dir", d + "/summary", "--bucket_boundaries_train",
        "128", "--bucket_batch_sizes", "4", "--max_tokenlen_train", "12",
        "--epoch", "1", "--steps_per_epoch", "2"])
    lm_cfg = tcr.LMConfig(vocab_size=28, hidden_size=16, num_layers=2,
                          model="lstm")
    tcr.save_lm_dir(d + "/lm", tcr.init(lm_cfg, torch.Generator()
                                        .manual_seed(1), CPU), lm_cfg)
    return d


def _decode(d, capsys, *extra):
    wer = decode_cli.main(["--device", "cpu"] + MODEL_FLAGS + [
        "--shard_dir", d, "--feat_dir", d + "/no_feats", "--split", "dev",
        "--save_dir", d + "/model", "--log_dir", d + "/log",
        "--lm_dir", d + "/lm", "--beam_size", "3", "--beam_logprob", "True",
        "--decode_batch", "4", "--decode_pad_quantum", "32",
        "--report_cer", "True"] + list(extra))
    out = capsys.readouterr().out
    assert f"WER: {wer:.4f}" in out and "CER: " in out
    preds = open(d + "/log/decode_pred.txt").read().split("\n")
    refs = open(d + "/log/decode_gt.txt").read().split("\n")
    assert len(preds) == len(refs) == 6
    assert sorted(refs) == sorted(TEXTS)
    return wer, preds


@pytest.mark.parametrize("extra", [
    (),
    ("--apply_lm", "True", "--lm_weight", "0.5"),
    ("--ctc_beam_weight", "0.5"),
    ("--apply_lm", "True", "--ctc_beam_weight", "0.5"),
])
def test_decode_over_raw_audio_shards(assets, capsys, extra):
    wer, _ = _decode(assets, capsys, *extra)
    assert np.isfinite(wer)


def test_decode_over_feature_dumps_equals_raw_audio(assets, capsys,
                                                    tmp_path):
    """preprocess.py's dumps ({split}-feats.npy + {split}-chars.npy) of
    the same utterances decode to the same hypotheses."""
    r = shards.ShardReader(os.path.join(assets, "dev-0.arsh"))
    recs = [r.record(i) for i in range(len(r))]
    feats = frontend.extract_features_list(
        [np.asarray(f, np.float32).reshape(-1) for f, _ in recs],
        small_cfg(feat_dim=13), CPU)
    dumps = np.empty(len(recs), object)
    chars = np.empty(len(recs), object)
    for i, (f, (_, t)) in enumerate(zip(feats, recs)):
        dumps[i], chars[i] = f, np.asarray(t)
    np.save(tmp_path / "dev-feats.npy", dumps, allow_pickle=True)
    np.save(tmp_path / "dev-chars.npy", chars, allow_pickle=True)
    _, want = _decode(assets, capsys)
    _, got = _decode(assets, capsys, "--feat_dir", str(tmp_path),
                     "--audio_shards", "False")
    assert got == want


def test_decode_refuses_what_it_cannot_honour(assets, capsys):
    with pytest.raises(NotImplementedError, match="item 12"):
        _decode(assets, capsys, "--num_partitions", "2")
    # int8 decoder weights are ported: the flag runs
    wer, _ = _decode(assets, capsys, "--quantize_decoder", "int8")
    assert np.isfinite(wer)
    with pytest.raises(ValueError, match="--beam_logprob True"):
        _decode(assets, capsys, "--ctc_beam_weight", "0.5",
                "--beam_logprob", "False")
    with pytest.raises(ValueError, match="--ctc True"):
        _decode(assets, capsys, "--ctc_beam_weight", "0.5", "--ctc",
                "False")


def _wavs(d, rng):
    paths = []
    for i, seconds in enumerate((0.6, 1.1)):
        p = os.path.join(d, f"utt{i}.wav")
        audio_io.write_wav(p, (rng.standard_normal(int(seconds * SR)) * 0.1)
                           .astype(np.float32), SR)
        paths.append(p)
    return paths


def test_transcribe_two_wavs(assets, tmp_path, rng):
    paths = _wavs(str(tmp_path), rng)
    out = str(tmp_path / "out.tsv")
    texts = transcribe_cli.main(
        [str(tmp_path), "--device", "cpu"] + MODEL_FLAGS + [
            "--save_dir", assets + "/model", "--beam_size", "3",
            "--beam_logprob", "True", "--apply_lm", "True",
            "--lm_dir", assets + "/lm", "--output", out])
    lines = open(out).read().splitlines()
    assert [line.split("\t")[0] for line in lines] == paths
    cfg = transcribe_cli.parse([paths[0]] + MODEL_FLAGS + [
        "--beam_logprob", "True"])[0]
    rec = Recognizer.from_checkpoint(assets + "/model", cfg,
                                     lm_dir=assets + "/lm", device="cpu")
    assert texts == rec.transcribe(paths, beam_size=3)
    assert [line.split("\t")[1] for line in lines] == texts


def test_from_checkpoint_with_an_lm_dir(assets, rng):
    cfg = transcribe_cli.parse(["x.wav"] + MODEL_FLAGS + [
        "--beam_logprob", "True", "--lm_weight", "0.5"])[0]
    rec = Recognizer.from_checkpoint(assets + "/model", cfg,
                                     lm_dir=assets + "/lm", device="cpu")
    assert rec.lm is not None and rec.lm_cfg.num_layers == 2
    assert rec.cfg.vocab_size == 30
    sigs = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32)
            for s in (0.4, 0.9)]
    texts = rec.transcribe_signals(sigs, beam_size=3)
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
    # int8 decoder weights are ported: the speller's cells and the LM's
    # come back quantized, and the recognizer transcribes
    q = Recognizer.from_checkpoint(assets + "/model",
                                   cfg.replace(quantize_decoder="int8"),
                                   lm_dir=assets + "/lm", device="cpu")
    assert q.model.speller.cells[0].q.dtype == torch.int8
    assert q.lm.cells[0].q.dtype == torch.int8
    assert all(isinstance(t, str)
               for t in q.transcribe_signals(sigs, beam_size=3))
    with pytest.raises(FileNotFoundError):
        Recognizer.from_checkpoint(assets + "/nothing", cfg, device="cpu")


def test_batching_recognizer_with_beam_search(assets, rng):
    cfg = transcribe_cli.parse(["x.wav"] + MODEL_FLAGS + [
        "--beam_logprob", "True"])[0]
    rec = Recognizer.from_checkpoint(assets + "/model", cfg, device="cpu")
    sigs = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32)
            for s in (0.5, 1.5, 0.7)]
    with BatchingRecognizer(rec, max_batch=2, max_wait_ms=10, beam_size=4,
                            bucket_seconds=(1, 2)) as srv:
        served = [f.result(timeout=120) for f in map(srv.submit, sigs)]
    for s, text in zip(sigs, served):
        b = srv._bucket_of(s)
        assert text == rec.transcribe_signals([s, s], beam_size=4,
                                              pad_seconds=b)[0]
    snap = srv.stats.snapshot()
    assert snap["requests"] == 3 and snap["errors"] == 0


@pytest.mark.parametrize("joint", [False, True])
def test_slice_matches_jax_end_to_end(rng, joint):
    """Identical beam transcripts from the port and from JAX on converted
    weights: frontend -> listener -> beam search with LM fusion (and joint
    CTC) -> rank 0 -> detokenization."""
    cfg = small_cfg(beam_logprob=True, lm_weight=0.5, ctc=joint,
                    ctc_beam_weight=0.5 if joint else 0.0)
    params, state = jax_model(cfg, rng)
    # a later <EOS>, so the transcripts compared are not empty
    params["speller"]["out"]["b"][2] -= 2.0
    if joint:
        params["speller"]["ctc_head"]["b"][2] -= 2.0
    lm_kw = dict(vocab_size=28, hidden_size=16, num_layers=2, model="lstm")
    lm_params = jax.tree_util.tree_map(
        np.asarray, jcr.lm_init(jax.random.PRNGKey(3), jcr.LMConfig(**lm_kw)))
    tok = CharEncoder()
    sigs = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32)
            for s in (0.5, 0.8, 1.0)]
    lm_cfg = tcr.LMConfig(**lm_kw)
    rec = Recognizer(convert.from_jax_params(params, state, cfg, CPU), cfg,
                     tok, CPU, convert.from_jax_lm_params(lm_params, lm_cfg,
                                                          CPU), lm_cfg)
    got = rec.transcribe_signals(sigs, beam_size=4)

    audio = np.zeros((3, SR), np.float32)
    for i, s in enumerate(sigs):
        audio[i, :len(s)] = s
    lens = np.array([len(s) for s in sigs], np.int32)
    feats, featlen = jfe.extract_features_cfg(audio, lens, jax_cfg(cfg))
    res = jbeam.beam_search(params, state, feats, featlen, jax_cfg(cfg),
                            max_steps=int(cfg.convert_rate * feats.shape[1]),
                            beam_size=4, logprob=True, lm_params=lm_params,
                            lm_cfg=jcr.LMConfig(**lm_kw))
    toks, tlen = np.asarray(res.tokens), np.asarray(res.lengths)
    want = [convert_idx_to_string(toks[i, 0, :tlen[i, 0]], tok.id_to_token,
                                  cfg.unit) for i in range(3)]
    assert got == want
    assert any(got)


def test_a_missing_gpu_is_refused(assets, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _decode(assets, capsys, "--device", "cuda")
