"""The port's recipe chain at fixture scale, stage by stage beside the JAX
package's CLIs on the same inputs: train_subword -> preprocess ->
create_shards -> train -> test (attention and ctc_greedy) -> train_lm ->
sample_lm -> decode --apply_lm, all on the CPU.

Held to the JAX side:
- the BPE files (and corpus_all.txt): identical;
- preprocess's feature dumps: the same files, token dumps equal, features
  within rtol 1e-4 / atol 1e-4 (float32 frontends, the JAX one through
  its Pallas kernel in interpret mode, sums in another order), speed
  dumps and raw-waveform dumps equal;
- create_shards from the same dumps: byte-identical shards;
- the root test.py over a JAX checkpoint built by convert.to_jax_params
  from the port's trained weights: the same test_pred.txt and WER as the
  port's test (greedy ids compared exactly).
"""

import filecmp
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import create_shards as jax_create_shards
import preprocess as jax_preprocess
import test as jax_test
import train_subword as jax_train_subword
from automatic_speech_recognition_tpu.config import parse_args as jparse
from automatic_speech_recognition_tpu.training import trainer as jtrainer
from automatic_speech_recognition_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from automatic_speech_recognition_torch import create_shards, decode
from automatic_speech_recognition_torch import preprocess, sample_lm
from automatic_speech_recognition_torch import test as test_cli
from automatic_speech_recognition_torch import train, train_lm, train_subword
from automatic_speech_recognition_torch.config import parse_args
from automatic_speech_recognition_torch.data.audio_io import write_wav
from automatic_speech_recognition_torch.models import convert, las
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)

SR = 16000
WORDS = ["GO", "STOP", "LEFT", "RIGHT", "UP", "DOWN", "YES", "NO"]
MODEL = ["--unit", "char", "--feat_dim", "13", "--enc_units", "16",
         "--num_enc_channels", "4", "--num_enc_layers", "1",
         "--dec_units", "16", "--num_dec_layers", "1",
         "--embedding_size", "8", "--attention_size", "8", "--mode", "loc",
         "--loc_kernel_size", "5", "--loc_num_channels", "2", "--ctc", "True",
         "--convert_rate", "0.12"]


def _write_split(root, name, n, rng, spk):
    d = os.path.join(root, name, str(spk), "10")
    os.makedirs(d)
    lines = []
    for u in range(n):
        uid = f"{spk}-10-{u:04d}"
        lines.append(f"{uid} {' '.join(rng.choice(WORDS, 2))}'S")
        write_wav(os.path.join(d, f"{uid}.wav"),
                  rng.standard_normal(int(SR * rng.uniform(0.3, 0.8))) * 0.1,
                  SR)
    with open(os.path.join(d, f"{spk}-10.trans.txt"), "w") as f:
        f.write("\n".join(lines))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A LibriSpeech-layout corpus of WAVs: 12 train, 6 dev utterances."""
    r = str(tmp_path_factory.mktemp("recipe"))
    rng = np.random.default_rng(0)
    _write_split(r, "train", 12, rng, 1)
    _write_split(r, "dev", 6, rng, 2)
    return r


def corpus_flags(r, feat_dir, shard_dir, *extra):
    return MODEL + [
        "--train_100hr_corpus_dir", f"{r}/train",
        "--train_360hr_corpus_dir", f"{r}/no360",
        "--train_500hr_corpus_dir", f"{r}/no500",
        "--dev_data_dir", f"{r}/dev", "--test_data_dir", f"{r}/notest",
        "--feat_dir", feat_dir, "--shard_dir", shard_dir] + list(extra)


def test_train_subword_files_equal_jax(root):
    for mod, d in ((train_subword, "sub_port"), (jax_train_subword,
                                                 "sub_jax")):
        mod.main(corpus_flags(root, "", "") + ["--subword_dir",
                                                f"{root}/{d}", "--size",
                                                "60"])
    for name in ("corpus_all.txt", "bpe-vocab.json", "bpe-merges.txt"):
        assert filecmp.cmp(f"{root}/sub_port/{name}", f"{root}/sub_jax/{name}",
                           shallow=False), name
    assert len(open(f"{root}/sub_port/corpus_all.txt").read().split("\n")) \
        == 12


@pytest.fixture(scope="module")
def dumps(root):
    """preprocess by both packages: features with speed augmentation
    (feats_port, feats_jax) and raw waveforms (raw_port, raw_jax)."""
    for mod, tag, dev in ((preprocess, "port", ["--device", "cpu"]),
                          (jax_preprocess, "jax", [])):
        mod.main(dev + corpus_flags(root, f"{root}/feats_{tag}", "",
                                    "--augmentation", "True"))
        mod.main(dev + corpus_flags(root, f"{root}/raw_{tag}", "",
                                    "--audio_shards", "True",
                                    "--augmentation", "True"))
    return root


def test_preprocess_dumps_match_jax(dumps):
    r = dumps
    for kind in ("feats", "raw"):
        names = sorted(os.listdir(f"{r}/{kind}_port"))
        assert names == sorted(os.listdir(f"{r}/{kind}_jax"))
        assert "speed_0.9_train-100-feats.npy" in names
        for name in names:
            got = np.load(f"{r}/{kind}_port/{name}", allow_pickle=True)
            want = np.load(f"{r}/{kind}_jax/{name}", allow_pickle=True)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            if got.dtype != object:
                np.testing.assert_array_equal(got, want, err_msg=name)
                continue
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape, name
                if kind == "feats" and "-feats" in name:
                    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                               err_msg=name)
                else:
                    np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def shards(dumps):
    r = dumps
    for kind in ("feats", "raw"):
        extra = ["--audio_shards", "True"] if kind == "raw" else []
        for mod, tag in ((create_shards, "port"), (jax_create_shards, "jax")):
            mod.main(corpus_flags(r, f"{r}/{kind}_port",
                                  f"{r}/shards_{kind}_{tag}",
                                  "--records_per_shard", "16", *extra))
    return r


def test_create_shards_byte_identical(shards):
    r = shards
    for kind in ("feats", "raw"):
        names = sorted(os.listdir(f"{r}/shards_{kind}_port"))
        assert names == sorted(os.listdir(f"{r}/shards_{kind}_jax"))
        assert "dev-1.arsh" in names and "train-3.arsh" in names
        for name in names:
            assert filecmp.cmp(f"{r}/shards_{kind}_port/{name}",
                               f"{r}/shards_{kind}_jax/{name}",
                               shallow=False), name


TRAIN = ["--dropout_rate", "0.0", "--scheduled_sampling", "False",
         "--bucket_boundaries_train", "96", "--bucket_batch_sizes", "6",
         "--bucket_boundaries_eval", "96", "--max_tokenlen_train", "32",
         "--max_tokenlen_eval", "32", "--lr", "1e-2"]


@pytest.fixture(scope="module")
def model(shards):
    """The port's trainer over the raw-audio shards (speed-augmented sets
    included), 6 steps with every online perturbation and SpecAugment."""
    r = shards
    train.main(["--device", "cpu"] + corpus_flags(
        r, "", f"{r}/shards_raw_port", "--audio_shards", "True",
        "--save_dir", f"{r}/model", "--summary_dir", f"{r}/summary",
        "--epoch", "1", "--steps_per_epoch", "6",
        "--online_speed_perturb", "True", "--online_volume_perturb", "True",
        "--online_noise_perturb", "True", "--spec_augment", "True") + TRAIN)
    return r


def _eval_flags(r, decoder, log_dir, save_dir):
    return corpus_flags(r, "", f"{r}/shards_raw_port", "--audio_shards",
                        "True", "--split", "dev", "--save_dir", save_dir,
                        "--log_dir", log_dir, "--eval_decoder", decoder,
                        "--report_cer", "True") + TRAIN


@pytest.mark.parametrize("decoder", ["attention", "ctc_greedy"])
def test_test_matches_the_root_test_py(model, decoder, capsys):
    r = model
    res = test_cli.main(["--device", "cpu"] + _eval_flags(
        r, decoder, f"{r}/log_port_{decoder}", f"{r}/model"))
    out = capsys.readouterr().out
    assert f"WER: {res.wer:.4f}" in out and "CER: " in out
    assert res.utterances == 6 and res.skipped == 0 and res.batches == 1
    preds = open(f"{r}/log_port_{decoder}/test_pred.txt").read()
    assert len(preds.split("\n")) == 6

    # the same weights through the JAX package's test.py
    cfg = parse_args(MODEL).replace(vocab_size=30)
    lasm = CheckpointManager(f"{r}/model").load_weights(las.LAS(cfg))
    params, bn = convert.to_jax_params(lasm)
    jcfg = jparse(MODEL).replace(vocab_size=30)
    jts = jtrainer.create_train_state(jax.random.PRNGKey(0), jcfg)
    jts = jts._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                       bn_state=jax.tree_util.tree_map(jnp.asarray, bn))
    jdir = f"{r}/jax_model_{decoder}"
    ckpt = JaxCheckpointManager(jdir)
    ckpt.save(1, jts)
    ckpt.close()
    want = jax_test.main(_eval_flags(r, decoder, f"{r}/log_jax_{decoder}",
                                     jdir))
    assert open(f"{r}/log_jax_{decoder}/test_pred.txt").read() == preds
    assert open(f"{r}/log_jax_{decoder}/test_gt.txt").read() == \
        open(f"{r}/log_port_{decoder}/test_gt.txt").read()
    assert res.wer == want


def test_test_takes_the_saved_model_flags(model):
    """--use_saved_config reads the model flags from the training run's
    config.json: the same hypotheses without them on the command line."""
    r = model
    res = test_cli.main([
        "--device", "cpu", "--use_saved_config", "True", "--unit", "char",
        "--audio_shards", "True", "--shard_dir", f"{r}/shards_raw_port",
        "--split", "dev", "--save_dir", f"{r}/model",
        "--log_dir", f"{r}/log_saved", "--convert_rate", "0.12"] + TRAIN)
    full = test_cli.main(["--device", "cpu"] + _eval_flags(
        r, "attention", f"{r}/log_full", f"{r}/model"))
    assert res.utterances == 6 and res.skipped == 0 and res.wer == full.wer
    assert open(f"{r}/log_saved/test_pred.txt").read() == \
        open(f"{r}/log_full/test_pred.txt").read()


@pytest.mark.parametrize("flag,value,match", [
    ("--num_partitions", "2", "item 12")])
def test_test_refuses_unported_flags(tmp_path, flag, value, match):
    with pytest.raises(NotImplementedError, match=match):
        test_cli.main(["--device", "cpu", "--shard_dir", str(tmp_path),
                       flag, value])


def test_lm_chain_samples_and_fuses(model, capsys):
    r = model
    corpus = f"{r}/sub_port/corpus_all.txt"
    assert os.path.exists(corpus)     # written by train_subword above
    res = train_lm.main(["--device", "cpu", "--data_file", corpus,
                         "--output_dir", f"{r}/lm", "--num_epochs", "2",
                         "--hidden_size", "16", "--batch_size", "2",
                         "--num_unrollings", "4", "--train_frac", "0.6",
                         "--valid_frac", "0.2",
                         "--learning_rate", "1e-2"])
    assert res["best_model"] in (1, 2) and np.isfinite(res["test_ppl"])
    text = sample_lm.main(["--device", "cpu", "--init_dir", f"{r}/lm",
                           "--start_text", "GO ", "--length", "12"])
    assert text.startswith("GO ") and len(text) == 15
    wer = decode.main(["--device", "cpu"] + corpus_flags(
        r, f"{r}/no_feats", f"{r}/shards_raw_port", "--audio_shards", "True",
        "--split", "dev", "--save_dir", f"{r}/model",
        "--log_dir", f"{r}/log_decode", "--apply_lm", "True",
        "--lm_dir", f"{r}/lm", "--lm_weight", "0.5", "--beam_size", "3",
        "--beam_logprob", "True", "--decode_batch", "6",
        "--decode_pad_quantum", "32"))
    assert np.isfinite(wer) and "RNNLM restored" in capsys.readouterr().out
    assert len(open(f"{r}/log_decode/decode_pred.txt").read()
               .split("\n")) == 6
    assert glob.glob(f"{r}/lm/lang/best_model/*.pt")
