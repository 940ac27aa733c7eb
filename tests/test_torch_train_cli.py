"""The port's training entry point,
automatic_speech_recognition_torch/train.py, on the CPU: two tiny
raw-audio shards, 4 steps with the frontend inside the step, an epoch
checkpoint, then a resume that continues at step 5."""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import json
import os

import numpy as np
import pytest

from automatic_speech_recognition_tpu.data import shards
from automatic_speech_recognition_torch import train as train_cli
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)
from automatic_speech_recognition_torch.utils.tokenizer import CharEncoder

SR = 16000


def _shards(d, rng):
    """Two shards of 8 waveforms, 0.3-0.6 s, stored (S, 1, 1)."""
    tok = CharEncoder()
    texts = ["AB CD", "HELLO", "A B", "SPEECH"]
    for k in range(2):
        sigs, tokens = [], []
        for i in range(8):
            S = int(rng.integers(int(0.3 * SR), int(0.6 * SR)))
            sigs.append((rng.standard_normal(S) * 0.1)
                        .astype(np.float32)[:, None, None])
            tokens.append(np.asarray(tok.encode(texts[i % 4],
                                                with_eos=True), np.int32))
        shards.write_shard(os.path.join(d, f"train-{k}.arsh"), sigs, tokens)


def _args(d):
    return ["--device", "cpu", "--unit", "char", "--feat_dim", "13",
            "--audio_shards", "True", "--enc_units", "16",
            "--num_enc_channels", "4", "--num_enc_layers", "1",
            "--dec_units", "16", "--num_dec_layers", "1",
            "--embedding_size", "8", "--attention_size", "8",
            "--mode", "loc", "--loc_kernel_size", "5",
            "--loc_num_channels", "2", "--dropout_rate", "0.0",
            "--scheduled_sampling", "False", "--ctc", "True",
            "--shard_dir", d, "--save_dir", d + "/model",
            "--summary_dir", d + "/summary",
            "--bucket_boundaries_train", "64,128",
            "--bucket_batch_sizes", "4,4", "--max_tokenlen_train", "12"]


def test_train_four_steps_then_resume(tmp_path, rng):
    d = str(tmp_path)
    _shards(d, rng)
    ts, hist = train_cli.main(_args(d) + ["--epoch", "1",
                                          "--steps_per_epoch", "4"])
    assert ts.step == 4 and len(hist["loss"]) == 4
    assert np.all(np.isfinite(hist["loss"]))
    assert np.all(np.isfinite(hist["grad_norm"]))
    assert CheckpointManager(d + "/model").all_epochs() == [1]
    assert json.load(open(d + "/model/config.json"))["audio_shards"]
    events = [json.loads(line) for line in open(d + "/summary/events.jsonl")]
    assert {e["tag"] for e in events} >= {"train/loss", "train/lr"}
    # resume: epoch 1 restores, epoch 2 runs steps 5-8
    ts2, hist2 = train_cli.main(_args(d) + ["--epoch", "2",
                                            "--steps_per_epoch", "4"])
    assert ts2.step == 8 and len(hist2["loss"]) == 4
    assert CheckpointManager(d + "/model").all_epochs() == [1, 2]
    # contradicting model flags are refused before the directory changes
    with pytest.raises(ValueError, match="different model flags"):
        train_cli.main(_args(d) + ["--enc_units", "32"])


def test_profile_dir_and_verbose_logging(tmp_path, rng):
    """--profile_dir traces steps 10-20 with torch.profiler (here the run
    ends at 11, so the trace closes early); --verbose logs the decoded
    sample and its alignment image."""
    d = str(tmp_path)
    _shards(d, rng)
    ts, _ = train_cli.main(_args(d) + ["--epoch", "1",
                                       "--steps_per_epoch", "11",
                                       "--profile_dir", d + "/prof",
                                       "--verbose", "1"])
    assert ts.step == 11
    assert os.path.getsize(d + "/prof/trace.json") > 0
    tags = {json.loads(line)["tag"]
            for line in open(d + "/summary/events.jsonl")}
    assert {"train/hyp", "train/alphas"} <= tags


@pytest.mark.parametrize("flag,value,match", [
    ("--steps_per_dispatch", "2", "Not ported"),
    ("--recycle_after_steps", "5", "Not ported"),
    # tensor parallelism is ported, over one process per partition: in
    # one process it is refused with the command that runs it
    ("--num_partitions", "2", "torchrun --nproc_per_node 2"),
])
def test_tpu_only_flags_are_refused(tmp_path, flag, value, match):
    error = (ValueError if flag == "--num_partitions"
             else NotImplementedError)
    with pytest.raises(error, match=match):
        train_cli.main(_args(str(tmp_path)) + [flag, value])


def test_augmentation_flags_train(tmp_path, rng):
    """The online waveform perturbations and SpecAugment run inside the
    step: the loader buckets by the slowest rate's length, and the losses
    stay finite."""
    d = str(tmp_path)
    _shards(d, rng)
    ts, hist = train_cli.main(_args(d) + [
        "--epoch", "1", "--steps_per_epoch", "3",
        "--online_speed_perturb", "True", "--online_volume_perturb", "True",
        "--online_noise_perturb", "True", "--online_noise_kind", "pink",
        "--spec_augment", "True"])
    assert ts.step == 3 and np.all(np.isfinite(hist["loss"]))
    assert np.all(np.isfinite(hist["grad_norm"]))


def test_a_missing_gpu_is_refused(tmp_path, monkeypatch):
    """--device cuda on a host without CUDA raises; it never trains on the
    CPU instead."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a if a != "cpu" else "cuda" for a in _args(str(tmp_path))]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(args)
