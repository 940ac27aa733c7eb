"""Beam-search decoding of a split with WER (counterpart of the
repository's decode.py, on the same flags).

    python -m automatic_speech_recognition_torch.decode <decode.py's flags> \\
        [--device cuda]

Inputs as decode.py takes them: the feature dumps preprocess.py writes
({split}-feats[-i].npy with {split}-{unit}s.npy) in --feat_dir, else the
ARSH shards {split}-*.arsh in --shard_dir; with --audio_shards True they
hold raw waveforms, featurized on the device (the fused CUDA kernel on a
GPU) by ops/frontend.extract_features_list.  The LAS checkpoint is the
port's (training/checkpoint.py, written by the port's train.py), the
fusion LM (--apply_lm, --lm_dir) a port LM directory
(models/char_rnn.load_lm_dir).  Utterances are sorted by feature length
and decoded --decode_batch at a time, padded to --decode_pad_quantum
frames, by decoding/beam.beam_search; rank 0 is the hypothesis.  Writes
decode_pred.txt and decode_gt.txt to --log_dir (newline-terminated lines,
as test does) and prints `WER: x.xxxx`
(and `CER: x.xxxx` with --report_cer).  --dtype bfloat16 decodes in
bf16, --quantize_decoder int8 with int8 speller (and fusion-LM cell)
weights.  A comma list of devices (--device cuda:0,cuda:1) decodes over
a data axis: a replica of the model and the fusion LM on each, every
batch padded to a multiple of the replicas with 1-frame rows and its rows
split over them (parallel/sharding.py); --device cuda is one GPU.  With
--num_partitions k each run of k devices holds one replica of both, split
column-wise over them (the JAX package's param_spec layout).  Under
torchrun every process decodes the split on its own GPU with the model
whole (--num_partitions is logged and set aside, as in JAX's
multi-process path), and only the primary writes the files.
`batch_iter` is decode.py's,
written again because that module imports JAX.

Tiny CPU run:
  python -m automatic_speech_recognition_torch.decode --device cpu \\
      --unit char --feat_dim 13 --enc_units 16 --dec_units 16 \\
      --audio_shards True --shard_dir /tmp/shards --split dev \\
      --save_dir /tmp/model --log_dir /tmp/log --beam_size 4
"""

from __future__ import annotations

import glob
import logging
import os
import sys
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from automatic_speech_recognition_torch.config import (
    Config, apply_saved_model_config, check_model_config, parse_args)
from automatic_speech_recognition_torch.data.shards import ShardReader
from automatic_speech_recognition_torch.utils.text import (
    convert_idx_to_string, corpus_cer, edit_distance)
from automatic_speech_recognition_torch.utils.tokenizer import get_tokenizer
from automatic_speech_recognition_torch.utils.watchdog import StallWatchdog

from .create_shards import load_cat_feats
from .decoding import beam as beam_lib
from .models import char_rnn
from .models.las import LAS
from .ops import frontend
from .parallel import distributed, sharding
from .parallel.mesh import eval_mesh
from .training.checkpoint import CheckpointManager
from .ops.quant import maybe_quantize, quantize_lm
from .utils.device import disable_tf32, split_device

log = logging.getLogger("decode")


def batch_iter(feats: Sequence[np.ndarray], tokens: Sequence, batch: int,
               pad_quantum: int = 128
               ) -> Iterator[Tuple[np.ndarray, np.ndarray, List]]:
    """(features (b, T, D, C), lengths, token lists) batches in order of
    feature length, T padded up to a multiple of pad_quantum."""
    order = np.argsort([len(f) for f in feats])
    for lo in range(0, len(order), batch):
        idx = order[lo:lo + batch]
        group = [np.asarray(feats[i], np.float32) for i in idx]
        lens = np.asarray([len(g) for g in group], np.int32)
        T = int(-(-int(lens.max()) // pad_quantum) * pad_quantum)
        audio = np.zeros((len(group), T) + group[0].shape[1:], np.float32)
        for r, g in enumerate(group):
            audio[r, :len(g)] = g
        yield audio, lens, [tokens[i] for i in idx]


def load_split(cfg: Config) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(records, token arrays) of cfg.split: feature dumps, else shards."""
    if glob.glob(os.path.join(cfg.feat_dir, f"{cfg.split}-feats*")):
        feats = load_cat_feats(cfg.feat_dir, cfg.split)
        tokens = list(np.load(
            os.path.join(cfg.feat_dir, f"{cfg.split}-{cfg.unit}s.npy"),
            allow_pickle=True))
        return feats, tokens
    shard_files = sorted(glob.glob(
        os.path.join(cfg.shard_dir, f"{cfg.split}-*.arsh")))
    if not shard_files:
        raise FileNotFoundError(
            f"no features for split {cfg.split} in {cfg.feat_dir} and "
            f"no shards in {cfg.shard_dir}; run preprocess.py first")
    feats, tokens = [], []
    for fn in shard_files:
        r = ShardReader(fn)
        for i in range(len(r)):
            f, t = r.record(i)
            feats.append(np.array(f))
            tokens.append(np.array(t))
    log.info("loaded %d records from shards (%s)", len(feats), cfg.shard_dir)
    return feats, tokens


def check_flags(cfg: Config) -> None:
    """Refuse what the port cannot decode; the joint-CTC guards of
    decode.py."""
    if cfg.ctc_beam_weight > 0:
        if not cfg.ctc:
            raise ValueError(
                "--ctc_beam_weight needs --ctc True so the checkpoint's "
                "CTC head is part of the restored parameter structure")
        if not cfg.beam_logprob:
            raise ValueError(
                "--ctc_beam_weight mixes log probabilities; pass "
                "--beam_logprob True")
        log.info("joint CTC/attention decoding, weight %.2f",
                 cfg.ctc_beam_weight)
    elif cfg.ctc:
        log.warning(
            "checkpoint has a CTC head but joint scoring is OFF; the "
            "measured-better decode is --beam_logprob True "
            "--ctc_beam_weight 0.5 (see benchmarks/WER_SYNTH.md)")


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Decode cfg.split; returns its WER."""
    device_name, argv = split_device(argv)
    cfg = parse_args(argv)
    logging.basicConfig(force=True, stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    if cfg.use_saved_config:
        cfg, overridden = apply_saved_model_config(cfg, cfg.save_dir)
        for line in overridden:
            log.info("model flag from training snapshot: %s", line)
    log.info("parameters:\n%s", cfg.to_json())
    check_flags(cfg)
    distributed.maybe_initialize(device_name)
    mesh = eval_mesh(device_name, cfg.num_partitions, cfg.data_axis,
                     cfg.model_axis)
    device, dp = mesh.devices[0], mesh.shape[cfg.data_axis]
    if device.type == "cuda":
        disable_tf32()
    watchdog = (StallWatchdog(cfg.stall_timeout_s, what="decode progress")
                .start() if cfg.stall_timeout_s > 0 else None)

    tokenizer = get_tokenizer(cfg.unit, cfg.subword_dir)
    cfg = cfg.replace(vocab_size=tokenizer.get_vocab_size())
    lm = lm_cfg = None
    if cfg.apply_lm:
        lm, lm_cfg, _, _ = char_rnn.load_lm_dir(cfg.lm_dir, device=device)
        log.info("RNNLM restored from %s", cfg.lm_dir)
        if cfg.unit != "char":
            log.warning("LM fusion assumes char units; unit=%s will fuse "
                        "garbage scores", cfg.unit)

    feats, tokens = load_split(cfg)
    if cfg.audio_shards:
        # raw (S, 1, 1) waveforms: featurize on the device first
        feats = frontend.extract_features_list(
            [np.asarray(f, np.float32).reshape(-1) for f in feats], cfg,
            device)
    log.info("decoding %d utterances (beam %d, lm %s), mesh %s over %s",
             len(feats), cfg.beam_size, cfg.apply_lm, mesh.shape,
             ", ".join(map(str, mesh.devices)))

    for line in check_model_config(cfg, cfg.save_dir):
        log.warning("model flag differs from the training snapshot "
                    "(%s/config.json) -- %s", cfg.save_dir, line)
    model = CheckpointManager(cfg.save_dir).load_weights(LAS(cfg),
                                                         cfg.restore_epoch)
    if model is None:
        raise FileNotFoundError(f"no LAS checkpoint in {cfg.save_dir}")
    model = maybe_quantize(model.to(device).eval(), cfg)
    if lm is not None and cfg.quantize_decoder != "none":
        lm = quantize_lm(lm, lm_cfg)
    replicas = sharding.place_eval_params(mesh, model, lm)

    error, N = 0, 0
    hyps, refs = [], []
    for audio, lens, ys in batch_iter(feats, tokens, cfg.decode_batch,
                                      cfg.decode_pad_quantum):
        max_steps = max(int(cfg.convert_rate * audio.shape[1]), 1)
        pad = sharding.pad_batch_to(len(ys), dp) - len(ys)
        if pad:   # rows of one frame, decoded and dropped
            audio = np.pad(audio, ((0, pad),) + ((0, 0),) * (audio.ndim - 1))
            lens = np.pad(lens, (0, pad), constant_values=1)
        res = sharding.run_replicas(
            mesh, replicas,
            lambda r, f, fl: beam_lib.beam_search(
                r.model, f, fl, cfg, max_steps, cfg.beam_size,
                cfg.beam_logprob, r.lm, lm_cfg),
            (audio, lens))
        toks, tlen = res.tokens.cpu().numpy(), res.lengths.cpu().numpy()
        for b, y in enumerate(ys):
            hyp = convert_idx_to_string(toks[b, 0, :tlen[b, 0]],
                                        tokenizer.id_to_token, cfg.unit)
            ref = convert_idx_to_string(y, tokenizer.id_to_token, cfg.unit)
            dist, n = edit_distance(ref.split(" "), hyp.split(" "))
            error += dist
            N += n
            if cfg.verbose > 0:
                log.info("REF | %s", ref)
                log.info("HYP | %s", hyp)
            hyps.append(hyp)
            refs.append(ref)
        log.info("utt %d/%d, running WER: %.4f", len(hyps), len(feats),
                 error / max(N, 1))
        if watchdog is not None:
            watchdog.pet()
    if watchdog is not None:
        watchdog.stop()

    if distributed.is_primary():
        os.makedirs(cfg.log_dir, exist_ok=True)
        with open(os.path.join(cfg.log_dir, "decode_pred.txt"), "w") as f:
            f.writelines(line + "\n" for line in hyps)
        with open(os.path.join(cfg.log_dir, "decode_gt.txt"), "w") as f:
            f.writelines(line + "\n" for line in refs)
    wer = error / max(N, 1)
    log.info("%s WER: %.4f", cfg.split, wer)
    if cfg.report_cer:
        cer = corpus_cer(refs, hyps)
        log.info("%s CER: %.4f", cfg.split, cer)
        print(f"CER: {cer:.4f}")
    print(f"WER: {wer:.4f}")
    return wer


if __name__ == "__main__":
    from automatic_speech_recognition_torch.utils.platform import \
        exit_for_transient_errors
    try:
        exit_for_transient_errors(main)  # exit 18 on dead-platform errors
    finally:
        distributed.destroy()
