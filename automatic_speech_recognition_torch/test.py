"""Greedy evaluation of a split with WER (counterpart of the repository's
test.py, on the same flags).

    python -m automatic_speech_recognition_torch.test <test.py's flags> \\
        [--device cuda]

Streams the ARSH shards {split}-*.arsh (or --shard_glob) through the
bucketed loader (data/pipeline.BucketedLoader), pads a partial batch up
to its bucket's batch size with audiolen = 1 rows (dropped after
decoding), featurizes raw-audio shards on the device
(ops/frontend.featurize_batch, the fused CUDA kernel on a GPU), and
decodes each batch with dec_steps = max(int(convert_rate * T), 1):
--eval_decoder attention runs the greedy speller
(training/trainer.eval_forward), ctc_greedy the best CTC path
(decoding/ctc.ctc_greedy_decode).  The LAS checkpoint is the port's
(--restore_epoch, default the latest); --use_saved_config takes the model
flags from the training run's config.json, and flags that still differ
from it are logged.  Writes test_pred.txt and test_gt.txt to --log_dir
and prints `WER: x.xxxx` (and `CER: x.xxxx` with --report_cer).  As in
test.py, a batch that fails is skipped; here it is logged with its
traceback and counted.  --dtype bfloat16 decodes in bf16 (the loader's
bf16 feature batches reach the model bit for bit), --quantize_decoder
int8 with int8 speller weights (ops/quant.py).

A comma list of devices (--device cuda:0,cuda:1) evaluates over a data
axis, as test.py's mesh over jax.devices(): one replica of the model on
each (parallel/sharding.py), every batch padded to a multiple of the
devices, featurized on the first, its rows split over the replicas and
gathered back in order ('cpu,cpu' splits over two replicas on the CPU).
--device cuda is one GPU (parallel/mesh.devices_for).  Under torchrun every
process evaluates the whole split on its own GPU, as JAX's multi-process
path does, and only the primary writes the files.  Refused:
--num_partitions > 1 (tensor parallelism, ROADMAP item 12).

Tiny CPU run:
  python -m automatic_speech_recognition_torch.test --device cpu \\
      --unit char --feat_dim 13 --audio_shards True --shard_dir /tmp/shards \\
      --split dev --save_dir /tmp/model --use_saved_config True \\
      --log_dir /tmp/log
"""

from __future__ import annotations

import glob
import logging
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from automatic_speech_recognition_torch.config import (
    apply_saved_model_config, check_model_config, parse_args)
from automatic_speech_recognition_torch.data.pipeline import BucketedLoader
from automatic_speech_recognition_torch.utils.text import (
    convert_idx_to_string, corpus_cer, corpus_wer)
from automatic_speech_recognition_torch.utils.tokenizer import (EOS_ID,
                                                               get_tokenizer)
from automatic_speech_recognition_torch.utils.watchdog import StallWatchdog

from .decoding.ctc import ctc_greedy_decode
from .models.las import LAS
from .ops import frontend
from .parallel import distributed, sharding
from .parallel.mesh import TENSOR_PARALLEL, devices_for, make_mesh
from .training import trainer
from .training.checkpoint import CheckpointManager
from .ops.quant import maybe_quantize
from .utils.device import disable_tf32, host_tensor, split_device

log = logging.getLogger("test")


@dataclass
class EvalResult:
    """What one evaluation measured: the corpus WER (and CER), the
    utterances decoded and skipped, and the batches with their mean wall
    time from the batch's upload to its hypotheses on the host."""
    wer: float
    cer: float
    utterances: int
    skipped: int
    batches: int
    ms_per_batch: float


def main(argv: Optional[Sequence[str]] = None) -> EvalResult:
    device_name, argv = split_device(argv)
    cfg = parse_args(argv)
    logging.basicConfig(force=True, stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    if cfg.use_saved_config:
        cfg, overridden = apply_saved_model_config(cfg, cfg.save_dir)
        for line in overridden:
            log.info("model flag from training snapshot: %s", line)
    if cfg.num_partitions > 1:
        raise NotImplementedError(TENSOR_PARALLEL)
    if cfg.eval_decoder not in ("attention", "ctc_greedy"):
        raise ValueError(f"unknown --eval_decoder {cfg.eval_decoder!r} "
                         "(want 'attention' or 'ctc_greedy')")
    if cfg.eval_decoder == "ctc_greedy" and not cfg.ctc:
        raise ValueError("--eval_decoder ctc_greedy needs --ctc True so "
                         "the checkpoint's CTC head is restored")
    distributed.maybe_initialize(device_name)
    mesh = make_mesh(devices=devices_for(device_name),
                     data_axis=cfg.data_axis, model_axis=cfg.model_axis)
    device, dp = mesh.devices[0], len(mesh.devices)
    if device.type == "cuda":
        disable_tf32()
    watchdog = (StallWatchdog(cfg.stall_timeout_s, what="eval progress")
                .start() if cfg.stall_timeout_s > 0 else None)

    tokenizer = get_tokenizer(cfg.unit, cfg.subword_dir)
    cfg = cfg.replace(vocab_size=tokenizer.get_vocab_size())

    pattern = cfg.shard_glob or os.path.join(cfg.shard_dir,
                                             f"{cfg.split}-*.arsh")
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no eval shards match {pattern}")
    loader = BucketedLoader(files, cfg, is_training=False)
    log.info("eval records: %d in %d shards", loader.num_records, len(files))

    # vocab_size is resolved by now, so a wrong tokenizer shows here too
    for line in check_model_config(cfg, cfg.save_dir):
        log.warning("model flag differs from the training snapshot "
                    "(%s/config.json) -- %s", cfg.save_dir, line)
    ckpt = CheckpointManager(cfg.save_dir)
    model = ckpt.load_weights(LAS(cfg), cfg.restore_epoch)
    if model is None:
        raise FileNotFoundError(f"no checkpoint found in {cfg.save_dir}")
    model = maybe_quantize(model.to(device).eval(), cfg)
    replicas = sharding.place_eval_params(mesh, model)
    log.info("restored epoch %s; eval mesh %s over %s",
             cfg.restore_epoch if cfg.restore_epoch >= 0
             else ckpt.latest_epoch(), mesh.shape,
             ", ".join(map(str, mesh.devices)))

    def decode(replica, feats, featlen):
        if cfg.eval_decoder == "ctc_greedy":
            toks, lens = ctc_greedy_decode(replica.model, feats, featlen, cfg)
            # pad the collapsed ids with <EOS> so detokenization cuts
            # there even when the CTC path never emits one itself
            steps = torch.arange(toks.shape[1], device=toks.device)
            return torch.where(steps[None, :] < lens[:, None], toks, EOS_ID)
        dec_steps = max(int(cfg.convert_rate * feats.shape[1]), 1)
        return trainer.eval_forward(replica.model, feats, featlen, cfg,
                                    dec_steps)[1]

    hyps, refs = [], []
    skipped, batches, busy_s = 0, 0, 0.0
    for audio, audiolen, ys, _ in loader:
        real_b = audio.shape[0]
        # pad a partial batch up to its bucket's batch size, rounded to a
        # multiple of the devices; the padded rows carry audiolen = 1 and
        # are dropped below
        cap = sharding.pad_batch_to(
            max(loader.batch_size_for(audio.shape[1]) or real_b, real_b), dp)
        if real_b < cap:
            pad = cap - real_b
            audio = np.pad(audio, ((0, pad),) + ((0, 0),) * (audio.ndim - 1))
            audiolen = np.pad(audiolen, (0, pad), constant_values=1)
        t0 = time.perf_counter()
        try:
            feats = host_tensor(audio).to(device)
            featlen = host_tensor(audiolen).to(device)
            if cfg.audio_shards:
                feats, featlen = frontend.featurize_batch(feats, featlen, cfg)
            y_hat = sharding.run_replicas(mesh, replicas, decode,
                                          (feats, featlen))
            y_hat = y_hat.cpu().numpy()[:real_b]
        except Exception:  # test.py skips a failed batch; counted here
            log.warning("eval batch failed, skipping %d utts", real_b,
                        exc_info=True)
            skipped += real_b
            continue
        busy_s += time.perf_counter() - t0
        batches += 1
        if watchdog is not None:
            watchdog.pet()
        for i in range(real_b):
            hyps.append(convert_idx_to_string(y_hat[i],
                                              tokenizer.id_to_token, cfg.unit))
            refs.append(convert_idx_to_string(ys[i],
                                              tokenizer.id_to_token, cfg.unit))
        log.info("decoded %d utts", len(hyps))

    if watchdog is not None:
        watchdog.stop()
    if distributed.is_primary():
        os.makedirs(cfg.log_dir, exist_ok=True)
        with open(os.path.join(cfg.log_dir, "test_pred.txt"), "w") as f:
            f.write("\n".join(hyps))
        with open(os.path.join(cfg.log_dir, "test_gt.txt"), "w") as f:
            f.write("\n".join(refs))

    if not refs:
        raise RuntimeError(
            f"no utterances decoded ({skipped} skipped by errors); "
            "refusing to report a WER over an empty set")
    w = corpus_wer(refs, hyps)
    if skipped:
        log.warning("WER computed over %d utts; %d skipped due to errors",
                    len(refs), skipped)
    if loader.dropped:
        log.warning("%d utterances beyond the last bucket boundary were "
                    "dropped by the loader", loader.dropped)
    ms = 1e3 * busy_s / max(batches, 1)
    log.info("WER: %.4f over %d utterances in %d batches (%.2f ms/batch on "
             "%s), %d skipped", w, len(refs), batches, ms,
             ", ".join(map(str, mesh.devices)), skipped)
    c = corpus_cer(refs, hyps)
    if cfg.report_cer:
        log.info("CER: %.4f", c)
        print(f"CER: {c:.4f}")
    print(f"WER: {w:.4f}")
    return EvalResult(w, c, len(refs), skipped, batches, ms)


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.destroy()
