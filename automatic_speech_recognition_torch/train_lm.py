"""Train the character RNN language model (counterpart of the repository's
train_lm.py, on the same flags).

    python -m automatic_speech_recognition_torch.train_lm <train_lm.py's \\
        flags> [--device cuda]

Cleans the transcript corpus (upper-case, '?'/'!' -> '.', punctuation and
digits stripped), encodes it with the fixed 28-token vocabulary ['.', ' ',
A..Z] (written to vocab.json), splits it into train / valid / test by
fraction, and trains with contiguous cursor batching
(models/char_rnn.BatchGenerator) and models/char_rnn.lm_train_step, the
recurrent state carried across steps.  Every epoch is checkpointed with
the full train state in <out>/lang/save_model/ (5 kept) and the best on
validation perplexity in <out>/lang/best_model/ (1 kept); a rerun resumes
from the latest.  The test perplexity comes from the best model, and
result.json is written however the run ends.  The directory is what
models/char_rnn.load_lm_dir, sample_lm and decode --apply_lm read.

Tiny CPU run:
  python -m automatic_speech_recognition_torch.train_lm --device cpu \\
      --data_file corpus.txt --output_dir /tmp/lm --num_epochs 2 \\
      --hidden_size 16 --batch_size 4 --num_unrollings 5
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from automatic_speech_recognition_torch.utils.text import (clean_lm_text,
                                                           lm_vocab)

from .models import char_rnn
from .training.checkpoint import CheckpointManager
from .utils.device import disable_tf32, resolve_device, split_device

log = logging.getLogger("train_lm")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Flag names and defaults of train_lm.py (reference train_lm.py:
    22-119)."""
    p = argparse.ArgumentParser("char RNNLM trainer (PyTorch)")
    p.add_argument("--data_file", type=str, default="data/lm_corpus.txt")
    p.add_argument("--encoding", type=str, default="utf-8")
    p.add_argument("--num_epochs", type=int, default=50)
    p.add_argument("--n_save", type=int, default=1)
    p.add_argument("--hidden_size", type=int, default=128)
    p.add_argument("--embedding_size", type=int, default=0)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--num_unrollings", type=int, default=10)
    p.add_argument("--model", type=str, default="lstm",
                   choices=["rnn", "lstm", "gru"])
    p.add_argument("--batch_size", type=int, default=20)
    p.add_argument("--train_frac", type=float, default=0.9)
    p.add_argument("--valid_frac", type=float, default=0.05)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--input_dropout", type=float, default=0.0)
    p.add_argument("--max_grad_norm", type=float, default=5.0)
    p.add_argument("--learning_rate", type=float, default=2e-3)
    p.add_argument("--output_dir", type=str, default="lang/output")
    p.add_argument("--init_dir", type=str, default="")
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--progress_freq", type=int, default=100)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--test", action="store_true",
                   help="use the first 1000 characters to unittest")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def encode_text(text: str, v2i) -> np.ndarray:
    """Encode cleaned text, dropping any character outside the 28-token
    vocabulary (cleaning removes most, but e.g. '/' survives the
    reference's translation table)."""
    ids = [v2i[c] for c in text if c in v2i]
    if len(ids) != len(text):
        log.warning("dropped %d out-of-vocab characters from corpus",
                    len(text) - len(ids))
    return np.asarray(ids, np.int32)


def run_epoch(ts: char_rnn.LMTrainState, cfg: char_rnn.LMConfig,
              gen: char_rnn.BatchGenerator, data_size: int,
              is_training: bool, verbose: int = 0, freq: int = 100,
              divide_by_n: int = 1) -> Tuple[float, float]:
    """One pass: (perplexity = exp(mean loss), steps per second).  The
    losses stay on the device until the pass ends (and at each verbose
    progress line)."""
    epoch_size = data_size // (cfg.batch_size * cfg.num_unrollings)
    if data_size % (cfg.batch_size * cfg.num_unrollings):
        epoch_size += 1
    dev = ts.model.softmax.weight.device
    state = char_rnn.zero_state(cfg, cfg.batch_size, dev)
    loss_sum = torch.zeros((), device=dev)
    count = 0
    t0 = time.perf_counter()
    for step in range(max(epoch_size // divide_by_n, 1)):
        rows = torch.from_numpy(gen.next()).to(dev)
        inputs, targets = rows[:-1].T, rows[1:].T
        if is_training:
            loss, state = char_rnn.lm_train_step(ts, inputs, targets, state,
                                                 cfg)
        else:
            loss, state = char_rnn.lm_eval_loss(ts.model, inputs, targets,
                                                state, cfg)
        loss_sum += loss
        count += 1
        if verbose and (step + 1) % freq == 0:
            log.info("%.1f%%, step %d, perplexity %.3f, speed %.0f words/s",
                     (step + 1) * 100.0 / epoch_size, step,
                     np.exp(float(loss_sum) / count),
                     (step + 1) * cfg.batch_size * cfg.num_unrollings
                     / (time.perf_counter() - t0))
    ppl = float(np.exp(float(loss_sum) / max(count, 1)))
    seconds = max(time.perf_counter() - t0, 1e-9)
    log.info("perplexity: %.3f, speed: %.0f words per sec, %.1f steps/s",
             ppl, count * cfg.batch_size * cfg.num_unrollings / seconds,
             count / seconds)
    return ppl, count / seconds


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns what result.json holds (plus the per-epoch train and
    valid perplexities and train steps/s under "history")."""
    device_name, argv = split_device(argv)
    args = parse_args(argv)
    logging.basicConfig(force=True, stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    device = resolve_device(device_name)
    if device.type == "cuda":
        disable_tf32()
    out = args.init_dir or args.output_dir
    os.makedirs(out, exist_ok=True)

    with open(args.data_file, encoding=args.encoding) as f:
        text = clean_lm_text(f.read())
    if args.test:
        text = text[:1000]
    log.info("corpus characters: %d", len(text))

    v2i, _, vocab_size = lm_vocab()
    with open(os.path.join(out, "vocab.json"), "w") as f:
        json.dump(v2i, f, indent=2)

    cfg = char_rnn.LMConfig(
        vocab_size=vocab_size, hidden_size=args.hidden_size,
        embedding_size=args.embedding_size, num_layers=args.num_layers,
        num_unrollings=args.num_unrollings, batch_size=args.batch_size,
        model=args.model, learning_rate=args.learning_rate,
        max_grad_norm=args.max_grad_norm, dropout=args.dropout,
        input_dropout=args.input_dropout)

    # split sizes from the ENCODED length (encode_text drops OOV chars)
    ids = encode_text(text, v2i)
    train_size = int(args.train_frac * len(ids))
    valid_size = int(args.valid_frac * len(ids))
    train_ids = ids[:train_size]
    valid_ids = ids[train_size:train_size + valid_size]
    test_ids = ids[train_size + valid_size:]
    min_chunk = args.batch_size * args.num_unrollings + 1
    if len(train_ids) < min_chunk or len(valid_ids) < min_chunk:
        raise ValueError(
            f"corpus too small for the requested split: train {len(train_ids)}"
            f" / valid {len(valid_ids)} encoded chars, need >= {min_chunk} "
            f"each (batch_size*num_unrollings+1); adjust --train_frac/"
            f"--valid_frac or the batch geometry")

    train_gen = char_rnn.BatchGenerator(train_ids, cfg.batch_size,
                                        cfg.num_unrollings)
    valid_gen = char_rnn.BatchGenerator(valid_ids, cfg.batch_size,
                                        cfg.num_unrollings)

    ts = char_rnn.create_lm_train_state(cfg, args.seed, device)
    log.info("model size (number of parameters): %d on %s",
             sum(p.numel() for p in ts.model.parameters()), device)

    ckpt = CheckpointManager(os.path.join(out, "lang", "save_model"),
                             max_to_keep=5)
    best_ckpt = CheckpointManager(os.path.join(out, "lang", "best_model"),
                                  max_to_keep=1)
    epoch = 0
    if ckpt.restore(ts) is not None:
        epoch = ckpt.latest_epoch() or 0   # continue epoch numbering
        log.info("restored from %s (epoch %d, step %d)", out, epoch, ts.step)

    result = {"params": dataclasses.asdict(cfg),
              "vocab_file": os.path.join(out, "vocab.json"),
              "encoding": args.encoding}
    history = {"train_ppl": [], "valid_ppl": [], "train_steps_per_s": []}
    best_valid_ppl, best_epoch = None, None
    try:
        for i in range(args.num_epochs):
            for j in range(args.n_save):
                epoch += 1
                log.info("=" * 19 + " Epoch %d: %d/%d " + "=" * 19,
                         i + 1, j + 1, args.n_save)
                ppl, sps = run_epoch(ts, cfg, train_gen, train_size,
                                     is_training=True, verbose=args.verbose,
                                     freq=args.progress_freq,
                                     divide_by_n=args.n_save)
                ckpt.save(epoch, ts)
                valid_ppl, _ = run_epoch(ts, cfg, valid_gen, valid_size,
                                         is_training=False,
                                         verbose=args.verbose,
                                         freq=args.progress_freq)
                history["train_ppl"].append(ppl)
                history["valid_ppl"].append(valid_ppl)
                history["train_steps_per_s"].append(sps)
                if best_valid_ppl is None or valid_ppl < best_valid_ppl:
                    best_ckpt.save(epoch, ts)
                    best_valid_ppl, best_epoch = valid_ppl, epoch
                log.info("best validation ppl %.4f (epoch %s)",
                         best_valid_ppl, best_epoch)
                result.update(latest_model=epoch, best_model=best_epoch,
                              best_valid_ppl=float(best_valid_ppl))
        # test-set ppl with the best model (reference: train_lm.py:344-351)
        if best_epoch is not None:     # --num_epochs 0 scores the state
            best_ckpt.restore(ts, epoch=best_epoch)
        if len(test_ids) >= 2:
            test_cfg = cfg.replace(batch_size=1, num_unrollings=1)
            test_gen = char_rnn.BatchGenerator(test_ids, 1, 1)
            test_ppl, _ = run_epoch(ts, test_cfg, test_gen, len(test_ids),
                                    is_training=False)
            result["test_ppl"] = float(test_ppl)
        else:
            log.warning("test split has %d encoded chars; skipping test ppl",
                        len(test_ids))
    finally:
        with open(os.path.join(out, "result.json"), "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
        log.info("result.json written to %s", out)
    return {**result, "history": history}


if __name__ == "__main__":
    main()
