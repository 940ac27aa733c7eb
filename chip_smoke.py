#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the fused frontend kernel from csrc/ with nvcc.
2. Holds the kernel to its plain PyTorch version on the card (mfcc and
   fbank, CMVN on and off, rtol 1e-4 / atol 2e-4): B = 8 at 1 to 32 s
   with ragged and sub-frame rows; B = 1 at 5 s and at 60 s; frame counts
   on and between the kernel's tile edges; a batch whose rows are all
   shorter than one tile; frames of subnormal energy; an odd subsegment
   (15 kHz) and whole frames (11025 Hz).  Holds the raw features and the
   whole output to be bit-equal under every work split pass 1 can take,
   and each of 12 seeded rows (one below a frame, one of 60 s) to equal
   itself alone, bit for bit, in batches of 2, 4, 8 and 128 beside other
   rows and other frames_max (mfcc and fbank; the 128-row batch also
   against the plain version).  Then to the NumPy speechpy golden on
   synthesized speech (5e-3).  Counts the HMMA (tensor-core)
   instructions of the built library (cuobjdump -sass).  Times the
   kernel and the plain version in turns at 128 x 10 s and the serving
   and training shapes, each beside its bound (bench_torch.work's
   frontend_least_s); each kernel's device time (pass 1, the statistics,
   pass 2) at 128 x 10 s and 8 x 2 s from a torch.profiler trace; and
   torch.stft's power spectrum of the same frames at 128 x 10 s, a
   yardstick for the spectrum stage only.  Then the BiLSTM recurrence kernels
   (csrc/lstm_recurrence.cu, phase_lstm): against their plain version,
   forward and backward over the whole sequence, at the word-piece cell's
   longest shapes (48 x 428 and 96 x 214 steps, U 1280), at two row tiles
   and at a toy width, each beside the plain version's own float32 error
   against float64 and a stale step the check must refuse; the launches
   and the kernels' share of the listener's frame-steps in one
   LAS-6-1280 train step at its published widths (no cuDNN RNN op or
   kernel left in it); the whole BiLSTM against cuDNN's nn.LSTM
   (library_ms) and the recurrence alone against its plain version,
   timed in turns at those shapes, beside their least times.
3. Serves >= 12 concurrent synthesized requests through
   BatchingRecognizer at the published width (run.sh: cnn listener
   4 x 512, location attention 128 / K 201 / 10 channels, speller
   2 x 1024, char vocab 30, mfcc 13 + deltas, float32, random weights
   from seed 0), checks the transcripts, the kernel's launch count and
   finite logits, and kernel vs plain frontend on one batch.
4. Trains at the same published width over raw-audio shards (the recipe's
   train flags: lr 1e-4, grad_clip 5, label smoothing, no scheduled
   sampling) through the port's train.main with --audio_shards True, so
   the fused kernel runs inside every step: synthesized speech with char
   transcripts in three buckets, ~2 s at batch 96, ~8 s and ~16 s at
   batch 48.  Plain and with --ctc True --ctc_weight 0.2, each 3 steps,
   an epoch checkpoint, and a resume that must continue at step 4.
   Checks finite losses and gradient norms, kernel launches >= steps,
   bias_hh still zero, the loss falling over 10 steps on one repeated
   batch, and one step from identical state with the kernel frontend vs
   the plain one (loss rtol 1e-4, gradient norm rtol 1e-3).  Prints, per
   bucket, ms per train step (CUDA events, median of 3), the frontend's
   share of it, peak device memory, and the device idle share of one step
   from a torch.profiler trace.
5. Decodes by beam search at the same width with a CTC head: the model
   and a published-shape fusion LM (lstm 4 x 512, one-hot over the
   28-token char vocabulary, seed 1) are written to disk (port checkpoint,
   save_lm_dir) and loaded back through Recognizer.from_checkpoint(...,
   lm_dir=...).  The speller's and CTC head's EOS biases are lowered by
   20, so each search runs its step budget as a trained model's about
   does.  Beam 8 with log-prob scoring on 8-utterance batches of
   synthesized speech at the 2, 8 and 16 s buckets, in three modes:
   attention only, + LM (lm_weight 0.5), + joint CTC (ctc_beam_weight
   0.5); ms per batch (CUDA events, mean of 3), decoder steps, ms per
   step beside frontend + listener, and peak device memory each.  Serves
   8 concurrent requests through BatchingRecognizer(beam_size=8).
   Checks: every result a str, rank 0 a hypothesis and every score a
   number, the fused kernel launched, beam 1 = greedy up to the first
   near tie, and CUDA = CPU in rank-0 tokens on a 2 s batch in each mode
   (where they differ, the two rank-0 scores must tie within 1e-3
   relative).  The device idle share comes from one torch.profiler trace
   of the 8 s joint-CTC batch.

6. Runs run.sh's stages through the port's entry points at the same
   width on a synthesized LibriSpeech-layout corpus (64 train utterances
   of 1.2-14 s, 12 dev of 1.5-15.5 s, 16-bit WAVs): train_subword
   (--size 5000: the vocabulary the corpus allows); preprocess with
   --augmentation True (features held to the plain frontend on the card,
   rtol 1e-4 / atol 2e-4; utt/s) and with --audio_shards True;
   create_shards on both; train.main over the raw-audio shards with
   --ctc True, the three online waveform perturbations and --spec_augment
   (3 steps); per bucket, the resampler on the card against the CPU at
   each rate (atol 1e-5) and its time, the noise SNR over valid samples
   against the drawn one, zero padding, the perturbed batch's features
   kernel vs plain, and the augmented step's time against the
   unaugmented one on the same batch, in turns; one augmented step with
   the kernel against one with
   the plain frontend from identical state and generators; test with
   --eval_decoder attention and ctc_greedy (every dev utterance decoded,
   none skipped; ms per batch); train_lm at its defaults for 2 epochs on
   corpus_all.txt (validation perplexity falls; steps/s) and one
   lm_train_step on the card against the CPU; sample_lm greedy on the
   card = on the CPU; decode --apply_lm True over that LM directory; and
   serve.main on a local port: 8 concurrent WAV requests, /healthz,
   /stats, each text = Recognizer.transcribe_signals greedy.
7. Every model configuration the JAX package accepts, at the same width
   (speller 2 x 1024, location attention 128 / K 201 / 10 channels, mfcc
   13 + deltas), over the training shards of phase 4:
   - pblstm (enc_units 512, tools/pblstm_r5.sh's 1 BiRNN + 2 pyramid
     stages, listener output 1024), loaded by Recognizer.from_checkpoint:
     greedy batches of 8 at 2 / 8 / 16 s (ms per batch), card = CPU in
     beam-8 rank 0 on the 2 s batch, train.main with --ctc True
     --ctc_weight 0.2 (3 steps), the loss falling over 10 steps on one
     batch;
   - bf16 (--dtype bfloat16) for the published cnn and the pblstm model:
     train.main (3 steps; every parameter, BN statistic and Adam moment
     still float32, and the checkpoint restores them exactly), the first
     step's loss from one state within 5 % of float32's, ms per step bf16
     vs float32 in turns per bucket with peak memory, the device idle
     share of one profiled step each; greedy and beam-8 joint-CTC batches
     at 8 s, bf16 vs float32, with their rank-0 agreement;
   - int8 (--quantize_decoder int8) on the published cnn model through
     Recognizer.from_checkpoint at vocab 30 (cells; a quantized fusion LM
     of the published shape, beam 8) and 5000 (cells and the output
     layer; a synthesized vocabulary file of that size): teacher-forced
     logits within 5e-2 relative L2 of float, the speller's bytes, greedy
     ms per batch at 8 s float vs int8 in turns; int8 under bf16 keeps
     w_scale float32;
   - the kernel against its plain version on the phase's 8 s batch.
8. Data parallelism at the same width over raw audio (cnn listener, the
   fused kernel inside every step), 8 s x 48:
   - train.main in a subprocess given torchrun's environment by hand
     (WORLD_SIZE 1: NCCL on the card) for 11 steps, its ms per step
     (steps 2-10) against the same steps without it in this process;
   - two ranks on gloo over CUDA tensors, both on this card, each with 24
     rows of one global batch whose halves hold different token counts,
     apply_bn on: loss and gradient norm equal on both ranks and to one
     process on the whole batch (rtol 1e-4 / 1e-3); the gradient
     all-reduce's bytes and ms (CUDA events); the kernel against its
     plain version on each rank's rows; one more step with dropout,
     SpecAugment and the waveform perturbations, equal on both ranks;
   - a Recognizer over a mesh that lists the card twice, one worker
     process per replica (parallel/workers.EvalPool): each replica's
     devices from the pool, the workers' start-up seconds, greedy tokens
     and beam-8 joint-CTC rank 0 against one device on 8 utterances (the
     batch's rows split over the workers), the workers' own features
     against the first device's (equal), 7 requests padded to the data
     axis, featurized and decoded in the workers, against one device's
     texts, the split batch's wall ms each way, and test.py's
     whole-batch loop (featurize + greedy, one batch in flight per
     replica), Recognizer.transcribe_all and the batcher (every request
     at once) in rows per second against one device, in turns, their
     tokens and texts held to one device's (near ties excepted); the
     workers' kernel launches come back with their results.

9. The port's run.sh chain at the published model widths (enc 512 x 4
   with the two stride-2 convs, dec 1024 x 2, embedding 256, attention
   128, char units) on 32 / 8 / 8 utterances from the port's
   tools/synth_corpus: subword, preprocess (features, and raw-audio
   dumps), shards, train (two epochs of 3 steps through the supervisor),
   test, lm, decode and decode_lm, each `bash run.sh <stage>` in its own
   processes, whose kernel launches a python3 shim on PATH counts; each
   stage's wall seconds.  Then average_checkpoints over the two epochs,
   test on the average and wer_ci (WER and its 95 % CI, recorded); four
   dumped feature rows against the plain frontend; the chain's epoch 2
   written in tools/export_jax_checkpoint.py's format and imported by
   import_checkpoint on the card (greedy tokens on 8 utterances equal,
   logits within 1e-5, Adam moments, count and step equal, one resumed
   step equal to the source's); and the port's supervisor: a worker
   that exits 18 once, then trains from the imported directory, is
   retried to success, one that exits 20 stops at once.
10. Tensor parallelism at the same width over raw audio (cnn listener,
   apply_bn, the fused kernel inside every rank's step), 8 s x 24: two
   gloo ranks at --num_partitions 2 sharing this card, each holding its
   columns of every split weight (the JAX package's param_spec layout):
   loss and gradient norm equal on both ranks and to one process on the
   same batch (rtol 1e-4 / 1e-3), the gathered parameters' sums equal,
   the bytes of parameters and Adam state a rank holds against one
   process's, the model axis's all-gathers and backward all-reduces in
   one step (count and ms, each timed between two synchronizes), ms per
   step against one process, and the kernel against its plain version
   on the rows; then a Recognizer whose one replica is split over the
   card listed twice (inline; its split read from the pool's
   description): greedy tokens and beam-8 joint-CTC rank 0 against one
   device, and the greedy and beam batches' ms each way; one
   published-width BiRNN layer's forward and backward with its weights
   whole against gathered from two parts (cuDNN compacts them each call).
11. Training across hosts on this card: two `python3 -m
   automatic_speech_recognition_torch.train --device cuda:0` commands as
   hosts 0 and 1 of one job (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES
   / JAX_PROCESS_ID, a static rendezvous), a gloo rank each (NCCL refuses
   two ranks on one GPU), at the same width with apply_bn over the 8 s x
   48 global batches, the fused kernel inside every rank's step: 3 steps,
   losses equal on both hosts and, first, to one process's within rtol
   1e-4, and the wall seconds; then graft_entry.entry('cuda') at flagship
   width against the same forward on the CPU (greedy tokens, logits, ms a
   call by CUDA events).

Every phase raises on failure.  The last line is the result JSON; the
line before it lists the kernels, with the launches of the serving,
training, beam, recipe, configs, parallel, tensor-parallel, multihost and
chain runs (those of the parallel, tensor-parallel and multihost ranks
and of the chain counted in their processes).  Without CUDA it exits
non-zero.

    python3 chip_smoke.py --lstm         # phase_lstm alone

prints the card and the recurrence kernels' phase, then their line of
the kernels.

    python3 chip_smoke.py --multichip    # a host with N > 1 GPUs

runs only the data-parallel checks across N GPUs (phase_multichip):
train.main on N NCCL processes against one process on the same 8 s x 48
global batches; one `python3 -m automatic_speech_recognition_torch.train
--device cuda` over every GPU (train starts the ranks itself), whose
losses must equal, bit for bit, those of N hand-launched processes on the
same flags (both with deterministic CUDA algorithms), and the same
command with rank 1 raising an error that carries a transient marker
(RANK_SITE), which must exit 18 within 60 s of the fault; with N a
multiple of 4, two hosts of N / 2 NCCL ranks at dp N / 4 x tp 2, one
`train` command a host through the multi-host environment, whose losses
must equal one host's N ranks' bit for bit, then rank N - 1 raising the
same error: its host must exit 18, the other 17 or 18;
graft_entry.dryrun_multichip(N); N NCCL ranks of 48
rows each against one process on the
N x 48 batch (with the NCCL all-reduce's ms and each rank's ms per step
against one process's at 48 rows), and decoding over plain 'cuda' (it
must resolve to every GPU; one worker process per GPU) against one GPU:
greedy and beam tokens, one split batch's wall ms, and test.py's
whole-batch loop, Recognizer.transcribe_all and the batcher in rows per
second, each of which must beat one GPU's or the run fails; then tensor parallelism over NCCL: 4 ranks at dp 2 x tp 2 and
at dp 1 x tp 4 (with N >= 4) on the 8 s x 24 batch against one process,
as phase 10 measures them, decoding over 'cuda' at num_partitions 2 (two
workers, each split over two GPUs), and greedy and beam decoding with
the model split over 'cuda:0,cuda:1' against one GPU.
"""

from __future__ import annotations

import copy
import glob
import json
import logging
import os
import re
import socket
import subprocess
import sys
import tempfile
import queue
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from bench_torch import work
from bench_torch.trace import _is_device
from automatic_speech_recognition_torch.config import Config, parse_args
from automatic_speech_recognition_torch.data import shards
from automatic_speech_recognition_torch.data.pipeline import BucketedLoader
from automatic_speech_recognition_torch.ops import frontend_host as host
from automatic_speech_recognition_torch.utils.formant_synth import (
    PHONES, synth_phones)
from automatic_speech_recognition_torch.utils.tokenizer import (CharBPE,
                                                               CharEncoder,
                                                               EOS_ID)
from automatic_speech_recognition_torch import create_shards as \
    create_shards_cli
from automatic_speech_recognition_torch import decode as decode_cli
from automatic_speech_recognition_torch import preprocess as preprocess_cli
from automatic_speech_recognition_torch import sample_lm as sample_lm_cli
from automatic_speech_recognition_torch import serve as serve_cli
from automatic_speech_recognition_torch import test as test_cli
from automatic_speech_recognition_torch import train as train_cli
from automatic_speech_recognition_torch import train_lm as train_lm_cli
from automatic_speech_recognition_torch import train_subword as \
    train_subword_cli
from automatic_speech_recognition_torch import graft_entry
from automatic_speech_recognition_torch import import_checkpoint
from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.data.audio_io import (read_audio,
                                                              write_wav)
from automatic_speech_recognition_torch.decoding import beam as beam_lib
from automatic_speech_recognition_torch.models import char_rnn, convert, las
from automatic_speech_recognition_torch.ops import _kernels, augmentation, quant
from automatic_speech_recognition_torch.ops import layers as L
from automatic_speech_recognition_torch.ops import cuda_frontend, frontend
from automatic_speech_recognition_torch.parallel import (distributed,
                                                         sharding,
                                                         tensor_parallel)
from automatic_speech_recognition_torch.parallel.mesh import (devices_for,
                                                              make_mesh)
from automatic_speech_recognition_torch.serving import BatchingRecognizer
from automatic_speech_recognition_torch.tools import (
    average_checkpoints as avg_tool, wer_ci as wer_ci_tool)
from automatic_speech_recognition_torch.training import trainer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)
from automatic_speech_recognition_torch.utils.device import (disable_tf32,
                                                              resolve_device)

SR = 16000
RTOL, ATOL = 1e-4, 2e-4          # tests/test_pallas_frontend.py
GOLDEN_TOL = 5e-3                # tests/test_frontend_golden.py
BUCKETS = [2, 4, 8, 16, 32]
# the timed frontend's settings, as bench_torch.work counts its work
FRONTEND_WORK = dict(fft_length=512, feat_dim=13, feat_type="mfcc",
                     num_mel_filters=40, sample_rate=SR)
KERNEL_SOURCE = "automatic_speech_recognition_torch/csrc/fused_frontend.cu"
REPLACES = "automatic_speech_recognition_tpu/ops/pallas_frontend.py:177"
# (name, batch, samples): bench.py's shape, serving's buckets of 8, and
# the training buckets (frames < 200 / 800 / 1600) at their batch sizes
TIMED_SHAPES = [("128 x 10 s", 128, 10 * SR),
                ("serving 8 x 2 s", 8, 2 * SR),
                ("serving 8 x 8 s", 8, 8 * SR),
                ("serving 8 x 32 s", 8, 32 * SR),
                ("training 96 x 2.025 s", 96, 200 * 160 + 400),
                ("training 48 x 8.025 s", 48, 800 * 160 + 400),
                ("training 48 x 16.025 s", 48, 1600 * 160 + 400)]
# training buckets in frames (frames < b): padded to 2.025, 8.025 and
# 16.025 s; the default bucket_batch_sizes give them 96, 48 and 48 rows
TRAIN_BUCKETS = (200, 800, 1600)
TRAIN_BATCH = Config().bucket_batch_sizes[:len(TRAIN_BUCKETS)]
TRAIN_SECONDS = (2.0, 8.0, 16.0)
CHARS_PER_SECOND = 11            # transcript length: CTC-feasible at /4
OVERFIT_STEPS = 10
# the published recipe's train flags (run.sh:17-33,88) at char units
PUBLISHED_FLAGS = [
    "--unit", "char", "--feat_type", "mfcc", "--feat_dim", "13",
    "--cmvn", "True", "--enc_type", "cnn", "--num_enc_channels", "32",
    "--enc_units", "512", "--num_enc_layers", "4", "--mode", "loc",
    "--attention_size", "128", "--loc_kernel_size", "201",
    "--loc_num_channels", "10", "--dec_units", "1024",
    "--num_dec_layers", "2", "--embedding_size", "256",
    "--dropout_rate", "0.0", "--scheduled_sampling", "False",
    "--lr", "1e-4", "--grad_clip", "5", "--label_smoothing", "True",
    "--dtype", "float32", "--use_pallas", "True", "--audio_shards", "True",
    "--bucket_boundaries_train", ",".join(map(str, TRAIN_BUCKETS))]
BEAM_SIZE = 8                    # run.sh:32
BEAM_BUCKETS = (2, 8, 16)
# the fusion LM's published shape (config.py:189-190): lstm 4 x 512,
# one-hot input over the 28-token char vocabulary
LM_SHAPE = dict(vocab_size=28, hidden_size=512, num_layers=4,
                embedding_size=0, model="lstm")
NEAR_TIE = 1e-3
EOS_SHIFT = 20.0                 # lowers the EOS logit of the beam's model


def published_cfg() -> Config:
    """run.sh:17-33 at char units (the recipe's bpe-5k vocab needs a
    trained tokenizer; vocab 30 changes only the output layer)."""
    return Config(unit="char", vocab_size=CharEncoder().get_vocab_size(),
                  feat_type="mfcc", feat_dim=13, cmvn=True, enc_type="cnn",
                  num_enc_channels=32, enc_units=512, num_enc_layers=4,
                  mode="loc", attention_size=128, loc_kernel_size=201,
                  loc_num_channels=10, dec_units=1024, num_dec_layers=2,
                  embedding_size=256, dropout_rate=0.0, convert_rate=0.12,
                  dtype="float32", use_pallas=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over reps calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def traced(fn, name: str = "traced"):
    """(fn(), the events of a torch.profiler trace, CPU and CUDA) of fn
    inside the host range `name`, through a synchronize."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(name):
            out = fn()
        torch.cuda.synchronize()
    return out, prof.events()


def speech(rng: np.random.Generator, seconds: float) -> np.ndarray:
    names = [p for p in PHONES if p not in ("SIL", "SP")]
    phones = list(rng.choice(names, max(int(seconds * 9), 1)))
    return synth_phones(phones, rng=rng)[:int(seconds * SR)]


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                rtol: float, atol: float) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond "
                             f"rtol {rtol} / atol {atol}, max abs err "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def bound(B: int, S: int, T: int):
    """(bound ms, 'bytes' or 'operations') of one mfcc 13 + CMVN + deltas
    frontend call: bench_torch.work's least time, the larger of its bytes
    over HBM's rate and its operations over the TF32 tensor-core peak."""
    least = work.frontend_least_s(FRONTEND_WORK, B, S, T)
    by_bytes = (work.frontend_bytes(B, S, T, FRONTEND_WORK["feat_dim"])
                / work.HBM_BYTES_PER_S)
    return 1e3 * least, "bytes" if by_bytes >= least else "operations"


def kernel_vs_plain(dev, audio, audiolen, name: str, sample_rate: int = SR):
    """The kernel against the plain version in every mode; max abs err."""
    worst = 0.0
    for feat_type in ("mfcc", "fbank"):
        for cmvn in (True, False):
            kw = dict(feat_dim=13, feat_type=feat_type, apply_cmvn=cmvn,
                      sample_rate=sample_rate)
            fk, lk = frontend.extract_features(audio, audiolen,
                                               use_kernel=True, **kw)
            fp, lp = frontend.extract_features(audio, audiolen, **kw)
            torch.cuda.synchronize()
            if not torch.equal(lk, lp):
                raise AssertionError(f"{name}: featlen differs")
            case = f"{name} {feat_type} cmvn={cmvn} T={fk.shape[1]}"
            err = check_close(case, fk, fp, RTOL, ATOL)
            worst = max(worst, err)
            print(f"kernel vs plain  {case:44s} max_abs_err {err:.3e}")
    return worst


def tile_frames(dev, B: int, S: int) -> int:
    """Frames of one pass-1 work item at this shape (16 kHz, mfcc 13)."""
    p = cuda_frontend.plan(400, 160, 512, 13, "mfcc", 40, SR)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return cuda_frontend.tiling(p, B, host.num_frames(S, 400, 160), sms,
                                13).tt


def noise(rng, B: int, S: int, dev) -> torch.Tensor:
    return torch.from_numpy((rng.standard_normal((B, S)) * 0.1)
                            .astype(np.float32)).to(dev)


def kernel_cases(dev, rng) -> float:
    """Every case the kernel is held to its plain version on."""
    worst = 0.0
    for seconds in (1, 2, 4, 8, 10, 16, 32):
        S = seconds * SR
        worst = max(worst, kernel_vs_plain(
            dev, noise(rng, 8, S, dev),
            torch.tensor([S] * 6 + [S // 2, 300], device=dev), f"{seconds}s"))
    flen, fstride = host.frame_params(SR, 25, 10)
    worst = max(worst, kernel_vs_plain(
        dev, noise(rng, 1, 5 * SR, dev),
        torch.tensor([5 * SR - 999], device=dev), "B=1 5s"))
    worst = max(worst, kernel_vs_plain(
        dev, noise(rng, 1, 60 * SR, dev),
        torch.tensor([60 * SR], device=dev), "B=1 60s"))
    S = 4 * SR
    tt = tile_frames(dev, 8, S)
    frames = [tt, 3 * tt, 2 * tt + tt // 2, 5 * tt - 1, 4 * tt + 1, 7 * tt,
              tt // 2, 6 * tt]                       # tile edges, mid-tile
    worst = max(worst, kernel_vs_plain(
        dev, noise(rng, 8, S, dev),
        torch.tensor([f * fstride + flen for f in frames], device=dev),
        f"tile edges (tile {tt})"))
    lens = [flen - 1, flen, flen + fstride * (tt // 2), 100, 300,
            flen + fstride * (tt - 1), 1, flen + 7]    # all under one tile
    worst = max(worst, kernel_vs_plain(
        dev, noise(rng, 8, S, dev), torch.tensor(lens, device=dev),
        f"rows under one tile ({tt})"))
    # frames holding only a few samples of ~1e-22 (a resampler's ringing
    # over digital silence): subnormal power and energy count as zero
    audio = noise(rng, 8, 2 * SR, dev)
    audio[::2, 1600:6400] = 0.0
    audio[::2, 1600:6400:700] = 4.4e-22
    worst = max(worst, kernel_vs_plain(
        dev, audio, torch.tensor([2 * SR] * 8, device=dev),
        "subnormal frame energy"))
    worst = max(worst, kernel_vs_plain(
        dev, noise(rng, 8, 4 * 15000, dev),
        torch.tensor([4 * 15000] * 7 + [20000], device=dev),
        "odd g (15 kHz)", 15000))
    worst = max(worst, kernel_vs_plain(
        dev, noise(rng, 8, 4 * 11025, dev),
        torch.tensor([4 * 11025] * 7 + [20000], device=dev),
        "whole frames (11025 Hz)", 11025))
    return worst


# rows the batch-invariance check features alone and in batches: one below
# a frame (featlen 0), the serving and training lengths, and 60 s
INVARIANCE_SECONDS = (0.02, 0.9, 1.7, 2.0, 3.3, 4.1, 6.5, 8.0, 10.0, 12.7,
                      16.0, 60.0)
INVARIANCE_BATCHES = (2, 4, 8, 128)


def batch_features(dev, sigs: list, feat_type: str, extra: int = 0):
    """The kernel's features of `sigs` (NumPy rows) as one batch padded
    with zeros to the longest row + `extra` samples: (B, T, 13, 3) and
    the frame counts."""
    audio = np.zeros((len(sigs), max(map(len, sigs)) + extra), np.float32)
    for r, x in enumerate(sigs):
        audio[r, :len(x)] = x
    return frontend.extract_features(
        torch.from_numpy(audio).to(dev),
        torch.tensor([len(x) for x in sigs], device=dev), use_kernel=True,
        feat_dim=13, feat_type=feat_type)


def batch_invariance(dev, rng, card: str) -> float:
    """The seeded rows of INVARIANCE_SECONDS featurized alone (B = 1),
    then at each B of INVARIANCE_BATCHES: in random order, cut into
    batches of B filled up with fresh rows of 0.5-16 s at random places,
    each padded by a further 0-2 s (frames_max differs); every row must
    equal itself alone bit for bit.  The 128-row batch is also held to
    the plain version.  Returns the largest difference (0)."""
    rows = [(rng.standard_normal(max(int(t * SR), 1)) * 0.1)
            .astype(np.float32) for t in INVARIANCE_SECONDS]
    worst = 0.0
    for feat_type in ("mfcc", "fbank"):
        alone = []
        for x in rows:
            f, l = batch_features(dev, [x], feat_type)
            alone.append(f[0, :int(l[0])])
        for B in INVARIANCE_BATCHES:
            order = list(rng.permutation(len(rows)))
            diffs, frames = [0.0] * len(rows), []
            for start in range(0, len(rows), B):
                idx = order[start:start + B]
                mates = [(rng.standard_normal(int(rng.uniform(0.5, 16) * SR))
                          * 0.1).astype(np.float32)
                         for _ in range(B - len(idx))]
                place = list(rng.permutation(B))
                sigs = [None] * B
                for k, x in enumerate([rows[i] for i in idx] + mates):
                    sigs[place[k]] = x
                f, l = batch_features(dev, sigs, feat_type,
                                      int(rng.integers(0, 2 * SR)))
                frames.append(f.shape[1])
                for k, i in enumerate(idx):
                    got = f[place[k], :int(l[place[k]])]
                    if got.shape != alone[i].shape:
                        raise AssertionError(
                            f"batch invariance {feat_type} B={B}: row {i} "
                            f"has {got.shape[0]} frames, alone "
                            f"{alone[i].shape[0]}")
                    diffs[i] = float((got - alone[i]).abs().max()) \
                        if got.numel() else 0.0
                    if not torch.equal(got, alone[i]):
                        raise AssertionError(
                            f"batch invariance {feat_type} B={B}: row {i} "
                            f"({INVARIANCE_SECONDS[i]} s) differs from "
                            f"itself alone by {diffs[i]:.3e}")
                if B == 128 and feat_type == "mfcc":
                    audio = torch.zeros((B, max(map(len, sigs))),
                                        device=dev)
                    for r, x in enumerate(sigs):
                        audio[r, :len(x)] = torch.from_numpy(x).to(dev)
                    worst = max(worst, kernel_vs_plain(
                        dev, audio, torch.tensor([len(x) for x in sigs],
                                                 device=dev),
                        "B=128 with a 60 s row"))
            print(f"batch invariance {feat_type} [{card}]: B={B}, "
                  f"frames_max {frames}: max abs diff of each row vs "
                  f"itself alone {diffs}")
    return worst


def every_work_split(dev, rng, card: str) -> None:
    """Pass 1's raw features (cmvn off) and the whole output (cmvn on)
    under every work split the plan allows (mt 2 and 1, the basis in
    shared or global memory) must be bit-equal: a frame's arithmetic does
    not depend on the work item it falls in."""
    p = cuda_frontend.plan(400, 160, 512, 13, "mfcc", 40, SR)
    flen, fstride = host.frame_params(SR, 25, 10)
    for name, B, S, lens in (
            ("8 x 4 s ragged", 8, 4 * SR, [4 * SR] * 5 + [3 * SR, 9000, 300]),
            ("1 x 60 s", 1, 60 * SR, [60 * SR]),
            ("128 x 10 s", 128, 10 * SR, [10 * SR] * 128)):
        T = host.num_frames(S, flen, fstride)
        audio = noise(rng, B, S, dev)
        featlen = torch.tensor([(n - flen) // fstride for n in lens],
                               dtype=torch.int32, device=dev).clamp(0, T)
        splits = cuda_frontend.tiling_options(p, T, 13)
        for cmvn in (False, True):
            outs = [cuda_frontend.fused_frontend(
                audio, featlen, flen=flen, fstride=fstride, fft_length=512,
                feat_dim=13, feat_type="mfcc", num_mel_filters=40,
                sample_rate=SR, frames_max=T, apply_cmvn=cmvn,
                work_split=tl) for tl in splits]
            diffs = [float((o - outs[0]).abs().max()) for o in outs]
            print(f"work splits (mt, tt, basis in shared memory), {name}, "
                  f"cmvn={cmvn} [{card}]: max abs diff vs "
                  f"{splits[0][:2] + splits[0][3:4]}: "
                  + ", ".join(f"{tl[:2] + tl[3:4]} {d:.3e}"
                              for tl, d in zip(splits[1:], diffs[1:])))
            if not all(torch.equal(o, outs[0]) for o in outs):
                raise AssertionError(f"work splits, {name}, cmvn={cmvn}: "
                                     f"outputs differ by {max(diffs)}")


def golden(dev, rng) -> None:
    """The kernel against the speechpy golden (float64 NumPy) on
    synthesized speech."""
    sigs = [speech(rng, 2.5), speech(rng, 4.0)]
    S = -(-max(map(len, sigs)) // SR) * SR
    audio = np.zeros((2, S), np.float32)
    for i, s in enumerate(sigs):
        audio[i, :len(s)] = s
    fk, lk = frontend.extract_features(
        torch.from_numpy(audio).to(dev),
        torch.tensor([len(s) for s in sigs], device=dev), use_kernel=True)
    for i, s in enumerate(sigs):
        want = host.process_audio(s.astype(np.float64))
        T = want.shape[0]
        if int(lk[i]) != T:
            raise AssertionError(f"golden {i}: featlen {int(lk[i])} != {T}")
        err = check_close(f"golden {i}", fk[i, :T].cpu(),
                          torch.from_numpy(want), GOLDEN_TOL, GOLDEN_TOL)
        print(f"kernel vs speechpy golden utt {i} ({len(s) / SR:.2f}s) "
              f"max_abs_err {err:.3e}")


def kernel_ms(fn, names, reps: int = 20, traces: int = 2) -> dict:
    """Mean device ms per launch of each kernel whose name holds one of
    `names`, from a torch.profiler trace of reps calls of fn, each of
    which must launch it once.  A trace that lost launches (one held 18
    of 20 on an H100) is taken again, up to `traces` in all; the times
    come only from a trace that holds every launch."""
    def calls():
        for _ in range(reps):
            fn()

    fn()
    torch.cuda.synchronize()
    for attempt in range(traces):
        _, events = traced(calls)
        hits = {name: [e.time_range.elapsed_us() for e in events
                       if _is_device(e) and name in e.name]
                for name in names}
        short = {n: len(h) for n, h in hits.items() if len(h) != reps}
        if not short:
            return {n: sum(h) / reps / 1e3 for n, h in hits.items()}
        print(f"trace {attempt + 1} of {traces} holds {short} launches, "
              f"expected {reps} each")
    raise AssertionError(f"the trace holds {short} launches, expected "
                         f"{reps} each")


def in_turns(fns: dict, reps: int, rounds: int = 3) -> dict:
    """Median ms per call of fns["plain"] and fns["kernel"], timed in
    turns: plain, kernel, kernel, plain (CUDA events, reps calls a
    reading)."""
    runs = {k: [] for k in fns}
    for _ in range(rounds):
        for k in ("plain", "kernel", "kernel", "plain"):
            runs[k].append(cuda_ms(fns[k], reps))
    return {k: (float(np.median(v)), [round(x, 4) for x in v])
            for k, v in runs.items()}


def hmma_count() -> int:
    """HMMA instructions in the built kernel library (cuobjdump -sass)."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass",
                           str(_kernels.library_path("fused_frontend"))],
                          capture_output=True, text=True, check=True).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def phase_kernel(dev, card: str) -> dict:
    """Kernel vs plain and golden on the card; times at the main path's
    shapes (kernel and plain in turns), pass 2 alone, the stft
    yardstick, the HMMA count; returns the kernel line's numbers."""
    rng = np.random.default_rng(0)
    worst = kernel_cases(dev, rng)
    every_work_split(dev, rng, card)
    worst = max(worst, batch_invariance(dev, rng, card))
    golden(dev, rng)
    hmma = hmma_count()
    print(f"HMMA instructions in the built fused_frontend library: {hmma}")
    if hmma == 0:
        raise AssertionError("the built kernel has no tensor-core (HMMA) "
                             "instruction")
    res = {}
    for name, B, S in TIMED_SHAPES:
        T = host.num_frames(S, 400, 160)
        audio = noise(rng, B, S, dev)
        featlen = torch.full((B,), T, dtype=torch.int32, device=dev)
        kw = dict(flen=400, fstride=160, fft_length=512, feat_dim=13,
                  feat_type="mfcc", num_mel_filters=40, sample_rate=SR,
                  frames_max=T, apply_cmvn=True)
        fns = {"kernel": lambda: cuda_frontend.fused_frontend(audio, featlen,
                                                              **kw),
               "plain": lambda: frontend.reference_features(audio, featlen,
                                                            **kw)}
        want = fns["plain"]()
        check_close(f"{name} new", fns["kernel"](), want, RTOL, ATOL)
        times = in_turns(fns, 10 if B * S > 8 * 32 * SR else 50)
        b_ms, b_by = bound(B, S, T)
        ms = times["kernel"][0]
        print(f"frontend {name} mfcc13+cmvn+deltas, T {T} [{card}]: new "
              f"{ms:.4f} ms (runs {times['kernel'][1]}), plain "
              f"{times['plain'][0]:.4f} ms (runs {times['plain'][1]}); bound "
              f"{b_ms * 1e3:.2f} us ({b_by}), share {b_ms / ms:.4f}")
        res[name] = dict(ms=ms, plain_ms=times["plain"][0], bound_ms=b_ms,
                         bound_by=b_by)
        del audio, fns, want

    # each kernel's device time at 128 x 10 s and serving's 8 x 2 s, from
    # a trace of whole calls
    passes = {}
    names = ("features_kernel", "cmvn_stats_kernel", "cmvn_deltas_kernel")
    for name, B, S in TIMED_SHAPES[:2]:
        T = host.num_frames(S, 400, 160)
        audio = noise(rng, B, S, dev)
        featlen = torch.full((B,), T, dtype=torch.int32, device=dev)
        t = kernel_ms(lambda: cuda_frontend.fused_frontend(
            audio, featlen, flen=400, fstride=160, fft_length=512,
            feat_dim=13, feat_type="mfcc", num_mel_filters=40,
            sample_rate=SR, frames_max=T, apply_cmvn=True), names)
        passes[name] = t
        print(f"device time per launch at {name} (torch.profiler, 20 "
              f"calls) [{card}]: pass 1 {t[names[0]]:.4f} ms, statistics "
              f"{t[names[1]]:.4f} ms, pass 2 (normalize + deltas) "
              f"{t[names[2]]:.4f} ms, "
              f"{-(-T // cuda_frontend.pass2_frames(13))} blocks per "
              f"utterance")

    # yardstick for the spectrum stage only: torch.stft's power spectrum
    # of the same frames at 128 x 10 s (a 400-sample ones window centred
    # in 512: 56 samples of padding on the left line it up)
    B, S = 128, 10 * SR
    T = host.num_frames(S, 400, 160)
    audio = noise(rng, B, S, dev)
    need = 512 + (T - 1) * 160                 # exactly T frames
    xp = torch.nn.functional.pad(audio, (56, max(need - 56 - S, 0)))[:, :need]
    win = torch.ones(400, device=dev)
    spec = lambda: torch.stft(xp, 512, hop_length=160, win_length=400,
                              window=win, center=False,
                              return_complex=True).abs().square() / 512
    got = spec()[:2].transpose(1, 2)
    want = frontend.power_spectrum(frontend.frame_signal(audio[:2], 400, 160,
                                                         T), 512)
    check_close("stft yardstick spectrum", got / want.max(),
                want / want.max(), 1e-4, 1e-5)
    stft_ms = float(np.median([cuda_ms(spec, 10) for _ in range(3)]))
    print(f"stft power spectrum of the same frames at 128 x 10 s [{card}]: "
          f"{stft_ms:.4f} ms (the spectrum stage only; no PyTorch call "
          f"computes the whole function)")
    main = res[TIMED_SHAPES[0][0]]
    return dict(max_abs_err=worst, **main, share=main["bound_ms"] / main["ms"],
                passes=passes, stft_ms=stft_ms, hmma=hmma, shapes=res)


class CheckedRecognizer(Recognizer):
    """Records, for every greedy batch it transcribes, whether all logits
    are finite (the pool's op returns them for this check)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.finite = []

    def _raw_op(self, beam_size):
        op, kw = super()._raw_op(beam_size)
        return op, (kw if beam_size > 1 else {**kw, "logits": True})

    def _texts(self, out, n, beam_size):
        if beam_size <= 1:
            self.finite.append(bool(torch.isfinite(out[0]).all()))
        return super()._texts(out, n, beam_size)


LSTM_UNITS = 1280                # LAS-6-1280's listener, a direction
LSTM_SHAPES = ((48, 428, 1280), (96, 214, 1280), (48, 428, 640))
# the recurrence checked against its plain version: the word-piece cell's
# longest shapes (48 x 428, 96 x 214), two row tiles, a toy width
LSTM_CHECKS = ((48, 428, LSTM_UNITS), (96, 214, LSTM_UNITS),
               (100, 12, LSTM_UNITS), (5, 9, 32))
# from readings at LSTM_CHECKS on an H100, two seeds (PERF.md's kernel
# table): the kernels need atol 3.4e-07 at rtol 1e-5 (max abs err
# 7.2e-07; the plain version's own float32 error against float64 is as
# large), the plain version in TF32 at least 1.15e-04, a stale step 0.13
LSTM_TOL = dict(rtol=1e-5, atol=5e-6)
LSTM_CELL = (Path(__file__).parent / "bench_torch" / "configs"
             / "las_6_1280_park2019.json")
LSTM_KERNELS = ("lstm_forward_kernel", "lstm_backward_kernel")
LEAD_KERNELS = 8                 # lstm_traced's throwaway head of a trace


def lstm_weights(dev, D: int, U: int, seed: int) -> list:
    """nn.LSTM's flat weight list at its own init, seeded, bias_hh zero."""
    rnn = L.make_birnn(D, U, "lstm")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in rnn.parameters():
            p.uniform_(-U ** -0.5, U ** -0.5, generator=g)
    return [getattr(rnn, n).detach().to(dev).requires_grad_(
        n.startswith(("weight", "bias_ih"))) for n in rnn._flat_weights_names]


def lstm_recurrences(gates, dout, w_hh, core: str) -> tuple:
    """The recurrence's forward and backward, both directions, by `core`
    ('kernel': csrc/lstm_recurrence.cu, 'plain': ops/lstm's plain
    version) on a copy of gates (B, T, 8U: x W_ih^T + b) and on dout (B,
    T, 2U): (h, c, the activated gates, the gates' gradient)."""
    from automatic_speech_recognition_torch.ops import lstm
    fwd, bwd = ((lstm.recurrence_forward, lstm.recurrence_backward)
                if core == "kernel" else
                (lstm.plain_forward, lstm.plain_backward))
    B, T, G8 = gates.shape
    act = gates.clone()
    cells, out = act.new_empty(B, T, G8 // 4), act.new_empty(B, T, G8 // 4)
    fwd(act, cells, out, w_hh)
    dgates = torch.empty_like(act)
    bwd(dgates, dout, act, cells, w_hh)
    return out, cells, act, dgates


def lstm_inputs(dev, B: int, T: int, U: int, seed: int) -> tuple:
    """(gates, dout, w_hh) of one BiLSTM call, seeded: pre-activations of
    an input of unit variance through nn.LSTM's init at 1280 inputs
    (standard deviation (1280 / 3U)^0.5), the output's gradient of unit
    variance, both directions' W_hh at nn.LSTM's init."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gates = torch.randn(B, T, 8 * U, device=dev, generator=g)
    gates *= (1280 / (3 * U)) ** 0.5
    dout = torch.randn(B, T, 2 * U, device=dev, generator=g)
    w_hh = tuple((torch.rand(4 * U, U, device=dev, generator=g) * 2 - 1)
                 * U ** -0.5 for _ in range(2))
    return gates, dout, w_hh


def lstm_stale(gates, out, w_hh, t: int):
    """gates whose forward step t (> 1) takes h_{t-2} where h_{t-1}
    belongs, in both directions, as a recurrence that read a stale h
    would: a fault the check must catch."""
    U = w_hh[0].shape[1]
    bad = gates.clone()
    for d, (now, before) in enumerate(((t - 1, t - 2), (t + 1, t + 2))):
        if 0 <= before < gates.shape[1]:
            hu = slice(U * d, U * (d + 1))
            bad[:, t, 4 * U * d:4 * U * (d + 1)] += (
                out[:, before, hu] - out[:, now, hu]) @ w_hh[d].t()
    return bad


def lstm_launches(events) -> tuple:
    """(forward, backward) launches of the recurrence kernels in a
    torch.profiler trace's events."""
    names = [e.name for e in events if _is_device(e)]
    return tuple(sum(k in n for n in names) for k in LSTM_KERNELS)


def lstm_traced(fn, want: tuple, traces: int = 3) -> tuple:
    """(fn(), (forward, backward) recurrence launches in its trace).  A
    trace can lose its first device records: on an H100, once CUDA graphs
    had replayed under a profiler earlier in the process, every later
    trace lost its first three.  So fn runs after LEAD_KERNELS
    one-element kernels inside the trace, and a trace that still lost a
    launch is taken again, up to `traces` in all (as kernel_ms does); the
    counts are the last trace's."""
    def lead_then_fn():
        for _ in range(LEAD_KERNELS):
            torch.zeros(1, device="cuda")
        return fn()

    for attempt in range(traces):
        out, events = traced(lead_then_fn)
        got = lstm_launches(events)
        if got == want:
            break
        print(f"trace {attempt + 1} of {traces} holds {got} recurrence "
              f"launches, expected {want}")
    return out, got


def lstm_compare(name: str, got: tuple, want: tuple, tol: dict) -> dict:
    """check_close of each of lstm_recurrences' four results: name -> max
    abs err."""
    return {k: check_close(f"{name} {k}", a, b, **tol)
            for k, a, b in zip(("h", "c", "gates", "dgates"), got, want)}


def lstm_least_s(B: int, T: int, D: int, U: int) -> tuple:
    """(least seconds of the whole BiLSTM's forward and backward, least
    seconds of its recurrences alone): operations at float32's 67 TFLOP/s
    or bytes at 3.35 TB/s, the larger (bench_torch's las_lstm.rnn_work:
    3 x the forward's 2 x 4U (D + U) a frame a direction; the recurrences'
    2 x 4U x U a frame a direction, forward and backward)."""
    g = 4 * U
    fwd = T * g * U + g * D + B * T * D + B * T * U + B * T * g
    bwd = T * g * U + B * T * g + B * T * U + 2 * B * T * D + g * (D + U)
    fp32 = work.PEAK_FLOPS["float32"]
    whole = max(3 * 2 * 2 * B * T * g * (D + U) / fp32,
                2 * 4 * (fwd + bwd) / work.HBM_BYTES_PER_S)
    rec = 2 * 2 * 2 * B * T * g * U / fp32
    return whole, rec


def lstm_refused(name: str, got: tuple, want: tuple) -> str:
    """lstm_compare's refusal of a wrong recurrence, or raise."""
    try:
        lstm_compare(name, got, want, LSTM_TOL)
    except AssertionError as e:
        return str(e)
    raise AssertionError(f"{name} passes {LSTM_TOL}")


def lstm_checks(dev) -> float:
    """The recurrence kernels against their plain version at each of
    LSTM_CHECKS, forward and backward over the whole sequence (h, c, the
    activated gates, the gates' gradient) within LSTM_TOL; beside each,
    the plain version's own float32 error against float64, and two wrong
    recurrences the check must refuse: the plain version in TF32, and
    with a stale h at one step.  Returns the largest error."""
    worst = 0.0
    for B, T, U in LSTM_CHECKS:
        gates, dout, w_hh = lstm_inputs(dev, B, T, U, seed=B * T + U)
        name = f"lstm {B}x{T}x{U}"
        want = lstm_recurrences(gates, dout, w_hh, "plain")
        errs = lstm_compare(name, lstm_recurrences(gates, dout, w_hh,
                                                   "kernel"), want, LSTM_TOL)
        f64 = lstm_recurrences(gates.double(), dout.double(),
                               tuple(w.double() for w in w_hh), "plain")
        own = {k: float((a.double() - b).abs().max())
               for k, a, b in zip(errs, want, f64)}
        worst = max([worst, *errs.values()])
        line = (f"{name}: kernels = plain, max abs err "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + "; plain float32 vs float64 "
                + ", ".join(f"{k} {v:.3e}" for k, v in own.items()))
        mm = torch.backends.cuda.matmul
        prev, mm.allow_tf32 = mm.allow_tf32, True
        try:
            tf32 = lstm_recurrences(gates, dout, w_hh, "plain")
        finally:
            mm.allow_tf32 = prev
        line += f"; in TF32 refused ({lstm_refused(name, tf32, want)})"
        t = 3 * T // 4
        stale = lstm_recurrences(lstm_stale(gates, want[0], w_hh, t), dout,
                                 w_hh, "plain")
        line += (f"; a stale h at step {t} refused "
                 f"({lstm_refused(name, stale, want)})")
        print(line)
    return worst


def lstm_las_step(dev, card: str) -> dict:
    """One train step of LAS-6-1280 at its published widths (the values
    of bench_torch/configs/las_6_1280_park2019.json) on a batch of the
    word-piece cell's longest bucket (48 rows of 1710 frames: 428
    listener steps; 96 tokens), under torch.profiler after a step that
    warms it: the recurrence kernels' launches and the frame-steps they
    ran against the listener's, counted over that step alone, and the
    cuDNN RNN ops and kernels in it (none)."""
    from automatic_speech_recognition_torch.utils import spans
    values = json.loads(LSTM_CELL.read_text())["values"]
    fields = Config.__dataclass_fields__
    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in values.items() if k in fields})
    B, frames, tokens = 48, 1710, 96
    samples = (frames - 1) * 160 + 400
    g = torch.Generator(device=dev).manual_seed(11)
    batch = (0.1 * torch.randn(B, samples, device=dev, generator=g),
             torch.full((B,), samples, dtype=torch.int32, device=dev),
             torch.randint(3, cfg.vocab_size, (B, tokens), device=dev,
                           generator=g, dtype=torch.int32),
             torch.full((B,), tokens, dtype=torch.int32, device=dev))
    ts = trainer.create_train_state(cfg, dev)
    trainer.train_step(ts, batch, cfg)
    torch.cuda.synchronize()
    before = spans.totals()
    out, events = traced(lambda: trainer.train_step(ts, batch, cfg))
    loss = float(out["loss"])
    counters = ("las.listener.rnn_frames", L.KERNEL_FRAMES)
    got = spans.report(before, counters)
    frames_all, kernel = (got.get(k, {}).get("count", 0) for k in counters)
    fwd, bwd = lstm_launches(events)
    cudnn_ops = sum("cudnn_rnn" in e.name for e in events)
    cudnn_kernels = sorted({e.name[:48] for e in events if _is_device(e)
                            and ("RNN" in e.name or "LSTM" in e.name)})
    print(f"LAS-6-1280 train step, {B} x {frames} frames, {tokens} tokens "
          f"[{card}]: loss {loss:.4f}; recurrence launches in the trace "
          f"{fwd} forward + {bwd} backward; listener "
          f"frame-steps {frames_all}, {kernel} through the kernels "
          f"({100 * kernel / max(frames_all, 1):.1f} %); cuDNN RNN ops "
          f"{cudnn_ops}, kernels {cudnn_kernels}")
    layers_n = cfg.num_enc_layers
    if not (fwd == bwd == 2 * layers_n and kernel == frames_all > 0
            and cudnn_ops == 0 and not cudnn_kernels):
        raise AssertionError("the LSTM listener's step did not run every "
                             "recurrence through the kernels")
    return dict(forward_launches=fwd, backward_launches=bwd,
                frames=frames_all, kernel_frames=kernel)


def lstm_row(lk: dict, card: str) -> dict:
    """The kernels line's entry of the recurrence kernels."""
    return {"name": "lstm_recurrence", "route": "cuda",
            "source": "automatic_speech_recognition_torch/csrc/"
                      "lstm_recurrence.cu",
            "replaces": None, "max_abs_err": lk["max_abs_err"],
            "launches": lk["las_step"]["forward_launches"]
            + lk["las_step"]["backward_launches"],
            "las_step": lk["las_step"], "shapes": lk["shapes"], "card": card}


def phase_lstm(dev, card: str) -> dict:
    """The BiLSTM recurrence kernels (csrc/lstm_recurrence.cu): against
    their plain PyTorch version (lstm_checks), one LAS-6-1280 train step's
    launches and frame-steps (lstm_las_step); then, at the word-piece
    cell's longest shapes, the whole BiLSTM forward + backward with the
    kernels and cuDNN's (nn.LSTM, the library_ms yardstick), and the
    recurrence alone by the kernels and by the plain version, in turns,
    beside their least times."""
    from automatic_speech_recognition_torch.ops import lstm
    t0 = time.perf_counter()
    _kernels.load("lstm_recurrence")
    print(f"lstm_recurrence build + load: {time.perf_counter() - t0:.2f} s")
    print(_kernels.build_log.get("lstm_recurrence", "(already built)").strip())
    err = lstm_checks(dev)
    step = lstm_las_step(dev, card)
    rows = {}
    for B, T, D in LSTM_SHAPES:
        U = LSTM_UNITS
        g = torch.Generator(device=dev).manual_seed(7)
        weights = lstm_weights(dev, D, U, seed=3)
        x = torch.randn(B, T, D, device=dev, generator=g).requires_grad_()
        dout = torch.randn(B, T, 2 * U, device=dev, generator=g)
        rnn = L.make_birnn(D, U, "lstm").to(dev)
        with torch.no_grad():
            for n, p in rnn.named_parameters():
                p.copy_(weights[rnn._flat_weights_names.index(n)])
        leaves = [x] + [w for w in weights if w.requires_grad]

        def kernel():
            torch.autograd.grad(lstm.bilstm(x, weights), leaves, dout)

        def cudnn():
            out, _ = rnn(x)
            torch.autograd.grad(out, [x] + list(rnn.parameters()), dout)

        gates, _, w_hh = lstm_inputs(dev, B, T, U, seed=5)
        fns = {"kernel": kernel, "cudnn": cudnn,
               "recurrence": lambda: lstm_recurrences(gates, dout, w_hh,
                                                      "kernel"),
               "plain": lambda: lstm_recurrences(gates, dout, w_hh, "plain")}
        for fn in fns.values():
            fn()                                   # warm: plans, the build
        runs = {k: [] for k in fns}
        for k in ("plain", "kernel", "cudnn", "recurrence", "recurrence",
                  "cudnn", "kernel", "plain"):
            runs[k].append(cuda_ms(fns[k], 2))
        ms = {k: float(np.median(v)) for k, v in runs.items()}
        whole, least_rec = lstm_least_s(B, T, D, U)
        key = f"{B}x{T}x{D}"
        rows[key] = dict(ms=ms["kernel"], library_ms=ms["cudnn"],
                         bound_ms=1e3 * whole,
                         share=1e3 * whole / ms["kernel"],
                         recurrence_ms=ms["recurrence"],
                         plain_ms=ms["plain"],
                         recurrence_bound_ms=1e3 * least_rec,
                         recurrence_share=1e3 * least_rec / ms["recurrence"])
        print(f"lstm BiLSTM fwd+bwd at B {B}, T {T}, D {D}, U {U} [{card}]: "
              f"kernels {ms['kernel']:.2f} ms (least {1e3 * whole:.2f}, "
              f"share {rows[key]['share']:.3f}), cuDNN {ms['cudnn']:.2f} ms; "
              f"the recurrence alone: kernels {ms['recurrence']:.2f} ms "
              f"(least {1e3 * least_rec:.2f}, share "
              f"{rows[key]['recurrence_share']:.3f}), plain "
              f"{ms['plain']:.2f} ms")
    return dict(max_abs_err=err, las_step=step, shapes=rows)


def phase_serving(dev, card: str) -> int:
    """Published-width greedy serving; returns the kernel launches the
    served traffic made."""
    cfg = published_cfg()
    model = las.init(cfg, torch.Generator().manual_seed(0), dev)
    n_params = sum(p.numel() for p in model.parameters())
    rec = CheckedRecognizer(model, cfg, CharEncoder(), dev)
    rng = np.random.default_rng(1)
    durations = [1.0, 1.5, 2.5, 3.0, 3.5, 5.0, 6.0, 7.5, 9.0, 12.0, 15.0,
                 20.0, 1.2, 4.5, 10.5, 18.0]
    sigs = [speech(rng, d) for d in durations]
    print(f"serving: LAS at published width, {n_params} parameters, "
          f"{len(sigs)} requests of {min(map(len, sigs)) / SR:.2f}-"
          f"{max(map(len, sigs)) / SR:.2f} s")

    srv = BatchingRecognizer(rec, max_batch=8, max_wait_ms=50,
                             bucket_seconds=BUCKETS)
    t0 = time.perf_counter()
    srv.warmup()
    torch.cuda.synchronize()
    print(f"warmup of {len(BUCKETS)} buckets: "
          f"{time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats(dev)
    rec.finite.clear()
    futures = [None] * len(sigs)

    def client(idx):
        for i in idx:
            futures[i] = srv.submit(sigs[i])
            time.sleep(0.005)

    cuda_frontend.fused_frontend.launches = 0
    srv.start()
    try:
        threads = [threading.Thread(target=client,
                                    args=(range(k, len(sigs), 4),))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        texts = [f.result(timeout=600) for f in futures]
    finally:
        srv.stop()
    launches = cuda_frontend.fused_frontend.launches
    snap = srv.stats.snapshot()
    if not all(isinstance(t, str) for t in texts):
        raise AssertionError("a request did not resolve to a str")
    if snap["requests"] != len(sigs) or snap["errors"]:
        raise AssertionError(f"serving stats: {snap}")
    if launches < snap["batches"] or launches == 0:
        raise AssertionError(f"kernel launches {launches} < batches "
                             f"{snap['batches']}")
    if not rec.finite or not all(rec.finite):
        raise AssertionError("non-finite logits in a served batch")
    print(f"served {len(texts)} requests in {snap['batches']} batches, "
          f"fused_frontend launches {launches}, sample transcripts "
          f"{[t[:24] for t in texts[:3]]}")
    print(f"serving stats [{card}]: {json.dumps(snap)}")
    print(f"peak device memory while serving [{card}]: "
          f"{torch.cuda.max_memory_allocated(dev)} bytes")

    # one batch: kernel frontend vs plain frontend on the card
    batch = [s for s in sigs if len(s) <= 8 * SR][:8]
    fk, lk = rec._features(batch, pad_seconds=8)
    plain = Recognizer(model, cfg.replace(use_pallas=False),
                       CharEncoder(), dev)
    fp, lp = plain._features(batch, pad_seconds=8)
    torch.cuda.synchronize()
    if not torch.equal(lk, lp):
        raise AssertionError("featlen differs between kernel and plain")
    err = check_close("serving batch features", fk, fp, RTOL, ATOL)
    logits_k, y_k = rec.greedy(fk, lk)
    logits_p, y_p = plain.greedy(fp, lp)
    # compare up to the first step where either run's top-2 logit gap is
    # under 1e-3 (a near tie may flip the argmax and the feedback)
    gap = lambda lg: lg.topk(2, -1).values.diff(dim=-1).abs()[..., 0]
    tie = (torch.minimum(gap(logits_k), gap(logits_p)) < 1e-3).any(0)
    n = int(tie.nonzero()[0]) if tie.any() else logits_k.shape[1]
    if not torch.equal(y_k[:, :n], y_p[:, :n]):
        raise AssertionError("y_hat differs before the first near tie")
    lerr = check_close("serving batch logits", logits_k[:, :n],
                       logits_p[:, :n], 1e-3, 1e-3)
    print(f"serving batch kernel vs plain frontend: features max_abs_err "
          f"{err:.3e}, logits max_abs_err {lerr:.3e} over the first {n} of "
          f"{logits_k.shape[1]} steps, y_hat equal")

    # ms per batch of 8 per bucket
    pool = sorted(sigs, key=len)
    for b in BUCKETS:
        fit = [s for s in pool if len(s) <= b * SR] or [pool[0]]
        batch = (fit[-8:] * 8)[:8]
        steps = max(int(cfg.convert_rate * host.num_frames(b * SR, 400, 160)),
                    1)
        ms = cuda_ms(lambda: rec.transcribe_signals(batch, pad_seconds=b), 3)
        print(f"greedy batch of 8 at the {b:2d} s bucket ({steps} decoder "
              f"steps) [{card}]: {ms:.2f} ms/batch")
    return launches


def train_cfg() -> Config:
    """published_cfg() with the recipe's train flags, over raw audio."""
    return published_cfg().replace(
        audio_shards=True, lr=1e-4, grad_clip=5.0, label_smoothing=True,
        scheduled_sampling=False, bucket_boundaries_train=TRAIN_BUCKETS)


def write_train_shards(directory: str, rng: np.random.Generator) -> None:
    """Two raw-audio shards, (S, 1, 1) float32 records: per bucket, 4
    synthesized utterances repeated over its batch at 80-100 % of the
    bucket's length, so one pass of the loader is one batch per bucket.
    A transcript is the utterance's phone names, CHARS_PER_SECOND
    characters a second."""
    tok = CharEncoder()
    names = [p for p in PHONES if p not in ("SIL", "SP")]
    records = []
    for seconds, batch in zip(TRAIN_SECONDS, TRAIN_BATCH):
        pool = []
        for _ in range(4):
            phones = list(rng.choice(names, int(seconds * 10)))
            text = " ".join(phones)[:int(seconds * CHARS_PER_SECOND)]
            pool.append((synth_phones(phones, rng=rng),
                         tok.encode(text.strip(), with_eos=True)))
        for i in range(batch):
            sig, ids = pool[i % 4]
            n = int(seconds * SR * rng.uniform(0.8, 1.0))
            records.append((np.resize(sig, n).astype(np.float32),
                            np.asarray(ids, np.int32)))
    order = rng.permutation(len(records))
    for k in range(2):
        part = [records[i] for i in order[k::2]]
        shards.write_shard(os.path.join(directory, f"train-{k}.arsh"),
                           [r[0][:, None, None] for r in part],
                           [r[1] for r in part])


def run_train_cli(shard_dir: str, save_dir: str, epoch: int,
                  extra: list, base: list = PUBLISHED_FLAGS):
    """train.main for `epoch` epochs of 3 steps; checks the run and
    returns its fused-kernel launches and its final state."""
    before = cuda_frontend.fused_frontend.launches
    ts, hist = train_cli.main(
        ["--device", "cuda:0"] + base + [
            "--shard_dir", shard_dir, "--save_dir", save_dir,
            "--summary_dir", os.path.join(save_dir, "summary"),
            "--epoch", str(epoch)] + extra)
    torch.cuda.synchronize()
    launches = cuda_frontend.fused_frontend.launches - before
    steps = len(hist["loss"])
    if ts.step != 3 * epoch or steps != 3:
        raise AssertionError(f"run to epoch {epoch} took {steps} steps and "
                             f"ended at step {ts.step}, expected 3 steps "
                             f"ending at {3 * epoch}")
    if not (np.all(np.isfinite(hist["loss"]))
            and np.all(np.isfinite(hist["grad_norm"]))):
        raise AssertionError(f"non-finite training metrics: {hist}")
    if launches < steps:
        raise AssertionError(f"fused_frontend launched {launches} times in "
                             f"{steps} steps")
    for rnn in ts.model.modules():
        if isinstance(rnn, torch.nn.RNN) and (rnn.bias_hh_l0.any()
                                              or rnn.bias_hh_l0_reverse.any()):
            raise AssertionError("bias_hh moved off zero")
    epochs = CheckpointManager(save_dir).all_epochs()
    if epochs != list(range(1, epoch + 1)):
        raise AssertionError(f"checkpoints {epochs} after epoch {epoch}")
    print(f"train.main {' '.join(extra) or '(attention only)'} to epoch "
          f"{epoch}: steps {ts.step - steps + 1}-{ts.step}, losses "
          f"{[round(x, 4) for x in hist['loss']]}, grad norms "
          f"{[round(x, 4) for x in hist['grad_norm']]}, fused_frontend "
          f"launches {launches}, checkpoints {epochs}")
    return launches, ts


def device_busy(events, name: str):
    """(busy, span) in ms from a profiler trace: the union of the device's
    kernel and copy intervals, and the span from the start of the host
    range `name` to the end of the last of them."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in events if _is_device(e))
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    start = min(e.time_range.start for e in events
                if e.name == name and e.device_type
                == torch.autograd.DeviceType.CPU)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1e3, (max(e for _, e in spans) - start) / 1e3


def top_kernels(events, n: int = 6) -> str:
    """Device time by kernel name, the n largest, with launch counts."""
    total, calls = {}, {}
    for e in filter(_is_device, events):
        total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us()
        calls[e.name] = calls.get(e.name, 0) + 1
    top = sorted(total, key=total.get, reverse=True)[:n]
    return "; ".join(f"{k[:60]} {total[k] / 1e3:.2f} ms x{calls[k]}"
                     for k in top)


def step_timings(ts, batch, cfg: Config, card: str) -> None:
    """ms per train step (CUDA events, median of 3 after a warm-up), the
    frontend's and the forward's share, peak memory, and the idle share
    and top kernels of one profiled step, for one bucket's batch."""
    dev = batch[0].device
    B, S = batch[0].shape[:2]
    step = lambda: trainer.train_step(ts, batch, cfg)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = [cuda_ms(step, 1) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        fe_ms = float(np.median([
            cuda_ms(lambda: frontend.featurize_batch(batch[0], batch[1], cfg),
                    1) for _ in range(5)]))
        feats = frontend.featurize_batch(batch[0], batch[1], cfg)
    forward = lambda: las.total_loss(ts.model, (*feats, *batch[2:]), cfg,
                                     batch[2].shape[1], ts.generator,
                                     ts.step)
    fwd_ms = float(np.median([cuda_ms(forward, 1) for _ in range(3)]))
    _, events = traced(step, "train_step")
    busy_ms, span_ms = device_busy(events, "train_step")
    ms = float(np.median(times))
    print(f"train step, {S / SR:.3f} s bucket, batch {B}, "
          f"{batch[2].shape[1]} decoder steps [{card}]: {ms:.2f} ms/step "
          f"(median of {[round(t, 2) for t in times]}); frontend "
          f"{fe_ms:.3f} ms = {100 * fe_ms / ms:.2f} % of the step; forward "
          f"(listener + speller + losses) {fwd_ms:.2f} ms; peak device "
          f"memory {peak} bytes; profiled step: device busy {busy_ms:.2f} "
          f"ms of {span_ms:.2f} ms, idle share {1 - busy_ms / span_ms:.4f}")
    print(f"  top kernels of the profiled step [{card}]: "
          f"{top_kernels(events)}")


def train_batches(d: str, cfg: Config, dev) -> list:
    """One batch of each training bucket from the shards in d, on the
    device, shortest first (one pass of the loader is one batch a
    bucket)."""
    loader = BucketedLoader(sorted(glob.glob(os.path.join(d, "train-*.arsh"))),
                            cfg, seed=0)
    it = iter(loader)
    host_batches = sorted((next(it) for _ in TRAIN_BUCKETS),
                          key=lambda b: b[0].shape[1])
    return [tuple(torch.from_numpy(x).to(dev) for x in b)
            for b in host_batches]


def phase_train(dev, card: str, d: str) -> int:
    """Published-width training over the raw-audio shards in d; returns the
    kernel launches of the train.main runs."""
    cfg = train_cfg()
    launches = 0
    for name, extra in (("att", []),
                        ("ctc", ["--ctc", "True", "--ctc_weight", "0.2"])):
        save = os.path.join(d, f"model_{name}")
        launches += run_train_cli(d, save, 1, extra)[0]
        launches += run_train_cli(d, save, 2, extra)[0]   # resumes at 4
    batches = train_batches(d, cfg, dev)

    ts = trainer.create_train_state(cfg, dev)
    print(f"training: LAS at published width, "
          f"{las.num_params(ts.model)} trainable parameters")
    for batch in batches:
        step_timings(ts, batch, cfg, card)

    # the loss falls on one repeated batch
    ts = trainer.create_train_state(cfg, dev)
    losses = torch.stack([trainer.train_step(ts, batches[0], cfg)["loss"]
                          for _ in range(OVERFIT_STEPS)]).tolist()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall in {OVERFIT_STEPS} steps "
                             f"on one batch: {losses}")
    print(f"{OVERFIT_STEPS} steps on one {TRAIN_SECONDS[0]} s batch: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")

    # one step from identical state: kernel frontend vs plain frontend
    got = {}
    for use_kernel in (True, False):
        c = cfg.replace(use_pallas=use_kernel)
        m = trainer.train_step(trainer.create_train_state(c, dev),
                               batches[1], c)
        got[use_kernel] = (m["loss"].item(), m["grad_norm"].item())
    (lk, gk), (lp, gp) = got[True], got[False]
    if abs(lk - lp) > 1e-4 * abs(lp) or abs(gk - gp) > 1e-3 * abs(gp):
        raise AssertionError(f"kernel vs plain frontend step: loss {lk} vs "
                             f"{lp}, grad norm {gk} vs {gp}")
    print(f"one step on the {TRAIN_SECONDS[1]} s batch, kernel vs plain "
          f"frontend: loss {lk:.6f} vs {lp:.6f} (rel {abs(lk - lp) / lp:.2e}"
          f"), grad norm {gk:.6f} vs {gp:.6f} (rel "
          f"{abs(gk - gp) / gp:.2e})")
    return launches


def beam_modes(cfg: Config):
    """mode -> (config, whether the fusion LM is on): the recipe's beam
    decodes (run.sh:32, :109-113, :136-140)."""
    return {"attention": (cfg, False),
            "lm": (cfg.replace(apply_lm=True, lm_weight=0.5), True),
            "joint_ctc": (cfg.replace(ctc_beam_weight=0.5), False)}


class BeamCheckedRecognizer(Recognizer):
    """Records, for every beam batch it transcribes, whether rank 0 holds
    a hypothesis and every score is a number, and the decoder steps."""

    def __init__(self, *args):
        super().__init__(*args)
        self.ok, self.steps = [], []

    def _texts(self, res, n, beam_size):
        if beam_size > 1:
            kept = res.scores > beam_lib.NEG / 2
            self.ok.append(bool(kept[:, 0].all())
                           and bool(torch.isfinite(res.scores[kept]).all())
                           and not bool(torch.isnan(res.scores).any()))
            self.steps.append(res.steps)
        return super()._texts(res, n, beam_size)


def compare_rank0(name: str, got, want) -> int:
    """Rank-0 hypotheses of two beam runs: equal tokens, or, where they
    differ, rank-0 scores that tie within NEAR_TIE relative (either is a
    best hypothesis).  Returns the number of near ties."""
    ties = 0
    for b in range(want.tokens.shape[0]):
        g = got.tokens[b, 0, :got.lengths[b, 0]].cpu()
        w = want.tokens[b, 0, :want.lengths[b, 0]].cpu()
        if torch.equal(g, w):
            continue
        sg, sw = float(got.scores[b, 0]), float(want.scores[b, 0])
        if abs(sg - sw) > NEAR_TIE * abs(sw):
            raise AssertionError(f"{name}: utterance {b} rank 0 differs "
                                 f"({g.tolist()} vs {w.tolist()}) with "
                                 f"scores {sg} vs {sw}")
        ties += 1
    return ties


def check_beam1_greedy(rec: Recognizer, feats, featlen) -> int:
    """Beam 1 against greedy y_hat, up to the first step where greedy's
    top-2 logit gap is under NEAR_TIE, the first EOS (included) or <SOS>
    (beam search never re-emits it), and the beam's own length.  Returns
    the number of tokens compared."""
    res = rec.beam(feats, featlen, 1)
    logits, y_hat = rec.greedy(feats, featlen)
    gap = logits.topk(2, -1).values.diff(dim=-1).abs()[..., 0]
    compared = 0
    for b in range(y_hat.shape[0]):
        limit = int(res.lengths[b, 0])
        tie = (gap[b] < NEAR_TIE).nonzero()
        if len(tie):
            limit = min(limit, int(tie[0]))
        for stop, extra in ((2, 1), (1, 0)):
            hit = (y_hat[b] == stop).nonzero()
            if len(hit):
                limit = min(limit, int(hit[0]) + extra)
        if not torch.equal(res.tokens[b, 0, :limit], y_hat[b, :limit]):
            raise AssertionError(f"beam 1 vs greedy, utterance {b}: "
                                 f"{res.tokens[b, 0, :limit].tolist()} vs "
                                 f"{y_hat[b, :limit].tolist()}")
        compared += limit
    return compared


def phase_beam(dev, card: str) -> int:
    """Published-width beam search (three modes, three buckets) and beam
    serving; returns the kernel launches of those decodes."""
    cfg = published_cfg().replace(ctc=True, beam_logprob=True)
    model = las.init(cfg, torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        # random weights put EOS among the first candidates, so every
        # search would fill its bank within a few steps; a lower EOS bias
        # makes each utterance run its step budget, as a trained model's
        # decode of speech at 11 characters a second about does
        model.speller.out.bias[EOS_ID] -= EOS_SHIFT
        model.speller.ctc_head.bias[EOS_ID] -= EOS_SHIFT
    lm_cfg = char_rnn.LMConfig(**LM_SHAPE)
    lm = char_rnn.init(lm_cfg, torch.Generator().manual_seed(1), dev)
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(os.path.join(d, "model")).save_weights(1, model)
        char_rnn.save_lm_dir(os.path.join(d, "lm"), lm, lm_cfg)
        base = BeamCheckedRecognizer.from_checkpoint(
            os.path.join(d, "model"), cfg, lm_dir=os.path.join(d, "lm"),
            device=dev)
    for a, b in zip(list(model.state_dict().values())
                    + list(lm.state_dict().values()),
                    list(base.model.state_dict().values())
                    + list(base.lm.state_dict().values())):
        if not torch.equal(a, b):
            raise AssertionError("weights changed on their way through disk")
    print(f"beam: LAS at published width with a CTC head "
          f"({las.num_params(base.model)} parameters), fusion LM "
          f"{LM_SHAPE} ({sum(p.numel() for p in base.lm.parameters())} "
          f"parameters), both loaded by Recognizer.from_checkpoint")
    recs = {mode: BeamCheckedRecognizer(
                base.model, c, base.tokenizer, dev,
                base.lm if use_lm else None, base.lm_cfg if use_lm else None)
            for mode, (c, use_lm) in beam_modes(cfg).items()}
    rng = np.random.default_rng(3)
    batches = {b: [speech(rng, b * rng.uniform(0.8, 1.0)) for _ in range(8)]
               for b in BEAM_BUCKETS}
    serve_sigs = [speech(rng, s) for s in (1.0, 1.8, 2.5, 3.5, 6.0, 7.5,
                                           12.0, 15.0)]

    cuda_frontend.fused_frontend.launches = 0
    texts = []
    for b in BEAM_BUCKETS:
        encode = lambda: base.model.listener(*base._features(
            batches[b], pad_seconds=b))
        with torch.inference_mode():
            encode()
            enc_ms = cuda_ms(encode, 3)
        for mode, rec in recs.items():
            run = lambda: texts.extend(rec.transcribe_signals(
                batches[b], beam_size=BEAM_SIZE, pad_seconds=b))
            run()                                          # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            ms = cuda_ms(run, 3)
            peak = torch.cuda.max_memory_allocated(dev)
            steps = rec.steps[-1]
            print(f"beam {BEAM_SIZE}, batch of 8 at the {b:2d} s bucket, "
                  f"{mode:9s} [{card}]: {ms:.2f} ms/batch, {steps} decoder "
                  f"steps, {(ms - enc_ms) / steps:.3f} ms/step beside "
                  f"frontend + listener {enc_ms:.2f} ms, peak device memory "
                  f"{peak} bytes")
    srv = BatchingRecognizer(recs["joint_ctc"], max_batch=8, max_wait_ms=50,
                             beam_size=BEAM_SIZE,
                             bucket_seconds=(2, 4, 8, 16))
    futures = [None] * len(serve_sigs)

    def client(i):
        futures[i] = srv.submit(serve_sigs[i])

    with srv:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(serve_sigs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        served = [f.result(timeout=600) for f in futures]
    torch.cuda.synchronize()
    launches = cuda_frontend.fused_frontend.launches
    snap = srv.stats.snapshot()
    if not all(isinstance(t, str) for t in texts + served):
        raise AssertionError("a beam decode did not give a str")
    if snap["requests"] != len(serve_sigs) or snap["errors"]:
        raise AssertionError(f"beam serving stats: {snap}")
    if not all(rec.ok and all(rec.ok) for rec in recs.values()):
        raise AssertionError("a beam batch had no rank-0 hypothesis or a "
                             "non-finite kept score")
    if launches == 0:
        raise AssertionError("fused_frontend was not launched by the beam "
                             "decodes")
    print(f"beam serving of {len(served)} concurrent requests (joint CTC) "
          f"[{card}]: {json.dumps(snap)}; fused_frontend launches in the "
          f"beam phase {launches}; sample transcripts "
          f"{[t[:24] for t in served[:3]]}")

    rec = recs["joint_ctc"]
    _, events = traced(lambda: rec.transcribe_signals(
        batches[8], beam_size=BEAM_SIZE, pad_seconds=8), "beam_batch")
    busy_ms, span_ms = device_busy(events, "beam_batch")
    print(f"profiled beam batch, 8 s bucket, joint CTC [{card}]: device busy "
          f"{busy_ms:.2f} ms of {span_ms:.2f} ms, idle share "
          f"{1 - busy_ms / span_ms:.4f}, {rec.steps[-1]} decoder steps")
    print(f"  top kernels of the profiled beam batch [{card}]: "
          f"{top_kernels(events)}")

    feats, featlen = recs["attention"]._features(batches[8], pad_seconds=8)
    n = check_beam1_greedy(recs["attention"], feats, featlen)
    print(f"beam 1 = greedy y_hat over {n} tokens of the 8 s batch")

    feats, featlen = recs["attention"]._features(batches[2], pad_seconds=2)
    model_cpu = copy.deepcopy(base.model).cpu()
    lm_cpu = copy.deepcopy(base.lm).cpu()
    for mode, (c, use_lm) in beam_modes(cfg).items():
        on_cpu = Recognizer(model_cpu, c, base.tokenizer, "cpu",
                            lm_cpu if use_lm else None,
                            base.lm_cfg if use_lm else None)
        got = recs[mode].beam(feats, featlen, BEAM_SIZE)
        want = on_cpu.beam(feats.cpu(), featlen.cpu(), BEAM_SIZE)
        ties = compare_rank0(f"CUDA vs CPU, {mode}", got, want)
        print(f"CUDA vs CPU beam {BEAM_SIZE} on the 2 s batch, {mode}: rank 0 "
              f"equal on {8 - ties} of 8 utterances, {ties} near ties")
    return launches


RECIPE_TRAIN = ((16, 1.2, 1.8), (24, 2.5, 7.0), (24, 8.0, 14.0))
RECIPE_DEV = ((4, 1.5, 1.8), (4, 3.0, 7.5), (4, 9.0, 15.5))
RECIPE_AUG = ["--ctc", "True", "--ctc_weight", "0.2",
              "--online_speed_perturb", "True",
              "--online_volume_perturb", "True",
              "--online_noise_perturb", "True", "--online_noise_p", "0.7",
              "--spec_augment", "True"]
SERVE_DURATIONS = (1.0, 1.7, 2.5, 3.6, 5.0, 7.4, 11.0, 15.0)


def synth_corpus(root: str, rng: np.random.Generator) -> dict:
    """A LibriSpeech-layout corpus of 16-bit WAVs: train and dev splits of
    the durations in RECIPE_TRAIN / RECIPE_DEV, each a slice of one of 8
    synthesized 16 s phone sequences, its transcript the phone names at
    CHARS_PER_SECOND characters a second.  Returns the durations."""
    names = [p for p in PHONES if p not in ("SIL", "SP")]
    pool = []
    for _ in range(8):
        phones = list(rng.choice(names, 160))
        pool.append((synth_phones(phones, rng=rng), " ".join(phones)))
    out = {}
    for split, spec, spk in (("train", RECIPE_TRAIN, 1),
                             ("dev", RECIPE_DEV, 2)):
        d = os.path.join(root, split, str(spk), "10")
        os.makedirs(d)
        lines, secs = [], []
        for n, lo, hi in spec:
            for _ in range(n):
                sec = float(rng.uniform(lo, hi))
                sig, text = pool[int(rng.integers(len(pool)))]
                start = int(rng.integers(0, len(sig) - int(sec * SR)))
                uid = f"{spk}-10-{len(lines):04d}"
                write_wav(os.path.join(d, f"{uid}.wav"),
                          sig[start:start + int(sec * SR)], SR)
                lines.append(f"{uid} "
                             + text[:int(sec * CHARS_PER_SECOND)].strip())
                secs.append(sec)
        with open(os.path.join(d, f"{spk}-10.trans.txt"), "w") as f:
            f.write("\n".join(lines))
        out[split] = secs
    return out


def recipe_flags(root: str) -> list:
    """The published flags with the corpus, feature and shard paths."""
    return PUBLISHED_FLAGS + [
        "--convert_rate", "0.12",
        "--bucket_boundaries_eval", ",".join(map(str, TRAIN_BUCKETS)),
        "--train_100hr_corpus_dir", f"{root}/train",
        "--train_360hr_corpus_dir", f"{root}/none",
        "--train_500hr_corpus_dir", f"{root}/none",
        "--dev_data_dir", f"{root}/dev", "--test_data_dir", f"{root}/none",
        "--subword_dir", f"{root}/subword", "--save_dir", f"{root}/model",
        "--summary_dir", f"{root}/summary", "--feat_dir", f"{root}/none"]


def launched(fn):
    """(fn's result, fused_frontend launches while it ran)."""
    cuda_frontend.fused_frontend.launches = 0
    res = fn()
    torch.cuda.synchronize()
    return res, cuda_frontend.fused_frontend.launches


def recipe_preprocess(dev, root: str, flags: list, card: str) -> int:
    """preprocess into feats/ (with speed augmentation) and raw/, the
    features held to the plain frontend; returns the kernel launches."""
    t0 = time.perf_counter()
    _, n_feat = launched(lambda: preprocess_cli.main(
        ["--device", dev.type] + flags
        + ["--feat_dir", f"{root}/feats", "--audio_shards", "False",
           "--augmentation", "True"]))
    wall = time.perf_counter() - t0
    preprocess_cli.main(["--device", dev.type] + flags
                        + ["--feat_dir", f"{root}/raw"])
    cfg = published_cfg()
    worst, n_utt, audio_s = 0.0, 0, 0.0
    for cat, split in (("train-100", "train"), ("dev", "dev")):
        _, paths = preprocess_cli.data_preparation(f"{root}/{split}")
        sigs = [read_audio(p)[0].astype(np.float32) for p in paths]
        saved = create_shards_cli.load_cat_feats(f"{root}/feats", cat)
        plain = frontend.extract_features_list(
            sigs, cfg.replace(use_pallas=False), dev)
        for i, (got, want) in enumerate(zip(saved, plain)):
            worst = max(worst, check_close(
                f"preprocess {cat} utterance {i}", torch.from_numpy(got),
                torch.from_numpy(want), RTOL, ATOL))
        run = lambda: frontend.extract_features_list(sigs, cfg, dev)
        run()
        t0 = time.perf_counter()
        run()
        dt = time.perf_counter() - t0
        n_utt += len(sigs)
        audio_s += sum(map(len, sigs)) / SR
        print(f"featurize {cat}: {len(sigs)} utterances, "
              f"{sum(map(len, sigs)) / SR:.1f} s of audio [{card}]: "
              f"{dt * 1e3:.2f} ms, {len(sigs) / dt:.1f} utt/s "
              f"(extract_features_list, host padding and copies included)")
    print(f"preprocess (features + speed 0.9 / 1.1 dumps of train) of "
          f"{n_utt} utterances, {audio_s:.1f} s of audio [{card}]: "
          f"{wall:.2f} s wall, fused_frontend launches {n_feat}; saved "
          f"features vs the plain "
          f"frontend: max abs err {worst:.3e} over {n_utt} utterances")
    if n_feat == 0:
        raise AssertionError("preprocess did not launch the kernel")
    return n_feat


def first_batch_per_bucket(files, cfg: Config, dev) -> list:
    """One training batch of each bucket, on the device, shortest first."""
    loader = BucketedLoader(files, cfg, seed=0)
    found = {}
    for _, b in zip(range(100), loader):
        found.setdefault(b[0].shape[1], b)
        if len(found) == len(TRAIN_BUCKETS):
            break
    else:
        raise AssertionError(f"batches of {len(found)} buckets in 100")
    return [tuple(torch.from_numpy(x).to(dev) for x in found[k])
            for k in sorted(found)]


def recipe_augmentation_checks(batches, cfg: Config, card: str) -> None:
    """The resampler on the card against the CPU at each rate, its time
    beside the step's, the noise SNR over valid samples, zero padding, and
    one augmented step with the kernel against one with the plain
    frontend from identical state and generators."""
    for batch in batches:
        sig, lens = batch[0][:, :, 0, 0], batch[1]
        B, S = sig.shape
        for up, down in augmentation._rate_fractions(cfg.online_speed_rates):
            if up == down:
                continue
            run = lambda: augmentation.resample_rational_device(sig, lens,
                                                                up, down)
            got, got_len = run()
            want, want_len = augmentation.resample_rational_device(
                sig[:2].cpu(), lens[:2].cpu(), up, down)
            if not torch.equal(got_len[:2].cpu(), want_len):
                raise AssertionError("resample lengths differ from the CPU")
            err = check_close(f"resample {up}/{down} {B} x {S / SR:.2f} s",
                              got[:2].cpu(), want, 0.0, 1e-5)
            ms = float(np.median([cuda_ms(run, 3) for _ in range(3)]))
            print(f"resample_rational_device up {up} down {down}, {B} x "
                  f"{S / SR:.3f} s [{card}]: {ms:.3f} ms, CUDA vs CPU max "
                  f"abs err {err:.3e}")
        ts = trainer.create_train_state(cfg, sig.device)
        aug_ms = float(np.median([cuda_ms(lambda: trainer.augment_waveforms(
            ts, sig, lens, cfg), 1) for _ in range(5)]))
        out, new_len = trainer.augment_waveforms(ts, sig, lens, cfg)
        pad = torch.arange(S, device=sig.device)[None, :] >= new_len[:, None]
        if out[pad].any():
            raise AssertionError("augmentation left non-zero padding")
        fk, lk = frontend.featurize_batch(out, new_len, cfg)
        fp, lp = frontend.featurize_batch(out, new_len,
                                          cfg.replace(use_pallas=False))
        if not torch.equal(lk, lp):
            raise AssertionError("featlen differs on augmented waveforms")
        feat_err = check_close(f"features of the augmented {S / SR:.2f} s "
                               "batch", fk, fp, RTOL, ATOL)
        snr_cfg = cfg.replace(online_noise_snr_low=10.0,
                              online_noise_snr_high=10.0, online_noise_p=1.0)
        noisy = augmentation.online_noise_perturb(
            ts.aug_generator, sig, lens, snr_cfg).double()
        valid = ~(torch.arange(S, device=sig.device)[None, :]
                  >= lens[:, None])
        x = sig.double()
        p_sig = (x * x * valid).sum(1)
        p_add = ((noisy - x) ** 2 * valid).sum(1)
        live = p_sig > 0
        snr = 10 * torch.log10(p_sig[live] / p_add[live])
        if not (snr - 10.0).abs().max() < 1e-3:
            raise AssertionError(f"noise SNR {snr.tolist()} != 10 dB")
        print(f"augmentation of the {S / SR:.3f} s bucket batch [{card}]: "
              f"speed + volume + noise {aug_ms:.3f} ms; padding zero; kernel "
              f"vs plain features of the perturbed batch max abs err "
              f"{feat_err:.3e}; noise "
              f"SNR over valid samples within "
              f"{float((snr - 10.0).abs().max()):.2e} dB of the drawn 10 dB")
        step_timings(ts, batch, cfg, card)
        off_cfg = cfg.replace(online_speed_perturb=False,
                              online_volume_perturb=False,
                              online_noise_perturb=False, spec_augment=False)
        steps = {"off": (trainer.create_train_state(off_cfg, sig.device),
                         off_cfg), "on": (ts, cfg)}
        times = {"off": [], "on": []}
        for k in ("off", "on", "on", "off") * 2:
            times[k].append(cuda_ms(lambda: trainer.train_step(
                steps[k][0], batch, steps[k][1]), 1))
        on, off = (float(np.median(times[k])) for k in ("on", "off"))
        print(f"train step on the same {S / SR:.3f} s batch, augmented vs "
              f"not, in turns [{card}]: {on:.2f} vs {off:.2f} ms "
              f"({100 * (on / off - 1):+.1f} %; runs on "
              f"{[round(x, 2) for x in times['on']]}, off "
              f"{[round(x, 2) for x in times['off']]})")
    got = {}
    for use_kernel in (True, False):
        c = cfg.replace(use_pallas=use_kernel)
        m = trainer.train_step(trainer.create_train_state(c, batches[1][0]
                                                          .device),
                               batches[1], c)
        got[use_kernel] = (m["loss"].item(), m["grad_norm"].item())
    (lk, gk), (lp, gp) = got[True], got[False]
    if abs(lk - lp) > 1e-4 * abs(lp) or abs(gk - gp) > 1e-3 * abs(gp):
        raise AssertionError(f"augmented step, kernel vs plain frontend: "
                             f"loss {lk} vs {lp}, grad norm {gk} vs {gp}")
    print(f"one augmented step on the 8 s batch, kernel vs plain frontend "
          f"[{card}]: loss {lk:.6f} vs {lp:.6f} (rel "
          f"{abs(lk - lp) / lp:.2e}), grad norm {gk:.6f} vs {gp:.6f} (rel "
          f"{abs(gk - gp) / gp:.2e})")


def recipe_lm(dev, root: str, card: str) -> str:
    """train_lm at its defaults for 2 epochs on corpus_all.txt, one LM
    step on the card against the CPU, and sample_lm's greedy text on both;
    returns the LM directory."""
    lm_dir = f"{root}/lm"
    res = train_lm_cli.main(["--device", dev.type, "--data_file",
                             f"{root}/subword/corpus_all.txt",
                             "--output_dir", lm_dir, "--num_epochs", "2"])
    hist = res["history"]
    if not hist["valid_ppl"][-1] < hist["valid_ppl"][0]:
        raise AssertionError(f"LM validation perplexity did not fall: "
                             f"{hist['valid_ppl']}")
    print(f"train_lm (lstm 2 x 128, batch 20 x 10, 2 epochs) [{card}]: "
          f"train ppl {[round(x, 4) for x in hist['train_ppl']]}, valid ppl "
          f"{[round(x, 4) for x in hist['valid_ppl']]}, test ppl "
          f"{res.get('test_ppl', float('nan')):.4f}, steps/s "
          f"{[round(x, 1) for x in hist['train_steps_per_s']]}")
    lm, cfg, v2i, _ = char_rnn.load_lm_dir(lm_dir)
    ids = np.asarray([v2i[c] for c in open(f"{root}/subword/corpus_all.txt")
                      .read().upper() if c in v2i], np.int32)
    rows = torch.from_numpy(char_rnn.BatchGenerator(
        ids, cfg.batch_size, cfg.num_unrollings).next())
    res = []
    for d in (dev, torch.device("cpu")):
        m = copy.deepcopy(lm).to(d)
        ts = char_rnn.LMTrainState(m, char_rnn.make_lm_optimizer(m, cfg), 0,
                                   torch.Generator(device=d).manual_seed(0))
        x = rows.to(d)
        loss, _ = char_rnn.lm_train_step(
            ts, x[:-1].T, x[1:].T, char_rnn.zero_state(cfg, cfg.batch_size,
                                                       d), cfg)
        res.append((loss.item(), torch.cat(
            [p.detach().cpu().reshape(-1) for p in m.parameters()])))
    (card_loss, card_w), (cpu_loss, cpu_w) = res
    err = check_close("lm_train_step weights card vs CPU", card_w, cpu_w,
                      1e-4, 1e-6)
    if abs(card_loss - cpu_loss) > 1e-4 * cpu_loss:
        raise AssertionError(f"LM loss {card_loss} vs {cpu_loss}")
    print(f"one lm_train_step card vs CPU: loss {card_loss:.6f} vs "
          f"{cpu_loss:.6f}, weights max abs err {err:.3e}")
    texts = [sample_lm_cli.main(["--device", d, "--init_dir", lm_dir,
                                 "--length", "60"])
             for d in (dev.type, "cpu")]
    if texts[0] != texts[1]:
        raise AssertionError(f"greedy samples differ: {texts}")
    print(f"sample_lm greedy, card = CPU: {texts[0]!r}")
    return lm_dir


def recipe_serve(dev, root: str, flags: list, card: str) -> int:
    """serve.main on a local port: 8 concurrent WAV requests, /healthz,
    /stats; each text equals Recognizer.transcribe_signals greedy on a
    batch of the server's shape.  Returns the kernel launches."""
    rng = np.random.default_rng(5)
    sigs = [speech(rng, s) for s in SERVE_DURATIONS]
    bodies = []
    for i, s in enumerate(sigs):
        write_wav(f"{root}/req{i}.wav", s, SR)
        bodies.append(open(f"{root}/req{i}.wav", "rb").read())
        sigs[i] = read_audio(f"{root}/req{i}.wav")[0].astype(np.float32)
    started = queue.Queue()
    cuda_frontend.fused_frontend.launches = 0
    t = threading.Thread(target=serve_cli.main, args=(
        ["--device", dev.type] + flags + ["--port", "0", "--beam_size", "1",
                                        "--max_batch", "8"],
        started.put))
    t.start()
    httpd = started.get(timeout=600)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    texts = [None] * len(sigs)

    def client(i):
        req = urllib.request.Request(url + "/transcribe", data=bodies[i],
                                     headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=600) as r:
            texts[i] = json.loads(r.read())["text"]

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(sigs))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            snap = json.loads(r.read())
    finally:
        httpd.shutdown()
        t.join(timeout=120)
    torch.cuda.synchronize()
    launches = cuda_frontend.fused_frontend.launches
    if t.is_alive():
        raise AssertionError("the server did not stop")
    if snap["requests"] != len(sigs) or snap["errors"] or None in texts:
        raise AssertionError(f"HTTP serving: {snap}, texts {texts}")
    rec = Recognizer.from_checkpoint(f"{root}/model",
                                     serve_cli.parse(flags)[0], device=dev)
    ladder = BatchingRecognizer(rec, max_batch=8).bucket_seconds
    for s, text in zip(sigs, texts):
        bucket = next(b for b in ladder if len(s) / SR <= b)
        want = rec.transcribe_signals([s] * 8, pad_seconds=bucket)[0]
        if text != want:
            raise AssertionError(f"HTTP text {text!r} != Recognizer's "
                                 f"{want!r} ({len(s) / SR:.2f} s)")
    print(f"serve.main over HTTP, {len(sigs)} concurrent WAV requests of "
          f"{min(SERVE_DURATIONS)}-{max(SERVE_DURATIONS)} s [{card}]: "
          f"{wall:.3f} s wall, texts = Recognizer.transcribe_signals "
          f"greedy; /healthz {json.dumps(health)}; /stats "
          f"{json.dumps(snap)}; fused_frontend launches {launches} (warmup "
          f"included)")
    return launches


def phase_recipe(dev, card: str) -> int:
    """run.sh's stages through the port's entry points at published width
    on a synthesized corpus; returns the kernel launches of the
    preprocess, train, test, decode and serve runs."""
    rng = np.random.default_rng(4)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        secs = synth_corpus(root, rng)
        print(f"recipe corpus: {len(secs['train'])} train and "
              f"{len(secs['dev'])} dev utterances, {sum(secs['train']):.1f} "
              f"+ {sum(secs['dev']):.1f} s, synthesized in "
              f"{time.perf_counter() - t0:.1f} s")
        flags = recipe_flags(root)
        bpe = train_subword_cli.main(flags + ["--size", "5000"])
        print(f"train_subword --size 5000: vocabulary of "
              f"{bpe.get_vocab_size()} tokens (what the corpus allows)")
        launches = recipe_preprocess(dev, root, flags, card)
        for kind in ("feats", "raw"):
            extra = ["--audio_shards", "False"] if kind == "feats" else []
            n = create_shards_cli.main(flags + [
                "--feat_dir", f"{root}/{kind}",
                "--shard_dir", f"{root}/shards_{kind}"] + extra)
            print(f"create_shards {kind}: {n} train records, shards "
                  f"{sorted(os.listdir(f'{root}/shards_{kind}'))}")
        shard_flags = flags + ["--shard_dir", f"{root}/shards_raw"]

        # cuda:0: this process trains (plain cuda is every GPU)
        (ts, hist), n = launched(lambda: train_cli.main(
            ["--device", f"{dev.type}:0"] + shard_flags + RECIPE_AUG
            + ["--epoch", "1", "--steps_per_epoch", "3"]))
        launches += n
        if ts.step != 3 or not np.all(np.isfinite(hist["loss"])) or n < 3:
            raise AssertionError(f"augmented train.main: step {ts.step}, "
                                 f"{hist}, kernel launches {n}")
        print(f"train.main with online speed / volume / noise perturbation "
              f"and SpecAugment, 3 steps [{card}]: losses "
              f"{[round(x, 4) for x in hist['loss']]}, grad norms "
              f"{[round(x, 4) for x in hist['grad_norm']]}, fused_frontend "
              f"launches {n}")
        aug_cfg = parse_args(shard_flags + RECIPE_AUG).replace(
            vocab_size=published_cfg().vocab_size)
        batches = first_batch_per_bucket(
            sorted(glob.glob(f"{root}/shards_raw/train-*.arsh")), aug_cfg,
            dev)
        recipe_augmentation_checks(batches, aug_cfg, card)
        del batches

        for decoder in ("attention", "ctc_greedy"):
            res, n = launched(lambda: test_cli.main(
                ["--device", dev.type] + shard_flags
                + ["--ctc", "True", "--split", "dev", "--eval_decoder",
                   decoder, "--log_dir", f"{root}/log_{decoder}"]))
            launches += n
            if res.utterances != len(secs["dev"]) or res.skipped:
                raise AssertionError(f"test {decoder}: {res}")
            print(f"test --eval_decoder {decoder} over {res.utterances} dev "
                  f"utterances [{card}]: {res.batches} batches, "
                  f"{res.ms_per_batch:.2f} ms/batch, none skipped, WER "
                  f"{res.wer:.4f}, fused_frontend launches {n}")

        lm_dir = recipe_lm(dev, root, card)
        t0 = time.perf_counter()
        wer, n = launched(lambda: decode_cli.main(
            ["--device", dev.type] + shard_flags
            + ["--ctc", "True", "--split", "dev", "--log_dir",
               f"{root}/log_decode", "--apply_lm", "True", "--lm_dir", lm_dir,
               "--lm_weight", "0.5", "--beam_size", str(BEAM_SIZE),
               "--beam_logprob", "True"]))
        launches += n
        if not np.isfinite(wer) or n == 0:
            raise AssertionError(f"decode --apply_lm: WER {wer}, {n} "
                                 "launches")
        print(f"decode --apply_lm True (beam {BEAM_SIZE}, the LM train_lm "
              f"wrote) over {len(secs['dev'])} dev utterances [{card}]: "
              f"{time.perf_counter() - t0:.2f} s wall, WER {wer:.4f}, "
              f"fused_frontend launches {n}")
        launches += recipe_serve(dev, root, shard_flags + ["--ctc", "True"],
                                 card)
    return launches


# phase_configs: every model configuration the JAX package accepts
PBLSTM_STAGES = 2                # tools/pblstm_r5.sh: 1 BiRNN + 2 stages
BF16_LOSS_RTOL = 0.05            # tests/test_quirk_paths.py
# int8 vs float teacher-forced logits, relative L2 error: per-channel int8
# rounds every weight by at most half a step, about 1 % of a matmul
INT8_REL_LIMIT = 0.05
SUBWORD_VOCAB = 5000             # the recipe's bpe-5k (run.sh)
CONFIG_SECONDS = 8               # the bucket of the phase's decode checks
DTYPES = ("float32", "bfloat16")


def with_flags(flags: list, **values) -> list:
    """flags with the value of each named flag replaced."""
    out = list(flags)
    for name, value in values.items():
        out[out.index(f"--{name}") + 1] = str(value)
    return out


def pblstm_cfg() -> Config:
    """published_cfg() with tools/pblstm_r5.sh's listener geometry at the
    published enc_units: listener output 2 x 512."""
    return published_cfg().replace(enc_type="pblstm",
                                   num_enc_layers=PBLSTM_STAGES)


def float_state(ts) -> bool:
    """Every parameter, buffer and Adam moment of a train state is
    float32."""
    tensors = list(ts.model.state_dict().values())
    for st in ts.optimizer.adam.state.values():
        tensors += [st["exp_avg"], st["exp_avg_sq"]]
    return all(t.dtype == torch.float32 for t in tensors)


def profiled_step(ts, batch, cfg: Config):
    """(device busy ms, idle share, top kernels, cuDNN RNN kernels:
    launches and names) of one profiled train step."""
    _, events = traced(lambda: trainer.train_step(ts, batch, cfg),
                       "train_step")
    busy_ms, span_ms = device_busy(events, "train_step")
    rnn = [e.name for e in events if _is_device(e) and "RNN" in e.name]
    return (busy_ms, 1 - busy_ms / span_ms, top_kernels(events, 4),
            (len(rnn), sorted({n[:48] for n in rnn})[:3]))


def dtype_turns(name: str, cfg: Config, batches: list, dev, card: str):
    """bf16 against float32 from one state: the first step's loss on the
    shortest batch (within BF16_LOSS_RTOL), then per bucket ms per step in
    turns (float32, bf16, bf16, float32, after a warm-up step each) and
    peak device memory over a step; the device idle share of one profiled
    step of each on the shortest batch.  Returns the bf16 state."""
    cfgs = {dt: cfg.replace(dtype=dt) for dt in DTYPES}
    states = {dt: trainer.create_train_state(c, dev) for dt, c in cfgs.items()}
    first = {dt: trainer.train_step(states[dt], batches[0], c)["loss"].item()
             for dt, c in cfgs.items()}
    l32, l16 = first["float32"], first["bfloat16"]
    if l16 == l32 or abs(l16 - l32) > BF16_LOSS_RTOL * abs(l32):
        raise AssertionError(f"{name}: first bf16 loss {l16} vs float32 "
                             f"{l32}")
    print(f"{name}: first step from one state, bf16 loss {l16:.5f} vs "
          f"float32 {l32:.5f} (rel {abs(l16 - l32) / abs(l32):.2e}, limit "
          f"{BF16_LOSS_RTOL})")
    for batch in batches:
        B, S = batch[0].shape[:2]
        peak = {}
        for dt, c in cfgs.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            trainer.train_step(states[dt], batch, c)
            torch.cuda.synchronize()
            peak[dt] = torch.cuda.max_memory_allocated(dev) - base
        times = {dt: [] for dt in DTYPES}
        for dt in DTYPES + DTYPES[::-1]:
            times[dt].append(cuda_ms(lambda: trainer.train_step(
                states[dt], batch, cfgs[dt]), 1))
        ms = {dt: float(np.median(v)) for dt, v in times.items()}
        print(f"{name} train step, {S / SR:.3f} s bucket, batch {B}, "
              f"{batch[2].shape[1]} decoder steps [{card}]: float32 "
              f"{ms['float32']:.2f} ms (runs "
              f"{[round(x, 2) for x in times['float32']]}), bf16 "
              f"{ms['bfloat16']:.2f} ms (runs "
              f"{[round(x, 2) for x in times['bfloat16']]}); peak device "
              f"memory over a step, beyond what was resident: float32 "
              f"{peak['float32']} / bf16 {peak['bfloat16']} bytes")
    for dt, c in cfgs.items():
        busy, idle, top, (n_rnn, rnn) = profiled_step(states[dt],
                                                      batches[0], c)
        print(f"{name} {dt} profiled step, {batches[0][0].shape[1] / SR:.3f}"
              f" s bucket [{card}]: device busy {busy:.2f} ms, idle share "
              f"{idle:.4f}; cuDNN RNN kernels {n_rnn} {rnn}; top kernels "
              f"{top}")
    if not float_state(states["bfloat16"]):
        raise AssertionError(f"{name}: a bf16 state tensor is not float32")
    return states["bfloat16"]


def configs_pblstm(dev, card: str, d: str, rng) -> list:
    """The pblstm listener: greedy serving at 2 / 8 / 16 s, card = CPU in
    beam-8 rank 0 on the 2 s batch, train.main with joint CTC, the loss
    falling on one repeated batch.  Returns the CONFIG_SECONDS batch."""
    cfg = pblstm_cfg().replace(beam_logprob=True)
    CheckpointManager(os.path.join(d, "cfg_pblstm")).save_weights(
        1, las.init(cfg, torch.Generator().manual_seed(0), dev))
    rec = Recognizer.from_checkpoint(os.path.join(d, "cfg_pblstm"), cfg,
                                     device=dev)
    print(f"pblstm: LAS with the pyramidal listener (enc_units "
          f"{cfg.enc_units}, {PBLSTM_STAGES} pyramid stages, listener output "
          f"{las.enc_out_dim(cfg)}; speller {cfg.num_dec_layers} x "
          f"{cfg.dec_units}), {las.num_params(rec.model)} parameters, loaded "
          f"by Recognizer.from_checkpoint")
    batches = {}
    for b in BEAM_BUCKETS:
        batches[b] = [speech(rng, b * rng.uniform(0.8, 1.0)) for _ in range(8)]
        run = lambda: rec.transcribe_signals(batches[b], pad_seconds=b)
        if not all(isinstance(t, str) for t in run()):
            raise AssertionError("a pblstm transcript is not a str")
        steps = max(int(cfg.convert_rate * host.num_frames(b * SR, 400, 160)),
                    1)
        print(f"pblstm greedy batch of 8 at the {b:2d} s bucket ({steps} "
              f"decoder steps) [{card}]: {cuda_ms(run, 3):.2f} ms/batch")
    short = BEAM_BUCKETS[0]
    feats, featlen = rec._features(batches[short], pad_seconds=short)
    on_cpu = Recognizer(copy.deepcopy(rec.model).cpu(), cfg, rec.tokenizer,
                        "cpu")
    ties = compare_rank0("pblstm CUDA vs CPU", rec.beam(feats, featlen,
                                                        BEAM_SIZE),
                         on_cpu.beam(feats.cpu(), featlen.cpu(), BEAM_SIZE))
    print(f"pblstm CUDA vs CPU beam {BEAM_SIZE} on the {short} s batch: rank 0 "
          f"equal on {8 - ties} of 8 utterances, {ties} near ties")

    flags = with_flags(PUBLISHED_FLAGS, enc_type="pblstm",
                       num_enc_layers=PBLSTM_STAGES)
    run_train_cli(d, os.path.join(d, "cfg_pblstm_train"), 1,
                  ["--ctc", "True", "--ctc_weight", "0.2"], flags)
    tcfg = train_cfg().replace(enc_type="pblstm",
                               num_enc_layers=PBLSTM_STAGES)
    batch = train_batches(d, tcfg, dev)[0]
    ts = trainer.create_train_state(tcfg, dev)
    losses = torch.stack([trainer.train_step(ts, batch, tcfg)["loss"]
                          for _ in range(OVERFIT_STEPS)]).tolist()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"pblstm loss did not fall in {OVERFIT_STEPS} "
                             f"steps on one batch: {losses}")
    print(f"pblstm, {OVERFIT_STEPS} steps on one {TRAIN_SECONDS[0]} s batch: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return batches[CONFIG_SECONDS]


def configs_bf16(dev, card: str, d: str, sigs8: list) -> None:
    """bf16 compute: train.main for the published cnn and the pblstm
    models (every state tensor float32 after it, resume exact), bf16 vs
    float32 step times per bucket, greedy and beam-8 joint-CTC batches at
    8 s with their rank-0 agreement with float32."""
    print(f"bf16 matmuls with reduced-precision reductions: "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    for name, base, extra in (
            ("cnn", PUBLISHED_FLAGS, []),
            ("pblstm", with_flags(PUBLISHED_FLAGS, enc_type="pblstm",
                                  num_enc_layers=PBLSTM_STAGES),
             ["--ctc", "True", "--ctc_weight", "0.2"])):
        save = os.path.join(d, f"cfg_bf16_{name}")
        flags = with_flags(base, dtype="bfloat16")
        _, ts = run_train_cli(d, save, 1, extra, flags)
        if not float_state(ts):
            raise AssertionError(f"{name} bf16 train.main: a state tensor "
                                 "is not float32")
        cfg = parse_args(flags + extra).replace(
            vocab_size=published_cfg().vocab_size)
        back = CheckpointManager(save).restore(
            trainer.create_train_state(cfg, dev))
        mine, theirs = ts.model.state_dict(), back.model.state_dict()
        if back.step != ts.step or any(not torch.equal(v, theirs[k])
                                       for k, v in mine.items()):
            raise AssertionError(f"{name} bf16: resume differs")
        print(f"{name} bf16 train.main: parameters, BN statistics and Adam "
              f"moments float32 after {ts.step} steps; the checkpoint "
              f"restores them exactly")
    for name, cfg in (("cnn", train_cfg()),
                      ("pblstm", train_cfg().replace(
                          enc_type="pblstm", num_enc_layers=PBLSTM_STAGES,
                          ctc=True, ctc_weight=0.2))):
        dtype_turns(name, cfg, train_batches(d, cfg, dev), dev, card)

    cfg = published_cfg().replace(ctc=True, beam_logprob=True,
                                  ctc_beam_weight=0.5)
    model = las.init(cfg, torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        model.speller.out.bias[EOS_ID] -= EOS_SHIFT
        model.speller.ctc_head.bias[EOS_ID] -= EOS_SHIFT
    recs = {dt: Recognizer(model, cfg.replace(dtype=dt), CharEncoder(), dev)
            for dt in DTYPES}
    feats, featlen = recs["float32"]._features(sigs8,
                                               pad_seconds=CONFIG_SECONDS)
    out = {}
    for dt, rec in recs.items():
        greedy = lambda: rec.greedy(feats, featlen)
        beam = lambda: rec.beam(feats, featlen, BEAM_SIZE)
        out[dt] = (greedy()[1], beam())
        out[dt] += (cuda_ms(greedy, 3), cuda_ms(beam, 2))
    (y32, b32, g32_ms, b32_ms), (y16, b16, g16_ms, b16_ms) = (
        out["float32"], out["bfloat16"])
    stop = lambda y: y[:int((y == EOS_ID).nonzero()[0]) + 1] \
        if (y == EOS_ID).any() else y
    greedy_eq = sum(torch.equal(stop(a), stop(b)) for a, b in zip(y32, y16))
    beam_eq = sum(torch.equal(b32.tokens[i, 0, :b32.lengths[i, 0]],
                              b16.tokens[i, 0, :b16.lengths[i, 0]])
                  for i in range(8))
    if not bool(torch.isfinite(b16.scores[:, 0]).all()):
        raise AssertionError("bf16 beam: a rank-0 score is not finite")
    print(f"bf16 vs float32 decoding of 8 utterances at the "
          f"{CONFIG_SECONDS} s bucket "
          f"[{card}]: greedy {g16_ms:.2f} vs {g32_ms:.2f} ms/batch, same "
          f"tokens on {greedy_eq} of 8; beam {BEAM_SIZE} joint CTC "
          f"{b16_ms:.2f} vs {b32_ms:.2f} ms/batch ({b16.steps} / {b32.steps} "
          f"steps), rank 0 equal on {beam_eq} of 8")


def write_bpe_vocab(directory: str, size: int) -> None:
    """A subword vocabulary of `size` tokens in the bpe-*.json / .txt
    format: specials, letters, then letter triples (decoding random
    weights needs only the vocabulary's size)."""
    letters = [chr(c) for c in range(ord("A"), ord("Z") + 1)]
    tokens = ["<PAD>", "<SOS>", "<EOS>", "<unk>"] + letters
    for a in letters:
        for b in letters:
            for c in letters:
                tokens.append(a + b + c)
    CharBPE({t: i for i, t in enumerate(tokens[:size])}, []).save(directory)


def configs_int8(dev, card: str, d: str, sigs8: list) -> None:
    """int8 decoder weights through Recognizer.from_checkpoint at vocab 30
    (cells quantized; a quantized fusion LM beside them) and 5000 (cells
    and `out`): teacher-forced logits against float, the speller's bytes,
    greedy ms float vs int8 in turns; int8 under bf16."""
    lm_cfg = char_rnn.LMConfig(**LM_SHAPE)
    lm_dir = os.path.join(d, "cfg_lm")
    char_rnn.save_lm_dir(lm_dir, char_rnn.init(
        lm_cfg, torch.Generator().manual_seed(1), dev), lm_cfg)
    write_bpe_vocab(os.path.join(d, "bpe5k"), SUBWORD_VOCAB)
    for vocab, cfg in ((30, published_cfg()),
                       (SUBWORD_VOCAB, published_cfg().replace(
                           unit="subword", subword_dir=os.path.join(d, "bpe5k"),
                           vocab_size=SUBWORD_VOCAB))):
        cfg = cfg.replace(lm_weight=0.5, beam_logprob=True)
        ckpt = os.path.join(d, f"cfg_int8_{vocab}")
        model = las.init(cfg, torch.Generator().manual_seed(0), dev)
        with torch.no_grad():      # each search runs its step budget
            model.speller.out.bias[EOS_ID] -= EOS_SHIFT
        CheckpointManager(ckpt).save_weights(1, model)
        lm = lm_dir if vocab < 512 else ""
        rec_f = Recognizer.from_checkpoint(ckpt, cfg, device=dev)
        rec_q = Recognizer.from_checkpoint(
            ckpt, cfg.replace(quantize_decoder="int8"), lm_dir=lm, device=dev)
        sp = rec_q.model.speller
        if not (all(isinstance(c, quant.QuantLinear) for c in sp.cells)
                and isinstance(sp.out, quant.QuantLinear) == (vocab >= 512)
                and isinstance(sp.attention.w_h, torch.nn.Linear)):
            raise AssertionError(f"vocab {vocab}: wrong matrices quantized")
        if lm and not isinstance(rec_q.lm.cells[0], quant.QuantLinear):
            raise AssertionError("the fusion LM's cells are not int8")
        feats, featlen = rec_f._features(sigs8, pad_seconds=CONFIG_SECONDS)
        steps = max(int(cfg.convert_rate * feats.shape[1]), 1)
        y = torch.randint(3, vocab, (8, steps), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            lf = las.las_forward(rec_f.model, feats, featlen, cfg, steps,
                                 teacher=y)[0]
            lq = las.las_forward(rec_q.model, feats, featlen, cfg, steps,
                                 teacher=y)[0]
        # the lowered EOS logit would dominate the norm: leave it out
        keep = torch.arange(lf.shape[-1], device=dev) != EOS_ID
        rel = float((lq - lf)[..., keep].norm() / lf[..., keep].norm())
        if not rel <= INT8_REL_LIMIT:
            raise AssertionError(f"vocab {vocab}: int8 teacher-forced logits "
                                 f"rel err {rel} > {INT8_REL_LIMIT}")
        times = {"float32": [], "int8": []}
        recs = {"float32": rec_f, "int8": rec_q}
        for k in ("float32", "int8", "int8", "float32"):
            times[k].append(cuda_ms(lambda: recs[k].greedy(feats, featlen),
                                    2))
        ms = {k: float(np.median(v)) for k, v in times.items()}
        print(f"int8, vocab {vocab} [{card}]: speller "
              f"{quant.size_bytes(rec_f.model.speller)} bytes float32 vs "
              f"{quant.size_bytes(sp)} int8; teacher-forced logits over "
              f"{steps} steps rel L2 err {rel:.3e} (limit {INT8_REL_LIMIT}); "
              f"greedy batch of 8 at {CONFIG_SECONDS} s float32 "
              f"{ms['float32']:.2f} ms "
              f"(runs {[round(x, 2) for x in times['float32']]}) vs int8 "
              f"{ms['int8']:.2f} ms (runs "
              f"{[round(x, 2) for x in times['int8']]})")
        if lm:
            res = rec_q.beam(feats, featlen, BEAM_SIZE)
            if not bool(torch.isfinite(res.scores[:, 0]).all()):
                raise AssertionError("int8 beam with the int8 LM: rank 0 "
                                     "not finite")
            ms = cuda_ms(lambda: rec_q.beam(feats, featlen, BEAM_SIZE), 1)
            print(f"int8 speller + int8 fusion LM {LM_SHAPE}, beam "
                  f"{BEAM_SIZE} at {CONFIG_SECONDS} s [{card}]: {ms:.2f} "
                  f"ms/batch, {res.steps} decoder steps; LM "
                  f"{quant.size_bytes(char_rnn.load_lm_dir(lm)[0])} bytes "
                  f"float32 vs {quant.size_bytes(rec_q.lm)} int8")
            c16 = rec_q.cfg.replace(dtype="bfloat16")
            with las.compute_cast(c16, rec_q.model):
                cell = rec_q.model.speller.cells[0]
                kept = (cell.w_scale.dtype == torch.float32
                        and cell.q.dtype == torch.int8
                        and cell.bias.dtype == torch.bfloat16)
            if not kept:
                raise AssertionError("int8 under bf16: w_scale or q cast")
            l16, _ = Recognizer(rec_q.model, c16, rec_q.tokenizer,
                                dev).greedy(feats, featlen)
            lq8, _ = rec_q.greedy(feats, featlen)
            if not bool(torch.isfinite(l16).all()):
                raise AssertionError("int8 under bf16: non-finite logits")
            print(f"int8 under bf16: w_scale float32, q int8, bias bf16 in "
                  f"the cast; greedy first-step logits vs int8 float32 rel "
                  f"err {float((l16[:, 0] - lq8[:, 0]).norm() / lq8[:, 0].norm()):.3e}")


def phase_configs(dev, card: str, d: str) -> int:
    """The pblstm listener, bf16 compute and int8 decoder weights at
    published width; returns the kernel launches of the phase."""
    rng = np.random.default_rng(6)
    cuda_frontend.fused_frontend.launches = 0
    sigs8 = configs_pblstm(dev, card, d, rng)
    configs_bf16(dev, card, d, sigs8)
    configs_int8(dev, card, d, sigs8)
    torch.cuda.synchronize()
    launches = cuda_frontend.fused_frontend.launches
    if launches == 0:
        raise AssertionError("the configs phase did not launch the kernel")
    # one batch of the phase: the kernel against its plain version
    audio = torch.zeros((len(sigs8), CONFIG_SECONDS * SR))
    for i, sig in enumerate(sigs8):
        audio[i, :len(sig)] = torch.from_numpy(sig)
    audio = audio.to(dev)
    lens = torch.tensor([len(sig) for sig in sigs8], device=dev)
    cfg = pblstm_cfg()
    fk, lk = frontend.extract_features_cfg(audio, lens, cfg)
    fp, lp = frontend.extract_features_cfg(audio, lens,
                                           cfg.replace(use_pallas=False))
    torch.cuda.synchronize()
    if not torch.equal(lk, lp):
        raise AssertionError("configs batch: featlen differs")
    err = check_close("configs batch features", fk, fp, RTOL, ATOL)
    print(f"configs phase [{card}]: fused_frontend launches {launches}; the "
          f"{CONFIG_SECONDS} s batch's features kernel vs plain max abs err "
          f"{err:.3e}")
    return launches


# phase_parallel: data parallelism
DP_SECONDS = 8                   # the 8 s x 48 training bucket
DP_FRAMES = 800
DP_BATCH = 48
DP_STEPS = 11                    # train.main logs steps/s over steps 2-10
# N ranks vs one process on one global batch: phase_train's kernel vs
# plain frontend step tolerance (cuDNN sums a 24-row and a 48-row batch's
# gradients in other orders)
DP_LOSS_RTOL, DP_GNORM_RTOL = 1e-4, 1e-3
DP_WORKER = r"""
import json, sys
import chip_smoke
from automatic_speech_recognition_torch.parallel import distributed
print("RESULT " + json.dumps(chip_smoke.dp_rank(*sys.argv[1:])), flush=True)
distributed.destroy()
"""
TRAIN_WORKER = r"""
import json, sys
import torch
from automatic_speech_recognition_torch import train
from automatic_speech_recognition_torch.ops import cuda_frontend
from automatic_speech_recognition_torch.parallel import distributed
ts, hist = train.main(sys.argv[1:])
print("RESULT " + json.dumps({
    "launches": cuda_frontend.fused_frontend.launches, "step": ts.step,
    "loss": hist["loss"], "world": distributed.process_count(),
    "backend": torch.distributed.get_backend()}), flush=True)
distributed.destroy()
"""


def dp_cfg() -> Config:
    """train_cfg() with BN on (apply_bn), the case whose statistics must
    be the global batch's."""
    return train_cfg().replace(apply_bn=True)


def write_dp_batch(path: str, rng: np.random.Generator, rows: int) -> None:
    """One global batch of `rows` rows in the 8 s bucket: 4 synthesized
    utterances tiled at 80-100 % of 8 s; the first half's transcripts are
    CHARS_PER_SECOND a second, the second half's about half that, so the
    ranks' shares hold different token counts."""
    tok = CharEncoder()
    names = [p for p in PHONES if p not in ("SIL", "SP")]
    pool = []
    for _ in range(4):
        phones = list(rng.choice(names, DP_SECONDS * 10))
        pool.append((synth_phones(phones, rng=rng), " ".join(phones)))
    S = DP_FRAMES * 160 + 400
    full = DP_SECONDS * CHARS_PER_SECOND
    ids = [tok.encode(pool[i % 4][1][:full if i < rows // 2
                                     else max(full // 2 - 3 * (i % 4), 1)]
                      .strip(),
                      with_eos=True) for i in range(rows)]
    audio = np.zeros((rows, S), np.float32)
    audiolen = np.zeros(rows, np.int32)
    y = np.zeros((rows, max(map(len, ids))), np.int32)
    for i in range(rows):
        n = int(DP_SECONDS * SR * rng.uniform(0.8, 1.0))
        audio[i, :n] = np.resize(pool[i % 4][0], n)
        audiolen[i] = n
        y[i, :len(ids[i])] = ids[i]
    np.savez(path, audio=audio, audiolen=audiolen, y=y,
             tokenlen=(y != 0).sum(1).astype(np.int32))


def load_dp_batch(path: str, dev, rows=slice(None)) -> tuple:
    with np.load(path) as z:
        return tuple(torch.from_numpy(z[k][rows]).to(dev)
                     for k in ("audio", "audiolen", "y", "tokenlen"))


def dp_rank(path: str, backend: str) -> dict:
    """One rank of a data-parallel job (launched by spawn_ranks): one step
    on its share of the global batch, the gradient all-reduce timed alone,
    ms per step over 3 more steps, the kernel held to its plain version on
    its rows, then one step with dropout, SpecAugment and the waveform
    perturbations on."""
    distributed.maybe_initialize("cuda", backend=backend)
    rank, world = distributed.process_index(), distributed.process_count()
    dev = devices_for("cuda")[0]
    disable_tf32()
    _kernels.load("fused_frontend")
    with np.load(path) as z:
        per = z["y"].shape[0] // world
    rows = load_dp_batch(path, dev, slice(rank * per, (rank + 1) * per))
    cfg = dp_cfg()
    group = distributed.world_group()
    ts = trainer.create_train_state(cfg, dev, rank, world)
    step_fn, ts, shard = trainer.make_mesh_train_step(
        make_mesh(devices=[dev], group=group), ts, None, cfg)
    cuda_frontend.fused_frontend.launches = 0
    m = step_fn(ts, rows)
    torch.cuda.synchronize()
    launches = cuda_frontend.fused_frontend.launches
    grads = [torch.ones_like(p) for p in ts.optimizer.params]
    distributed.all_reduce_flat(grads, group)             # warm-up
    ar_ms = [cuda_ms(lambda: distributed.all_reduce_flat(grads, group), 1)
             for _ in range(5)]
    with torch.no_grad():
        fk, lk = frontend.featurize_batch(rows[0], rows[1], cfg)
        fp, lp = frontend.featurize_batch(rows[0], rows[1],
                                          cfg.replace(use_pallas=False))
    if not torch.equal(lk, lp):
        raise AssertionError(f"rank {rank}: featlen kernel vs plain differ")
    err = check_close(f"rank {rank} features", fk, fp, RTOL, ATOL)
    step_ms = []
    cuda_frontend.fused_frontend.launches = 0
    for _ in range(3):
        distributed.barrier("timed step")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(ts, rows)["loss"].item()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    acfg = cfg.replace(dropout_rate=0.2, spec_augment=True,
                       online_speed_perturb=True, online_volume_perturb=True,
                       online_noise_perturb=True)
    ma = trainer.train_step(ts, rows, acfg, group=group)
    torch.cuda.synchronize()
    launches += cuda_frontend.fused_frontend.launches
    return {"rank": rank, "world": world, "rows": per,
            "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "aug_loss": ma["loss"].item(),
            "aug_grad_norm": ma["grad_norm"].item(),
            "checksum": float(sum(p.double().sum() for p in
                                  ts.model.parameters())),
            "allreduce_ms": ar_ms, "step_ms": step_ms,
            "allreduce_bytes": sum(g.numel() * g.element_size()
                                   for g in grads),
            "buckets": len(distributed._buckets(grads,
                                                distributed.BUCKET_BYTES)),
            "launches": launches, "kernel_err": err}


def spawn_ranks(code: str, args: list, world: int, local_rank=None,
                timeout: float = 300.0, env: dict = None) -> list:
    """`world` processes of `code` with torchrun's variables set by hand
    (LOCAL_RANK local_rank(r), default r) over `env` (default this
    process's), from the repository root; returns each one's RESULT
    object and its output.  Every process is waited for or killed."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = []
    for r in range(world):
        rank_env = dict(env or os.environ, RANK=str(r),
                        WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                        LOCAL_RANK=str(r if local_rank is None
                                       else local_rank(r)), MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *args], env=rank_env,
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"rank {r} of {world} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
        results.append((json.loads(lines[-1][7:]), out))
    return results


def steps_per_sec(out: str) -> float:
    """train.main's steps/s at step 10 (the window of steps 2-10)."""
    hits = re.findall(r"step 10/\d+ .*\(([\d.]+) steps/s\)", out)
    if not hits:
        raise AssertionError(f"no step-10 log line in:\n{out[-3000:]}")
    return float(hits[-1])


def graph_share(out: str) -> str:
    """train.main's last note of the speller's CUDA graph replays in a
    log (models/las.graphed_loop)."""
    hits = re.findall(r"speller graphs replayed [^;\n]*", out)
    return hits[-1] if hits else "no note of the speller's graphs"


def dp_flags(d: str) -> list:
    """The published train flags over the 8 s x 48 global batches of the
    shards in d, DP_STEPS steps."""
    flags = with_flags(PUBLISHED_FLAGS, bucket_boundaries_train=DP_FRAMES)
    return flags + ["--shard_dir", d, "--bucket_batch_sizes", str(DP_BATCH),
                    "--epoch", "1", "--steps_per_epoch", str(DP_STEPS)]


def dp_train(dev, card: str, d: str, world: int) -> int:
    """train.main on `world` processes given torchrun's environment (NCCL,
    one GPU each; WORLD_SIZE 1 on one card) over the 8 s x 48 global
    batches, against the same steps in this process without it: the
    losses and ms per step."""
    flags = dp_flags(d)
    t0 = time.perf_counter()
    ranks = spawn_ranks(TRAIN_WORKER, flags + [
        "--save_dir", os.path.join(d, f"dp_world{world}"),
        "--summary_dir", os.path.join(d, f"dp_world{world}_summary")], world)
    wall = time.perf_counter() - t0
    res, out = ranks[0]
    for r, _ in ranks:
        if ((r["world"], r["backend"], r["step"]) != (world, "nccl", DP_STEPS)
                or r["loss"] != res["loss"] or r["launches"] < DP_STEPS):
            raise AssertionError(f"world-{world} run: {r} vs {res}")
    ms_dp = 1e3 / steps_per_sec(out)
    mesh_line = [l for l in out.splitlines() if "mesh:" in l][-1]

    log_lines = []
    handler = logging.Handler()
    handler.emit = lambda record: log_lines.append(record.getMessage())
    logging.getLogger("train").addHandler(handler)
    cuda_frontend.fused_frontend.launches = 0
    try:
        # cuda:0: one process (plain cuda is every GPU)
        ts, hist = train_cli.main(["--device", "cuda:0"] + flags + [
            "--save_dir", os.path.join(d, f"dp_plain{world}"),
            "--summary_dir", os.path.join(d, f"dp_plain{world}_summary")])
    finally:
        logging.getLogger("train").removeHandler(handler)
    torch.cuda.synchronize()
    launches = cuda_frontend.fused_frontend.launches
    ms_plain = 1e3 / steps_per_sec("\n".join(log_lines))
    if ts.step != DP_STEPS or not np.all(np.isfinite(hist["loss"])):
        raise AssertionError(f"plain run: step {ts.step}, {hist}")
    rel = np.abs(np.array(res["loss"]) / np.array(hist["loss"]) - 1)
    if rel[0] > DP_LOSS_RTOL:
        raise AssertionError(f"first loss, {world} processes vs one: "
                             f"{res['loss'][0]} vs {hist['loss'][0]}")
    print(f"data parallel, train.main on {world} process(es) [{card}]: "
          f"{mesh_line.split('] ')[-1]}; {DP_STEPS} steps at {DP_SECONDS} s "
          f"x {DP_BATCH} (global): {ms_dp:.2f} ms/step (steps 2-10, "
          f"{wall:.1f} s wall with start-up) vs {ms_plain:.2f} ms/step in "
          f"one process without torchrun; losses equal on every rank, vs "
          f"one process max rel diff {rel.max():.2e} over the {DP_STEPS} "
          f"steps (first {rel[0]:.2e}); rank 0: {graph_share(out)}; one "
          f"process: {graph_share(chr(10).join(log_lines))}; "
          f"fused_frontend launches "
          f"{sum(r['launches'] for r, _ in ranks)} + {launches}")
    return sum(r["launches"] for r, _ in ranks) + launches


# the ranks of the train commands below (direct_train, the two-host runs):
# deterministic CUDA algorithms (PyTorch's own, cuDNN's; cuBLAS's fixed
# workspace comes from the environment), so that two runs of the same
# steps give the same bits (without them, two runs part after the first
# step).  CHIP_SMOKE_BACKEND names the group's backend (gloo: two ranks
# sharing one card); with CHIP_SMOKE_LAUNCHES, a directory, each rank
# writes its kernel launches there at exit.  With CHIP_SMOKE_FAULT=<r>,
# rank r raises an error carrying a transient marker at its first logging
# step's flag exchange (after writing the time to CHIP_SMOKE_FAULT_AT),
# so exit_for_transient_errors and distributed.run_main's abort run as in
# production; the other ranks, with CHIP_SMOKE_PEERS=sleep, sleep there
# outside any collective until torchrun's SIGTERM ends them (its default
# action: train's handler would defer it), and otherwise go into the
# exchange and wait for the rank that is gone
RANK_SITE = r"""
import json, os, signal, time
if "RANK" in os.environ:
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    from automatic_speech_recognition_torch.parallel import distributed
    if os.environ.get("CHIP_SMOKE_BACKEND"):
        initialize = distributed.maybe_initialize

        def forced(device="cuda", backend=None, **kwargs):
            return initialize(device, os.environ["CHIP_SMOKE_BACKEND"],
                              **kwargs)

        distributed.maybe_initialize = forced
    if os.environ.get("CHIP_SMOKE_LAUNCHES"):
        import atexit
        from automatic_speech_recognition_torch.ops import cuda_frontend

        def report():
            path = os.path.join(os.environ["CHIP_SMOKE_LAUNCHES"],
                                "rank%s.json" % os.environ["RANK"])
            with open(path, "w") as f:
                json.dump({"launches": cuda_frontend.fused_frontend.launches},
                          f)

        atexit.register(report)
    if os.environ.get("CHIP_SMOKE_FAULT"):
        any_flag = distributed.any_flag

        def fault(*args, **kwargs):
            if os.environ["RANK"] == os.environ["CHIP_SMOKE_FAULT"]:
                with open(os.environ["CHIP_SMOKE_FAULT_AT"], "w") as f:
                    json.dump({"at": time.time()}, f)
                raise RuntimeError("rank %s: injected transport failure: "
                                   "Connection reset by peer"
                                   % os.environ["RANK"])
            if os.environ.get("CHIP_SMOKE_PEERS") == "sleep":
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                time.sleep(600)
            return any_flag(*args, **kwargs)

        distributed.any_flag = fault
"""


def rank_site_env(site: str, **extra) -> dict:
    """This process's environment with RANK_SITE (written into `site`) on
    the ranks' PYTHONPATH, cuBLAS's fixed workspace and `extra`."""
    Path(site, "sitecustomize.py").write_text(RANK_SITE)
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
                PYTHONPATH=site + (os.pathsep + path if path else ""),
                **extra)


def fault_seconds(path: str, end: float) -> float:
    """Seconds from the injected fault (RANK_SITE wrote its time to path)
    to `end`."""
    with open(path) as f:
        return end - json.load(f)["at"]


def run_command(cmd: list, env: dict, timeout: float) -> tuple:
    """(exit code, output) of a command run from the repository root; on
    a timeout it is sent SIGTERM (torchrun passes it on to its ranks),
    then killed, and the timeout raises."""
    proc = subprocess.Popen(cmd, env=env, cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
        return proc.returncode, out
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
        raise


def direct_train(card: str, d: str, n: int) -> int:
    """One `python3 -m automatic_speech_recognition_torch.train --device
    cuda` on a host of n GPUs: train starts a rank per GPU itself
    (parallel/launch.py) and becomes their launcher.  Its losses must
    equal, bit for bit, those of n hand-launched ranks (spawn_ranks) on
    the same flags, both under RANK_SITE's deterministic algorithms; then
    the same command with rank 1 exiting 18 at its first logging step
    must exit 18.  Returns the hand-launched ranks' kernel launches."""
    flags = dp_flags(d)
    cmd = [sys.executable, "-m", train_cli.MODULE, "--device", "cuda",
           *flags]
    history = os.path.join(d, "direct_history.json")
    with tempfile.TemporaryDirectory() as site:
        env = rank_site_env(site)
        ranks = spawn_ranks(TRAIN_WORKER, flags + [
            "--save_dir", os.path.join(d, "direct_ranks"), "--summary_dir",
            os.path.join(d, "direct_ranks_summary")], n, env=env)
        want = ranks[0][0]["loss"]
        t0 = time.perf_counter()
        code, out = run_command(cmd + [
            "--save_dir", os.path.join(d, "direct"), "--summary_dir",
            os.path.join(d, "direct_summary")],
            dict(env, **{train_cli.HISTORY_ENV: history}), 900)
        wall = time.perf_counter() - t0
        mesh = f"mesh: {{'data': {n}, 'model': 1}} over {n} processes, " \
            "backend nccl"
        if code != 0 or mesh not in out:
            raise AssertionError(f"train --device cuda exited {code}, or "
                                 f"its log lacks {mesh!r}:\n{out[-6000:]}")
        with open(history) as f:
            got = json.load(f)["loss"]
        rel = np.abs(np.array(got) / np.array(want) - 1)
        print(f"train --device cuda, one command over {n} GPUs [{card}]: "
              f"{mesh}; deterministic algorithms: its {len(got)} losses vs "
              f"{n} hand-launched ranks' max rel diff {rel.max():.3e} "
              f"(bit-equal: {got == want}); {wall:.1f} s wall with "
              f"start-up; rank 0: {graph_share(out)}")
        if got != want:
            raise AssertionError(f"one command's losses {got} != the "
                                 f"ranks' {want}")
        at = os.path.join(d, "direct_fault_at.json")
        t0 = time.perf_counter()
        code, out = run_command(cmd + [
            "--save_dir", os.path.join(d, "direct_fault"), "--summary_dir",
            os.path.join(d, "direct_fault_summary")],
            dict(env, CHIP_SMOKE_FAULT="1", CHIP_SMOKE_PEERS="sleep",
                 CHIP_SMOKE_FAULT_AT=at), 900)
        wall = time.perf_counter() - t0
        after = fault_seconds(at, time.time())
    report = re.search(r"rank\s*: 1 \(local_rank: 1\)\s*\n\s*exitcode\s*: "
                       r"18", out)
    print(f"train --device cuda over {n} GPUs with rank 1 raising a "
          f"transient error (\"Connection reset by peer\") at its first "
          f"logging step [{card}]: the command exited {code}, "
          f"{after:.1f} s after the fault ({wall:.1f} s wall with "
          f"start-up); torchrun's report names rank 1 with 18: "
          f"{bool(report)}; rank 1 aborted its group: "
          f"{'leaving with exit code 18' in out}")
    if code != 18 or not report or after > FAULT_S:
        raise AssertionError(f"a transient error on rank 1 came back as "
                             f"{code}, {after:.1f} s after the fault:\n"
                             f"{out[-6000:]}")
    return sum(r["launches"] for r, _ in ranks)


# a failing host's command must exit this soon after the fault; a healthy
# host's, blocked in a collective, within the stall watchdog's timeout
# (HOST_STALL_S) and its poll after that
FAULT_S = 60
HOST_STALL_S = 60
MULTIHOST_STEPS = 3


def run_hosts(devices: list, flags: list, env: dict, d: str, name: str,
              timeout: float = 600, per_host: list = None) -> list:
    """`python3 -m ...train --device devices[i] flags` for each host i,
    side by side, host i given the multi-host environment (host 0's
    rendezvous on localhost), per_host[i]'s variables, and writing its
    history to d; returns each host's (exit code, output, time.time() at
    its exit, history or None).  Every process is waited for or killed."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs, logs, hists = [], [], []
    for i, device in enumerate(devices):
        logs.append(os.path.join(d, f"{name}_host{i}.log"))
        hists.append(os.path.join(d, f"{name}_history{i}.json"))
        host_env = dict(env, JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                        JAX_NUM_PROCESSES=str(len(devices)),
                        JAX_PROCESS_ID=str(i),
                        **{train_cli.HISTORY_ENV: hists[-1]},
                        **(per_host[i] if per_host else {}))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", train_cli.MODULE, "--device", device,
                 *flags], env=host_env, cwd=Path(__file__).resolve().parent,
                stdout=log, stderr=subprocess.STDOUT))
    ended = [None] * len(procs)
    t0 = time.time()
    try:
        while None in ended and time.time() - t0 < timeout:
            for i, p in enumerate(procs):
                if ended[i] is None and p.poll() is not None:
                    ended[i] = time.time()
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
            p.wait()
    if None in ended:
        raise AssertionError(f"{name}: a host did not end in {timeout} s")
    out = []
    for p, log, hist, end in zip(procs, logs, hists, ended):
        history = None
        if os.path.exists(hist):
            with open(hist) as f:
                history = json.load(f)
        out.append((p.returncode, Path(log).read_text(), end, history))
    return out


def launches_in(directory: str) -> int:
    """The kernel launches the ranks wrote there (RANK_SITE)."""
    total = 0
    for path in glob.glob(os.path.join(directory, "rank*.json")):
        with open(path) as f:
            total += json.load(f)["launches"]
    return total


def two_host_train(card: str, d: str, n: int) -> int:
    """Two hosts of n / 2 NCCL ranks each at dp n / 4 x tp 2 (one command
    a host, the multi-host environment) against one host's n ranks
    (`train --device cuda --num_partitions 2`) on the same flags, under
    RANK_SITE's deterministic algorithms: bit-equal losses; then
    two_host_fault.  Returns the kernel launches of the two-host run."""
    local = n // 2
    flags = with_flags(dp_flags(d), steps_per_epoch=MULTIHOST_STEPS) + [
        "--num_partitions", "2"]
    hosts = [",".join(f"cuda:{i}" for i in range(h * local, (h + 1) * local))
             for h in range(2)]
    with tempfile.TemporaryDirectory() as site, \
            tempfile.TemporaryDirectory() as counts:
        env = rank_site_env(site)
        history = os.path.join(d, "one_host_history.json")
        t0 = time.perf_counter()
        code, out = run_command(
            [sys.executable, "-m", train_cli.MODULE, "--device", "cuda",
             *flags, "--save_dir", os.path.join(d, "one_host"),
             "--summary_dir", os.path.join(d, "one_host_summary")],
            dict(env, **{train_cli.HISTORY_ENV: history}), 900)
        one_wall = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"one host exited {code}:\n{out[-6000:]}")
        with open(history) as f:
            want = json.load(f)["loss"]
        t0 = time.perf_counter()
        res = run_hosts(hosts, flags + [
            "--save_dir", os.path.join(d, "two_hosts"), "--summary_dir",
            os.path.join(d, "two_hosts_summary")],
            dict(env, CHIP_SMOKE_LAUNCHES=counts), d, "two_hosts")
        wall = time.perf_counter() - t0
        launches = launches_in(counts)
    for i, (code, out, _, hist) in enumerate(res):
        if code != 0 or hist is None:
            raise AssertionError(f"host {i} exited {code}:\n{out[-6000:]}")
    mesh = f"mesh: {{'data': {n // 2}, 'model': 2}} over {n} processes, " \
        "backend nccl"
    got = [hist["loss"] for _, _, _, hist in res]
    print(f"two hosts x {local} NCCL ranks, one `train` command a host "
          f"through JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
          f"JAX_PROCESS_ID [{card}]: {mesh}: {mesh in res[0][1]}; losses "
          f"{got[0]} on host 0, bit-equal to host 1's: {got[0] == got[1]}, "
          f"to one host's {n} ranks (`train --device cuda "
          f"--num_partitions 2`): {got[0] == want}; {wall:.1f} s wall "
          f"against one host's {one_wall:.1f} s; fused_frontend launches in "
          f"the ranks {launches}")
    if mesh not in res[0][1] or got[0] != got[1] or got[0] != want \
            or launches < n * MULTIHOST_STEPS:
        raise AssertionError(f"two hosts {got} vs one host {want}; "
                             f"launches {launches}")
    two_host_fault(card, d, n)
    return launches


def two_host_fault(card: str, d: str, n: int) -> None:
    """Two hosts of n / 2 NCCL ranks, each with an NCCL host id of its own
    (NCCL_HOSTID), so that NCCL joins them over its network transport as
    it does separate machines; rank n - 1 raises a transient error at its
    first logging step while the others wait in the flag exchange: its
    host must exit 18 within FAULT_S seconds, the other 17 or 18 within
    HOST_STALL_S + FAULT_S (NCCL sees the dead peer only in its own
    watchdog thread; under the stall watchdog its error handling is off,
    distributed.leave_nccl_errors_to_the_watchdog)."""
    local = n // 2
    flags = with_flags(dp_flags(d), steps_per_epoch=MULTIHOST_STEPS) + [
        "--num_partitions", "2"]
    hosts = [",".join(f"cuda:{i}" for i in range(h * local, (h + 1) * local))
             for h in range(2)]
    with tempfile.TemporaryDirectory() as site:
        at = os.path.join(d, "two_host_fault_at.json")
        env = rank_site_env(site, CHIP_SMOKE_FAULT=str(n - 1),
                            CHIP_SMOKE_FAULT_AT=at)
        res = run_hosts(hosts, flags + [
            "--save_dir", os.path.join(d, "two_host_fault"),
            "--summary_dir", os.path.join(d, "two_host_fault_summary"),
            "--stall_timeout_s", str(HOST_STALL_S)], env, d,
            "two_host_fault", per_host=[{"NCCL_HOSTID": f"host{h}"}
                                        for h in range(2)])
    after = [fault_seconds(at, end) for _, _, end, _ in res]
    codes = [code for code, _, _, _ in res]
    seen = sorted(set(re.findall(r"transient platform failure \(([^)]*)",
                                 res[0][1])))
    print(f"two hosts x {local} NCCL ranks, NCCL host ids host0 / host1 "
          f"(its network transport between them), rank {n - 1} (host 1) "
          f"raising a transient error at its first logging step while the "
          f"others wait in the flag exchange, --stall_timeout_s "
          f"{HOST_STALL_S} "
          f"[{card}]: host 1 exited {codes[1]} {after[1]:.1f} s after the "
          f"fault, host 0 exited {codes[0]} {after[0]:.1f} s after it; the "
          f"failing rank aborted its group: "
          f"{'leaving with exit code 18' in res[1][1]}; host 0's ranks "
          f"saw: {seen[:2] or 'no error (the stall watchdog ended them)'}")
    if codes[1] != 18 or codes[0] not in (17, 18) or after[1] > FAULT_S \
            or after[0] > HOST_STALL_S + FAULT_S:
        raise AssertionError(f"two-host fault: exit codes {codes}, seconds "
                             f"after the fault {after}:\n"
                             + "\n".join(out[-4000:] for _, out, _, _ in res))


def dp_ranks(dev, card: str, d: str, world: int, backend: str,
             per_rank: int, local_rank=None) -> int:
    """`world` ranks, `per_rank` rows each of one global batch, against one
    process on the whole batch; each rank's ms per step against one
    process's on per_rank rows."""
    rows = world * per_rank
    path = os.path.join(d, f"dp_batch_{rows}.npz")
    write_dp_batch(path, np.random.default_rng(8), rows)
    batch = load_dp_batch(path, dev)
    tokens = [int(batch[3][r * per_rank:(r + 1) * per_rank].sum())
              for r in range(world)]
    t0 = time.perf_counter()
    ranks = [r for r, _ in spawn_ranks(DP_WORKER, [path, backend],
                                       world, local_rank)]
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks[1:]:
        for k in ("loss", "grad_norm", "aug_loss", "aug_grad_norm",
                  "checksum"):
            if r[k] != r0[k] or not np.isfinite(r[k]):
                raise AssertionError(f"ranks differ in {k}: {r0[k]} vs "
                                     f"{r[k]}")
    cfg = dp_cfg()
    m = trainer.train_step(trainer.create_train_state(cfg, dev), batch, cfg)
    loss, gnorm = m["loss"].item(), m["grad_norm"].item()
    if (abs(r0["loss"] - loss) > DP_LOSS_RTOL * abs(loss)
            or abs(r0["grad_norm"] - gnorm) > DP_GNORM_RTOL * abs(gnorm)):
        raise AssertionError(f"{world} ranks vs one process: loss "
                             f"{r0['loss']} vs {loss}, grad norm "
                             f"{r0['grad_norm']} vs {gnorm}")
    ts = trainer.create_train_state(cfg, dev)
    share = tuple(x[:per_rank] for x in batch)
    trainer.train_step(ts, share, cfg)
    one_ms = [cuda_ms(lambda: trainer.train_step(ts, share, cfg), 1)
              for _ in range(3)]
    med = lambda xs: f"{np.median(xs):.2f} (of {[round(x, 2) for x in xs]})"
    print(f"data parallel, {world} ranks on {backend} [{card}]: global batch "
          f"{DP_SECONDS} s x {rows} (tokens per rank {tokens}), apply_bn; "
          f"loss {r0['loss']:.6f} vs one process {loss:.6f} (rel "
          f"{abs(r0['loss'] - loss) / loss:.2e}), grad norm "
          f"{r0['grad_norm']:.6f} vs {gnorm:.6f} (rel "
          f"{abs(r0['grad_norm'] - gnorm) / gnorm:.2e}); equal on every "
          f"rank; with dropout 0.2, SpecAugment and speed / volume / noise: "
          f"loss {r0['aug_loss']:.6f}, grad norm {r0['aug_grad_norm']:.6f} "
          f"on every rank, parameter sums equal; gradient all-reduce "
          f"{r0['allreduce_bytes']} bytes in {r0['buckets']} buffers, ms "
          f"{med(r0['allreduce_ms'])} (CUDA events); ms per step, rank 0 at "
          f"{per_rank} rows {med(r0['step_ms'])} vs one process at "
          f"{per_rank} rows {med(one_ms)}; kernel vs plain on each rank's "
          f"rows max abs err {max(r['kernel_err'] for r in ranks):.3e}; "
          f"{wall:.1f} s wall")
    return sum(r["launches"] for r in ranks)


LOOP_BATCHES = 4                 # whole batches a replica in one loop
LOOP_ROUNDS = 2                  # (one, many) and (many, one) rounds
# a replica's features vs the first device's: equal, since a row's
# features do not depend on its batch (ops/cuda_frontend.py)
FEAT_TOL = 0.0


def eval_recognizers(dev, name: str, num_partitions: int = 1):
    """(cfg, model, one, many): the published-width beam model (CTC head,
    EOS biases lowered by EOS_SHIFT in memory) behind a Recognizer on
    cuda:0 and one over the devices `name` names."""
    cfg = published_cfg().replace(ctc=True, beam_logprob=True,
                                  ctc_beam_weight=0.5)
    model = las.init(cfg, torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        model.speller.out.bias[EOS_ID] -= EOS_SHIFT
        model.speller.ctc_head.bias[EOS_ID] -= EOS_SHIFT
    one = Recognizer(model, cfg, CharEncoder(), "cuda:0")
    many = Recognizer(model, cfg.replace(num_partitions=num_partitions),
                      CharEncoder(), name)
    return cfg, model, one, many


def loop_batches(rec: Recognizer, rng, count: int) -> list:
    """`count` whole batches of 8 raw-audio utterances at DP_SECONDS, as
    test.py's loader gives them: (audio, lens) on the host."""
    return [rec._audio([speech(rng, DP_SECONDS * rng.uniform(0.8, 1.0))
                        for _ in range(8)], DP_SECONDS)
            for _ in range(count)]


def batch_loop(rec: Recognizer, batches: list) -> tuple:
    """test.py's loop over `batches`: each whole batch featurized and
    decoded greedily on the next free replica, at most one in flight per
    replica, tokens collected in order on the host.  (rows per second,
    the tokens)."""
    t0 = time.perf_counter()
    inflight, tokens = [], []
    for audio, lens in batches:
        inflight.append(rec.pool.submit(
            "featurize_then_greedy", (audio, lens), decoder="attention",
            logits=False))
        if len(inflight) >= rec.pool.size:
            tokens.append(inflight.pop(0).result()[1].cpu())
    tokens += [f.result()[1].cpu() for f in inflight]
    rows = sum(len(a) for a, _ in batches)
    return rows / (time.perf_counter() - t0), tokens


def loop_in_turns(one: Recognizer, many: Recognizer, batches: list
                  ) -> tuple:
    """Rows per second of batch_loop on one device and over `many`'s
    replicas, in turns (one, many, many, one, ...); ({'one': [..],
    'many': [..]}, the tokens each way of the last round)."""
    rps = {"one": [], "many": []}
    toks = {}
    for order in (("one", "many"), ("many", "one")) * LOOP_ROUNDS:
        for k in order:
            r, toks[k] = batch_loop(one if k == "one" else many, batches)
            rps[k].append(round(r, 2))
    return rps, toks["many"], toks["one"]


def greedy_rows(name: str, got, want, logits) -> int:
    """Greedy tokens against one device's (tokens, logits): each row
    equal, or differing first at a step where one device's top-2 logit
    gap is under NEAR_TIE (either token is a best one).  Returns the
    near ties."""
    ties = 0
    for b in range(want.shape[0]):
        diff = (got[b].cpu() != want[b].cpu()).nonzero()
        if not len(diff):
            continue
        t = int(diff[0])
        gap = float(logits[b, t].topk(2).values.diff().abs())
        if gap > NEAR_TIE:
            raise AssertionError(f"{name}, row {b}: step {t} differs with a "
                                 f"top-2 logit gap of {gap}")
        ties += 1
    return ties


def loop_rows(name: str, one: Recognizer, batches: list, got: list,
              want: list) -> int:
    """The whole-batch loop's tokens over the replicas against one
    device's, batch by batch, under greedy_rows' rule (one device's
    logits recomputed for a batch that differs).  Returns the near
    ties."""
    ties = 0
    for k, (g, w) in enumerate(zip(got, want)):
        if torch.equal(g, w):
            continue
        logits, w = one.pool.submit("featurize_then_greedy", batches[k],
                                    decoder="attention").result()
        ties += greedy_rows(f"{name}, batch {k}", g, w, logits)
    return ties


def fragile_rows(one: Recognizer, sigs: list) -> set:
    """Utterances (all DP_SECONDS long) whose greedy path on one device,
    in batches of 8, has a top-2 logit gap under NEAR_TIE before its
    first <EOS>: a text that differs there is a near tie."""
    out = set()
    for lo in range(0, len(sigs), 8):
        logits, y = one.pool.submit(
            "featurize_then_greedy", one._audio(sigs[lo:lo + 8]),
            decoder="attention").result()
        gap = logits.topk(2, -1).values.diff(dim=-1).abs()[..., 0]
        for b in range(y.shape[0]):
            eos = (y[b] == EOS_ID).nonzero()
            end = int(eos[0]) + 1 if len(eos) else y.shape[1]
            if bool((gap[b, :end] < NEAR_TIE).any()):
                out.add(lo + b)
    return out


def throughput_in_turns(one: Recognizer, many: Recognizer, rng) -> tuple:
    """Recognizer.transcribe_all (length-sorted batches of 8, one in
    flight per replica) and a BatchingRecognizer (max_batch 8, one batch
    in flight per replica, every request sent at once) over
    8 x LOOP_BATCHES utterances of DP_SECONDS a replica, greedy: one
    device and the replicas in turns.  ({(path, 'one' | 'many'): [rows
    a second]}, texts that differ from one device's beyond near ties:
    none, or AssertionError)."""
    count = 8 * LOOP_BATCHES * many.pool.size
    width = DP_SECONDS * SR
    sigs = [np.pad(s, (0, width - len(s))) for s in
            (speech(rng, DP_SECONDS) for _ in range(count))]
    srvs = {k: BatchingRecognizer(r, max_batch=8, max_wait_ms=5,
                                  bucket_seconds=(DP_SECONDS,))
            for k, r in (("one", one), ("many", many))}
    for srv in srvs.values():
        srv.warmup()
        srv.start()
    paths = {
        "transcribe": lambda k: (one if k == "one" else many
                                 ).transcribe_all(sigs),
        "serve": lambda k: [f.result() for f in
                            [srvs[k].submit(x) for x in sigs]]}
    rps, texts = {}, {}
    try:
        for order in (("one", "many"), ("many", "one")) * LOOP_ROUNDS:
            for k in order:
                for path, fn in paths.items():
                    t0 = time.perf_counter()
                    texts[path, k] = fn(k)
                    rps.setdefault((path, k), []).append(
                        round(count / (time.perf_counter() - t0), 2))
    finally:
        for srv in srvs.values():
            srv.stop()
    for k, srv in srvs.items():
        snap = srv.stats.snapshot()
        if (snap["requests"] != count * 2 * LOOP_ROUNDS or snap["errors"]):
            raise AssertionError(f"the batcher ({k}) counted {snap}")
    fragile = None
    for path in paths:
        differ = {i for i in range(count)
                  if texts[path, "many"][i] != texts[path, "one"][i]}
        if differ and fragile is None:
            fragile = fragile_rows(one, sigs)
        if differ - (fragile or set()):
            i = min(differ - fragile)
            raise AssertionError(
                f"{path} over the replicas, utterance {i}: "
                f"{texts[path, 'many'][i]!r} vs one device "
                f"{texts[path, 'one'][i]!r}, with no near tie on its path")
    return rps, len(fragile or ())


def dp_eval(dev, card: str, name: str, num_partitions: int = 1,
            require_faster: bool = False) -> int:
    """Greedy and beam-8 joint-CTC decoding over the replicas of the mesh
    `name` names (num_partitions of its devices to a replica, split over
    them; one worker process per replica when there are several)
    against one device, 8 utterances at 8 s: tokens, the replicas'
    own featurization against the first device's, 7 requests
    featurized and decoded in the replicas against one device's texts,
    each replica's devices and split from the pool, the workers'
    start-up seconds, the split batch's wall ms each way in turns, and,
    with several replicas, test.py's whole-batch loop, transcribe_all
    and the batcher in rows per second against one device in turns
    (raising, with require_faster, unless the replicas beat one device
    on each).  Returns the kernel launches, the workers' included."""
    cfg, model, one, many = eval_recognizers(dev, name, num_partitions)
    try:
        return _dp_eval(card, name, num_partitions, require_faster, cfg,
                        one, many)
    finally:
        many.close()


def _dp_eval(card, name, num_partitions, require_faster, cfg, one, many):
    n = many.pool.size
    info = many.pool.describe()
    if num_partitions > 1:
        if any(r["split"] != num_partitions
               or len(r["devices"]) != num_partitions for r in info):
            raise AssertionError(f"{name}: a replica is not split over "
                                 f"{num_partitions} devices: {info}")
    elif n < 2 or any(r["pid"] is None for r in info):
        raise AssertionError(f"{name}: the mesh did not place a worker "
                             f"process per replica: {info}")
    rng = np.random.default_rng(9)
    sigs = [speech(rng, DP_SECONDS * rng.uniform(0.8, 1.0))
            for _ in range(8)]
    cuda_frontend.fused_frontend.launches = 0
    many.pool.launches = 0
    feats, featlen = many._features(sigs, pad_seconds=DP_SECONDS)
    # each replica featurizes its own rows, on its own device
    wfeats, wlen = many.pool.run_split("featurize",
                                       many._audio(sigs, DP_SECONDS))
    lg2, y2 = many.greedy(feats, featlen)
    lg1, y1 = one.greedy(feats, featlen)
    b2 = many.beam(feats, featlen, BEAM_SIZE)
    b1 = one.beam(feats, featlen, BEAM_SIZE)
    texts = many.transcribe_signals(sigs[:7], beam_size=BEAM_SIZE,
                                    pad_seconds=DP_SECONDS)
    want_texts = one.transcribe_signals(sigs[:7], beam_size=BEAM_SIZE,
                                        pad_seconds=DP_SECONDS)
    torch.cuda.synchronize()
    in_workers = many.pool.launches
    launches = cuda_frontend.fused_frontend.launches + in_workers
    if n > 1 and in_workers == 0:
        raise AssertionError(f"{name}: no kernel launch in the workers")
    feat_err = float((wfeats.to(feats.device) - feats).abs().max())
    if feat_err > FEAT_TOL or not torch.equal(wlen.cpu(), featlen.cpu()):
        raise AssertionError(f"features made in the replicas over {name} "
                             f"miss the first device's by {feat_err}")
    greedy_ties = greedy_rows(f"greedy over {name}", y2, y1, lg1)
    equal = [b for b in range(8) if torch.equal(y2[b], y1[b])]
    err = float((lg2[equal] - lg1[equal]).abs().max()) if equal else 0.0
    ties = compare_rank0(f"beam over {name} vs one device", b2, b1)
    text_ties = 0
    if texts != want_texts:
        # where a text differs, rank 0 must be a near tie
        pad = [np.zeros(1, np.float32)] * (sharding.pad_batch_to(7, n) - 7)
        text_ties = compare_rank0(
            f"7 requests decoded in the replicas over {name} vs one device",
            many.pool.run_split("featurize_then_beam", many._audio(
                sigs[:7] + pad, DP_SECONDS), beam_size=BEAM_SIZE),
            one.pool.submit("featurize_then_beam", one._audio(
                sigs[:7], DP_SECONDS), beam_size=BEAM_SIZE).result())

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return round(1e3 * (time.perf_counter() - t0), 2)

    fns = {"one": lambda: one.greedy(feats, featlen),
           "many": lambda: many.greedy(feats, featlen)}
    runs = {k: [] for k in fns}
    for order in (("one", "many"), ("many", "one")) * 2:
        for k in order:
            runs[k].append(wall_ms(fns[k]))
    ms = {k: f"{np.median(v):.2f} (of {v})" for k, v in runs.items()}
    beam_ms = {k: wall_ms(lambda: r.beam(feats, featlen, BEAM_SIZE))
               for k, r in (("one", one), ("many", many))}
    print(f"eval over {many.mesh.shape} ({name}) [{card}]: replicas "
          f"{info}, worker start-up {many.pool.startup_s:.1f} s; features "
          f"made in the replicas vs the first device max abs err "
          f"{feat_err:.3e} (tol {FEAT_TOL}); greedy tokens equal to one "
          f"device on {len(equal)} of 8 rows, {greedy_ties} near ties "
          f"(logits of the equal rows max abs err {err:.3e}); beam "
          f"{BEAM_SIZE} joint CTC rank 0 equal on {8 - ties} of 8, {ties} "
          f"near ties; 7 requests (padded to {sharding.pad_batch_to(7, n)})"
          f" featurized and decoded in the replicas through "
          f"transcribe_signals: texts equal to one device's on "
          f"{sum(a == b for a, b in zip(texts, want_texts))} of 7, "
          f"{text_ties} near ties; fused_frontend launches {launches} "
          f"({in_workers} in worker processes); greedy batch of 8 split "
          f"over the replicas (run_split), wall ms in turns: one device "
          f"{ms['one']}, {n} replicas {ms['many']}; beam {BEAM_SIZE} wall "
          f"ms one device {beam_ms['one']}, over the replicas "
          f"{beam_ms['many']}")
    if n > 1:
        batches = loop_batches(one, rng, LOOP_BATCHES * n)
        one.pool.launches = many.pool.launches = 0
        cuda_frontend.fused_frontend.launches = 0
        rps, got, want = loop_in_turns(one, many, batches)
        more, fragile = throughput_in_turns(one, many, rng)
        launches += cuda_frontend.fused_frontend.launches + many.pool.launches
        loop_ties = loop_rows(f"whole-batch loop over {name}", one, batches,
                              got, want)
        rps = {("loop", "one"): rps["one"], ("loop", "many"): rps["many"],
               **more}
        ratio = {p: float(np.median(rps[p, "many"]) /
                          np.median(rps[p, "one"]))
                 for p in ("loop", "transcribe", "serve")}

        def line(p):
            return (f"one device {np.median(rps[p, 'one']):.2f} (of "
                    f"{rps[p, 'one']}), {n} replicas over {name} "
                    f"{np.median(rps[p, 'many']):.2f} (of "
                    f"{rps[p, 'many']}): {ratio[p]:.3f}x one device")

        rows = sum(len(a) for a, _ in batches)
        print(f"whole-batch loop (test.py's: {len(batches)} batches of 8 "
              f"x {DP_SECONDS} s raw audio, featurize + greedy, one in "
              f"flight per replica) [{card}]: rows/s {line('loop')}; loop "
              f"tokens equal on {rows - loop_ties} of {rows} rows, "
              f"{loop_ties} near ties")
        print(f"transcribe_all ({8 * len(batches)} utterances of "
              f"{DP_SECONDS} s, batches of 8, one in flight per replica) "
              f"[{card}]: rows/s {line('transcribe')}; batcher (max_batch "
              f"8, the same utterances sent at once, one batch in flight "
              f"per replica) rows/s {line('serve')}; texts equal to one "
              f"device's but for near ties ({fragile} fragile utterances "
              f"looked up)")
        slower = [p for p, r in ratio.items() if r <= 1.0]
        if require_faster and slower:
            raise AssertionError(
                f"{n} replicas over {name} reach "
                f"{', '.join(f'{ratio[p]:.3f}x' for p in slower)} one "
                f"device's rows per second on {slower}: multi-GPU "
                "evaluation would be slower than one GPU")
    return launches


def phase_parallel(dev, card: str, d: str) -> int:
    """Data parallelism at published width over raw audio (cnn listener,
    the fused kernel inside every step) on one card: NCCL at world 1, two
    gloo ranks sharing the card, eval over the card listed twice; returns
    the kernel launches."""
    t0 = time.perf_counter()
    launches = dp_train(dev, card, d, 1)
    launches += dp_ranks(dev, card, d, 2, "gloo", DP_BATCH // 2,
                         local_rank=lambda r: 0)
    launches += dp_eval(dev, card, "cuda:0,cuda:0")
    print(f"parallel phase [{card}]: {time.perf_counter() - t0:.1f} s, "
          f"fused_frontend launches {launches}")
    return launches


# phase_tensor_parallel: tensor parallelism
TP_BATCH = 24                    # rows of the 8 s global batch
TP_WORKER = r"""
import json, sys
import chip_smoke
from automatic_speech_recognition_torch.parallel import distributed
print("RESULT " + json.dumps(chip_smoke.tp_rank(*sys.argv[1:])), flush=True)
distributed.destroy()
"""


def state_bytes(ts) -> int:
    """Bytes of a rank's parameters and Adam moments (after a step)."""
    opt = ts.optimizer
    n = sum(p.numel() * p.element_size() for p in opt.params)
    for p in opt.params:
        n += sum(v.numel() * v.element_size()
                 for v in opt.adam.state.get(p, {}).values()
                 if torch.is_tensor(v) and v.dim() > 0)
    return n


def timed_collectives(fn) -> dict:
    """Run fn() with the model axis's collectives (the forward gathers and
    copy_to_model's backward all-reduces) counted and each timed between
    two synchronizes: kind -> [count, ms]."""
    counts = {"all_gather": [0, 0.0], "all_reduce": [0, 0.0]}
    gather = tensor_parallel._all_gather
    backward = tensor_parallel._CopyToModel.backward

    def timed(kind, f):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*args)
            torch.cuda.synchronize()
            counts[kind][0] += 1
            counts[kind][1] += 1e3 * (time.perf_counter() - t0)
            return out
        return call

    tensor_parallel._all_gather = timed("all_gather", gather)
    tensor_parallel._CopyToModel.backward = staticmethod(
        timed("all_reduce", backward))
    try:
        fn()
    finally:
        tensor_parallel._all_gather = gather
        tensor_parallel._CopyToModel.backward = staticmethod(backward)
    return counts


def tp_rank(path: str, backend: str, partitions: str) -> dict:
    """One rank of a dp x tp job (launched by spawn_ranks): one step on
    its data index's rows with its columns of the model, its bytes of
    parameters and Adam state, one step with the model axis's collectives
    counted and timed, the kernel held to its plain version on its rows,
    and ms per step over 3 more steps."""
    k = int(partitions)
    distributed.maybe_initialize("cuda", backend=backend)
    rank, world = distributed.process_index(), distributed.process_count()
    dev = devices_for("cuda")[0]
    disable_tf32()
    _kernels.load("fused_frontend")
    mesh = make_mesh(devices=[dev], group=distributed.world_group(),
                     num_partitions=k)
    dp, d = mesh.shape["data"], mesh.data_index
    with np.load(path) as z:
        per = z["y"].shape[0] // dp
    rows = load_dp_batch(path, dev, slice(d * per, (d + 1) * per))
    cfg = dp_cfg()
    ts = trainer.create_train_state(cfg, dev, d, dp)
    step_fn, ts, _ = trainer.make_mesh_train_step(mesh, ts, None, cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_frontend.fused_frontend.launches = 0
    m = step_fn(ts, rows)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    nbytes = state_bytes(ts)
    checksum = float(sum(v.double().sum() for v in
                         sharding.whole_state_dict(ts.model).values()))
    colls = timed_collectives(lambda: step_fn(ts, rows)["loss"].item())
    launches = cuda_frontend.fused_frontend.launches
    with torch.no_grad():
        fk, lk = frontend.featurize_batch(rows[0], rows[1], cfg)
        fp, lp = frontend.featurize_batch(rows[0], rows[1],
                                          cfg.replace(use_pallas=False))
    if not torch.equal(lk, lp):
        raise AssertionError(f"rank {rank}: featlen kernel vs plain differ")
    err = check_close(f"rank {rank} features", fk, fp, RTOL, ATOL)
    step_ms = []
    cuda_frontend.fused_frontend.launches = 0
    for _ in range(3):
        distributed.barrier("timed step")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(ts, rows)["loss"].item()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches += cuda_frontend.fused_frontend.launches
    return {"rank": rank, "world": world, "shape": mesh.shape,
            "data_index": d, "rows": per, "loss": m["loss"].item(),
            "grad_norm": m["grad_norm"].item(), "checksum": checksum,
            "state_bytes": nbytes, "peak_bytes": peak,
            "collectives": colls, "step_ms": step_ms,
            "launches": launches, "kernel_err": err}


def tp_ranks(dev, card: str, d: str, world: int, k: int, backend: str,
             local_rank=None) -> int:
    """`world` ranks on a (world / k) x k grid over one TP_BATCH-row global
    batch at 8 s, against one process on the whole batch: loss, gradient
    norm, bytes of parameters and Adam state a rank holds, the model
    axis's collectives a step, and ms per step; returns the launches."""
    path = os.path.join(d, f"tp_batch_{TP_BATCH}.npz")
    if not os.path.exists(path):
        write_dp_batch(path, np.random.default_rng(10), TP_BATCH)
    batch = load_dp_batch(path, dev)
    t0 = time.perf_counter()
    ranks = [r for r, _ in spawn_ranks(TP_WORKER, [path, backend, str(k)],
                                       world, local_rank)]
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks[1:]:
        for key in ("loss", "grad_norm", "checksum"):
            if r[key] != r0[key] or not np.isfinite(r[key]):
                raise AssertionError(f"ranks differ in {key}: {r0[key]} vs "
                                     f"{r[key]}")
    cfg = dp_cfg()
    ts = trainer.create_train_state(cfg, dev)
    m = trainer.train_step(ts, batch, cfg)
    loss, gnorm = m["loss"].item(), m["grad_norm"].item()
    if (abs(r0["loss"] - loss) > DP_LOSS_RTOL * abs(loss)
            or abs(r0["grad_norm"] - gnorm) > DP_GNORM_RTOL * abs(gnorm)):
        raise AssertionError(f"{r0['shape']} vs one process: loss "
                             f"{r0['loss']} vs {loss}, grad norm "
                             f"{r0['grad_norm']} vs {gnorm}")
    one_bytes = state_bytes(ts)
    one_ms = [cuda_ms(lambda: trainer.train_step(ts, batch, cfg), 1)
              for _ in range(3)]
    med = lambda xs: f"{np.median(xs):.2f} (of {[round(x, 2) for x in xs]})"
    colls = {kind: f"{n} in {ms:.2f} ms"
             for kind, (n, ms) in r0["collectives"].items()}
    print(f"tensor parallel, {world} ranks on {backend}, mesh "
          f"{r0['shape']} [{card}]: global batch {DP_SECONDS} s x "
          f"{TP_BATCH}, {r0['rows']} rows a data index, apply_bn; loss "
          f"{r0['loss']:.6f} vs one process {loss:.6f} (rel "
          f"{abs(r0['loss'] - loss) / loss:.2e}), grad norm "
          f"{r0['grad_norm']:.6f} vs {gnorm:.6f} (rel "
          f"{abs(r0['grad_norm'] - gnorm) / gnorm:.2e}); equal on every "
          f"rank with the gathered parameters' sums; parameters + Adam "
          f"state a rank {[r['state_bytes'] for r in ranks]} bytes vs one "
          f"process {one_bytes}; peak device memory a rank "
          f"{[round(r['peak_bytes'] / 1e9, 3) for r in ranks]} GB; model-axis "
          f"collectives in rank 0's instrumented step (each between two "
          f"synchronizes): {colls}; ms per step, rank 0 {med(r0['step_ms'])} "
          f"vs one process on the whole batch {med(one_ms)}; kernel vs "
          f"plain on each rank's rows max abs err "
          f"{max(r['kernel_err'] for r in ranks):.3e}; {wall:.1f} s wall")
    return sum(r["launches"] for r in ranks)


def rnn_gather_cost(dev, card: str) -> None:
    """One published-width BiRNN layer (512 in, 512 units, over the 8 s x
    24 batch's 200 frames after the two stride-2 convs) forward and
    backward with its weights whole, against the same layer split over
    the card listed twice, whose weights are gathered whole and compacted
    by cuDNN at every call, in turns: what the gathered weights cost."""
    u = published_cfg().enc_units
    whole = L.make_birnn(u, u).to(dev).train()
    split = copy.deepcopy(whole)
    tensor_parallel.shard_(split, {n: 0 for n, _ in split.named_parameters()
                                   if n.startswith("weight")},
                           tensor_parallel.DeviceAxis([dev, dev]))
    x = torch.randn(TP_BATCH, 200, u, device=dev, requires_grad=True)
    with torch.no_grad():
        err = float((L.birnn_apply(split, x) - L.birnn_apply(whole, x))
                    .abs().max())
    if err > 1e-5:
        raise AssertionError(f"split BiRNN vs whole: max abs err {err}")
    fns = {k: (lambda rnn=rnn: L.birnn_apply(rnn, x).sum().backward())
           for k, rnn in (("whole", whole), ("split", split))}
    runs = {k: [] for k in fns}
    for order in (("whole", "split"), ("split", "whole")) * 2:
        for k in order:
            runs[k].append(round(cuda_ms(fns[k], 3), 3))
    print(f"BiRNN layer {u} x {u}, {TP_BATCH} x 200 frames, forward + "
          f"backward [{card}]: weights whole {np.median(runs['whole']):.3f}"
          f" ms (of {runs['whole']}), gathered from two parts and compacted"
          f" by cuDNN {np.median(runs['split']):.3f} ms (of "
          f"{runs['split']}); outputs max abs err {err:.3e}")


def phase_tensor_parallel(dev, card: str, d: str) -> int:
    """Tensor parallelism at published width over raw audio (the fused
    kernel inside every rank's step) on one card: two gloo ranks at
    num_partitions 2 sharing the card against one process, and greedy
    and beam-8 joint-CTC decoding with the model split over the card
    listed twice against one device; returns the kernel launches."""
    t0 = time.perf_counter()
    launches = tp_ranks(dev, card, d, 2, 2, "gloo", local_rank=lambda r: 0)
    launches += dp_eval(dev, card, "cuda:0,cuda:0", num_partitions=2)
    rnn_gather_cost(dev, card)
    print(f"tensor-parallel phase [{card}]: {time.perf_counter() - t0:.1f} "
          f"s, fused_frontend launches {launches}")
    return launches


def entry_vs_cpu(card: str) -> None:
    """graft_entry.entry("cuda") at flagship width (B 4, T 240, 40 decoder
    steps) against the same fn and seeded weights on the CPU: greedy
    tokens equal (near ties excepted), the logits' max abs diff, and ms
    per call (CUDA events, mean of 5 after a warm-up)."""
    fn, args = graft_entry.entry("cuda")
    got = fn(*args)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: fn(*args), 5)
    cfn, cargs = graft_entry.entry("cpu")
    t0 = time.perf_counter()
    want = cfn(*cargs)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    if got.shape != (4, 40, 30) or not torch.isfinite(got).all():
        raise AssertionError(f"entry logits {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    ties = greedy_rows("entry, card vs CPU", got.argmax(-1).cpu(),
                       want.argmax(-1), want)
    err = float((got.cpu() - want).abs().max())
    print(f"graft_entry.entry('cuda') [{card}]: logits {tuple(got.shape)}, "
          f"greedy tokens equal to the CPU's on {4 - ties} of 4 rows ({ties} "
          f"near ties), logits max abs diff {err:.3e}; {ms:.2f} ms a call "
          f"(CUDA events) against {cpu_ms:.1f} ms on the CPU (host clock)")
    if ties == 0 and err > 1e-3:
        raise AssertionError(f"entry: card vs CPU logits differ by {err}")


def phase_multihost(dev, card: str, d: str) -> int:
    """Training across hosts on one card: two `train --device cuda:0`
    commands as hosts 0 and 1 of a job (the multi-host environment), a
    gloo rank each (NCCL refuses two ranks on one GPU), at published width
    with apply_bn over the 8 s x 48 global batches, the fused kernel in
    every rank's step; the losses against one process's on the same
    batches (first within DP_LOSS_RTOL), and the wall seconds; then
    graft_entry.entry at flagship width against the CPU.  Returns the
    ranks' kernel launches."""
    t0 = time.perf_counter()
    flags = with_flags(dp_flags(d), steps_per_epoch=MULTIHOST_STEPS) + [
        "--apply_bn", "True"]
    with tempfile.TemporaryDirectory() as site, \
            tempfile.TemporaryDirectory() as counts:
        env = rank_site_env(site, CHIP_SMOKE_BACKEND="gloo",
                            CHIP_SMOKE_LAUNCHES=counts)
        res = run_hosts(["cuda:0", "cuda:0"], flags + [
            "--save_dir", os.path.join(d, "mh_hosts"), "--summary_dir",
            os.path.join(d, "mh_hosts_summary")], env, d, "multihost")
        launches = launches_in(counts)
    wall = time.perf_counter() - t0
    for i, (code, out, _, hist) in enumerate(res):
        if code != 0 or hist is None:
            raise AssertionError(f"host {i} exited {code}:\n{out[-6000:]}")
    got = [hist["loss"] for _, _, _, hist in res]
    mesh = "mesh: {'data': 2, 'model': 1} over 2 processes, backend gloo"
    before = cuda_frontend.fused_frontend.launches
    ts, hist = train_cli.main(["--device", "cuda:0"] + flags + [
        "--save_dir", os.path.join(d, "mh_one"), "--summary_dir",
        os.path.join(d, "mh_one_summary")])
    torch.cuda.synchronize()
    one_launches = cuda_frontend.fused_frontend.launches - before
    want = hist["loss"]
    rel = np.abs(np.array(got[0]) / np.array(want) - 1)
    print(f"two hosts x 1 gloo rank on this card, one `train --device "
          f"cuda:0` command a host [{card}]: {mesh}: {mesh in res[0][1]}; "
          f"{MULTIHOST_STEPS} steps at {DP_SECONDS} s x {DP_BATCH} (global, "
          f"apply_bn): losses {[round(x, 6) for x in got[0]]}, equal on "
          f"both hosts: {got[0] == got[1]}; vs one process "
          f"{[round(x, 6) for x in want]}: max rel diff {rel.max():.2e} "
          f"(first {rel[0]:.2e}); {wall:.1f} s wall with start-up; "
          f"host 0: {graph_share(res[0][1])}; "
          f"fused_frontend launches in the ranks {launches} + {one_launches}")
    if (mesh not in res[0][1] or got[0] != got[1] or rel[0] > DP_LOSS_RTOL
            or not np.all(np.isfinite(got[0]))
            or launches < 2 * MULTIHOST_STEPS):
        raise AssertionError(f"two hosts {got} vs one process {want}; "
                             f"launches {launches}")
    entry_vs_cpu(card)
    print(f"multihost phase [{card}]: {time.perf_counter() - t0:.1f} s")
    return launches + one_launches


def phase_multichip(dev, card: str, d: str) -> int:
    """`python3 chip_smoke.py --multichip` on a host of N > 1 GPUs: train.main
    on N NCCL processes against one, one `train --device cuda` command
    over every GPU against those N processes (direct_train), N NCCL ranks
    at DP_BATCH rows each
    against one process on the N x DP_BATCH batch, and eval over plain
    'cuda' (every GPU, a worker process each) against one GPU, raising
    unless its whole-batch loop beats one GPU's rows per second; then
    tensor parallelism: NCCL ranks at dp 2 x tp 2 and dp 1 x tp 4 (with
    N >= 4) against one process, and eval with the model split over two
    GPUs; returns the kernel launches."""
    n = torch.cuda.device_count()
    if n < 2:
        raise AssertionError(f"--multichip needs 2 or more GPUs, found {n}")
    every = devices_for("cuda")
    if every != [torch.device("cuda", i) for i in range(n)]:
        raise AssertionError(f"plain cuda is {every}, not the {n} GPUs")
    print(f"plain cuda resolves to {len(every)} devices: "
          f"{', '.join(map(str, every))}")
    t0 = time.perf_counter()
    launches = dp_train(dev, card, d, n)
    launches += direct_train(card, d, n)
    if n >= 4 and n % 4 == 0:
        launches += two_host_train(card, d, n)
    t1 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(n)
    dry_launches = sum(r["launches"] for r in dry["one host"])
    print(f"graft_entry.dryrun_multichip({n}) [{card}]: "
          f"{time.perf_counter() - t1:.1f} s; fused_frontend launches in the "
          f"raw-audio step {dry_launches}")
    if dry_launches < n:
        raise AssertionError(f"the dry run's raw-audio step launched the "
                             f"kernel {dry_launches} times on {n} ranks")
    launches += dry_launches
    launches += dp_ranks(dev, card, d, n, "nccl", DP_BATCH)
    launches += dp_eval(dev, card, "cuda", require_faster=True)
    if n >= 4:
        launches += tp_ranks(dev, card, d, 4, 2, "nccl")
        launches += tp_ranks(dev, card, d, 4, 4, "nccl")
        launches += dp_eval(dev, card, "cuda", num_partitions=2)
    launches += dp_eval(dev, card, "cuda:0,cuda:1", num_partitions=2)
    print(f"multichip phase, {n} GPUs [{card}]: "
          f"{time.perf_counter() - t0:.1f} s, fused_frontend launches "
          f"{launches}")
    return launches


# phase_chain: the port's run.sh chain at published width, its tools, and
# a TPU run's checkpoint carried across (exporter format, imported)
PORT_RUN_SH = Path(__file__).resolve().parent / \
    "automatic_speech_recognition_torch" / "run.sh"
PORT_SUPERVISOR = PORT_RUN_SH.parent / "tools" / "train_supervised.sh"
CHAIN_CORPUS = ["--train_utts", "32", "--dev_utts", "8", "--test_utts", "8",
                "--train_speakers", "4", "--eval_speakers", "2",
                "--seed", "7"]
CHAIN_STEPS = 3                  # per epoch; two epochs, two checkpoints
CHAIN_BATCH = 8
# run.sh's common model flags at its defaults, for the calls made beside it
RUN_SH_FLAGS = ["--unit", "char", "--feat_type", "mfcc", "--feat_dim", "13",
                "--enc_units", "512", "--dec_units", "1024",
                "--embedding_size", "256", "--attention_size", "128",
                "--num_enc_layers", "4", "--num_dec_layers", "2",
                "--mode", "loc", "--dropout_rate", "0.0", "--lr", "1e-4",
                "--grad_clip", "5"]
CHAIN_LM_FLAGS = ("--batch_size 4 --num_unrollings 10 --train_frac 0.6 "
                  "--valid_frac 0.2")
# run.sh's stages in order, each with the flags it adds: the features
# dump (the kernel in preprocess), then raw audio for the rest, so the
# kernel runs inside train, test and both decodes
CHAIN_STAGES = (("subword", "feats"), ("preprocess", "feats"),
                ("preprocess", "raw"), ("shards", "raw"), ("train", "raw"),
                ("test", "raw"), ("lm", "raw"), ("decode", "raw"),
                ("decode_lm", "raw"))
# every `python3 -m automatic_speech_recognition_torch.<module>` of the
# chain runs through this shim, which appends the module's fused_frontend
# launches to $CHAIN_LAUNCHES when the process exits; anything else
# (run.sh's GPU count) is handed to the interpreter unchanged
CHAIN_SHIM = r"""#!{python}
import atexit, json, os, runpy, sys
args = sys.argv[1:]
if args[:1] != ["-m"] or not args[1].startswith(
        "automatic_speech_recognition_torch."):
    os.execv(sys.executable, [sys.executable] + args)
from automatic_speech_recognition_torch.ops import cuda_frontend


def report():
    with open(os.environ["CHAIN_LAUNCHES"], "a") as f:
        f.write(json.dumps({{"module": args[1], "launches":
                            cuda_frontend.fused_frontend.launches}}) + "\n")


atexit.register(report)
sys.argv = [args[1]] + args[2:]
runpy.run_module(args[1], run_name="__main__", alter_sys=True)
"""


def chain_flags(work: str, raw: str, kind: str) -> list:
    """RUN_EXTRA_FLAGS of a stage: the corpus, the summaries in the working
    directory, the chain's batch and steps; for "raw", the raw-audio dumps
    and shards."""
    flags = ["--train_100hr_corpus_dir", f"{raw}/train",
             "--dev_data_dir", f"{raw}/dev", "--test_data_dir", f"{raw}/test",
             "--summary_dir", f"{work}/summary",
             "--steps_per_epoch", str(CHAIN_STEPS), "--bucket_batch_sizes",
             ",".join([str(CHAIN_BATCH)] * 9), "--decode_batch",
             str(CHAIN_BATCH)]
    if kind == "raw":
        flags += ["--audio_shards", "True", "--feat_dir", f"{work}/raw"]
    return flags


def run_chain_stage(stage: str, env: dict, work: str) -> tuple:
    """`bash run.sh <stage>` from the working directory; (output, wall s,
    fused_frontend launches of its processes)."""
    log = Path(env["CHAIN_LAUNCHES"])
    before = len(log.read_text().splitlines()) if log.exists() else 0
    t0 = time.perf_counter()
    r = subprocess.run(["bash", str(PORT_RUN_SH), stage], cwd=work, env=env,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"run.sh {stage} exited {r.returncode}:\n"
                             f"{r.stdout[-6000:]}")
    lines = log.read_text().splitlines()[before:] if log.exists() else []
    return r.stdout, wall, sum(json.loads(l)["launches"] for l in lines)


def chain_kernel_rows(dev, work: str, raw: str, cfg: Config) -> float:
    """preprocess's dumped dev features against the plain frontend on the
    card, recomputed from the FLACs (phase_recipe's tolerance)."""
    _, paths = preprocess_cli.data_preparation(f"{raw}/dev")
    sigs = [read_audio(p)[0].astype(np.float32) for p in paths[:4]]
    saved = create_shards_cli.load_cat_feats(
        f"{work}/data/LibriSpeech/features", "dev")[:4]
    plain = frontend.extract_features_list(
        sigs, cfg.replace(use_pallas=False, audio_shards=False), dev)
    return max(check_close(f"chain preprocess dev utterance {i}",
                           torch.from_numpy(got), torch.from_numpy(want),
                           RTOL, ATOL)
               for i, (got, want) in enumerate(zip(saved, plain)))


def _flat(tree: dict, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.array(v)     # a copy, never a view
    return out


def write_export(ts, cfg: Config, epoch: int, export: str) -> None:
    """The chain's checkpoint in tools/export_jax_checkpoint.py's format:
    models/convert.to_jax_params's trees under its key convention, the
    Adam moments through the same layouts (a model copy holding them)."""
    params, bn = convert.to_jax_params(ts.model)
    arrays = {**_flat(params, "params"), **_flat(bn, "bn_state"),
              "opt/adam/count": np.asarray(ts.optimizer.count, np.int32),
              "step": np.asarray(ts.step, np.int32)}
    holder = copy.deepcopy(ts.model)
    state = ts.optimizer.adam.state
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        with torch.no_grad():
            for p, q in zip(ts.optimizer.params, holder.parameters()):
                q.copy_(state[p][key])
        arrays.update(_flat(convert.to_jax_params(holder)[0],
                            f"opt/adam/{moment}"))
    os.makedirs(export)
    np.savez(f"{export}/{epoch}.npz", **arrays)
    with open(f"{export}/manifest.json", "w") as f:
        json.dump({"format_version": 1, "kind": "las",
                   "config": json.loads(cfg.to_json()),
                   "epochs": [{"dir": ".", "epoch": epoch,
                               "step": ts.step, "keys": sorted(arrays)}]},
                  f)


def chain_import(dev, card: str, work: str, cfg: Config) -> str:
    """Export the chain's epoch 2, import it through import_checkpoint on
    the card, and hold the imported state to the source: greedy tokens on
    8 dev utterances equal, logits within 1e-5 (tests/
    test_torch_import_checkpoint.py), Adam moments, counts and step
    equal, then one resumed step equal to the source's next step on the
    same batch; returns the imported save_dir."""
    src = trainer.create_train_state(cfg, dev)
    CheckpointManager(f"{work}/model/las").restore(src, epoch=2)
    step = src.step
    export, out = f"{work}/export", f"{work}/imported"
    write_export(src, cfg, 2, export)
    t0 = time.perf_counter()
    epochs = import_checkpoint.main(["--device", dev.type, "--export_dir",
                                     export, "--out", out])
    wall = time.perf_counter() - t0
    got = trainer.create_train_state(cfg, dev)
    if epochs != [2] or CheckpointManager(out).restore(got, epoch=2) is None:
        raise AssertionError(f"import wrote epochs {epochs}")
    if (got.step, got.optimizer.count) != (src.step, src.optimizer.count):
        raise AssertionError(f"step/count {got.step}/{got.optimizer.count} "
                             f"vs {src.step}/{src.optimizer.count}")
    names = [n for n, _ in got.model.named_parameters()]
    for name, p, q in zip(names, got.optimizer.params, src.optimizer.params):
        a, b = got.optimizer.adam.state[p], src.optimizer.adam.state[q]
        for what, x, y in (("parameter", p, q), ("step", a["step"], b["step"]),
                           ("exp_avg", a["exp_avg"], b["exp_avg"]),
                           ("exp_avg_sq", a["exp_avg_sq"], b["exp_avg_sq"])):
            if not torch.equal(x, y):
                raise AssertionError(f"imported {name} {what} differs: "
                                     f"{x.flatten()[:4]} vs {y.flatten()[:4]}")
    feats = create_shards_cli.load_cat_feats(
        f"{work}/data/LibriSpeech/features", "dev")[:8]
    T = max(len(f) for f in feats)
    x = torch.zeros(len(feats), T, *feats[0].shape[1:], device=dev)
    for i, f in enumerate(feats):
        x[i, :len(f)] = torch.from_numpy(f).to(dev)
    xl = torch.tensor([len(f) for f in feats], dtype=torch.int32, device=dev)
    with torch.no_grad():
        (sl, sy), (gl, gy) = (trainer.eval_forward(m.eval(), x, xl, cfg, 40)
                              for m in (src.model, got.model))
    if not torch.equal(sy, gy):
        raise AssertionError("greedy tokens of the imported model differ")
    err = check_close("imported logits", gl, sl, 1e-5, 1e-5)
    loader = BucketedLoader(sorted(glob.glob(
        f"{work}/data/shards/train-*.arsh")), cfg, seed=0)
    batch = tuple(torch.from_numpy(a).to(dev) for a in next(iter(loader)))
    src.model.train()
    got.model.train()
    ms = [trainer.train_step(ts, batch, cfg) for ts in (src, got)]
    for k in ("loss", "grad_norm"):
        a, b = (float(m[k]) for m in ms)
        if not np.isfinite(a) or abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"resumed step {k}: {a} vs source {b}")
    print(f"import_checkpoint on the card [{card}]: an exporter-format "
          f"directory of the chain's epoch 2 (step {step}, "
          f"{len(np.load(f'{export}/2.npz').files)} arrays) imported in "
          f"{wall:.2f} s; greedy tokens on {len(feats)} dev utterances "
          f"equal, logits max abs err {err:.3e}; Adam moments, count "
          f"{got.optimizer.count} and step equal; resumed step loss "
          f"{float(ms[1]['loss']):.6f} vs source {float(ms[0]['loss']):.6f}, "
          f"grad norm {float(ms[1]['grad_norm']):.6f} vs "
          f"{float(ms[0]['grad_norm']):.6f}")
    return out


def chain_supervisor(card: str, work: str, env: dict, train_flags: list,
                     imported: str) -> int:
    """The port's supervisor (its backoff sleep cut out, as the tests run
    it): a worker that exits 18 once and then runs train, resuming the
    imported directory for one more epoch, is retried to success; one
    that exits 20 stops at once.  Returns the kernel launches."""
    fast = f"{work}/supervisor.sh"
    subprocess.run(["bash", "-c", f"sed 's/sleep \"$backoff\"/:/' "
                    f"{PORT_SUPERVISOR} > {fast}"], check=True)
    count = f"{work}/worker_runs"
    worker = f"{work}/worker.sh"
    with open(worker, "w") as f:
        f.write("#!/bin/bash\n"
                f"n=$(cat {count} 2>/dev/null || echo 0)\n"
                f"echo $((n + 1)) > {count}\n"
                "[ \"$n\" = 0 ] && exit \"$1\"\n"
                "shift\nexec \"$@\"\n")
    os.chmod(worker, 0o755)
    log = Path(env["CHAIN_LAUNCHES"])
    before = len(log.read_text().splitlines())
    t0 = time.perf_counter()
    r = subprocess.run(
        ["bash", fast, "3", "--", worker, "18", "python3", "-m",
         "automatic_speech_recognition_torch.train"] + train_flags
        + ["--save_dir", imported, "--epoch", "3"],
        cwd=work, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    n = sum(json.loads(l)["launches"]
            for l in log.read_text().splitlines()[before:])
    resumed = CheckpointManager(imported).latest_epoch()
    if (r.returncode != 0 or open(count).read().strip() != "2"
            or "transient platform failure (rc 18)" not in r.stderr
            or resumed != 3 or n < CHAIN_STEPS):
        raise AssertionError(f"supervised retry: rc {r.returncode}, "
                             f"epoch {resumed}, launches {n}:\n"
                             f"{r.stderr[-3000:]}{r.stdout[-3000:]}")
    os.remove(count)
    stop = subprocess.run(["bash", fast, "3", "--", worker, "20", "true"],
                          capture_output=True, text=True, timeout=60)
    if (stop.returncode != 20 or open(count).read().strip() != "1"
            or "non-retryable exit 20" not in stop.stderr):
        raise AssertionError(f"exit 20: rc {stop.returncode}\n"
                             f"{stop.stderr}")
    print(f"supervisor [{card}]: a worker exiting 18 once, then train "
          f"resuming the imported directory for epoch 3 ({CHAIN_STEPS} "
          f"steps): retried, rc 0 in {wall:.1f} s, fused_frontend launches "
          f"{n}; a worker exiting 20 stopped at once with 20")
    return n


def phase_chain(dev, card: str) -> int:
    """The port's run.sh at the published model widths (enc 512 x 4 with
    the two stride-2 convs, dec 1024 x 2, embedding 256, attention 128,
    char units) on a corpus synthesized by the port's tools/synth_corpus:
    every stage as a subprocess, train through the supervisor (two epochs
    of CHAIN_STEPS steps); then average_checkpoints over the two epochs,
    test on the average and wer_ci over its output; the import path; the
    kernel's dumped rows against the plain frontend; the supervisor's
    retry and stop.  Returns the kernel launches of the chain's
    processes."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        raw = f"{work}/corpus"
        bindir = f"{work}/bin"
        os.makedirs(bindir)
        with open(f"{bindir}/python3", "w") as f:
            f.write(CHAIN_SHIM.format(python=sys.executable))
        os.chmod(f"{bindir}/python3", 0o755)
        env = {**os.environ, "PATH": f"{bindir}:{os.environ['PATH']}",
               "CHAIN_LAUNCHES": f"{work}/launches.jsonl",
               "PYTHONPATH": str(PORT_RUN_SH.parent.parent),
               "RUN_WORKDIR": work, "RUN_UNIT": "char", "RUN_EPOCH": "2",
               "RUN_DEVICE": dev.type, "RUN_LM_EPOCHS": "2",
               "RUN_LM_FLAGS": CHAIN_LM_FLAGS}
        t0 = time.perf_counter()
        r = subprocess.run(
            ["python3", "-m", "automatic_speech_recognition_torch.tools."
             "synth_corpus", "--out", raw] + CHAIN_CORPUS, cwd=work, env=env,
            capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"synth_corpus: {r.stderr[-3000:]}")
        print(f"chain corpus (tools/synth_corpus {' '.join(CHAIN_CORPUS)}): "
              f"{time.perf_counter() - t0:.1f} s")
        launches, walls = {}, []
        for stage, kind in CHAIN_STAGES:
            out, wall, n = run_chain_stage(stage, {
                **env, "RUN_EXTRA_FLAGS": " ".join(chain_flags(work, raw,
                                                               kind))}, work)
            name = f"{stage} ({kind})" if stage == "preprocess" else stage
            launches[name] = n
            walls.append(f"{name} {wall:.1f} s")
            wer = re.findall(r"^WER: (\S+)", out, re.M)
            print(f"run.sh {name} [{card}]: {wall:.2f} s wall, "
                  f"fused_frontend launches {n}"
                  + (f", WER {wer[-1]}" if wer else ""))
            if stage == "train" and ("[train_supervised] done" not in out
                                     or "hostmem: rss" not in out):
                raise AssertionError(f"train stage output:\n{out[-3000:]}")
        for name in ("preprocess (feats)", "train", "test", "decode",
                     "decode_lm"):
            if launches[name] == 0:
                raise AssertionError(f"run.sh {name} did not launch the "
                                     f"kernel: {launches}")
        cfg = Config.from_json(open(f"{work}/model/las/config.json").read())
        if CheckpointManager(f"{work}/model/las").all_epochs() != [1, 2]:
            raise AssertionError("the train stage did not write epochs 1-2")
        err = chain_kernel_rows(dev, work, raw, cfg)
        print(f"chain preprocess features vs the plain frontend on the card "
              f"(4 dev utterances): max abs err {err:.3e}")

        model_flags = RUN_SH_FLAGS + ["--subword_dir", f"{work}/subword/"]
        train_flags = (["--device", dev.type] + model_flags
                       + ["--shard_dir", f"{work}/data/shards"]
                       + chain_flags(work, raw, "raw")
                       + ["--scheduled_sampling", "False"])
        t0 = time.perf_counter()
        avg_tool.main(model_flags + [
            "--save_dir", f"{work}/model/las", "--avg_epochs", "1,2",
            "--avg_out", f"{work}/model/avg"])
        res, n = launched(lambda: test_cli.main(train_flags + [
            "--split", "dev", "--save_dir", f"{work}/model/avg",
            "--restore_epoch", "1", "--log_dir", f"{work}/log_avg"]))
        ci = wer_ci_tool.main(["--ref", f"{work}/log_avg/test_gt.txt",
                               "--hyp", f"{work}/log_avg/test_pred.txt",
                               "--json"])
        launches["test (average)"] = n
        print(f"average_checkpoints of epochs 1-2, test on the average, "
              f"wer_ci [{card}]: {time.perf_counter() - t0:.2f} s; WER "
              f"{ci['wer_a']:.4f}, 95% CI [{ci['ci'][0]:.4f}, "
              f"{ci['ci'][1]:.4f}] over {ci['n_utts']} dev utterances "
              f"(recorded, not a gate: two epochs of {CHAIN_STEPS} steps); "
              f"fused_frontend launches {n}")
        if res.utterances != 8 or not np.isfinite(res.wer):
            raise AssertionError(f"test on the average: {res}")

        imported = chain_import(dev, card, work, cfg)
        launches["supervised train"] = chain_supervisor(
            card, work, env, train_flags, imported)
    total = sum(launches.values())
    print(f"chain phase [{card}]: {time.perf_counter() - t_phase:.1f} s; "
          f"stages {'; '.join(walls)}; fused_frontend launches {launches} "
          f"= {total}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, allow_tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _kernels.load("fused_frontend")
    print(f"fused_frontend build + load: {time.perf_counter() - t0:.2f} s")
    print(_kernels.build_log.get("fused_frontend", "(already built)").strip())
    if sys.argv[1:] == ["--multichip"]:
        with tempfile.TemporaryDirectory() as d:
            write_train_shards(d, np.random.default_rng(2))
            phase_multichip(dev, card, d)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--lstm"]:
        print(json.dumps({"kernels": [lstm_row(phase_lstm(dev, card),
                                               card)]}))
        return 0

    k = phase_kernel(dev, card)
    lk = phase_lstm(dev, card)
    launches = phase_serving(dev, card)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_train_shards(d, np.random.default_rng(2))
        print(f"training shards: {sum(TRAIN_BATCH)} synthesized records "
              f"in {time.perf_counter() - t0:.1f} s")
        launches += phase_train(dev, card, d)
        launches += phase_beam(dev, card)
        launches += phase_recipe(dev, card)
        launches += phase_configs(dev, card, d)
        launches += phase_parallel(dev, card, d)
        launches += phase_tensor_parallel(dev, card, d)
        launches += phase_multihost(dev, card, d)
    launches += phase_chain(dev, card)

    print(json.dumps({"kernels": [{
        "name": "fused_frontend", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "share": k["share"], "library_ms": None,
        "previous_ms": None, "stft_spectrum_ms": k["stft_ms"],
        "ms_8x2s": k["shapes"][TIMED_SHAPES[1][0]]["ms"],
        "previous_ms_8x2s": None,
        "pass_ms": k["passes"], "hmma": k["hmma"], "card": card},
        lstm_row(lk, card)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
