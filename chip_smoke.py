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
   (15 kHz) and whole frames (11025 Hz).  Then to the NumPy speechpy golden on synthesized speech
   (5e-3).  Counts the HMMA (tensor-core) instructions of the built
   library (cuobjdump -sass).  Times the kernel, the previous kernel
   (built from a scratch copy of its source at BASELINE_SOURCE, when one
   is there) and the plain version in turns at 128 x 10 s and the serving
   and training shapes, each beside its bound; each pass's device time at
   8 x 32 s from a torch.profiler trace; and torch.stft's power spectrum
   of the same frames at 128 x 10 s, a yardstick for the spectrum stage
   only.
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
   - a Recognizer over a mesh that lists the card twice: greedy tokens
     and beam-8 joint-CTC rank 0 against one device on 8 utterances, 7
     requests padded to the data axis, the greedy batch's ms each way.

Every phase raises on failure.  The last line is the result JSON; the
line before it lists the kernels, with the launches of the serving,
training, beam, recipe, configs and parallel runs (the last counted in
their processes).  Without CUDA it exits non-zero.

    python3 chip_smoke.py --multichip    # a host with N > 1 GPUs

runs only the data-parallel checks across N GPUs (phase_multichip):
train.main on N NCCL processes against one process on the same 8 s x 48
global batches, N NCCL ranks of 48 rows each against one process on the
N x 48 batch (with the NCCL all-reduce's ms and each rank's ms per step
against one process's at 48 rows), and greedy and beam decoding over a
mesh of every GPU ('cuda:0,...,cuda:N-1') against one.
"""

from __future__ import annotations

import copy
import ctypes
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
from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.data.audio_io import (read_audio,
                                                              write_wav)
from automatic_speech_recognition_torch.decoding import beam as beam_lib
from automatic_speech_recognition_torch.models import char_rnn, las
from automatic_speech_recognition_torch.ops import _kernels, augmentation, quant
from automatic_speech_recognition_torch.ops import cuda_frontend, frontend
from automatic_speech_recognition_torch.parallel import distributed, sharding
from automatic_speech_recognition_torch.parallel.mesh import (devices_for,
                                                              make_mesh)
from automatic_speech_recognition_torch.serving import BatchingRecognizer
from automatic_speech_recognition_torch.training import trainer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)
from automatic_speech_recognition_torch.utils.device import (disable_tf32,
                                                              resolve_device)

SR = 16000
RTOL, ATOL = 1e-4, 2e-4          # tests/test_pallas_frontend.py
GOLDEN_TOL = 5e-3                # tests/test_frontend_golden.py
BUCKETS = [2, 4, 8, 16, 32]
KERNEL_SOURCE = "automatic_speech_recognition_torch/csrc/fused_frontend.cu"
REPLACES = "automatic_speech_recognition_tpu/ops/pallas_frontend.py:177"
# the previous kernel's source, for timing in turns with the new one: a
# scratch copy in a git-ignored directory, never committed
BASELINE_SOURCE = Path("_baseline/fused_frontend.cu")
H100_HBM = 3.35e12               # bytes/s, H100 SXM data sheet
H100_TF32 = 495e12               # dense TF32 tensor-core FLOP/s
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


def frontend_work(p, B: int, S: int, T: int, D: int):
    """(bytes, operations) the fused frontend must move and do at this
    shape: audio read once, (B, T, D, 3) features written once, featlen;
    the shared-subsegment DFT, the twiddle combine, the power spectrum,
    the mel filterbank's nonzeros and the DCT (PERF.md, bring_up table)."""
    nbytes = 4 * (B * S + B * T * D * 3 + B)
    nseg = p["step"] * (T - 1) + p["J"]
    per_utt = (2 * nseg * p["slen"] * 2 * p["nbins"]          # segment DFT
               + 8 * T * p["nbins"] * p["J"]                   # combine
               + 3 * T * p["nbins"]                            # |X|^2 / N
               + 2 * T * len(p["melw"])                        # mel
               + 2 * T * p["F"] * (D - 1))                     # DCT
    return nbytes, B * per_utt


def bound(p, B: int, S: int, T: int, D: int):
    """(bound ms, 'bytes' or 'operations'): the larger of the bytes over
    HBM's rate and the operations over the TF32 tensor-core peak."""
    nbytes, ops = frontend_work(p, B, S, T, D)
    t_bytes, t_ops = nbytes / H100_HBM * 1e3, ops / H100_TF32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def baseline_kernel(dev):
    """The previous kernel, built from a scratch copy of its source when
    one lies at BASELINE_SOURCE (never committed), for timing in turns
    with the new one; None without it."""
    if not BASELINE_SOURCE.exists():
        print(f"previous kernel: not timed (no source at {BASELINE_SOURCE})")
        return None
    lib = _kernels.load("fused_frontend_baseline", BASELINE_SOURCE)
    fn = lib.asr_fused_frontend
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = cuda_frontend.plan(400, 160, 512, 13, "mfcc", 40, SR)
    ang = 2.0 * np.pi * np.arange(512) / 512
    consts = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
              for a in (np.stack([np.cos(ang), np.sin(ang)], 1), p["mel"],
                        p["dct"])]
    bins = torch.from_numpy(p["bins"]).to(dev)

    def run(audio, featlen, T):
        B, S = audio.shape
        raw = torch.empty((B, T, 13), device=dev)
        out = torch.empty((B, T, 13, 3), device=dev)
        rc = fn(audio.data_ptr(), featlen.data_ptr(), bins.data_ptr(),
                *(c.data_ptr() for c in consts), raw.data_ptr(),
                out.data_ptr(), B, S, T, 400, 160, 512, len(p["bins"]),
                p["ksup"], p["F"], 13, 1, 1,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"previous kernel launch failed: {rc}")
        return out
    print(f"previous kernel built from {BASELINE_SOURCE}:\n"
          f"{_kernels.build_log.get('fused_frontend_baseline', '').strip()}")
    return run


def kernel_ms(fn, names, reps: int = 20) -> dict:
    """Mean device ms per launch of each kernel whose name holds one of
    `names`, from a torch.profiler trace of reps calls of fn, each of
    which must launch it once."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_intervals(prof.events())
    res = {}
    for name in names:
        hits = [e.time_range.elapsed_us() for e in events if name in e.name]
        if len(hits) != reps:
            raise AssertionError(f"the trace holds {len(hits)} launches of "
                                 f"{name}, expected {reps}")
        res[name] = sum(hits) / reps / 1e3
    return res


def in_turns(fns: dict, reps: int, rounds: int = 3) -> dict:
    """Median ms per call of each function, timed in turns: plain, new,
    old, old, new, plain (CUDA events, reps calls a reading)."""
    order = [k for k in ("plain", "kernel", "old", "old", "kernel", "plain")
             if k in fns]
    runs = {k: [] for k in fns}
    for _ in range(rounds):
        for k in order:
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
    shapes (new, previous and plain in turns), pass 2 alone, the stft
    yardstick, the HMMA count; returns the kernel line's numbers."""
    rng = np.random.default_rng(0)
    worst = kernel_cases(dev, rng)
    golden(dev, rng)
    hmma = hmma_count()
    print(f"HMMA instructions in the built fused_frontend library: {hmma}")
    if hmma == 0:
        raise AssertionError("the built kernel has no tensor-core (HMMA) "
                             "instruction")
    old = baseline_kernel(dev)
    p = cuda_frontend.plan(400, 160, 512, 13, "mfcc", 40, SR)
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
        if old is not None:
            fns["old"] = lambda: old(audio, featlen, T)
            check_close(f"{name} previous", fns["old"](), want, RTOL, ATOL)
        times = in_turns(fns, 10 if B * S > 8 * 32 * SR else 50)
        b_ms, b_by = bound(p, B, S, T, 13)
        ms = times["kernel"][0]
        old_txt = (f"previous {times['old'][0]:.4f} ms (runs "
                   f"{times['old'][1]}), " if "old" in times else "")
        print(f"frontend {name} mfcc13+cmvn+deltas, T {T} [{card}]: new "
              f"{ms:.4f} ms (runs {times['kernel'][1]}), {old_txt}plain "
              f"{times['plain'][0]:.4f} ms (runs {times['plain'][1]}); bound "
              f"{b_ms * 1e3:.2f} us ({b_by}), share {b_ms / ms:.4f}")
        res[name] = dict(ms=ms, plain_ms=times["plain"][0],
                         old_ms=times["old"][0] if "old" in times else None,
                         bound_ms=b_ms, bound_by=b_by)
        del audio, fns, want

    # each pass's device time at serving's 8 x 32 s, from a trace of
    # whole calls
    S = 32 * SR
    T = host.num_frames(S, 400, 160)
    audio = noise(rng, 8, S, dev)
    featlen = torch.full((8,), T, dtype=torch.int32, device=dev)
    t = kernel_ms(lambda: cuda_frontend.fused_frontend(
        audio, featlen, flen=400, fstride=160, fft_length=512, feat_dim=13,
        feat_type="mfcc", num_mel_filters=40, sample_rate=SR, frames_max=T,
        apply_cmvn=True), ("features_kernel", "cmvn_deltas_kernel"))
    pass2_ms = t["cmvn_deltas_kernel"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"device time per launch at 8 x 32 s (torch.profiler, 20 calls) "
          f"[{card}]: pass 2 (CMVN + deltas) {pass2_ms:.4f} ms, "
          f"{-(-T // cuda_frontend.pass2_frames(13))} blocks per utterance; "
          f"pass 1 {t['features_kernel']:.4f} ms, tiling "
          f"{cuda_frontend.tiling(p, 8, T, sms, 13)}")

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
                pass2_ms=pass2_ms, stft_ms=stft_ms, hmma=hmma,
                shapes=res)


class CheckedRecognizer(Recognizer):
    """Records, for every batch it decodes, whether all logits are finite."""

    def __init__(self, *args):
        super().__init__(*args)
        self.finite = []

    def greedy(self, feats, featlen):
        logits, y_hat = super().greedy(feats, featlen)
        self.finite.append(bool(torch.isfinite(logits).all()))
        return logits, y_hat


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
        base + ["--shard_dir", shard_dir, "--save_dir", save_dir,
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


def device_intervals(events):
    """The device's kernel and copy events of a profiler trace, without
    the device-side copies of record_function ranges."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy(events, name: str):
    """(busy, span) in ms from a profiler trace: the union of the device's
    kernel and copy intervals, and the span from the start of the host
    range `name` to the end of the last of them."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_intervals(events))
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
    for e in device_intervals(events):
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("train_step"):
            step()
        torch.cuda.synchronize()
    events = prof.events()
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
    """Records, for every beam batch it decodes, whether rank 0 holds a
    hypothesis and every score is a number, and the decoder steps."""

    def __init__(self, *args):
        super().__init__(*args)
        self.ok, self.steps = [], []

    def beam(self, feats, featlen, beam_size):
        res = super().beam(feats, featlen, beam_size)
        kept = res.scores > beam_lib.NEG / 2
        self.ok.append(bool(kept[:, 0].all())
                       and bool(torch.isfinite(res.scores[kept]).all())
                       and not bool(torch.isnan(res.scores).any()))
        self.steps.append(res.steps)
        return res


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
    if not all(all(rec.ok) for rec in recs.values()):
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("beam_batch"):
            rec.transcribe_signals(batches[8], beam_size=BEAM_SIZE,
                                   pad_seconds=8)
        torch.cuda.synchronize()
    events = prof.events()
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

        (ts, hist), n = launched(lambda: train_cli.main(
            ["--device", dev.type] + shard_flags + RECIPE_AUG
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("train_step"):
            trainer.train_step(ts, batch, cfg)
        torch.cuda.synchronize()
    events = prof.events()
    busy_ms, span_ms = device_busy(events, "train_step")
    rnn = [e.name for e in device_intervals(events) if "RNN" in e.name]
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
                timeout: float = 300.0) -> list:
    """`world` processes of `code` with torchrun's variables set by hand
    (LOCAL_RANK local_rank(r), default r), from the repository root;
    returns each one's RESULT object and its output.  Every process is
    waited for or killed."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r if local_rank is None else local_rank(r)),
                   MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *args], env=env,
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


def dp_train(dev, card: str, d: str, world: int) -> int:
    """train.main on `world` processes given torchrun's environment (NCCL,
    one GPU each; WORLD_SIZE 1 on one card) over the 8 s x 48 global
    batches, against the same steps in this process without it: the
    losses and ms per step."""
    flags = with_flags(PUBLISHED_FLAGS, bucket_boundaries_train=DP_FRAMES)
    flags += ["--shard_dir", d, "--bucket_batch_sizes", str(DP_BATCH),
              "--epoch", "1", "--steps_per_epoch", str(DP_STEPS)]
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
        ts, hist = train_cli.main(flags + [
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
          f"steps (first {rel[0]:.2e}); fused_frontend launches "
          f"{sum(r['launches'] for r, _ in ranks)} + {launches}")
    return sum(r["launches"] for r, _ in ranks) + launches


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


def dp_eval(dev, card: str, name: str) -> int:
    """Greedy and beam-8 joint-CTC decoding over the mesh `name` names
    against one device, 8 utterances at 8 s, and the greedy batch's ms
    each way in turns."""
    cfg = published_cfg().replace(ctc=True, beam_logprob=True,
                                  ctc_beam_weight=0.5)
    model = las.init(cfg, torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        model.speller.out.bias[EOS_ID] -= EOS_SHIFT
        model.speller.ctc_head.bias[EOS_ID] -= EOS_SHIFT
    one = Recognizer(model, cfg, CharEncoder(), "cuda:0")
    many = Recognizer(model, cfg, CharEncoder(), name)
    n = many.mesh.shape["data"]
    if n < 2 or many.replicas[1].model is model:
        raise AssertionError(f"{name}: the mesh did not place replicas")
    rng = np.random.default_rng(9)
    sigs = [speech(rng, DP_SECONDS * rng.uniform(0.8, 1.0))
            for _ in range(8)]
    cuda_frontend.fused_frontend.launches = 0
    feats, featlen = many._features(sigs, pad_seconds=DP_SECONDS)
    lg2, y2 = many.greedy(feats, featlen)
    lg1, y1 = one.greedy(feats, featlen)
    b2 = many.beam(feats, featlen, BEAM_SIZE)
    b1 = one.beam(feats, featlen, BEAM_SIZE)
    texts = many.transcribe_signals(sigs[:7], beam_size=BEAM_SIZE,
                                    pad_seconds=DP_SECONDS)
    torch.cuda.synchronize()
    launches = cuda_frontend.fused_frontend.launches
    fns = {"one": lambda: one.greedy(feats, featlen),
           "many": lambda: many.greedy(feats, featlen)}
    runs = {k: [] for k in fns}
    for order in (("one", "many"), ("many", "one")) * 2:
        for k in order:
            runs[k].append(round(cuda_ms(fns[k], 1), 2))
    ms = {k: f"{np.median(v):.2f} (of {v})" for k, v in runs.items()}
    greedy_ties, equal = 0, []
    for b in range(8):
        diff = (y2[b] != y1[b]).nonzero()
        if not len(diff):
            equal.append(b)
            continue
        t = int(diff[0])
        gap = float(lg1[b, t].topk(2).values.diff().abs())
        if gap > NEAR_TIE:
            raise AssertionError(f"greedy over {name}, utterance {b}: step "
                                 f"{t} differs with a top-2 logit gap of "
                                 f"{gap}")
        greedy_ties += 1
    err = float((lg2[equal] - lg1[equal]).abs().max()) if equal else 0.0
    ties = compare_rank0(f"beam over {name} vs one device", b2, b1)
    if len(texts) != 7 or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"7 requests over {name}: {texts}")
    print(f"eval over a data axis of {n} ({name}) [{card}]: greedy tokens "
          f"equal to one device on {len(equal)} of 8 rows, {greedy_ties} "
          f"near ties (logits of the equal rows max abs err {err:.3e}); "
          f"beam {BEAM_SIZE} joint CTC rank 0 equal on {8 - ties} of 8, "
          f"{ties} near ties; 7 requests (padded to "
          f"{sharding.pad_batch_to(7, n)}) "
          f"through transcribe_signals; fused_frontend launches {launches}; "
          f"greedy batch of 8, ms in turns: one device {ms['one']}, {n} "
          f"replicas {ms['many']}")
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


def phase_multichip(dev, card: str, d: str) -> int:
    """`python3 chip_smoke.py --multichip` on a host of N > 1 GPUs: train.main
    on N NCCL processes against one, N NCCL ranks at DP_BATCH rows each
    against one process on the N x DP_BATCH batch, and eval over every
    GPU against one; returns the kernel launches."""
    n = torch.cuda.device_count()
    if n < 2:
        raise AssertionError(f"--multichip needs 2 or more GPUs, found {n}")
    t0 = time.perf_counter()
    launches = dp_train(dev, card, d, n)
    launches += dp_ranks(dev, card, d, n, "nccl", DP_BATCH)
    launches += dp_eval(dev, card, ",".join(f"cuda:{i}" for i in range(n)))
    print(f"multichip phase, {n} GPUs [{card}]: "
          f"{time.perf_counter() - t0:.1f} s, fused_frontend launches "
          f"{launches}")
    return launches


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

    k = phase_kernel(dev, card)
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

    print(json.dumps({"kernels": [{
        "name": "fused_frontend", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "share": k["share"], "library_ms": None,
        "previous_ms": k["old_ms"], "stft_spectrum_ms": k["stft_ms"],
        "pass2_ms_8x32s": k["pass2_ms"], "hmma": k["hmma"],
        "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
