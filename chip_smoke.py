#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the fused frontend kernel from csrc/ with nvcc.
2. Holds the kernel to its plain PyTorch version on the card (mfcc and
   fbank, CMVN on and off, B = 8 at 1 to 32 s with ragged and sub-frame
   rows, rtol 1e-4 / atol 2e-4) and to the NumPy speechpy golden on
   synthesized speech (5e-3); times kernel and plain at 128 x 10 s.
3. Serves >= 12 concurrent synthesized requests through
   BatchingRecognizer at the published width (run.sh: cnn listener
   4 x 512, location attention 128 / K 201 / 10 channels, speller
   2 x 1024, char vocab 30, mfcc 13 + deltas, float32, random weights
   from seed 0), checks the transcripts, the kernel's launch count and
   finite logits, and kernel vs plain frontend on one batch.

Every phase raises on failure.  The last line is the result JSON; the
line before it lists the kernels.  Without CUDA it exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from automatic_speech_recognition_tpu.config import Config
from automatic_speech_recognition_tpu.ops import frontend_host as host
from automatic_speech_recognition_tpu.utils.formant_synth import (
    PHONES, synth_phones)
from automatic_speech_recognition_tpu.utils.tokenizer import CharEncoder
from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.models import las
from automatic_speech_recognition_torch.ops import _kernels, cuda_frontend
from automatic_speech_recognition_torch.ops import frontend
from automatic_speech_recognition_torch.serving import BatchingRecognizer
from automatic_speech_recognition_torch.utils.device import resolve_device

SR = 16000
RTOL, ATOL = 1e-4, 2e-4          # tests/test_pallas_frontend.py
GOLDEN_TOL = 5e-3                # tests/test_frontend_golden.py
BUCKETS = [2, 4, 8, 16, 32]
KERNEL_SOURCE = "automatic_speech_recognition_torch/csrc/fused_frontend.cu"
REPLACES = "automatic_speech_recognition_tpu/ops/pallas_frontend.py:177"


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


def phase_kernel(dev, card: str):
    """Kernel vs plain on the card; returns (max_abs_err, ms, plain_ms)."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for seconds in (1, 2, 4, 8, 10, 16, 32):
        S = seconds * SR
        audio = torch.from_numpy((rng.standard_normal((8, S)) * 0.1)
                                 .astype(np.float32)).to(dev)
        audiolen = torch.tensor([S] * 6 + [S // 2, 300], device=dev)
        for feat_type in ("mfcc", "fbank"):
            for cmvn in (True, False):
                kw = dict(feat_dim=13, feat_type=feat_type, apply_cmvn=cmvn)
                fk, lk = frontend.extract_features(audio, audiolen,
                                                   use_kernel=True, **kw)
                fp, lp = frontend.extract_features(audio, audiolen, **kw)
                torch.cuda.synchronize()
                if not torch.equal(lk, lp):
                    raise AssertionError("featlen differs")
                name = f"{seconds}s {feat_type} cmvn={cmvn} T={fk.shape[1]}"
                err = check_close(name, fk, fp, RTOL, ATOL)
                worst = max(worst, err)
                print(f"kernel vs plain  {name:28s} max_abs_err {err:.3e}")

    # the speechpy golden (float64 NumPy) on synthesized speech
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

    # time at the bench.py shape: 128 x 10 s, mfcc 13 + CMVN + deltas
    B, S = 128, 10 * SR
    audio = torch.from_numpy((rng.standard_normal((B, S)) * 0.1)
                             .astype(np.float32)).to(dev)
    flen, fstride = host.frame_params(SR, 25, 10)
    T = host.num_frames(S, flen, fstride)
    featlen = torch.full((B,), T, dtype=torch.int32, device=dev)
    kw = dict(flen=flen, fstride=fstride, fft_length=512, feat_dim=13,
              feat_type="mfcc", num_mel_filters=40, sample_rate=SR,
              frames_max=T, apply_cmvn=True)
    kernel = lambda: cuda_frontend.fused_frontend(audio, featlen, **kw)
    plain = lambda: frontend.reference_features(audio, featlen, **kw)
    check_close("128x10s", kernel(), plain(), RTOL, ATOL)
    times = {"kernel": [], "plain": []}
    for _ in range(3):                      # plain, kernel, kernel, plain
        for which in ("plain", "kernel", "kernel", "plain"):
            times[which].append(cuda_ms(kernel if which == "kernel"
                                        else plain, 10))
    ms, plain_ms = (float(np.median(times[k])) for k in ("kernel", "plain"))
    print(f"frontend 128 x 10 s mfcc13+cmvn+deltas [{card}]: kernel "
          f"{ms:.4f} ms/batch (runs {times['kernel']}), plain {plain_ms:.4f} "
          f"ms/batch (runs {times['plain']})")
    return worst, ms, plain_ms


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    worst, ms, plain_ms = phase_kernel(dev, card)
    launches = phase_serving(dev, card)

    print(json.dumps({"kernels": [{
        "name": "fused_frontend", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
