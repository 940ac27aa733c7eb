"""Acoustic frontend in plain PyTorch (counterpart of
automatic_speech_recognition_tpu/ops/frontend.py).

framing -> DFT-as-matmul power spectrum (1/N) -> mel -> log/DCT with
c0 = log energy (mfcc) or mel energies (fbank) -> masked per-utterance CMVN
-> feature-axis delta stacking, giving (B, T, D, 3) float32 (cmvn on) or
(B, T, D) raw features (cmvn off), with the speechpy semantics the JAX
package pins.  This is the path for CPU tensors and the reference the CUDA
kernel (ops/cuda_frontend.py) is held against; `extract_features_cfg`,
`extract_features_list` (decoding raw-audio shards) and `featurize_batch`
(the train step over raw-audio shards) send CUDA tensors to the kernel
when `cfg.use_pallas` is set.
"""

from __future__ import annotations

import functools
from typing import Iterator, List, Tuple

import numpy as np
import torch

from automatic_speech_recognition_torch.ops import frontend_host as host

EPS_CMVN = 2.0 ** -30
EPS_ZERO = float(np.finfo(np.float64).eps)
# powers below the smallest normal float32 count as zero, in this version
# and in the kernel alike (the TPU flushes subnormals): a frame of
# resampler ringing (samples ~1e-22) has a subnormal energy, which one
# float32 summation order keeps and another underflows
FLT_MIN = float(np.finfo(np.float32).tiny)


@functools.lru_cache(maxsize=16)
def _dft_matrices(flen: int, fft_length: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flen, fft//2+1) cos and -sin: frames @ C = Re(rfft), @ S = Im."""
    n = np.arange(flen)[:, None]
    k = np.arange(fft_length // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / fft_length
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(-np.sin(ang), dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=16)
def _mel_matrix(num_filters: int, fft_length: int, sample_rate: int,
                device: torch.device) -> torch.Tensor:
    fb = host.mel_filterbank(num_filters, fft_length // 2 + 1, sample_rate,
                             0, sample_rate / 2)
    return torch.tensor(fb.T, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def _dct_matrix(num_inputs: int, num_outputs: int,
                device: torch.device) -> torch.Tensor:
    return torch.tensor(host.dct_matrix(num_inputs, num_outputs),
                        dtype=torch.float32, device=device)


def frame_signal(audio: torch.Tensor, flen: int, fstride: int,
                 frames_max: int) -> torch.Tensor:
    """(B, S) -> (B, frames_max, flen); the gather clamps at S - 1."""
    idx = (torch.arange(frames_max) * fstride)[:, None] + torch.arange(flen)
    idx = idx.clamp(max=audio.shape[-1] - 1).to(audio.device)
    return audio[:, idx]


def power_spectrum(frames: torch.Tensor, fft_length: int) -> torch.Tensor:
    """|rfft|^2 / N over all fft//2 + 1 bins, as two matmuls."""
    C, S = _dft_matrices(frames.shape[-1], fft_length, frames.device)
    re = frames @ C
    im = frames @ S
    return (re * re + im * im) * (1.0 / fft_length)


def _zero_handling(x: torch.Tensor) -> torch.Tensor:
    """Zero (or subnormal) power -> speechpy's eps; x is non-negative."""
    return x.masked_fill(x < FLT_MIN, EPS_ZERO)


def _row_totals(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(B, T, D), (B,) frame counts in [0, T] -> (B, 1, D): each row's sum
    over its first n frames, read from a prefix sum along T (zero for
    n = 0).  The prefix runs along the row in order, so the sum does not
    depend on the frames past n, frames_max or the other rows."""
    idx = (n - 1).clamp(min=0)[:, None, None].expand(-1, 1, x.shape[2])
    total = torch.cumsum(x, 1).gather(1, idx)
    return torch.where(n[:, None, None] > 0, total, torch.zeros_like(total))


def masked_cmvn(feat: torch.Tensor, featlen: torch.Tensor) -> torch.Tensor:
    """Per-utterance CMVN over the first featlen frames: population std,
    denominator std + 2^-30, count floored at 1.  A row's result does not
    depend on its batch-mates or on frames_max."""
    T = feat.shape[1]
    n = featlen.to(feat.device).clamp(0, T).long()
    m3 = (torch.arange(T, device=feat.device)[None, :]
          < n[:, None]).to(feat.dtype)[..., None]
    count = n.clamp(min=1).to(feat.dtype)[:, None, None]
    mean = _row_totals(feat, n) / count
    centered = (feat - mean) * m3
    var = _row_totals(centered * centered, n) / count
    return centered / (var.sqrt() + EPS_CMVN)


def feature_axis_deltas(feat: torch.Tensor) -> torch.Tensor:
    """speechpy's derivative along the FEATURE axis, edge-padded:
    (x[j+1] - x[j-1] + 2 x[j+2] - x[j-2]) / 10."""
    D = feat.shape[-1]
    idx = torch.arange(-2, D + 2, device=feat.device).clamp(0, D - 1)
    p = feat[..., idx]
    return (1.0 * p[..., 3:3 + D] - p[..., 1:1 + D]
            + 2.0 * p[..., 4:4 + D] - p[..., 0:D]) / 10.0


def stack_derivatives(feat: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, D, 3): static, delta, delta-delta."""
    d1 = feature_axis_deltas(feat)
    d2 = feature_axis_deltas(d1)
    return torch.stack([feat, d1, d2], dim=-1)


def _cmvn_tail(feat: torch.Tensor, featlen: torch.Tensor,
               apply_cmvn: bool) -> torch.Tensor:
    """CMVN + delta stack with frames >= featlen zeroed, or the raw
    features verbatim."""
    if not apply_cmvn:
        return feat
    feat = stack_derivatives(masked_cmvn(feat, featlen))
    mask = (torch.arange(feat.shape[1], device=feat.device)[None, :]
            < featlen[:, None])
    return feat * mask[:, :, None, None].to(feat.dtype)


def reference_features(audio: torch.Tensor, featlen: torch.Tensor, *,
                       flen: int, fstride: int, fft_length: int,
                       feat_dim: int, feat_type: str, num_mel_filters: int,
                       sample_rate: int, frames_max: int,
                       apply_cmvn: bool) -> torch.Tensor:
    """The plain version of the fused kernel: same arguments, same
    outputs as ops/cuda_frontend.fused_frontend."""
    frames = frame_signal(audio, flen, fstride, frames_max)
    ps = power_spectrum(frames, fft_length)                      # (B,T,K)
    if feat_type == "mfcc":
        mel = ps @ _mel_matrix(num_mel_filters, fft_length, sample_rate,
                               audio.device)
        feat = torch.log(_zero_handling(mel)) @ _dct_matrix(
            num_mel_filters, feat_dim, audio.device)
        energy = _zero_handling(ps.sum(-1))
        feat[..., 0] = torch.log(energy)                         # c0
    elif feat_type == "fbank":
        feat = _zero_handling(ps @ _mel_matrix(feat_dim, fft_length,
                                               sample_rate, audio.device))
    else:
        raise ValueError(f"unknown feat_type: {feat_type}")
    return _cmvn_tail(feat, featlen, apply_cmvn)


def extract_features(audio: torch.Tensor, audiolen: torch.Tensor, *,
                     sample_rate: int = 16000, frame_length_ms: int = 25,
                     frame_step_ms: int = 10, feat_dim: int = 13,
                     feat_type: str = "mfcc", apply_cmvn: bool = True,
                     fft_length: int = 512, num_mel_filters: int = 40,
                     frames_max: int = 0, use_kernel: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched feature extraction.

    Args:
      audio:    (B, S) float32 padded waveforms.
      audiolen: (B,) valid sample counts.
      frames_max: output frame count; 0 = derive from S.
      use_kernel: run the fused CUDA kernel (a CPU tensor takes the plain
        path either way).

    Returns:
      feats:   (B, frames_max, feat_dim, 3) float32 (cmvn on), else
               (B, frames_max, feat_dim) raw features.
      featlen: (B,) int32 valid frame counts, floor((len-flen)/stride)
               clamped to [0, frames_max].
    """
    flen, fstride = host.frame_params(sample_rate, frame_length_ms,
                                      frame_step_ms)
    if frames_max <= 0:
        frames_max = max(host.num_frames(audio.shape[-1], flen, fstride), 1)
    audiolen = audiolen.to(audio.device)
    featlen = torch.div(audiolen - flen, fstride, rounding_mode="floor")
    featlen = featlen.clamp(0, frames_max).to(torch.int32)
    kw = dict(flen=flen, fstride=fstride, fft_length=fft_length,
              feat_dim=feat_dim, feat_type=feat_type,
              num_mel_filters=num_mel_filters, sample_rate=sample_rate,
              frames_max=frames_max, apply_cmvn=apply_cmvn)
    audio = audio.to(torch.float32)
    if use_kernel:
        from . import cuda_frontend
        return cuda_frontend.fused_frontend(audio.contiguous(), featlen,
                                            **kw), featlen
    return reference_features(audio, featlen, **kw), featlen


def extract_features_cfg(audio: torch.Tensor, audiolen: torch.Tensor, cfg,
                         frames_max: int = 0):
    """Config-driven wrapper: cfg.use_pallas selects the fused kernel,
    which a CUDA tensor runs and a CPU tensor replaces by the plain path."""
    return extract_features(
        audio, audiolen,
        sample_rate=cfg.sample_rate, frame_length_ms=cfg.frame_length,
        frame_step_ms=cfg.frame_step, feat_dim=cfg.feat_dim,
        feat_type=cfg.feat_type, apply_cmvn=cfg.cmvn,
        fft_length=cfg.fft_length, num_mel_filters=cfg.num_mel_filters,
        frames_max=frames_max, use_kernel=cfg.use_pallas)


def feature_batches(signals, cfg, batch_size: int = 128,
                    pad_quantum_s: float = 1.0
                    ) -> Iterator[Tuple[List[int], np.ndarray, np.ndarray]]:
    """extract_features_list's batches: (indices, (b, S) float32 padded
    waveforms, (b,) int32 lengths), sorted by length, batch_size at a
    time, S a whole number of pad_quantum_s."""
    order = sorted(range(len(signals)), key=lambda i: len(signals[i]))
    quantum = max(int(pad_quantum_s * cfg.sample_rate), 1)
    for lo in range(0, len(order), batch_size):
        idx = order[lo:lo + batch_size]
        lens = np.asarray([len(signals[i]) for i in idx], np.int32)
        padded = np.zeros((len(idx), -(-int(lens.max()) // quantum)
                           * quantum), np.float32)
        for r, i in enumerate(idx):
            padded[r, :lens[r]] = signals[i]
        yield idx, padded, lens


def extract_features_list(signals, cfg, device: torch.device,
                          batch_size: int = 128,
                          pad_quantum_s: float = 1.0) -> List[np.ndarray]:
    """Featurize a list of waveforms on `device` (the fused kernel on a
    GPU with cfg.use_pallas): sorted by length, batch_size at a time,
    padded to a whole number of pad_quantum_s (feature_batches); returns
    per-utterance (T_i, D, 3) float32 arrays (T_i = featlen) in the input
    order."""
    out: List[np.ndarray] = [None] * len(signals)
    for idx, padded, lens in feature_batches(signals, cfg, batch_size,
                                             pad_quantum_s):
        feats, featlen = extract_features_cfg(
            torch.from_numpy(padded).to(device),
            torch.from_numpy(lens).to(device), cfg)
        feats, featlen = feats.cpu().numpy(), featlen.cpu().numpy()
        for r, i in enumerate(idx):
            out[i] = feats[r, :featlen[r]]
    return out


def featurize_batch(sig: torch.Tensor, siglen: torch.Tensor, cfg
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A loader batch of raw waveforms, (B, S, 1, 1) or (B, S), -> the
    feature batch the model takes, (B, T, D, 3) with CMVN or (B, T, D, 1)
    raw, and frame counts floored at 1 (as the feature pipeline pads a
    sub-frame row to one zeroed frame).  T follows S.  The fused kernel
    runs on a CUDA tensor when cfg.use_pallas is set; the waveform takes
    no gradient, so the kernel needs no backward."""
    if sig.dim() == 4:
        sig = sig[:, :, 0, 0]
    feat, featlen = extract_features_cfg(sig, siglen.to(torch.int32), cfg)
    if feat.dim() == 3:                  # no CMVN: one channel
        feat = feat[..., None]
    return feat, featlen.clamp(min=1)
