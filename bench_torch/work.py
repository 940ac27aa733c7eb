"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes the model's function needs, counted from shapes:
the frontend's here, since every configuration shares the fused kernel,
and the rest by the configuration's reference module (reference/).

Counts are of the function, not of any kernel's algorithm: a matrix
product of (m, k) by (k, n) is 2 m k n; a 512-point real DFT is
2.5 N log2 N (a real FFT's count); an element-wise operation is one.
Utilization numbers built on them count useful work only: real frames,
each utterance's own step budget, real tokens; no recomputation."""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from bench_torch.reference.las import _mel_filterbank

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def peak(cfg: dict) -> float:
    """The dense peak of the configuration's precision: float32 with TF32
    off runs outside the tensor cores."""
    return PEAK_FLOPS[cfg["dtype"]]


@lru_cache(maxsize=8)
def _mel_nonzeros(filters: int, fft_length: int, sample_rate: int) -> int:
    fb = _mel_filterbank(filters, fft_length // 2 + 1, sample_rate)
    return int(np.count_nonzero(fb))


def frontend_ops_per_frame(cfg: dict) -> float:
    """DFT, power, mel, log and DCT (mfcc) or mel (fbank), CMVN, deltas."""
    n = cfg["fft_length"]
    bins = n // 2 + 1
    D = cfg["feat_dim"]
    ops = 2.5 * n * math.log2(n) + 3 * bins
    if cfg["feat_type"] == "mfcc":
        F = cfg["num_mel_filters"]
        ops += 2 * _mel_nonzeros(F, n, cfg["sample_rate"]) + F
        ops += 2 * F * D + bins                  # DCT, c0 energy
    else:
        ops += 2 * _mel_nonzeros(D, n, cfg["sample_rate"])
    ops += 6 * D                                 # CMVN: mean, var, scale
    ops += 2 * 5 * D                             # two delta passes
    return ops


def frontend_bytes(B: int, S: int, T: int, D: int) -> int:
    """Audio read once, (B, T, D, 3) float32 features and featlen written
    once."""
    return 4 * (B * S + B * T * D * 3 + B)


def frontend_least_s(cfg: dict, B: int, S: int, T: int) -> float:
    """The least time of one frontend call on the card: the larger of its
    bytes over HBM's rate and its operations over the TF32 peak."""
    ops = B * T * frontend_ops_per_frame(cfg)
    return max(frontend_bytes(B, S, T, cfg["feat_dim"]) / HBM_BYTES_PER_S,
               ops / PEAK_FLOPS["tf32"])


def forward_flops(model, cfg: dict, frames: int, steps: int) -> float:
    """Frontend, and what the configuration's reference module `model`
    counts past it (its `model_flops`: listener, the attention's encoder
    projection, `steps` teacher-forced or greedy decoder steps), of one
    utterance."""
    return (frames * frontend_ops_per_frame(cfg)
            + model.model_flops(cfg, frames, steps))


def step_budget(cfg: dict, frames: int) -> int:
    """int32(float32(frames) * convert_rate), at least 1."""
    return max(int(np.float32(frames) * np.float32(cfg["convert_rate"])), 1)

