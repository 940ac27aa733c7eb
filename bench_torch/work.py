"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes the model's function needs, counted from shapes.

Counts are of the function, not of any kernel's algorithm: a matrix
product of (m, k) by (k, n) is 2 m k n; a 512-point real DFT is
2.5 N log2 N (a real FFT's count); an element-wise operation is one.
Utilization numbers built on them count useful work only: real frames,
each utterance's own step budget, real tokens; no recomputation."""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from bench_torch.reference import las as ref

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def peak(cfg: dict) -> float:
    """The dense peak of the configuration's precision: float32 with TF32
    off runs outside the tensor cores."""
    return PEAK_FLOPS[cfg["dtype"]]


@lru_cache(maxsize=8)
def _mel_nonzeros(filters: int, fft_length: int, sample_rate: int) -> int:
    fb = ref._mel_filterbank(filters, fft_length // 2 + 1, sample_rate)
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


def _birnn(T: int, d_in: int, u: int) -> float:
    return 2 * T * (2 * d_in * u + 2 * u * u)


def listener_flops(cfg: dict, frames: int) -> float:
    """Forward operations of the listener over `frames` real frames."""
    u, D = cfg["enc_units"], cfg["feat_dim"]
    if cfg["enc_type"] == "cnn":
        C = cfg["num_enc_channels"]
        t1, d1 = ref._ceil_half(frames), ref._ceil_half(D)
        t2, d2 = ref._ceil_half(t1), ref._ceil_half(d1)
        ops = 2 * t1 * d1 * C * 27 + 2 * t2 * d2 * C * C * 9
        d = d2 * C
        for _ in range(cfg["num_enc_layers"]):
            ops += _birnn(t2, d, u) + 2 * t2 * 2 * u * u
            d = u
        return ops
    T = frames
    ops = _birnn(T, 3 * D, u) + 2 * T * 2 * u * 2 * u
    for _ in range(cfg["num_enc_layers"]):
        ops += _birnn(T, 2 * u, u)
        T = ref._ceil_half(T)
        ops += 2 * T * 4 * u * 2 * u
    return ops


def enc_frames(cfg: dict, frames: int) -> int:
    t = frames
    for _ in range(2 if cfg["enc_type"] == "cnn" else cfg["num_enc_layers"]):
        t = ref._ceil_half(t)
    return t


def speller_step_flops(cfg: dict, t_enc: int) -> float:
    """One decoder step for one row attending over t_enc frames."""
    h = ref.enc_dim(cfg)
    A, U, L, E, V = (cfg["attention_size"], cfg["dec_units"],
                     cfg["num_dec_layers"], cfg["embedding_size"],
                     cfg["vocab_size"])
    ops = 2 * L * U * A + 3 * t_enc * A + 3 * t_enc + 2 * t_enc * h
    if cfg["mode"] == "loc":
        C, K = cfg["loc_num_channels"], cfg["loc_kernel_size"]
        ops += 2 * t_enc * C * K + 2 * t_enc * C * A
    d = E + h
    for _ in range(L):
        ops += 2 * (d + U) * U
        d = U
    return ops + 2 * U * V


def forward_flops(cfg: dict, frames: int, steps: int) -> float:
    """Frontend, listener, the attention's encoder projection and
    `steps` teacher-forced or greedy decoder steps of one utterance."""
    t = enc_frames(cfg, frames)
    return (frames * frontend_ops_per_frame(cfg) + listener_flops(cfg, frames)
            + 2 * t * ref.enc_dim(cfg) * cfg["attention_size"]
            + steps * speller_step_flops(cfg, t))


def step_budget(cfg: dict, frames: int) -> int:
    """int32(float32(frames) * convert_rate), at least 1."""
    return max(int(np.float32(frames) * np.float32(cfg["convert_rate"])), 1)

