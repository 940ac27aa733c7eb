"""The port's own copy of automatic_speech_recognition_tpu/ops/frontend_host.py
(tests/test_torch_shared_copies.py holds it to the original).

Host (NumPy) acoustic frontend — the speechpy-semantics reference.

The reference repo computes features offline on CPU with speechpy
(preprocess.py:50-91): mfcc/mfe framing at 25ms/10ms, 512-point FFT,
mel filterbank, DCT, per-utterance CMVN with variance normalization, and
delta/delta-delta stacking into (T, D, 3).

speechpy is not installable in this environment, so this module
reimplements its exact algorithm from its published source semantics,
including its two well-known quirks which the reference model was trained
on and therefore must be preserved:

1. The mel filterbank bin indices are computed as
   floor((coefficients + 1) * hertz / fs) with coefficients = fft//2 + 1
   (i.e. 258 points for a 512 FFT), so the filters occupy only the lower
   half of the spectrum.
2. `extract_derivative_feature` computes the "derivative" along the
   FEATURE axis (edge-padded), not the time axis, and scales only the
   leading term: dif = Range * x[j+Range] - x[j-Range], summed over
   Range in {1, 2}, divided by 10.

This module doubles as (a) the numerical golden for the on-TPU frontend
tests and (b) the CPU baseline that bench.py measures the TPU speedup
against (BASELINE.md north-star: >=50x utt/sec).
"""

from __future__ import annotations

import numpy as np
from scipy.fft import dct as _scipy_dct

EPS_CMVN = 2.0 ** -30
EPS_ZERO = np.finfo(np.float64).eps


def frame_params(sample_rate: int, frame_length_ms: float, frame_step_ms: float):
    """Frame sample length / stride as speechpy computes them (round)."""
    flen = int(np.round(sample_rate * frame_length_ms / 1000.0))
    fstride = int(np.round(sample_rate * frame_step_ms / 1000.0))
    return flen, fstride


def num_frames(num_samples: int, flen: int, fstride: int) -> int:
    """speechpy stack_frames(zero_padding=False): floor((L - flen)/stride)."""
    if num_samples < flen:
        return 0
    return int(np.floor((num_samples - flen) / float(fstride)))


def stack_frames(signal: np.ndarray, flen: int, fstride: int) -> np.ndarray:
    """Rectangular-window framing, last partial frame dropped."""
    T = num_frames(len(signal), flen, fstride)
    if T <= 0:
        return np.zeros((0, flen), dtype=signal.dtype)
    idx = np.arange(flen)[None, :] + (np.arange(T) * fstride)[:, None]
    return signal[idx]


def power_spectrum(frames: np.ndarray, fft_length: int = 512) -> np.ndarray:
    """(1/N) * |rfft|^2."""
    spec = np.abs(np.fft.rfft(frames, n=fft_length, axis=-1))
    return (1.0 / fft_length) * np.square(spec)


def frequency_to_mel(f):
    return 1127.0 * np.log(1 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_frequency(mel):
    return 700.0 * (np.exp(np.asarray(mel, dtype=np.float64) / 1127.0) - 1)


def _triangle(x, left, middle, right):
    out = np.zeros(x.shape)
    first = np.logical_and(left < x, x <= middle)
    out[first] = (x[first] - left) / (middle - left)
    second = np.logical_and(middle <= x, x < right)
    out[second] = (right - x[second]) / (right - middle)
    out[x <= left] = 0
    out[x >= right] = 0
    return out


def mel_filterbank(num_filters: int, coefficients: int, sample_rate: int,
                   low_freq: float = 0.0, high_freq: float | None = None) -> np.ndarray:
    """speechpy filterbanks(): NOTE two quirks.

    1. The bin indices use (coefficients + 1) — see module docstring.
    2. Upstream defaults low_freq via `low_freq = low_freq or 300`, so the
       0.0 that mfe passes down is COERCED TO 300 Hz: the reference's
       filterbanks actually start at 300 Hz (caught by the speechpy
       transcription conformance tests, tests/test_frontend_golden.py;
       round-1 code wrongly started them at 0 Hz).
    """
    high_freq = high_freq or sample_rate / 2
    low_freq = low_freq or 300
    mels = np.linspace(frequency_to_mel(low_freq), frequency_to_mel(high_freq),
                       num_filters + 2)
    hertz = mel_to_frequency(mels)
    freq_index = np.floor((coefficients + 1) * hertz / sample_rate).astype(int)
    fb = np.zeros((num_filters, coefficients))
    for i in range(num_filters):
        left, middle, right = int(freq_index[i]), int(freq_index[i + 1]), int(freq_index[i + 2])
        z = np.linspace(left, right, num=right - left + 1)
        fb[i, left:right + 1] = _triangle(z, left=left, middle=middle, right=right)
    return fb


def dct_matrix(num_inputs: int, num_outputs: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (num_inputs -> num_outputs), equivalent to
    scipy dct(type=2, norm='ortho')[:, :num_outputs]."""
    n = np.arange(num_inputs)
    k = np.arange(num_outputs)[:, None]
    # scipy ortho: X_0 scaled by sqrt(1/N), X_k by sqrt(2/N)
    m = np.cos(np.pi * k * (2 * n + 1) / (2.0 * num_inputs))
    scale = np.full((num_outputs, 1), np.sqrt(2.0 / num_inputs))
    scale[0, 0] = np.sqrt(1.0 / num_inputs)
    return (m * scale).T  # (num_inputs, num_outputs)


def zero_handling(x: np.ndarray) -> np.ndarray:
    return np.where(x == 0, EPS_ZERO, x)


def mfe(signal: np.ndarray, sample_rate: int, frame_length_ms: float = 20.0,
        frame_step_ms: float = 10.0, num_filters: int = 40,
        fft_length: int = 512):
    """Mel filterbank energies + frame energies (speechpy.feature.mfe)."""
    flen, fstride = frame_params(sample_rate, frame_length_ms, frame_step_ms)
    frames = stack_frames(np.asarray(signal, dtype=np.float64), flen, fstride)
    ps = power_spectrum(frames, fft_length)
    coefficients = ps.shape[1]
    energies = zero_handling(np.sum(ps, axis=1))
    fb = mel_filterbank(num_filters, coefficients, sample_rate, 0, sample_rate / 2)
    feats = zero_handling(ps @ fb.T)
    return feats, energies


def mfcc(signal: np.ndarray, sample_rate: int, frame_length_ms: float = 20.0,
         frame_step_ms: float = 10.0, num_cepstral: int = 13,
         num_filters: int = 40, fft_length: int = 512) -> np.ndarray:
    """MFCC (speechpy.feature.mfcc): log mel -> DCT-II ortho -> first
    num_cepstral; c0 replaced by log frame energy (dc_elimination)."""
    feature, energy = mfe(signal, sample_rate, frame_length_ms, frame_step_ms,
                          num_filters, fft_length)
    if len(feature) == 0:
        return np.empty((0, num_cepstral))
    feature = np.log(feature)
    feature = _scipy_dct(feature, type=2, axis=-1, norm="ortho")[:, :num_cepstral]
    feature[:, 0] = np.log(energy)
    return feature


def cmvn(vec: np.ndarray, variance_normalization: bool = False) -> np.ndarray:
    """Per-utterance cepstral mean (and variance) normalization
    (speechpy.processing.cmvn; invoked at preprocess.py:85 with True)."""
    mean = np.mean(vec, axis=0)
    mean_subtracted = vec - mean
    if variance_normalization:
        stdev = np.std(mean_subtracted, axis=0)
        return mean_subtracted / (stdev + EPS_CMVN)
    return mean_subtracted


def derivative_extraction(feat: np.ndarray, delta_windows: int = 2) -> np.ndarray:
    """speechpy.processing.derivative_extraction — the FEATURE-axis quirk.

    Edge-pads the feature axis and accumulates
    dif = Range * x[:, j+Range] - x[:, j-Range] for Range in 1..delta_windows,
    divided by Scale = 2 * sum(Range^2).
    """
    rows, cols = feat.shape
    DIF = np.zeros(feat.shape, dtype=feat.dtype)
    scale = 0
    FEAT = np.pad(feat, ((0, 0), (delta_windows, delta_windows)), "edge")
    for i in range(delta_windows):
        offset = delta_windows
        rng = i + 1
        dif = rng * FEAT[:, offset + rng:offset + rng + cols] \
            - FEAT[:, offset - rng:offset - rng + cols]
        scale += 2 * rng ** 2
        DIF += dif
    return DIF / scale


def extract_derivative_feature(feature: np.ndarray) -> np.ndarray:
    """Stack (static, d, dd) into (T, D, 3) (speechpy.feature)."""
    first = derivative_extraction(feature, 2)
    second = derivative_extraction(first, 2)
    return np.concatenate(
        (feature[:, :, None], first[:, :, None], second[:, :, None]), axis=2)


def process_audio(signal: np.ndarray, sample_rate: int = 16000,
                  frame_length_ms: float = 25.0, frame_step_ms: float = 10.0,
                  feat_dim: int = 13, feat_type: str = "mfcc",
                  apply_cmvn: bool = True) -> np.ndarray:
    """Full per-utterance pipeline exactly as preprocess.py:67-89 wires it.

    NOTE the reference quirk: deltas are stacked ONLY when cmvn is on
    (preprocess.py:84-87); with cmvn off the output is (T, D) 2-D.
    """
    if feat_type == "mfcc":
        feat = mfcc(signal, sample_rate, frame_length_ms, frame_step_ms,
                    num_cepstral=feat_dim)
    elif feat_type == "fbank":
        feat, _ = mfe(signal, sample_rate, frame_length_ms, frame_step_ms,
                      num_filters=feat_dim)
    else:
        raise ValueError(f"unknown feat_type: {feat_type}")
    if apply_cmvn:
        feat = cmvn(feat, True)
        feat = extract_derivative_feature(feat)
    return feat.astype(np.float32)
