"""Data augmentation (counterpart of
automatic_speech_recognition_tpu/ops/augmentation.py).

Host half, NumPy/SciPy, copied as it is (tests/test_torch_shared_copies.py
holds it to the original): sox-`speed` semantics by bandlimited rational
resampling (a Kaiser-windowed sinc low-pass, polyphase through
scipy.signal.upfirdn), volume scaling, the offline speed augmentation
preprocess.py --augmentation runs, the corpus degrader, the speed-rate
bound the loader buckets by, and the pink-noise FIR design.

Device half, PyTorch ops on the batch inside the train step (the JAX
package runs it in XLA, with no Pallas kernel):
- `resample_rational_device`: the host resampler as one strided
  convolution over the zero-stuffed batch (cuDNN on a GPU);
- `online_speed_perturb` (one rate per batch), `online_volume_perturb`
  and `online_noise_perturb` (per utterance) on raw waveforms, before the
  frontend;
- `spec_augment`: time and frequency masks on the features, vectorized
  over the batch.
Randomness comes from explicit torch.Generators; the rate index of
`online_speed_perturb` from a CPU generator, so choosing the branch waits
for no device.
"""

from __future__ import annotations

import functools as _functools
from fractions import Fraction
from typing import List, Sequence, Tuple

from ..utils.numerics import cdiv

import numpy as np
import torch
import torch.nn.functional as F

# Kaiser design: beta 8.6 gives ~90 dB stopband with enough taps;
# 16 zero crossings per side at the wider rate keeps transition narrow.
_KAISER_BETA = 8.6
_NUM_ZEROS = 16


def _rational_speed(speed: float, max_den: int = 1000) -> Fraction:
    """speed = down/up as a reduced fraction (0.9 -> 9/10: upsample 10,
    decimate 9; output length ~ len/speed).

    max_den 1000 keeps the rate error below 5e-7 relative for arbitrary
    factors and makes common sample-rate ratios exact (e.g. 11025/16000
    = 441/640)."""
    if speed <= 0:
        raise ValueError(f"speed must be positive, got {speed}")
    return Fraction(speed).limit_denominator(max_den)


def design_resample_filter(up: int, down: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for polyphase up/down resampling.

    Designed at the upsampled rate: cutoff = min(1/up, 1/down) of that
    rate's Nyquist (anti-image for upsampling, anti-alias for
    decimation), gain `up` to preserve amplitude through zero-stuffing.
    Odd length 2H+1, centered (zero-phase after delay compensation).
    """
    c = min(1.0 / up, 1.0 / down)
    H = _NUM_ZEROS * max(up, down)
    n = np.arange(-H, H + 1)
    h = c * np.sinc(c * n) * np.kaiser(2 * H + 1, _KAISER_BETA)
    return (up * h).astype(np.float64)


def _resample_sinc(signal: np.ndarray, up: int, down: int,
                   n_out: int) -> np.ndarray:
    """Bandlimited rational resampling: polyphase FIR interpolation to the
    up-rate (scipy.signal.upfirdn's C kernel; no zero-stuffed array is
    materialized), then strided decimation with the filter's group delay
    compensated exactly."""
    from scipy.signal import upfirdn

    h = design_resample_filter(up, down)
    H = (len(h) - 1) // 2
    x = signal.astype(np.float64)
    # extend the input so every requested output position exists in the
    # interpolated stream (the trailing samples then decay through the
    # sinc tail instead of being zero-filled)
    last_pos = H + (n_out - 1) * down           # upsampled index needed
    have = (len(x) - 1) * up + len(h) - 1       # last index upfirdn yields
    if last_pos > have:
        x = np.pad(x, (0, cdiv(last_pos - have, up)))
    # full interpolated stream f[k] = (zero-stuffed x * h)[k]; value at
    # upsampled position p is f[p + H]
    f = upfirdn(h, x, up=up, down=1)
    return f[H + np.arange(n_out, dtype=np.int64) * down]


def speed_perturb(signal: np.ndarray, speed: float,
                  quality: str = "sinc") -> np.ndarray:
    """Resample so the utterance plays `speed` times faster (sox `speed`
    semantics: pitch and tempo scale together; a tone at f comes out at
    f*speed).  Output length = floor(len / speed).

    quality: 'sinc' (default) = Kaiser-windowed sinc polyphase, the
    sox-fidelity path; 'linear' = 2-tap linear interpolation (cheap,
    aliases high frequencies).
    """
    n_out = int(len(signal) / speed)
    if quality == "sinc":
        frac = _rational_speed(speed)
        down, up = frac.numerator, frac.denominator
        if up == down:
            return signal.astype(signal.dtype, copy=True)
        return _resample_sinc(signal, up, down, n_out).astype(signal.dtype)
    if quality != "linear":
        raise ValueError(f"unknown quality {quality!r}")
    pos = np.arange(n_out) * speed
    i0 = np.minimum(pos.astype(np.int64), len(signal) - 1)
    i1 = np.minimum(i0 + 1, len(signal) - 1)
    frac = pos - i0
    return ((1.0 - frac) * signal[i0] + frac * signal[i1]).astype(signal.dtype)


def volume_perturb(signal: np.ndarray, vol: float) -> np.ndarray:
    """Scale amplitude by `vol` with clipping to [-1, 1] (sox `vol` semantics
    for the reference's commented-out VolumeAugmentation)."""
    return np.clip(signal * vol, -1.0, 1.0).astype(signal.dtype)


SPEED_LIST = (0.9, 1.1)  # reference: preprocess.py:160


def speed_augment_all(signals: Sequence[np.ndarray],
                      speed: float) -> List[np.ndarray]:
    return [speed_perturb(s, speed) for s in signals]


def host_noise(rng: np.random.Generator, n: int, kind: str) -> np.ndarray:
    """Unit-power noise vector: 'white' (flat) or 'pink' (1/f shaped)."""
    if kind not in ("white", "pink"):
        raise ValueError(f"noise kind must be 'white' or 'pink', got {kind!r}")
    x = rng.standard_normal(n).astype(np.float64)
    if kind == "pink":
        spec = np.fft.rfft(x)
        k = np.arange(spec.shape[0], dtype=np.float64)
        spec /= np.sqrt(np.maximum(k, 1.0))
        spec[0] = 0.0
        x = np.fft.irfft(spec, n=n)
    return x / max(np.sqrt(np.mean(x * x)), 1e-12)


def make_degrader(noise_snr: str, noise_kind: str, reverb_p: float,
                  sample_rate: int = 16000):
    """Host-side acoustic degradation for corpus tooling: optional random
    reverberation (exponential-decay noise impulse response, RT60 drawn
    from [0.15, 0.5] s) then additive white/pink noise at a per-utterance
    SNR drawn uniformly from the 'lo,hi' dB range (empty = no noise).
    Returns `degrade(sig, rng) -> sig` or None when fully disabled.

    Used by tools/synth_corpus.py (degrade while synthesizing) and
    tools/degrade_corpus.py (degrade an existing LibriSpeech-layout
    corpus); the on-device training-time counterpart is
    online_noise_perturb.  No reference counterpart (the reference's
    augmentations are speed/volume only, utils/augmentation.py).
    """
    if not noise_snr and reverb_p <= 0:
        return None
    snr_range = None
    if noise_snr:
        parts = [float(v) for v in str(noise_snr).split(",")]
        if len(parts) not in (1, 2):
            raise ValueError(
                f"noise SNR must be 'db' or 'lo,hi', got {noise_snr!r}")
        snr_range = (parts[0], parts[-1])
        if snr_range[0] > snr_range[1]:
            raise ValueError(f"noise SNR low > high: {noise_snr}")
        host_noise(np.random.default_rng(0), 8, noise_kind)  # validate kind

    def degrade(sig: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if reverb_p > 0 and rng.random() < reverb_p:
            rt60 = rng.uniform(0.15, 0.5)
            L = int(0.6 * rt60 * sample_rate)
            t = np.arange(L) / sample_rate
            ir = rng.standard_normal(L) * np.exp(-3.0 * np.log(10) * t / rt60)
            ir[0] = 1.0
            ir /= np.sqrt(np.sum(ir * ir))
            n = len(sig) + L - 1
            sig = np.fft.irfft(np.fft.rfft(sig, n) * np.fft.rfft(ir, n),
                               n)[:len(sig)]
        if snr_range is not None:
            p_sig = float(np.mean(sig * sig))
            if p_sig > 0:
                snr_db = rng.uniform(*snr_range)
                noise = host_noise(rng, len(sig), noise_kind)
                sig = sig + np.sqrt(p_sig / 10.0 ** (snr_db / 10.0)) * noise
        peak = float(np.abs(sig).max())
        if peak > 0.99:
            sig = sig * (0.99 / peak)
        return sig

    return degrade


def _parse_rates(spec: str):
    rates = tuple(float(r) for r in str(spec).split(",") if r.strip())
    if not rates:
        raise ValueError(f"no rates in online_speed_rates={spec!r}")
    if any(r <= 0 for r in rates):
        raise ValueError(f"speeds must be positive: {rates}")
    return rates


@_functools.lru_cache(maxsize=32)
def _rate_fractions(spec: str):
    """Parsed (up, down) pairs for a rate spec — cached: the loader calls
    worst_stretch_len per record per pass, and Fraction construction per
    call would put seconds of pure Python on the producer thread at
    LibriSpeech scale."""
    out = []
    for r in _parse_rates(spec):
        frac = _rational_speed(r)
        out.append((frac.denominator, frac.numerator))  # (up, down)
    return tuple(out)


def worst_stretch_len(n: int, rates_spec: str) -> int:
    """Largest output sample count any configured rate can produce from an
    n-sample signal — the loader buckets training records by THIS length
    so the slowest rate's output still fits the bucket's padded buffer."""
    out = n
    for up, down in _rate_fractions(rates_spec):
        out = max(out, (n * up) // down)
    return out


@_functools.lru_cache(maxsize=1)
def _pink_fir(num_taps: int = 513, design_len: int = 4096) -> np.ndarray:
    """Zero-phase FIR approximating a 1/sqrt(f) amplitude (1/f power)
    response, frequency-sampled on a design_len grid, Hamming-windowed to
    num_taps, unit-power-normalized.  DC is zeroed."""
    assert num_taps % 2 == 1
    f = np.fft.rfftfreq(design_len)
    amp = np.zeros_like(f)
    amp[1:] = 1.0 / np.sqrt(np.maximum(f[1:], f[1]))
    ir = np.fft.irfft(amp)                       # zero-phase, wraps around
    ir = np.roll(ir, design_len // 2)            # center the peak
    mid = design_len // 2
    h = ir[mid - num_taps // 2: mid + num_taps // 2 + 1] * np.hamming(num_taps)
    return (h / np.sqrt(np.sum(h * h))).astype(np.float32)


# ===========================================================================
# Device half: waveform perturbation inside the train step
# ===========================================================================


def _length_mask(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) bool: position < length."""
    return (torch.arange(n, device=lengths.device)[None, :]
            < lengths[:, None])


def resample_rational_device(sig: torch.Tensor, siglen: torch.Tensor,
                             up: int, down: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bandlimited rational resampling of a padded batch on its device.

    sig: (B, S) float32 padded waveforms; siglen: (B,) valid counts.
    Returns (out (B, S), new_len int32) with out[n] = f[H + n*down] as the
    host _resample_sinc computes it (the padded buffer's trailing zeros
    play the host's tail padding), truncated or zero-padded to S samples,
    and samples at or beyond new_len = floor(siglen*up/down) zeroed.

    JAX's conv_general_dilated(lhs_dilation=up, window_strides=down,
    padding=(H, H + down)) written out: the batch zero-stuffed by `up`
    into one buffer that already holds the padding, then F.conv1d (a
    cross-correlation, as conv_general_dilated is) with the reversed
    filter at stride `down`.  The stuffed buffer is `up` times the batch.
    """
    if up == down:
        return sig, siglen.to(torch.int32)
    h = design_resample_filter(up, down)
    H = (len(h) - 1) // 2
    B, S = sig.shape
    w = torch.as_tensor(h[::-1].copy(), dtype=torch.float32,
                        device=sig.device).reshape(1, 1, -1)
    dilated = (S - 1) * up + 1
    xp = sig.new_zeros((B, 1, H + dilated + H + down), dtype=torch.float32)
    xp[:, 0, H:H + dilated:up] = sig
    out = F.conv1d(xp, w, stride=down)[:, 0]
    out = out[:, :S] if out.shape[1] >= S else F.pad(out,
                                                     (0, S - out.shape[1]))
    new_len = torch.clamp(siglen.to(torch.int64) * up // down,
                          max=S).to(torch.int32)
    return out * _length_mask(new_len, S), new_len


def rate_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator online_speed_perturb draws a step's rate index
    from: a function of (seed, step), so a resumed run draws the same
    rates, and the choice waits for no device."""
    return torch.Generator().manual_seed(seed * 1_000_003 + step)


def online_speed_perturb(index_generator: torch.Generator,
                         sig: torch.Tensor, siglen: torch.Tensor, cfg
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One configured rate per BATCH, drawn from the CPU generator
    `index_generator`, and the batch resampled on its device.  The padded
    width is kept: the loader buckets by worst_stretch_len so slow rates
    fit."""
    rates = _rate_fractions(cfg.online_speed_rates)
    idx = int(torch.randint(len(rates), (), generator=index_generator))
    up, down = rates[idx]
    return resample_rational_device(sig, siglen, up, down)


def online_volume_perturb(generator: torch.Generator, sig: torch.Tensor,
                          cfg) -> torch.Tensor:
    """Per-UTTERANCE random gain in [online_volume_low,
    online_volume_high] with clipping to [-1, 1]."""
    lo, hi = cfg.online_volume_low, cfg.online_volume_high
    if not 0 < lo <= hi:
        raise ValueError(f"need 0 < low <= high, got [{lo}, {hi}]")
    gains = lo + (hi - lo) * torch.rand((sig.shape[0], 1),
                                        generator=generator,
                                        device=sig.device)
    return torch.clamp(sig * gains, -1.0, 1.0)


def online_noise_perturb(generator: torch.Generator, sig: torch.Tensor,
                         siglen: torch.Tensor, cfg) -> torch.Tensor:
    """Per-UTTERANCE additive noise at an SNR drawn from
    U[online_noise_snr_low, online_noise_snr_high] dB: white, or pink by
    the 513-tap FIR (_pink_fir) as a convolution.  The SNR holds over the
    VALID samples (noise power measured after shaping); silent rows get no
    noise; each row is noised with probability online_noise_p; the sum is
    clipped to [-1, 1] and samples at or beyond siglen stay exactly
    zero."""
    lo, hi = cfg.online_noise_snr_low, cfg.online_noise_snr_high
    if not lo <= hi:
        raise ValueError(f"need snr_low <= snr_high, got [{lo}, {hi}]")
    if cfg.online_noise_kind not in ("white", "pink"):
        raise ValueError(f"online_noise_kind must be 'white' or 'pink', "
                         f"got {cfg.online_noise_kind!r}")
    p = cfg.online_noise_p
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"need 0 <= online_noise_p <= 1, got {p}")
    B, S = sig.shape
    dev = sig.device
    noise = torch.randn((B, S), generator=generator, device=dev)
    if cfg.online_noise_kind == "pink":
        h = torch.from_numpy(_pink_fir()).to(dev)
        K = h.shape[0]
        noise = F.conv1d(noise[:, None], h.reshape(1, 1, -1),
                         padding=K // 2)[:, 0]
    mask = _length_mask(siglen, S).to(torch.float32)
    n_valid = mask.sum(-1).clamp(min=1.0)
    p_sig = (sig * sig * mask).sum(-1) / n_valid
    p_noise = (noise * noise * mask).sum(-1) / n_valid
    snr_db = lo + (hi - lo) * torch.rand((B,), generator=generator,
                                         device=dev)
    p_target = p_sig / 10.0 ** (snr_db / 10.0)
    gain = torch.sqrt(p_target / p_noise.clamp(min=1e-20))
    gain = torch.where(p_sig > 0.0, gain, 0.0)
    if p < 1.0:
        coin = torch.rand((B,), generator=generator, device=dev) < p
        gain = torch.where(coin, gain, 0.0)
    return torch.clamp(sig + gain[:, None] * noise, -1.0, 1.0) * mask


# ===========================================================================
# SpecAugment: masks on the features, in the training loss
# ===========================================================================


def _axis_mask(generator: torch.Generator, n_masks: int, axis_len: int,
               max_width: torch.Tensor, limit: torch.Tensor) -> torch.Tensor:
    """(B, axis_len) bool: per row, the union of `n_masks` spans of width
    U{0..max_width} (clipped to limit), starting at U[0, limit - width), so
    spans stay inside [0, limit).  max_width and limit are (B,) int64."""
    B = limit.shape[0]
    dev = limit.device
    u_w = torch.rand((B, n_masks), generator=generator, device=dev)
    u_s = torch.rand((B, n_masks), generator=generator, device=dev)
    widths = torch.minimum((u_w * (max_width[:, None] + 1)).long(),
                           max_width[:, None])
    widths = torch.minimum(widths, limit[:, None])
    span = torch.clamp(limit[:, None] - widths, min=1)
    starts = (u_s * span).long()
    pos = torch.arange(axis_len, device=dev)[None, None, :]
    hit = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return hit.any(1)


def spec_augment(generator: torch.Generator, audio: torch.Tensor,
                 audiolen: torch.Tensor, cfg) -> torch.Tensor:
    """Time and frequency masking on a feature batch (B, T, D, C) with
    valid frame counts audiolen: per utterance `sa_freq_masks` spans of
    width U{0..sa_freq_width} zero whole feature rows (every channel) and
    `sa_time_masks` spans of width U{0..min(sa_time_width,
    sa_time_ratio * audiolen)} zero whole frames, all rows at once."""
    B, T, D, _ = audio.shape
    length = audiolen.to(torch.int64)
    t_cap = torch.clamp((cfg.sa_time_ratio * length.to(torch.float32))
                        .to(torch.int64), max=cfg.sa_time_width)
    tmask = _axis_mask(generator, cfg.sa_time_masks, T, t_cap, length)
    fmask = _axis_mask(generator, cfg.sa_freq_masks, D,
                       torch.full_like(length, cfg.sa_freq_width),
                       torch.full_like(length, D))
    keep = ~(tmask[:, :, None] | fmask[:, None, :])            # (B, T, D)
    return audio * keep[..., None].to(audio.dtype)
