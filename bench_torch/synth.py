"""One seeded stretch of synthetic speech, from which every request and
every training utterance is cut, so set-up synthesizes once.

Segments of 40-220 ms: voiced ones are a harmonic series on a gliding
pitch, shaped by three formant resonances; unvoiced ones are white noise
through a first-order high-pass; short pauses sit between words.  Each
segment rises and falls over 5 ms."""

from __future__ import annotations

import numpy as np

SR = 16000
# (F1, F2, F3) in Hz of a few vowels
FORMANTS = np.array([[730, 1090, 2440], [270, 2290, 3010], [300, 870, 2240],
                     [530, 1840, 2480], [660, 1720, 2410], [570, 840, 2410],
                     [440, 1020, 2240], [490, 1350, 1690]], np.float64)


def stretch(seed: int, seconds: float, sr: int = SR) -> np.ndarray:
    """float32 waveform of `seconds` at `sr`, peak about 0.5."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    out = np.zeros(n, np.float64)
    pos = 0
    ramp = int(0.005 * sr)
    while pos < n:
        kind = rng.choice(3, p=[0.7, 0.2, 0.1])
        length = min(int(rng.uniform(0.04, 0.22) * sr), n - pos)
        t = np.arange(length) / sr
        if kind == 0:
            f0 = rng.uniform(90, 240) * (1 + rng.uniform(-0.15, 0.15) * t
                                         / max(t[-1], 1e-3))
            phase = 2 * np.pi * np.cumsum(f0) / sr
            k = np.arange(1, 31)[:, None]
            freq = k * f0[None, :]
            fm = FORMANTS[rng.integers(len(FORMANTS))]
            gain = sum(1.0 / (1.0 + ((freq - f) / (0.08 * f + 60)) ** 2)
                       for f in fm) / k
            gain = np.where(freq < sr / 2, gain, 0.0)
            seg = (gain * np.sin(k * phase[None, :])).sum(0)
        elif kind == 1:
            noise = rng.standard_normal(length)
            seg = 0.3 * np.concatenate([noise[:1], np.diff(noise)])
        else:
            seg = 0.003 * rng.standard_normal(length)
        env = np.ones(length)
        r = min(ramp, length // 2)
        if r:
            env[:r] = np.linspace(0, 1, r)
            env[-r:] = np.linspace(1, 0, r)
        out[pos:pos + length] = seg * env
        pos += length
    out *= 0.5 / max(np.abs(out).max(), 1e-9)
    return out.astype(np.float32)


def cut(source: np.ndarray, samples: int, offset: int) -> np.ndarray:
    """`samples` samples of the stretch from `offset`, wrapping round."""
    idx = (offset + np.arange(samples)) % len(source)
    return source[idx]
