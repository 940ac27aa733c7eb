"""The port's own copy of automatic_speech_recognition_tpu/utils/formant_synth.py
(tests/test_torch_shared_copies.py holds it to the original), without
the original's opt-in JAX path for the voiced part (`enable_accel`,
`_voiced_accel`): the NumPy path, the original's default, is the only one.

Parallel-formant speech synthesizer (Klatt-style, NumPy, 16 kHz).

Why this exists: the reference's defining result is WER on recorded
LibriSpeech speech (README.md:104-108), but this build environment has no
network egress (openslr.org unresolvable), no TTS binaries, and no speech
corpora on disk.  The closest obtainable real-audio corpus is therefore
synthesized speech with genuine phonetic structure: voiced source with a
pitch contour, formant resonances with coarticulated transitions,
fricative noise, stop closures/bursts, nasal murmurs, per-speaker vocal
tract scaling.  A char LAS trained on it must learn the same class of
grapheme-to-acoustics mapping as on recorded speech (many-to-one phones,
coarticulation, speaker variability), making the end-to-end WER pipeline
(preprocess -> shards -> train -> test/decode) exercisable for real.

Architecture (all vectorized NumPy; ~5 ms parameter frames):
- per-phone targets: formants F1-F3 + bandwidths, voicing and noise
  gains, noise color (band center/width), burst/closure structure;
- track builder: phone targets -> frame tracks, Gaussian-smoothed for
  coarticulation; f0 declination + final fall + jitter;
- voiced part: harmonic synthesis, amplitudes sampled from the parallel
  formant envelope at each harmonic of the (time-varying) f0;
- noise part: per-color FFT-filtered white noise, amplitude-modulated by
  the per-sample noise gain track;
- speakers: f0 base, formant scale (vocal-tract length), speaking rate.

No counterpart in the reference repo (it downloads recorded speech,
prepare_libri_data.sh); this module feeds tools/synth_corpus.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FS = 16000
HOP_MS = 5.0
HOP = int(FS * HOP_MS / 1000)  # 80 samples


# ---------------------------------------------------------------------------
# Phone inventory
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Phone:
    kind: str                      # vowel|glide|nasal|fric|stop|affric|sil
    dur_ms: float
    formants: Tuple[float, float, float] = (500.0, 1500.0, 2500.0)
    formants2: Optional[Tuple[float, float, float]] = None  # diphthong end
    bandwidths: Tuple[float, float, float] = (90.0, 110.0, 170.0)
    voiced: bool = True
    voiced_gain: float = 1.0
    noise_gain: float = 0.0
    noise_color: Optional[Tuple[float, float]] = None  # (center, halfwidth)
    # stops/affricates: closure then release burst (+ aspiration if unvoiced)
    closure_ms: float = 0.0
    burst_ms: float = 0.0
    burst_gain: float = 0.0


def _v(d, f1, f2, f3, f1b=None, f2b=None, f3b=None):
    return Phone("vowel", d, (f1, f2, f3),
                 (f1b, f2b, f3b) if f1b is not None else None)


# Formant targets: classic male averages (Peterson & Barney / Klatt 80).
PHONES: Dict[str, Phone] = {
    # monophthongs
    "IY": _v(130, 270, 2290, 3010),
    "IH": _v(110, 390, 1990, 2550),
    "EH": _v(120, 530, 1840, 2480),
    "AE": _v(150, 660, 1720, 2410),
    "AA": _v(150, 730, 1090, 2440),
    "AO": _v(150, 570, 840, 2410),
    "UH": _v(100, 440, 1020, 2240),
    "UW": _v(130, 300, 870, 2240),
    "AH": _v(110, 640, 1190, 2390),
    "ER": _v(140, 490, 1350, 1690),
    # diphthongs
    "EY": _v(160, 480, 2020, 2600, 330, 2200, 2900),
    "AY": _v(180, 730, 1090, 2440, 330, 2200, 2900),
    "OY": _v(180, 570, 840, 2410, 390, 1990, 2550),
    "AW": _v(180, 730, 1090, 2440, 430, 1020, 2240),
    "OW": _v(160, 570, 840, 2410, 330, 870, 2240),
    # glides / liquids
    "W": Phone("glide", 70, (300, 610, 2200)),
    "Y": Phone("glide", 70, (270, 2290, 3010)),
    "L": Phone("glide", 70, (360, 1300, 2700)),
    "R": Phone("glide", 80, (420, 1300, 1600)),
    # nasals: low murmur, damped
    "M": Phone("nasal", 75, (250, 1000, 2200), bandwidths=(120, 250, 300),
               voiced_gain=0.45),
    "N": Phone("nasal", 75, (250, 1600, 2600), bandwidths=(120, 250, 300),
               voiced_gain=0.45),
    "NG": Phone("nasal", 85, (250, 2000, 2800), bandwidths=(120, 250, 300),
                voiced_gain=0.45),
    # fricatives (noise colors: center, halfwidth)
    "S": Phone("fric", 110, (400, 1700, 2600), voiced=False, voiced_gain=0.0,
               noise_gain=0.8, noise_color=(6200, 2200)),
    "Z": Phone("fric", 100, (300, 1700, 2600), voiced_gain=0.35,
               noise_gain=0.55, noise_color=(6200, 2200)),
    "SH": Phone("fric", 110, (400, 1800, 2500), voiced=False, voiced_gain=0.0,
                noise_gain=0.85, noise_color=(3300, 1500)),
    "ZH": Phone("fric", 100, (300, 1800, 2500), voiced_gain=0.35,
                noise_gain=0.55, noise_color=(3300, 1500)),
    "F": Phone("fric", 100, (400, 1100, 2400), voiced=False, voiced_gain=0.0,
               noise_gain=0.35, noise_color=(4500, 3400)),
    "V": Phone("fric", 80, (300, 1100, 2400), voiced_gain=0.4,
               noise_gain=0.22, noise_color=(4500, 3400)),
    "TH": Phone("fric", 95, (400, 1400, 2500), voiced=False, voiced_gain=0.0,
                noise_gain=0.28, noise_color=(5500, 3000)),
    "DH": Phone("fric", 70, (300, 1400, 2500), voiced_gain=0.45,
                noise_gain=0.18, noise_color=(5500, 3000)),
    "HH": Phone("fric", 70, (500, 1500, 2500), voiced=False, voiced_gain=0.0,
                noise_gain=0.25, noise_color=(1500, 1800)),
    # stops: closure + burst (+ aspiration when unvoiced)
    "P": Phone("stop", 95, (400, 800, 2200), voiced=False,
               closure_ms=55, burst_ms=12, burst_gain=0.55,
               noise_color=(1100, 900)),
    "B": Phone("stop", 80, (350, 800, 2200), closure_ms=45, burst_ms=10,
               burst_gain=0.4, noise_color=(1100, 900), voiced_gain=0.25),
    "T": Phone("stop", 95, (400, 1800, 2600), voiced=False,
               closure_ms=55, burst_ms=14, burst_gain=0.65,
               noise_color=(4200, 1800)),
    "D": Phone("stop", 80, (350, 1800, 2600), closure_ms=45, burst_ms=10,
               burst_gain=0.45, noise_color=(4200, 1800), voiced_gain=0.25),
    "K": Phone("stop", 100, (400, 2200, 2600), voiced=False,
               closure_ms=60, burst_ms=16, burst_gain=0.6,
               noise_color=(2400, 1200)),
    "G": Phone("stop", 85, (350, 2200, 2600), closure_ms=50, burst_ms=12,
               burst_gain=0.45, noise_color=(2400, 1200), voiced_gain=0.25),
    "CH": Phone("affric", 130, (400, 1800, 2500), voiced=False,
                closure_ms=55, burst_ms=60, burst_gain=0.7,
                noise_color=(3300, 1500)),
    "JH": Phone("affric", 110, (350, 1800, 2500), closure_ms=45, burst_ms=50,
                burst_gain=0.5, noise_color=(3300, 1500), voiced_gain=0.3),
    # silence / pause
    "SIL": Phone("sil", 120, voiced=False, voiced_gain=0.0),
    "SP": Phone("sil", 45, voiced=False, voiced_gain=0.0),
}


@dataclass
class Speaker:
    """Per-speaker voice parameters."""
    f0_base: float = 120.0       # Hz
    formant_scale: float = 1.0   # vocal tract length factor
    rate: float = 1.0            # speaking rate multiplier
    breathiness: float = 0.01

    @staticmethod
    def sample(rng: np.random.Generator) -> "Speaker":
        female = rng.random() < 0.5
        f0 = rng.uniform(165, 235) if female else rng.uniform(85, 140)
        scale = rng.uniform(1.08, 1.18) if female else rng.uniform(0.92, 1.04)
        return Speaker(f0_base=f0, formant_scale=scale,
                       rate=rng.uniform(0.88, 1.15),
                       breathiness=rng.uniform(0.005, 0.02))


# ---------------------------------------------------------------------------
# Track building
# ---------------------------------------------------------------------------

def _gauss_smooth(x: np.ndarray, sigma_frames: float) -> np.ndarray:
    """Gaussian smoothing along axis 0 (edge-padded)."""
    if sigma_frames <= 0:
        return x
    r = int(np.ceil(3 * sigma_frames))
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma_frames) ** 2)
    k /= k.sum()
    pad = np.pad(x, [(r, r)] + [(0, 0)] * (x.ndim - 1), mode="edge")
    return np.apply_along_axis(lambda v: np.convolve(v, k, "valid"), 0, pad)


def build_tracks(phones: Sequence[str], spk: Speaker,
                 rng: np.random.Generator):
    """Per-frame parameter tracks for a phone sequence.

    Returns dict of (T,) or (T,3) arrays: formants, bandwidths, voiced
    gain, noise gain per color, f0.
    """
    segs = []  # (phone, n_frames)
    for name in phones:
        p = PHONES[name]
        dur = p.dur_ms / spk.rate * rng.uniform(0.82, 1.25)
        segs.append((p, max(2, int(round(dur / HOP_MS)))))
    T = sum(n for _, n in segs)
    F = np.zeros((T, 3))
    B = np.zeros((T, 3))
    vg = np.zeros(T)
    colors: Dict[Tuple[float, float], np.ndarray] = {}
    f0_rel = np.zeros(T)

    t = 0
    for p, n in segs:
        sl = slice(t, t + n)
        f_start = np.asarray(p.formants, float)
        f_end = np.asarray(p.formants2 if p.formants2 else p.formants, float)
        ramp = np.linspace(0.0, 1.0, n)[:, None]
        F[sl] = (f_start * (1 - ramp) + f_end * ramp) * spk.formant_scale
        B[sl] = np.asarray(p.bandwidths, float)
        g = np.full(n, p.voiced_gain if p.voiced else 0.0)
        noise = np.zeros(n)
        if p.kind in ("stop", "affric"):
            # closure/burst spans scale with the SAME factor the segment
            # length did (rate AND the random duration draw), then clamp
            # so closure + burst always fit inside the segment with at
            # least one trailing frame for the voiced tail — otherwise a
            # fast speaker with a short draw loses the burst and the
            # voiced portion entirely to slice clipping
            scale = n / max(p.dur_ms / HOP_MS, 1e-6)
            nc = max(1, int(round(p.closure_ms / HOP_MS * scale)))
            nb = max(1, int(round(p.burst_ms / HOP_MS * scale)))
            nc = min(nc, max(n - 2, 1))
            nb = min(nb, max(n - nc - 1, 1))
            g[:] = 0.0
            if p.voiced:
                g[:nc] = 0.12  # voice bar during closure
                g[nc + nb:] = p.voiced_gain
            burst = np.zeros(n)
            burst[nc:nc + nb] = p.burst_gain
            if not p.voiced:  # aspiration tail after the burst
                asp = min(n, nc + nb + max(1, int(6 / spk.rate)))
                burst[nc + nb:asp] = 0.25 * p.burst_gain
            noise = burst
        elif p.noise_gain > 0:
            noise[:] = p.noise_gain
        if p.noise_color is not None:
            c = colors.setdefault(p.noise_color, np.zeros(T))
            c[sl] = np.maximum(c[sl], noise)
        vg[sl] = g
        f0_rel[sl] = 1.0 if (p.voiced and p.kind != "sil") else 0.0
        t += n

    # coarticulation: formant/bandwidth targets glide between phones
    F = _gauss_smooth(F, 2.2)
    B = _gauss_smooth(B, 2.2)
    vg = _gauss_smooth(vg, 1.0)
    colors = {k: _gauss_smooth(v, 0.8) for k, v in colors.items()}

    # prosody: declination + sentence-final fall + slow wander + jitter
    pos = np.linspace(0.0, 1.0, T)
    contour = 1.12 - 0.22 * pos
    contour *= 1.0 - 0.12 * np.clip((pos - 0.85) / 0.15, 0, 1)
    wander = _gauss_smooth(rng.standard_normal(T) * 0.06, 8.0)
    f0 = spk.f0_base * contour * (1.0 + wander)
    f0 *= 1.0 + 0.01 * rng.standard_normal(T)  # jitter
    return dict(F=F, B=B, voiced=vg, colors=colors, f0=f0,
                voiced_mask=f0_rel)


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

def _formant_envelope(freqs: np.ndarray, F: np.ndarray, B: np.ndarray
                      ) -> np.ndarray:
    """Parallel formant amplitude envelope: sum of Lorentzian peaks with
    falling per-formant amplitudes, plus glottal tilt.

    freqs: (K,) or (T,K) Hz; F,B: (T,3).  Returns (T,K)."""
    if freqs.ndim == 1:
        freqs = freqs[None, :]
    amps = (1.0, 0.63, 0.35)
    env = np.zeros((F.shape[0], freqs.shape[-1]))
    for i, a in enumerate(amps):
        Fi = F[:, i:i + 1]
        Bi = B[:, i:i + 1]
        env += a / (1.0 + ((freqs - Fi) / (Bi / 2.0 + 1e-9)) ** 2)
    # source tilt ~ -12 dB/oct above 800 Hz
    env *= 1.0 / (1.0 + (freqs / 800.0) ** 2) ** 0.5
    return env


def _upsample(track: np.ndarray, n_samples: int) -> np.ndarray:
    """Frame track (T,...) -> per-sample (n_samples,...), linear interp.

    The 2D path is a vectorized re-statement of per-column np.interp on
    the uniform grid xp = arange(T)*HOP (same slope/offset arithmetic and
    operation order, so it is bit-identical — asserted by
    tests/test_synth_accel.py); the per-column np.interp + np.stack it
    replaces dominated corpus-synthesis time on 1-core hosts."""
    T = track.shape[0]
    x = np.arange(n_samples)
    if track.ndim == 1:
        return np.interp(x, np.arange(T) * HOP, track)
    track = track.astype(np.float64, copy=False)
    if T == 1:
        return np.broadcast_to(track, (n_samples,) + track.shape[1:]).copy()
    # Frame-blocked: sample i*HOP+t of segment i is slope_i*t + lo_i with
    # slope_i = (track[i+1]-track[i])/HOP — exactly np.interp's formula.
    K = track.shape[1]
    frac = np.arange(HOP, dtype=np.float64)[None, :, None]        # (1,HOP,1)
    lo = track[:-1][:, None, :]                                   # (T-1,1,K)
    slope = ((track[1:] - track[:-1]) / np.float64(HOP))[:, None, :]
    body = (slope * frac + lo).reshape((T - 1) * HOP, K)
    out = np.empty((n_samples, K))
    m = min(n_samples, (T - 1) * HOP)
    out[:m] = body[:m]
    out[m:] = track[T - 1]                                        # np.interp tail clamp
    return out


def _colored_noise(n: int, center: float, halfwidth: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Unit-RMS noise band-shaped around `center` (Lorentzian in freq)."""
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    f = np.fft.rfftfreq(n, 1.0 / FS)
    shape = 1.0 / (1.0 + ((f - center) / (halfwidth + 1e-9)) ** 2)
    shaped = np.fft.irfft(spec * shape, n)
    return shaped / (np.sqrt(np.mean(shaped ** 2)) + 1e-12)


def synth_tracks(tracks: Dict, rng: np.random.Generator) -> np.ndarray:
    """Render parameter tracks to a 16 kHz float waveform in [-1, 1]."""
    T = tracks["F"].shape[0]
    n = T * HOP
    f0_s = _upsample(tracks["f0"] * tracks["voiced_mask"], n)
    vg_s = _upsample(tracks["voiced"], n)

    # --- harmonic (voiced) part ---
    f0_frame = np.maximum(tracks["f0"], 60.0)
    Kmax = int(np.floor(7600.0 / float(f0_frame.min())))
    k = np.arange(1, Kmax + 1)
    harm_freqs = f0_frame[:, None] * k[None, :]             # (T, K)
    env = _formant_envelope(harm_freqs, tracks["F"], tracks["B"])
    env = np.where(harm_freqs < 7600.0, env, 0.0)
    f0_safe = np.where(f0_s > 1.0, f0_s, 100.0)
    phase = 2.0 * np.pi * np.cumsum(f0_safe) / FS
    amps = _upsample(env, n)                                 # (n, K)
    voiced = np.sum(amps * np.sin(phase[:, None] * k[None, :]), axis=1)
    voiced *= vg_s
    # normalize the harmonic stack so speakers w/ different K match
    voiced /= max(np.sqrt(np.mean(voiced[vg_s > 0.05] ** 2)), 1e-9) \
        if np.any(vg_s > 0.05) else 1.0

    # --- noise part (per color) + breathiness ---
    noise = np.zeros(n)
    for (center, halfwidth), gain_track in tracks["colors"].items():
        g = _upsample(gain_track, n)
        if g.max() <= 1e-6:
            continue
        noise += g * _colored_noise(n, center, halfwidth, rng)
    breath = tracks.get("breathiness", 0.01)
    noise += breath * vg_s * rng.standard_normal(n)

    sig = 0.6 * voiced + 0.45 * noise
    peak = np.max(np.abs(sig)) + 1e-9
    return (0.3 * sig / peak).astype(np.float32)


def synth_phones(phones: Sequence[str], speaker: Optional[Speaker] = None,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Phone names -> waveform.  Convenience wrapper."""
    rng = rng or np.random.default_rng(0)
    spk = speaker or Speaker()
    seq = ["SIL"] + list(phones) + ["SIL"]
    tracks = build_tracks(seq, spk, rng)
    tracks["breathiness"] = spk.breathiness
    return synth_tracks(tracks, rng)
