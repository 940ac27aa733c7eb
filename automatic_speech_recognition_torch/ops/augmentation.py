"""The host-side speed-rate arithmetic of
automatic_speech_recognition_tpu/ops/augmentation.py (`_rational_speed`,
`_parse_rates`, `_rate_fractions`, `worst_stretch_len`), copied as they
are: data/pipeline.py buckets training records by `worst_stretch_len`
when online speed perturbation is configured.  The rest of that module
(the resampler on the device) is not ported yet (ROADMAP item 5).
"""

from __future__ import annotations

import functools as _functools
from fractions import Fraction


def _rational_speed(speed: float, max_den: int = 1000) -> Fraction:
    """speed = down/up as a reduced fraction (0.9 -> 9/10: upsample 10,
    decimate 9; output length ~ len/speed).

    max_den 1000 keeps the rate error below 5e-7 relative for arbitrary
    factors and makes common sample-rate ratios exact (e.g. 11025/16000
    = 441/640)."""
    if speed <= 0:
        raise ValueError(f"speed must be positive, got {speed}")
    return Fraction(speed).limit_denominator(max_den)


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
