"""The one traffic generator: a mix file's parameters -> sizes, arrival
times, token ids and audio slices.

The mix's `shape_seed` fixes the sizes, their order, the arrival times
and the token counts, so every run of a cell does the same work: in an
open-loop cell the pairing of sizes with arrival times is the work, and a
seed that reordered them moved the tail by more than the host did.  The
run's --seed picks the audio slices and the token ids (and the weights).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import List

import numpy as np

from bench_torch.reference import las as ref

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def sizes(mix: dict, cfg: dict, count: int = 0) -> np.ndarray:
    """Samples per item, fixed by the mix's shape seed.

    'lognormal': `count` durations exp(N(log median, sigma)) clipped to
    [min_s, max_s]; 'buckets': `per_bucket` items uniform in each
    training bucket's sample range (frames < boundary), the first bucket
    from min_s."""
    spec = mix["durations"]
    rng = np.random.default_rng([mix["shape_seed"], 1])
    sr = cfg["sample_rate"]
    if spec["kind"] == "lognormal":
        secs = np.exp(rng.normal(math.log(spec["median_s"]), spec["sigma"],
                                 count))
        secs = np.clip(secs, spec["min_s"], spec["max_s"])
        return np.round(secs * sr).astype(np.int64)
    if spec["kind"] == "buckets":
        flen, step = ref.frame_params(cfg)
        out, lo = [], int(spec["min_s"] * sr)
        for b in cfg["bucket_boundaries_train"]:
            hi = b * step + flen                  # frames < b <=> samples < hi
            out.append(rng.integers(lo, hi, spec["per_bucket"]))
            lo = hi
        return np.concatenate(out).astype(np.int64)
    raise ValueError(f"unknown durations kind {spec['kind']!r}")


def arrivals(mix: dict, seconds: float) -> np.ndarray:
    """Poisson arrivals at the mix's rate over [0, seconds): a count of
    rate x seconds, at sorted uniform times (a Poisson process given its
    count), fixed by the shape seed."""
    spec = mix["arrivals"]
    if spec["kind"] != "poisson":
        raise ValueError(f"unknown arrivals kind {spec['kind']!r}")
    rng = np.random.default_rng([mix["shape_seed"], 2])
    n = max(int(round(spec["rate_per_s"] * seconds)), 1)
    return np.sort(rng.uniform(0.0, seconds, n))


def offsets(seed: int, lengths: np.ndarray, source_len: int) -> np.ndarray:
    """Where each item's audio starts in the stretch, so that it fits."""
    rng = np.random.default_rng([seed, 4])
    return (rng.random(len(lengths)) * (source_len - lengths + 1)
            ).astype(np.int64)


def labels(seed: int, lengths: np.ndarray, mix: dict, cfg: dict
           ) -> List[np.ndarray]:
    """Token ids of each item: `tokens_per_s` (a [low, high] range)
    tokens a second of audio, the rate fixed by the shape seed, the ids
    drawn by `seed` uniformly from the content ids (past PAD, SOS, EOS),
    capped so that the EOS appended fits max_tokenlen_train."""
    counts = np.random.default_rng([mix["shape_seed"], 5])
    rng = np.random.default_rng([seed, 5])
    lo, hi = mix["tokens_per_s"]
    cap = cfg["max_tokenlen_train"] - 1
    out = []
    for n in lengths:
        rate = counts.uniform(lo, hi)
        k = int(min(max(round(rate * n / cfg["sample_rate"]), 1), cap))
        ids = rng.integers(ref.EOS + 1, cfg["vocab_size"], k)
        out.append(np.append(ids, ref.EOS).astype(np.int32))
    return out
