"""The port's own copy of automatic_speech_recognition_tpu/utils/summary.py
(tests/test_torch_shared_copies.py holds it to the original).

Training observability: scalars, text samples, alignment/feature images.

The reference writes TensorBoard summaries — scalar loss/step, HYP/REF text
samples, attention-alignment images (alpha x 255) and input-feature images
(las/las.py:285-299; train.py:93-97).  This module provides the same
visibility without a TF dependency:

- scalars + text -> append-only JSONL (`events.jsonl`), trivially plottable
  and machine-readable;
- images (attention alignments, features) -> .npy dumps plus portable PGM
  renders (alpha x 255, like the reference's tf.summary.image).

Also hosts the per-stage wall-clock timers — the tracing subsystem the
reference lacks (SURVEY.md §5).  The original's jax.profiler hook
`profile_trace` is left out: the port traces with torch.profiler.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import numpy as np


class SummaryWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "events.jsonl"), "a")

    def scalar(self, tag: str, value, step: int) -> None:
        self._write({"kind": "scalar", "tag": tag, "step": int(step),
                     "value": float(value)})

    def text(self, tag: str, text: str, step: int) -> None:
        self._write({"kind": "text", "tag": tag, "step": int(step),
                     "text": text})

    def image(self, tag: str, array: np.ndarray, step: int) -> None:
        """Save a 2-D array as .npy + an 8-bit PGM render (alpha x 255,
        reference: las/las.py:294-296)."""
        a = np.asarray(array, np.float32)
        base = os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step}")
        np.save(base + ".npy", a)
        lo, hi = float(a.min()), float(a.max())
        img = np.zeros_like(a, np.uint8) if hi <= lo else \
            ((a - lo) / (hi - lo) * 255).astype(np.uint8)
        with open(base + ".pgm", "wb") as f:
            f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
            f.write(img.tobytes())
        self._write({"kind": "image", "tag": tag, "step": int(step),
                     "file": base + ".pgm"})

    def _write(self, rec: Dict) -> None:
        rec["ts"] = time.time()
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class NullSummaryWriter:
    """Drop-in no-op writer for non-primary processes in multi-host runs
    (scalars are replicated, so N writers would only duplicate events)."""

    def scalar(self, tag, value, step):
        pass

    def text(self, tag, text, step):
        pass

    def image(self, tag, array, step):
        pass

    def close(self):
        pass


class StageTimer:
    """Named wall-clock accumulators (utt/sec, steps/sec reporting)."""

    def __init__(self):
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t0
            self.count[name] = self.count.get(name, 0) + 1

    def rate(self, name: str, items: int) -> float:
        t = self.total.get(name, 0.0)
        return items / t if t > 0 else 0.0

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.total[k], "calls": self.count[k],
                    "mean_s": self.total[k] / max(self.count[k], 1)}
                for k in self.total}

