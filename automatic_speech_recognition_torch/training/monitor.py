"""The port's own copy of automatic_speech_recognition_tpu/training/monitor.py
(tests/test_torch_shared_copies.py holds it to the original).

Host-side training-health monitor: catch dead-basin runs early.

Motivation (measured, round 4): a published-size LAS retrain on the
identical recipe as a previously-successful run spent 41k steps with the
total loss flat at ~22 (CTC never descended below ~110 nats/seq) while
teacher-forced att_peak rose to ~0.46 by 4k and then decayed back to
~0.25 — the attention/decoder never bound, and nothing in the driver
surfaced it.  A 256-unit control probe on the same shards bound in <750
steps, so the data was fine; the flagship had simply fallen into an
optimization basin it was never going to leave.  41k steps x ~70 ms =
~45 TPU-minutes of provably wasted work that a trend check on the
metrics the driver ALREADY logs would have flagged by step 10k.

The reference has no equivalent (its train loop prints loss and samples,
las/train.py:114-126, and relies on a human watching the console); this
monitor is the framework's productionization of the round-3 study's
att_peak transition scalar (benchmarks/WER_SYNTH.md "attention/decoder
binding") into an automatic alarm.

Rules (each fires at most once, WARNING by default; --monitor_abort
exits with code 20 so supervisors can distinguish "diverged, do NOT
retry the same seed" from transient platform failures (18) and stalls
(17), tools/train_supervised.sh):

- loss_plateau: at step >= monitor_min_step the smoothed total loss has
  improved less than (1 - monitor_plateau_frac) relative to its early
  reference (the smoothed loss near step monitor_min_step/10).  The
  failed run holds 22/25.8 = 0.85 at every step past 10k (fires); the
  successful round-3 run was at 2.46/~25 = 0.10 by 8.6k (never fires).
- att_collapse: smoothed att_peak climbed to >= monitor_att_rise and
  then fell below monitor_att_keep x its running peak without ever
  binding (>= monitor_att_bound).  The failed run peaked ~0.45 and
  decayed to ~0.25 (0.55 x peak -> fires); healthy runs either bind
  (0.95 plateau) or never rise in the first place (round-2 arm sat at
  0.15-0.23 -> loss_plateau is the rule that catches those).

Smoothing is an EMA over log-cadence observations (every ~10 steps in
train.py), horizon ~50 observations, so bucket-to-bucket loss noise
(batches are bucket-homogeneous) does not trip the rules.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

# exit code for "training diverged; retrying the same configuration will
# reproduce the failure" — deliberately distinct from the retryable
# codes (17 stall, 18 transient platform) in utils/platform.py
DIVERGED_EXIT_CODE = 20


@dataclass
class BindingMonitor:
    """Trend alarms over (step, loss, att_peak) observations."""

    min_step: int = 10000        # no alarms before this step
    plateau_frac: float = 0.7    # smoothed loss still > frac * early ref
    att_rise: float = 0.35       # EMA must first climb past this ...
    att_keep: float = 0.6        # ... then fall below keep * peak
    att_bound: float = 0.7       # reaching this = bound; collapse alarm off
    ema_alpha: float = 0.04      # per-observation smoothing (~50-obs horizon)

    _ema_loss: Optional[float] = field(default=None, repr=False)
    _ema_att: Optional[float] = field(default=None, repr=False)
    _early_loss: Optional[float] = field(default=None, repr=False)
    _peak_att: float = field(default=0.0, repr=False)
    _bound: bool = field(default=False, repr=False)
    _fired: set = field(default_factory=set, repr=False)

    def _ema(self, prev, x):
        return x if prev is None else (1 - self.ema_alpha) * prev \
            + self.ema_alpha * x

    def update(self, step: int, loss: float, att_peak: float) -> List[str]:
        """Feed one logged observation; returns newly-fired alarm strings
        (empty list almost always).  NaN/inf observations are skipped —
        a NaN loss is its own, louder, failure."""
        import math
        if not (math.isfinite(loss) and math.isfinite(att_peak)):
            return []
        self._ema_loss = self._ema(self._ema_loss, float(loss))
        self._ema_att = self._ema(self._ema_att, float(att_peak))
        self._peak_att = max(self._peak_att, self._ema_att)
        if self._ema_att >= self.att_bound:
            self._bound = True
        # early loss reference: first observation at/after min_step/10
        # (past the first dispatches' warmup transient).  Only captured
        # while still inside the early window — a run RESUMED past
        # min_step/2 (fine-tune arms, preemption restarts) never arms
        # the plateau rule, since comparing a converged loss to itself
        # would always "plateau".
        if (self._early_loss is None
                and self.min_step // 10 <= step <= self.min_step // 2):
            self._early_loss = self._ema_loss
        alarms: List[str] = []
        if step < self.min_step:
            return alarms
        if ("loss_plateau" not in self._fired
                and self._early_loss is not None
                and self._ema_loss > self.plateau_frac * self._early_loss):
            self._fired.add("loss_plateau")
            alarms.append(
                f"loss_plateau: smoothed loss {self._ema_loss:.3f} at step "
                f"{step} is still {self._ema_loss / self._early_loss:.0%} of "
                f"its early value {self._early_loss:.3f} — the run is not "
                f"converging (round-4 dead-basin signature)")
        if ("att_collapse" not in self._fired and not self._bound
                and self._peak_att >= self.att_rise
                and self._ema_att < self.att_keep * self._peak_att):
            self._fired.add("att_collapse")
            alarms.append(
                f"att_collapse: smoothed att_peak fell to {self._ema_att:.2f} "
                f"from a peak of {self._peak_att:.2f} without ever binding "
                f"(>= {self.att_bound}) — attention rose and collapsed; the "
                f"decoder is detaching from the encoder")
        return alarms

    @property
    def alarmed(self) -> bool:
        return bool(self._fired)
