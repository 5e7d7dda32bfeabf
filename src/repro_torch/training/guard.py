"""Host-side anomaly detection + rewind policy for the training loop
(port of ``repro/training/guard.py``; host numpy).

Two detection tiers guard each train step:

  * STEP tier (``training/step.py``): an all-finite + grad-norm check on
    the step's loss and gradient norm, read once per step. An anomalous
    step is SKIPPED: params, optimizer state and masks are returned
    unchanged, so a run that hits NaN grads at step k is
    bitwise-identical to a run that never applies step k's update.
  * HOST tier (this module): EMA/z-score loss-spike detection. A spike
    has finite gradients, so its update was already applied and cannot
    be skipped after the fact — spikes instead count toward the same
    K-consecutive-anomalies budget as step skips, and hitting K
    triggers an automatic REWIND: restore the newest intact checkpoint
    and replay. The stateless data pipeline (batch = f(seed, step)) and
    in-state RNG make the replay bitwise-exact.

The spike threshold is SCHEDULE-AWARE: right after a scheduled
prune-grow refresh (``core/schedule.py`` cadence) the loss legitimately
jumps — the sparsifier just zeroed whole weight blocks — so for
``refresh_window`` steps after each refresh the z-threshold is widened
by ``refresh_relax`` instead of tripping the guard on the schedule's
own dynamics.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.schedule import steps_since_refresh


@dataclasses.dataclass
class GuardConfig:
    """Knobs for both guard tiers. ``grad_norm_limit`` feeds the step
    tier; the rest drive the host tier."""
    enabled: bool = True
    z_threshold: float = 10.0      # spike = z-score above this
    ema_beta: float = 0.9          # EMA decay for loss mean/variance
    warmup_steps: int = 10         # healthy observations before arming
    min_std_frac: float = 0.2      # std floor as a fraction of |mean|
    max_consecutive: int = 3       # K anomalies in a row -> rewind
    max_rewinds: int = 2           # rewind budget, then diverged
    refresh_window: int = 5        # widened steps after a prune refresh
    refresh_relax: float = 4.0     # threshold multiplier in the window
    grad_norm_limit: float | None = None  # step-tier norm anomaly


class AnomalyGuard:
    """Per-run detector state + counters. ``observe`` returns a verdict:

      * ``"ok"``     — healthy step, EMA updated;
      * ``"skip"``   — the step tier already skipped the update;
      * ``"spike"``  — host-tier loss spike (update was applied);
      * ``"rewind"`` — K consecutive anomalies: the loop should restore
        the newest intact checkpoint and replay (or raise
        ``TrainingDivergedError`` if it cannot).
    """

    def __init__(self, cfg: GuardConfig, step_size: int = 0):
        self.cfg = cfg
        self.step_size = int(step_size or 0)
        self._mean: float | None = None
        self._var = 0.0
        self._n = 0                    # healthy observations seen
        self.consecutive = 0
        self.counters = {"anomaly_steps": 0, "skipped_steps": 0,
                         "spike_steps": 0, "rewinds": 0,
                         "steps_replayed": 0}

    # -------------------------------------------------------- detection
    def threshold_at(self, step: int) -> float:
        thr = self.cfg.z_threshold
        if (self.step_size
                and steps_since_refresh(step, self.step_size)
                < self.cfg.refresh_window):
            thr *= self.cfg.refresh_relax
        return thr

    def zscore(self, loss: float) -> float:
        """Deviation of ``loss`` from the EMA in floored-std units; 0
        until the detector has a mean."""
        if self._mean is None:
            return 0.0
        std = math.sqrt(max(self._var, 0.0))
        floor = abs(self._mean) * self.cfg.min_std_frac + 1e-8
        return (loss - self._mean) / max(std, floor)

    def observe(self, step: int, loss: float,
                device_anomaly: bool) -> str:
        c = self.cfg
        verdict = "ok"
        if device_anomaly:
            self.counters["skipped_steps"] += 1
            verdict = "skip"
        elif not np.isfinite(loss):
            # host sees a non-finite loss the step tier did not skip
            # (guard compiled out): treat as a spike-tier anomaly
            self.counters["spike_steps"] += 1
            verdict = "spike"
        elif (self._n >= c.warmup_steps
                and self.zscore(loss) > self.threshold_at(step)):
            self.counters["spike_steps"] += 1
            verdict = "spike"

        if verdict != "ok":
            self.counters["anomaly_steps"] += 1
            self.consecutive += 1
            if self.consecutive >= c.max_consecutive:
                return "rewind"
            return verdict

        self.consecutive = 0
        if self._mean is None:
            self._mean = float(loss)
        else:
            d = float(loss) - self._mean
            self._mean += (1.0 - c.ema_beta) * d
            self._var = c.ema_beta * (self._var
                                      + (1.0 - c.ema_beta) * d * d)
        self._n += 1
        return "ok"

    # ----------------------------------------------------------- rewind
    def note_rewind(self, from_step: int, to_step: int) -> None:
        """Record a performed rewind and restart the detector — the
        replayed region is judged fresh (the faults that tripped the
        guard were transient; deterministic recurrence exhausts
        ``max_rewinds`` and surfaces as TrainingDivergedError)."""
        self.counters["rewinds"] += 1
        self.counters["steps_replayed"] += max(from_step - to_step, 0)
        self.reset()
        self._mean, self._var, self._n = None, 0.0, 0

    def reset(self) -> None:
        """Clear the consecutive-anomaly streak (rewind unavailable)."""
        self.consecutive = 0
