"""Drift detection: when incremental quality decays, ask for a retrain
(the port of ``predictionio_tpu/streaming/drift.py``, the same
arithmetic).

Fold-in keeps the deployed model seconds-fresh but holds the OPPOSITE
factor table fixed — over enough distribution shift the fixed side
itself goes stale and per-row solves stop converging to what a full
retrain would produce. The monitor watches two signals:

- **fold-in residual** (EWMA of each batch's mean normalized
  |u·v − r|): how well freshly solved rows explain their own events.
  Rising residuals mean the fixed factors no longer span the new
  preferences.
- **rating-distribution shift**: a Welford baseline over the first
  consumed events vs. a sliding recent window; the score is the
  standardized mean shift (|Δmean| / baseline σ).

``score()`` is the max of both (each normalized so ~0 is healthy and
1.0 is the default retrain trigger). Past the threshold the trainer
flips ``retrain_due`` and keeps folding — incremental updates stay better than nothing while the
operator (or an ``on_retrain`` hook) schedules the full retrain. A
rebind to a fresh full retrain resets the monitor.
"""

from __future__ import annotations

import math
from typing import List, Optional

__all__ = ["DriftMonitor"]


class DriftMonitor:
    def __init__(self, threshold: float = 1.0,
                 baseline_min_samples: int = 64,
                 window: int = 512, residual_halflife: int = 16,
                 residual_scale: float = 0.5):
        self.threshold = float(threshold)
        self.baseline_min = int(baseline_min_samples)
        self.window = int(window)
        #: EWMA decay per BATCH for the residual track
        self._alpha = 1.0 - 0.5 ** (1.0 / max(residual_halflife, 1))
        #: residual at which the residual track alone reads 1.0
        self.residual_scale = float(residual_scale)
        # Welford baseline (frozen once baseline_min samples land)
        self._n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._frozen = False
        self._recent: List[float] = []
        self._residual_ewma: Optional[float] = None
        self.batches = 0

    # -- feeding -------------------------------------------------------------
    def observe(self, values: List[float],
                residual: Optional[float]) -> None:
        """One fold-in batch: its projected rating values and its
        solve residual."""
        self.batches += 1
        for v in values:
            if not self._frozen:
                self._n += 1
                d = v - self._mean
                self._mean += d / self._n
                self._m2 += d * (v - self._mean)
                if self._n >= self.baseline_min:
                    self._frozen = True
            self._recent.append(float(v))
        if len(self._recent) > self.window:
            self._recent = self._recent[-self.window:]
        if residual is not None and math.isfinite(residual):
            if self._residual_ewma is None:
                self._residual_ewma = float(residual)
            else:
                self._residual_ewma += self._alpha * (
                    float(residual) - self._residual_ewma)

    def reset(self) -> None:
        """A fresh full retrain is serving: baseline and tracks restart
        from its distribution."""
        self.__init__(threshold=self.threshold,
                      baseline_min_samples=self.baseline_min,
                      window=self.window,
                      residual_scale=self.residual_scale)

    # -- scoring -------------------------------------------------------------
    def shift_score(self) -> float:
        """|Δmean| of the recent window vs the frozen baseline, in
        baseline standard deviations (0 until both sides have
        samples)."""
        if not self._frozen or len(self._recent) < 8:
            return 0.0
        var = self._m2 / max(self._n - 1, 1)
        sigma = math.sqrt(var) if var > 1e-12 else 1.0
        recent_mean = sum(self._recent) / len(self._recent)
        return abs(recent_mean - self._mean) / sigma

    def residual_score(self) -> float:
        if self._residual_ewma is None:
            return 0.0
        return self._residual_ewma / max(self.residual_scale, 1e-9)

    def score(self) -> float:
        return max(self.shift_score(), self.residual_score())

    @property
    def retrain_due(self) -> bool:
        return self.score() >= self.threshold

    def status(self) -> dict:
        return {
            "score": round(self.score(), 4),
            "shiftScore": round(self.shift_score(), 4),
            "residualScore": round(self.residual_score(), 4),
            "residualEwma": (round(self._residual_ewma, 6)
                             if self._residual_ewma is not None else None),
            "baselineFrozen": self._frozen,
            "baselineSamples": self._n,
            "threshold": self.threshold,
            "retrainDue": self.retrain_due,
            "batches": self.batches,
        }
